"""The port's import rule: ``repro_torch`` imports neither ``jax`` nor any
module of the reference package ``repro``.  A fresh interpreter imports
every module of ``repro_torch`` and lists what entered ``sys.modules``."""
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"

_PROBE = r"""
import json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(m.name)
    names.append(m.name)
banned = sorted(n for n in sys.modules
                if n.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"imported": names, "banned": banned}))
"""


def test_repro_torch_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the walk reached every package of the port, the serving tier included
    for name in ("repro_torch.serve.engine", "repro_torch.serve.sampling",
                 "repro_torch.launch.serve", "repro_torch.launch.bench_serve",
                 "repro_torch.kernels.flash_attention.ops", "repro_torch.core.abi"):
        assert name in got["imported"]
    assert got["banned"] == [], f"repro_torch pulled in {got['banned']}"
