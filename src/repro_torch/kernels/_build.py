"""Build and load the hand-written CUDA kernels (nvcc -> shared library with
a plain C interface -> ``ctypes``).

Each library is compiled at first use for ``sm_90a`` into ``build/kernels/``
at the repository root, named by a digest of its sources and of the shared
headers in ``kernels/csrc/`` (which nvcc gets with ``-I``), so an edited
source or header never loads a stale library.  The compile goes to a
temporary file that is renamed into place, so concurrent ranks never load a
half-written library.  Nothing here runs at import.  :func:`launch` is the one place a
kernel wrapper calls into a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
#: the headers the kernels' sources share (``#include "tf32_wgmma.cuh"``)
INCLUDE_DIR = Path(__file__).with_name("csrc")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    location, or ``nvcc`` on the PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are compiled on the machine with the card")


def headers() -> list:
    """The shared headers, each part of every library's digest."""
    return sorted(INCLUDE_DIR.glob("*.cuh"))


def library_path(name: str, sources) -> Path:
    h = hashlib.sha1()
    for src in (*sources, *headers()):
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, sources) -> Path:
    """Compile ``sources`` into the shared library for ``name`` unless the
    library for these exact sources exists.  Returns its path; the
    compiler's resource report (``-Xptxas -v``) is kept beside it as
    ``<lib>.log``."""
    sources = [Path(s) for s in sources]
    lib = library_path(name, sources)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v", f"-I{INCLUDE_DIR}",
           "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name, sources)))
    return lib


def launch(load, fn_name: str, tensors, *args) -> None:
    """Call ``fn_name`` of the library ``load()`` returns with the tensors'
    device pointers, then ``args``, then the current stream of their card.
    Raises unless every tensor is on one CUDA device (before anything is
    built), and when the library reports a failed launch."""
    dev = tensors[0].device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{fn_name} takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(*(t.data_ptr() for t in tensors), *args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {rc}")
