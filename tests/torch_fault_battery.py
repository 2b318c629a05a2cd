"""The port's fault tier on eight gloo ranks: the legs of the multidev
battery's sections 14 and 16 that need more processes than the tier-1
tests start (``tests/test_torch_fault_tier.py`` and
``tests/test_torch_serve_supervisor.py`` run them at dp=4 and tp=2).
pytest does not collect this script; run it from the repository root:

    PYTHONPATH=src python tests/torch_fault_battery.py

* section 14: ZeRO-1 at dp=8 under ``faulty:paxi``/``minimal``/``ompix``,
  rank 5 dead before step 6 of 8; the survivors (seven) shrink, the
  power-of-two trim keeps ranks 0-3 at dp=4, which resume from the step-4
  checkpoint bitwise equal to a dp=4 oracle restored from the same
  checkpoint; ranks 4-7 leave;
* section 16 and 18's serving half: tp=4, rank 2 dies silently mid-decode
  or drops the decode broadcast; the survivors replay token for token.

About a minute on eight CPU cores; it ends with "TORCH FAULT BATTERY
PASSED".
"""
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import _torch_fault_ranks as FR  # noqa: E402
import _torch_ranks  # noqa: E402


def _bitwise(out) -> bool:
    got = {k[4:]: v for k, v in out.items() if k.startswith("got:")}
    want = {k[5:]: v for k, v in out.items() if k.startswith("want:")}
    return got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)


def _dir(root: Path, name: str) -> Path:
    d = root / name
    d.mkdir()
    return d


def main() -> None:
    root = Path(tempfile.mkdtemp(prefix="torch-fault-battery-"))
    for impl in ("paxi", "minimal", "ompix"):
        ranks = _torch_ranks.run_ranks(FR.elastic_rank, 8, _dir(root, f"elastic-{impl}"), impl, 5,
                                       timeout=300)
        for r, out in enumerate(ranks):
            if r < 4:
                assert not out["left"] and int(out["dp"]) == 4, (impl, r)
                assert list(out["world_ranks"]) == [0, 1, 2, 3] and _bitwise(out), (impl, r)
            else:
                assert out["left"] and list(out["failed"]) == [5], (impl, r)
        print(f"  {impl}: dp=8, rank 5 dead at step {FR.KILL_AT} -> dp=4 resume bitwise == "
              "oracle OK")
    for impl in ("paxi", "minimal", "ompix"):
        for mode in ("die", "drop"):
            ranks = _torch_ranks.run_ranks(FR.serve_rank, 4, _dir(root, f"serve-{impl}-{mode}"),
                                           impl, mode, 2, timeout=300)
            for r, out in enumerate(ranks):
                if r == 2:
                    assert out["left"], (impl, mode)
                    continue
                assert not out["left"] and list(out["excludes"]) == [2], (impl, mode, r)
                for i in range(3):
                    np.testing.assert_array_equal(out[f"got{i}"], out[f"want{i}"])
            print(f"  {impl}: tp=4, rank 2 {mode} mid-decode -> shrink, replay bitwise OK")
    print("TORCH FAULT BATTERY PASSED")


if __name__ == "__main__":
    main()
