"""The serving engine's ``decode-tp`` sync across tensor-parallel ranks (the
twin of the multidev battery's section 15): in a gloo world of two ranks on
the model axis, each rank starts the plan group with its own token and
active-row vectors, and both get rank 0's, bitwise equal to the pooled
``ibcast``/``waitall`` path; a counting tool sees one ``decode-tp`` call per
step and the pooled path's two ``bcast`` calls."""
from pathlib import Path

import numpy as np
import pytest

from _torch_ranks import run_ranks

MB = 8
STEPS = 3


def _payload(rank: int):
    tok = (np.arange(MB, dtype=np.int32) + 100 * rank) * 3 + 1
    act = ((np.arange(MB) + rank) % 2).astype(np.int32)
    return tok, act


def decode_sync_rank(rank, world, init_method, out_dir, impl):
    from repro_torch.core import CallCounter
    from repro_torch.runtime.dist import make_dist
    from repro_torch.serve import DecodeSync

    with make_dist(model_axis=world, impl=impl, device="cpu", world_size=world, rank=rank,
                   init_method=init_method) as dist:
        cc = CallCounter()
        dist.abi.attach_tool(cc)
        ds = DecodeSync(dist.abi, dist.tp_comm, MB)
        tok, act = _payload(rank)
        out = {}
        for step in range(STEPS):        # restartable: the same group slot every step
            out[f"gt{step}"], out[f"ga{step}"] = ds.step(tok, act)
            out[f"pt{step}"], out[f"pa{step}"] = ds.step_pooled(tok, act)
        out["group_calls"] = np.array(cc.counts[DecodeSync.NAME])
        out["bcast_calls"] = np.array(cc.counts["bcast"])
        ds.free()
        out["outstanding"] = np.array(dist.abi.outstanding_requests)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)


@pytest.mark.parametrize("impl", ["paxi", "ring"])
def test_decode_tp_group_equals_pooled_across_two_ranks(impl, tmp_path):
    ranks = run_ranks(decode_sync_rank, 2, tmp_path, impl)
    want_tok, want_act = _payload(0)
    for r, out in enumerate(ranks):
        for step in range(STEPS):
            np.testing.assert_array_equal(out[f"gt{step}"], out[f"pt{step}"])
            np.testing.assert_array_equal(out[f"ga{step}"], out[f"pa{step}"])
            np.testing.assert_array_equal(out[f"gt{step}"], want_tok, err_msg=f"rank {r}")
            np.testing.assert_array_equal(out[f"ga{step}"], want_act, err_msg=f"rank {r}")
        assert int(out["group_calls"]) == STEPS and int(out["bcast_calls"]) == 2 * STEPS
        assert int(out["outstanding"]) == 0
