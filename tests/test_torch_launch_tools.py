"""The port's small tools against the reference, on the CPU: the data
pipeline's ``FileSource``, the quickstart (``python -m
repro_torch.launch.quickstart``), the production meshes, and the kernel
registry's shape-only variant, which the dry run's fake tensors take and a
tensor that holds data (or one on ``meta``) never does."""
import os
import subprocess
import sys
from itertools import islice
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.data.pipeline import FileSource as RFileSource

from repro_torch import kernels as T_kernels
from repro_torch.data.pipeline import DataPipeline, FileSource
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ring_wire import ops as rw_ops
from repro_torch.kernels.ring_wire import ref as rw_ref
from repro_torch.launch import mesh as t_mesh

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("dtype,doc_len", [(np.uint16, 7), (np.uint32, 64)])
def test_file_source_yields_the_references_documents(tmp_path, dtype, doc_len):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(5).integers(0, 50000, size=1000).astype(dtype).tofile(path)
    for start in (0, 3, 200):
        want = list(islice(RFileSource(path, dtype=dtype, doc_len=doc_len).documents(start),
                           20))
        got = list(islice(FileSource(path, dtype=dtype, doc_len=doc_len).documents(start), 20))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    pipe = DataPipeline(FileSource(path, dtype=dtype, doc_len=doc_len), global_batch=2,
                        seq_len=16)
    batch = next(pipe)
    pipe.close()
    assert batch["tokens"].shape == (2, 16) and batch["targets"].shape == (2, 16)


def test_quickstart_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.quickstart",
                           "--device", "cpu"], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "allreduce: [0. 2. 4. 6.] | allgather: [0. 1. 2. 3.]" in out
    assert "user op result: [3. 3. 3.]" in out
    assert "tool ledger: {'allreduce': 28, 'allgather': 16} total bytes: 44" in out


def test_production_meshes_need_their_world():
    if torch.distributed.is_initialized():
        pytest.skip("a process group is already running in this process")
    with pytest.raises(RuntimeError, match="start torch.distributed"):
        t_mesh.make_production_mesh(device="cpu")
    host = t_mesh.make_host_mesh(1, device="cpu")
    assert (host.axis_names, host.sizes) == (("data", "model"), (1, 1))


def test_train_launcher_production_mesh_needs_256_ranks():
    from repro_torch.launch import train

    if torch.distributed.is_initialized():
        pytest.skip("a process group is already running in this process")
    with pytest.raises(ValueError, match="world of 256 ranks"):
        train.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--steps", "1",
                    "--production-mesh"])
    assert not torch.distributed.is_initialized()


def test_shape_variant_only_for_fake_tensors():
    x = torch.ones(4, 6)
    assert T_kernels.variant_for(x) == "torch"
    with FakeTensorMode():
        assert T_kernels.variant_for(torch.ones(4, 6)) == "shape"
    with pytest.raises(ValueError, match="CUDA or CPU"):   # meta has no kernel
        T_kernels.variant_for(torch.empty(4, 6, device="meta"))
    # a device (not a tensor) keeps its variant: there is no meta kernel
    assert T_kernels.variant_for("cuda") == "cuda"
    assert T_kernels.resolve("flash_attention", "cuda")[0] == "cuda"
    with pytest.raises(ValueError):
        T_kernels.variant_for("meta")


def test_shape_variant_returns_the_kernels_shapes_and_no_launch():
    before = (rw_ops.pack_transposed.launches, fa_ops.flash_attention.launches)
    x = torch.arange(24.0).reshape(4, 6)
    # a CPU tensor with data takes the plain version: its numbers
    assert torch.equal(rw_ops.pack_transposed(x, 2, 2, torch.bfloat16),
                       rw_ref.pack_transposed(x, 2, 2, torch.bfloat16))
    q = torch.randn(4, 16, 8)
    assert torch.equal(fa_ops.flash_attention(q, q[:2], q[:2]),
                       fa_ref.attention_ref(q, q[:2], q[:2]))
    with FakeTensorMode():
        packed = rw_ops.pack_transposed(torch.ones(4, 6), 2, 2, torch.bfloat16)
        assert (tuple(packed.shape), packed.dtype) == ((2, 2, 6), torch.bfloat16)
        unpacked = rw_ops.unpack_transposed(packed)
        assert (tuple(unpacked.shape), unpacked.dtype) == ((4, 6), torch.float32)
        out = fa_ops.flash_attention(torch.ones(4, 16, 8), torch.ones(2, 16, 8),
                                     torch.ones(2, 16, 8))
        assert tuple(out.shape) == (4, 16, 8)
    assert (rw_ops.pack_transposed.launches, fa_ops.flash_attention.launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tensor_takes_the_kernel(cuda_device):
    x = torch.ones(4, 6, device=cuda_device)
    assert T_kernels.variant_for(x) == "cuda"
    before = rw_ops.pack_transposed.launches
    rw_ops.pack_transposed(x, 2, 2, torch.float32)
    assert rw_ops.pack_transposed.launches == before + 1
