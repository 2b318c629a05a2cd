"""The step profiler's reading of a chrome trace (``trace_summary``).

A hand-made trace with what the card's traces hold: kernels on two
streams that overlap, a device copy, a memset, and the GPU-track
annotation ranges that ``record_function`` and c10d emit.  Only the
device's work may count, overlapping work counts once in the busy time,
and a span owns the work launched inside it from any thread.
"""
import pytest

from repro_torch.launch.profile_step import kernel_class, trace_summary


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _trace():
    return [
        # host: one span on the step's thread; launches on it and on the
        # autograd device thread (tid 2) while it waits inside the span
        _x("user_annotation", "zero1.grads", 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, tid=2, correlation=2),
        _x("user_annotation", "zero1.all_gather", 200, 50),
        _x("cuda_runtime", "cudaMemcpyAsync", 210, 1, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 300, 1, correlation=4),
        # device work: two kernels that overlap on two streams, a copy, a memset
        _x("kernel", "gemm_a", 1000, 400, tid=7, correlation=1),
        _x("kernel", "gemm_b", 1200, 400, tid=8, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 2000, 100, tid=7,
           correlation=3),
        _x("gpu_memset", "Memset (Device)", 3000, 50, tid=7, correlation=4),
        # annotation ranges on the GPU track: not work
        _x("gpu_user_annotation", "nccl:_all_gather_base", 2000, 100, tid=7),
        _x("gpu_user_annotation", "zero1.grads", 1000, 600, tid=7),
        {"ph": "M", "name": "process_name", "args": {"name": "gpu"}},
    ]


def test_only_device_work_counts():
    s = trace_summary(_trace(), n_steps=1)
    assert set(s["work"]) == {"gemm_a", "gemm_b", "Memcpy DtoD (Device -> Device)",
                              "Memset (Device)"}
    assert sum(ms for ms, _ in s["work"].values()) == pytest.approx(0.95)
    assert not any(kernel_class(n) == "nccl" for n in s["work"])


def test_busy_time_is_the_union_over_streams():
    # gemm_a and gemm_b overlap by 200 us: 600 + 100 + 50 us of busy device
    assert trace_summary(_trace(), n_steps=1)["busy_ms"] == pytest.approx(0.75)
    assert trace_summary(_trace(), n_steps=2)["busy_ms"] == pytest.approx(0.375)


def test_span_owns_the_work_launched_inside_it_from_any_thread():
    spans = trace_summary(_trace(), n_steps=1)["spans"]
    assert spans["zero1.grads"] == pytest.approx([0.1, 0.8])
    assert spans["zero1.all_gather"] == pytest.approx([0.05, 0.1])


@pytest.mark.parametrize("name", [
    "void permute_rows<float, float, true, true>(float const*, float*, int, int, long long)",
    "void pack_ef_rows<true>(float const*, float const*, __nv_bfloat16*, float*, int, int, long long)",
    "void quant_i8_kernel<true>(float const*, signed char*, float*, long long)",
    "void hop_add_quant_i8_kernel<false>(signed char const*, float const*, float const*, "
    "signed char*, float*, long long)",
    "void hop_accum_bf16_kernel<true>(__nv_bfloat16 const*, float const*, float*, long long)"])
def test_the_ring_wire_kernels_are_one_class(name):
    assert kernel_class(name) == "wire kernels (this repo)"


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::wkv6_fwd_wgmma<32>(float const*, float const*, float const*, "
    "float const*, float const*, float*, int, int, int, int)",
    "void (anonymous namespace)::ssd_fwd_wgmma<true>(float const*, float const*, float const*, "
    "float const*, float const*, float const*, float*, unsigned char const*, int, int, int, int, "
    "int)",
    "(anonymous namespace)::ssd_nan_flags(float const*, float const*, float const*, float const*, "
    "unsigned char*, int, int, int, int, int)",
    "void flash_attention_wgmma_kernel<64>(...)"])
def test_the_scan_and_attention_kernels_are_one_class(name):
    """A training step of the ssm and hybrid families (``--num-layers`` cuts
    the depth) shows its scan kernels apart from the library's."""
    assert kernel_class(name) == "scan and attention kernels (this repo)"
