// ZeRO-1 transposed bucket pack/unpack for Hopper (sm_90a).
//
// Replaces the Pallas kernels `pack_transposed`, `pack_transposed_ef` and
// `unpack_transposed` of src/repro/kernels/ring_wire/kernel.py (the
// `_pack_kernel`, `_pack_ef_kernel` and `_unpack_kernel` bodies), which move
// the zero1 flat gradient between the rank-major layout (dp*buckets, seg)
// and the bucket-major wire layout (buckets, dp, seg), casting to the wire
// dtype on the way out:
//
//   pack:    out[b][r][s] = wire(x[r*buckets + b][s])     f32 -> f32 | bf16
//   pack_ef: y = g + e at (r*buckets + b, s); out[b][r][s] = bf16(y);
//            ef'[r*buckets + b][s] = y - f32(bf16(y))    (error feedback)
//   unpack:  out[r*buckets + b][s] = f32(x[b][r][s])      f32 | bf16 -> f32
//
// Bound on this card: bytes.  Every element is read once and written once
// and there is no arithmetic beyond the optional round-to-nearest-even cast,
// so the least time is (bytes in + bytes out) / HBM bandwidth.  The TPU
// kernel holds the whole payload in VMEM with no grid, which caps it at a
// few million elements; here nothing is held on chip, so any size works.
//
// Design: one block row per output row (gridDim.y = dp*buckets, a small
// number), so the row permutation is one integer divide per block and the
// inner loop is pure streaming.  Threads walk their row with a grid stride
// in 16-byte vectors (float4 in, float4 or 4 x bf16 out) when the row
// length is a multiple of 4 and the buffers are aligned, else one element
// at a time.  The launch uses the caller's stream, allocates nothing and
// does not synchronise; each entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 8192;

__device__ __forceinline__ void store4(float* out, long long i, float4 v) {
  *reinterpret_cast<float4*>(out + i) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, long long i, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = packed;
}

__device__ __forceinline__ void store1(float* out, long long i, float v) { out[i] = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 load4(const float* x, long long i) {
  return __ldg(reinterpret_cast<const float4*>(x + i));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* x, long long i) {
  uint2 packed = __ldg(reinterpret_cast<const uint2*>(x + i));
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&packed.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&packed.y);
  float2 a = __bfloat1622float2(lo);
  float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float load1(const float* x, long long i) { return x[i]; }

__device__ __forceinline__ float load1(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

// Copies one source row to one destination row per blockIdx.y, casting.
// `src_row_of` maps the destination row to its source row.
template <typename InT, typename OutT, bool kVec, bool kPack>
__global__ void __launch_bounds__(kThreads)
permute_rows(const InT* __restrict__ x, OutT* __restrict__ out, int dp, int buckets,
             long long seg) {
  const int row = blockIdx.y;
  int src_row;
  if (kPack) {  // row = b*dp + r  <-  r*buckets + b
    const int b = row / dp, r = row - b * dp;
    src_row = r * buckets + b;
  } else {      // row = r*buckets + b  <-  b*dp + r
    const int r = row / buckets, b = row - r * buckets;
    src_row = b * dp + r;
  }
  const InT* src = x + static_cast<long long>(src_row) * seg;
  OutT* dst = out + static_cast<long long>(row) * seg;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    const long long nvec = seg >> 2;
    for (; i < nvec; i += step) store4(dst, i << 2, load4(src, i << 2));
  } else {
    for (; i < seg; i += step) store1(dst, i, load1(src, i));
  }
}

// Error-feedback fold + bf16 wire cast + residual refresh + transposed split
// (replaces `pack_transposed_ef`, the `_pack_ef_kernel` body): per element
//   y = g + e;  w = bf16_rn(y);  ef' = y - f32(w)
// with w stored at the bucket-major row (like `permute_rows` in pack mode)
// and ef' at the source's own rank-major position.  Bytes bound: two f32
// reads, one bf16 and one f32 write per element.  The residual comes from
// the rounded w, so g + e == f32(w) + ef' exactly (Sterbenz: the bf16
// rounding error of an f32 is an f32).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_ef_rows(const float* __restrict__ g, const float* __restrict__ e,
             __nv_bfloat16* __restrict__ out, float* __restrict__ ef_out, int dp,
             int buckets, long long seg) {
  const int row = blockIdx.y;                      // row = b*dp + r
  const int b = row / dp, r = row - b * dp;
  const long long src_off = static_cast<long long>(r * buckets + b) * seg;
  const float* gs = g + src_off;
  const float* es = e + src_off;
  float* efd = ef_out + src_off;
  __nv_bfloat16* dst = out + static_cast<long long>(row) * seg;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    for (; i < (seg >> 2); i += step) {
      const long long k = i << 2;
      const float4 a = load4(gs, k), c = load4(es, k);
      const float4 y = make_float4(__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y),
                                   __fadd_rn(a.z, c.z), __fadd_rn(a.w, c.w));
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y.x, y.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y.z, y.w);
      const float2 wl = __bfloat1622float2(lo), wh = __bfloat1622float2(hi);
      store4(efd, k, make_float4(__fsub_rn(y.x, wl.x), __fsub_rn(y.y, wl.y),
                                 __fsub_rn(y.z, wh.x), __fsub_rn(y.w, wh.y)));
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst + k) = packed;
    }
  } else {
    for (; i < seg; i += step) {
      const float y = __fadd_rn(gs[i], es[i]);
      const __nv_bfloat16 w = __float2bfloat16_rn(y);
      efd[i] = __fsub_rn(y, __bfloat162float(w));
      dst[i] = w;
    }
  }
}

template <typename InT, typename OutT, bool kPack>
int launch(const void* x, void* out, long long dp, long long buckets, long long seg,
           cudaStream_t stream) {
  const long long rows = dp * buckets;
  if (rows <= 0 || seg <= 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const bool vec = (seg % 4 == 0) && (align % 16 == 0);
  const long long work = vec ? seg / 4 : seg;
  long long bx = (work + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(rows));
  const InT* xi = static_cast<const InT*>(x);
  OutT* o = static_cast<OutT*>(out);
  const int idp = static_cast<int>(dp), ib = static_cast<int>(buckets);
  if (vec)
    permute_rows<InT, OutT, true, kPack><<<grid, kThreads, 0, stream>>>(xi, o, idp, ib, seg);
  else
    permute_rows<InT, OutT, false, kPack><<<grid, kThreads, 0, stream>>>(xi, o, idp, ib, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pax_pack_transposed(const void* x, void* out, long long dp, long long buckets,
                                   long long seg, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) return launch<float, __nv_bfloat16, true>(x, out, dp, buckets, seg, s);
  return launch<float, float, true>(x, out, dp, buckets, seg, s);
}

extern "C" int pax_unpack_transposed(const void* x, void* out, long long dp, long long buckets,
                                     long long seg, int in_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch<__nv_bfloat16, float, false>(x, out, dp, buckets, seg, s);
  return launch<float, float, false>(x, out, dp, buckets, seg, s);
}

extern "C" int pax_pack_transposed_ef(const void* g, const void* e, void* out, void* ef_out,
                                      long long dp, long long buckets, long long seg,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = dp * buckets;
  if (rows <= 0 || seg <= 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t align = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(e) |
                          reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(ef_out);
  const bool vec = (seg % 4 == 0) && (align % 16 == 0);
  long long bx = ((vec ? seg / 4 : seg) + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(rows));
  const float* gi = static_cast<const float*>(g);
  const float* ei = static_cast<const float*>(e);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* eo = static_cast<float*>(ef_out);
  const int idp = static_cast<int>(dp), ib = static_cast<int>(buckets);
  if (vec)
    pack_ef_rows<true><<<grid, kThreads, 0, s>>>(gi, ei, o, eo, idp, ib, seg);
  else
    pack_ef_rows<false><<<grid, kThreads, 0, s>>>(gi, ei, o, eo, idp, ib, seg);
  return static_cast<int>(cudaGetLastError());
}
