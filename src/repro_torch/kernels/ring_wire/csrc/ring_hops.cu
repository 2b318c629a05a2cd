// Compressed ring-hop kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels of src/repro/kernels/ring_wire/kernel.py that
// carry one hop of the ring reduce-scatter on a compressed wire:
//
//   quant_i8            (`_quant_i8_kernel`)          x -> (q, s)
//   hop_add_quant_i8    (`_hop_add_quant_i8_kernel`)  (q, s, a) -> quant(q*s + a)
//   hop_accum_i8        (`_hop_accum_i8_kernel`)      (q, s, a) -> q*s + a
//   hop_add_quant_bf16  (`_hop_add_quant_bf16_kernel`) (w, a) -> bf16(f32(w) + a)
//   hop_accum_bf16      (`_hop_accum_bf16_kernel`)    (w, a) -> f32(w) + a
//
// Every payload is a (nb, 128) view: the wire block of 128 elements is the
// int8 quantization granule, with one f32 scale per block,
//   s = max(absmax(block), 1e-30) * f32(1/127),  q = clip(rint(x / s), +-127).
//
// Bound on this card: bytes.  Each kernel is one pass: every input element
// is read once and every output written once, with a few flops each.
//
// Design: one warp per wire block, four elements per lane, so the absmax
// is a register max and a five-step __shfl_xor_sync butterfly; a block of
// 256 threads carries 8 wire blocks and the grid strides over the rest.
// When every buffer is 16-byte aligned a lane loads its four elements as
// one vector (float4, 4 x int8, 4 x bf16); otherwise a lane takes elements
// lane + 32j, one at a time.  The arithmetic is written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn) so the
// compiler cannot contract q*s + a into an FMA or replace the divide by a
// reciprocal: the result equals the plain PyTorch version bit for bit.
// rintf rounds half to even, as torch.round and jnp.round do.  Launches use
// the caller's stream, allocate nothing and do not synchronise; each entry
// point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kBlock = 128;                 // wire block (WIRE_BLOCK)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;       // wire blocks per CUDA block
constexpr long long kMaxGrid = 132 * 64;
constexpr float kInv127 = 1.0f / 127.0f;    // f32(1) / f32(127), rounded once
constexpr float kQEps = 1e-30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// -- one lane's four elements of a wire block ------------------------------
template <bool kVec>
__device__ __forceinline__ void load(const float* p, int lane, float v[4]) {
  if (kVec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + lane);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(p + lane + 32 * j);
  }
}

template <bool kVec>
__device__ __forceinline__ void load(const int8_t* p, int lane, float v[4]) {
  if (kVec) {
    const char4 t = *reinterpret_cast<const char4*>(p + lane * 4);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = p[lane + 32 * j];
  }
}

template <bool kVec>
__device__ __forceinline__ void load(const __nv_bfloat16* p, int lane, float v[4]) {
  if (kVec) {
    const uint2 t = *reinterpret_cast<const uint2*>(p + lane * 4);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(p[lane + 32 * j]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store(float* p, int lane, const float v[4]) {
  if (kVec) {
    reinterpret_cast<float4*>(p)[lane] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[lane + 32 * j] = v[j];
  }
}

template <bool kVec>
__device__ __forceinline__ void store(int8_t* p, int lane, const int8_t q[4]) {
  if (kVec) {
    *reinterpret_cast<char4*>(p + lane * 4) = make_char4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[lane + 32 * j] = q[j];
  }
}

template <bool kVec>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, int lane, const float v[4]) {
  if (kVec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const uint32_t*>(&lo);
    t.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p + lane * 4) = t;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[lane + 32 * j] = __float2bfloat16_rn(v[j]);
  }
}

// The block's int8 scale (every lane gets it) and this lane's codes.
__device__ __forceinline__ float quant4(const float y[4], int8_t q[4]) {
  float m = fmaxf(fmaxf(fabsf(y[0]), fabsf(y[1])), fmaxf(fabsf(y[2]), fabsf(y[3])));
  m = warp_max(m);
  const float s = __fmul_rn(fmaxf(m, kQEps), kInv127);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(y[j], s)), -127.0f), 127.0f);
    q[j] = static_cast<int8_t>(static_cast<int>(r));
  }
  return s;
}

// q*s + a with two roundings (no FMA), the plain version's arithmetic
__device__ __forceinline__ void dequant_add(const float qf[4], float s, const float a[4],
                                            float y[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = __fadd_rn(__fmul_rn(qf[j], s), a[j]);
}

#define PAX_WIRE_LOOP                                                       \
  const int lane = threadIdx.x & 31;                                        \
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;      \
  for (long long blk = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); \
       blk < nb; blk += stride)

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
quant_i8_kernel(const float* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                long long nb) {
  PAX_WIRE_LOOP {
    const long long off = blk * kBlock;
    float y[4];
    int8_t c[4];
    load<kVec>(x + off, lane, y);
    const float sc = quant4(y, c);
    store<kVec>(q + off, lane, c);
    if (lane == 0) s[blk] = sc;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hop_add_quant_i8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                        const float* __restrict__ a, int8_t* __restrict__ q2,
                        float* __restrict__ s2, long long nb) {
  PAX_WIRE_LOOP {
    const long long off = blk * kBlock;
    float qf[4], af[4], y[4];
    int8_t c[4];
    load<kVec>(q + off, lane, qf);
    load<kVec>(a + off, lane, af);
    dequant_add(qf, __ldg(s + blk), af, y);
    const float sc = quant4(y, c);
    store<kVec>(q2 + off, lane, c);
    if (lane == 0) s2[blk] = sc;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hop_accum_i8_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                    const float* __restrict__ a, float* __restrict__ o, long long nb) {
  PAX_WIRE_LOOP {
    const long long off = blk * kBlock;
    float qf[4], af[4], y[4];
    load<kVec>(q + off, lane, qf);
    load<kVec>(a + off, lane, af);
    dequant_add(qf, __ldg(s + blk), af, y);
    store<kVec>(o + off, lane, y);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hop_add_quant_bf16_kernel(const __nv_bfloat16* __restrict__ w, const float* __restrict__ a,
                          __nv_bfloat16* __restrict__ w2, long long nb) {
  PAX_WIRE_LOOP {
    const long long off = blk * kBlock;
    float wf[4], af[4], y[4];
    load<kVec>(w + off, lane, wf);
    load<kVec>(a + off, lane, af);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fadd_rn(wf[j], af[j]);
    store_bf16<kVec>(w2 + off, lane, y);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hop_accum_bf16_kernel(const __nv_bfloat16* __restrict__ w, const float* __restrict__ a,
                      float* __restrict__ o, long long nb) {
  PAX_WIRE_LOOP {
    const long long off = blk * kBlock;
    float wf[4], af[4], y[4];
    load<kVec>(w + off, lane, wf);
    load<kVec>(a + off, lane, af);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = __fadd_rn(wf[j], af[j]);
    store<kVec>(o + off, lane, y);
  }
}

#undef PAX_WIRE_LOOP

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16 == 0;
}

// Launch the vector or the scalar instance over nb wire blocks.
template <typename... Params, typename... Args>
int launch(void (*vec_kernel)(Params...), void (*scalar_kernel)(Params...), bool vec,
           long long nb, void* stream, Args... args) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  long long grid = (nb + kWarps - 1) / kWarps;
  if (grid > kMaxGrid) grid = kMaxGrid;
  void (*kernel)(Params...) = vec ? vec_kernel : scalar_kernel;
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pax_quant_i8(const void* x, void* q, void* s, long long nb, void* stream) {
  return launch(quant_i8_kernel<true>, quant_i8_kernel<false>, aligned16({x, q}), nb, stream,
                static_cast<const float*>(x), static_cast<int8_t*>(q),
                static_cast<float*>(s), nb);
}

extern "C" int pax_hop_add_quant_i8(const void* q, const void* s, const void* a, void* q2,
                                    void* s2, long long nb, void* stream) {
  return launch(hop_add_quant_i8_kernel<true>, hop_add_quant_i8_kernel<false>,
                aligned16({q, a, q2}), nb, stream, static_cast<const int8_t*>(q),
                static_cast<const float*>(s), static_cast<const float*>(a),
                static_cast<int8_t*>(q2), static_cast<float*>(s2), nb);
}

extern "C" int pax_hop_accum_i8(const void* q, const void* s, const void* a, void* o,
                                long long nb, void* stream) {
  return launch(hop_accum_i8_kernel<true>, hop_accum_i8_kernel<false>, aligned16({q, a, o}),
                nb, stream, static_cast<const int8_t*>(q), static_cast<const float*>(s),
                static_cast<const float*>(a), static_cast<float*>(o), nb);
}

extern "C" int pax_hop_add_quant_bf16(const void* w, const void* a, void* w2, long long nb,
                                      void* stream) {
  return launch(hop_add_quant_bf16_kernel<true>, hop_add_quant_bf16_kernel<false>,
                aligned16({w, a, w2}), nb, stream, static_cast<const __nv_bfloat16*>(w),
                static_cast<const float*>(a), static_cast<__nv_bfloat16*>(w2), nb);
}

extern "C" int pax_hop_accum_bf16(const void* w, const void* a, void* o, long long nb,
                                  void* stream) {
  return launch(hop_accum_bf16_kernel<true>, hop_accum_bf16_kernel<false>,
                aligned16({w, a, o}), nb, stream, static_cast<const __nv_bfloat16*>(w),
                static_cast<const float*>(a), static_cast<float*>(o), nb);
}
