// WKV6 chunked scan, forward from a zero state, for Hopper (sm_90a), in
// float32 on the CUDA cores.
//
// Replaces the Pallas kernel `wkv6` of src/repro/kernels/rwkv6_scan/kernel.py
// (the `_wkv_kernel` body).  Per (batch, head), with r, k, v and the per-step
// log decays wlog (< 0) of one chunk of c steps as (c, N) tiles and the
// running state S (N, N), the function is the reference's:
//
//   la      = inclusive cumsum of wlog over the chunk's steps (per channel)
//   q~      = r * exp(la - wlog)          k~ = k * exp(-la)
//   y       = tril(q~ k~^T, -1) v + (r . (u * k)) v + q~ S
//   S      <- exp(la_end) * S + (k * exp(la_end - la))^T v
//
// with S = 0 before the first chunk; the output `y` of a chunk reads the
// state from before that chunk's update, and the final state is dropped.
// This is the factorised form of the reference, kept as it is: k~ grows as
// exp(-la), so a chunk whose cumulative log decay falls below about -88
// overflows float32 here exactly as it does there (ROADMAP, open questions).
//
// Layout: the model's, read in place (no transposed copies): r, k, v, wlog
// and y are (B, T, H, N) contiguous float32, u is (H, N).  The rows of one
// (b, h) lie H * N floats apart.
//
// Bound on this card: bytes.  At the main path's shape (rwkv6-7b, B=4,
// T=2048, H=64, N=64, chunk 32) the four inputs and the output are 671 MB
// (0.200 ms at 3.35 TB/s) against 1.29e10 FLOP of the four products per
// chunk (0.026 ms at the TF32 tensor-core rate, 0.19 ms at the 67 TFLOP/s
// CUDA-core rate).  This first kernel is right and simple: its products run
// on the CUDA cores out of shared memory, one scalar FMA per operand pair,
// so shared-memory bandwidth, not HBM, limits it.  Tensor-core products
// (wgmma) with TMA-fed tiles are the work of a later redesign.
//
// Design, one thread block of 256 threads per (b, h):
// * CUDA blocks run in no order, so the TPU's sequential chunk grid axis
//   becomes a loop inside the block, and S (at most 64 x 64 floats) lives in
//   shared memory across it.
// * Every tile row is padded by one float, so the column walks of the
//   products (k~ rows by a warp of s, S rows by a warp of i) hit distinct
//   banks.
// * Per chunk: stage the four tiles (coalesced rows of N floats); one thread
//   per channel runs the cumsum and writes q~ and k~; the strictly lower
//   c x c product and the bonus diagonal; y, whose loop also turns k into
//   k * exp(la_end - la) in place; the state update.  __syncthreads()
//   separates the phases, and the last one guards the next chunk's staging.
//
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the entry point returns the launch's cudaError_t.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;       // head width: the state is N x N
constexpr int kMaxChunk = 64;   // steps per chunk

// Floats of dynamic shared memory for head width n and chunk c.
__host__ __device__ constexpr int smem_floats(int n, int c) {
  return n * (n + 1) + 6 * c * (n + 1) + c * (c + 1) + c + 3 * n;
}

__global__ void __launch_bounds__(kThreads)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, float* __restrict__ y, int T, int H, int N, int C) {
  extern __shared__ float smem[];
  const int ld = N + 1;          // row stride of the (C, N) and (N, N) tiles
  const int lc = C + 1;          // row stride of the (C, C) tile
  float* S = smem;               // [N][ld]  carried state S[i][j]
  float* rs = S + N * ld;        // [C][ld]  r
  float* ks = rs + C * ld;       // [C][ld]  k, then k * exp(la_end - la)
  float* vs = ks + C * ld;       // [C][ld]  v
  float* la = vs + C * ld;       // [C][ld]  wlog, then its inclusive cumsum
  float* qt = la + C * ld;       // [C][ld]  r * exp(la - wlog)
  float* kt = qt + C * ld;       // [C][ld]  k * exp(-la)
  float* att = kt + C * ld;      // [C][lc]  q~ k~^T below the diagonal
  float* diag = att + C * lc;    // [C]      r . (u * k)
  float* us = diag + C;          // [N]      this head's u
  float* lend = us + N;          // [N]      la at the chunk's last step
  float* aend = lend + N;        // [N]      exp(lend)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long row = static_cast<long long>(H) * N;   // from step t to t + 1
  const long long base = static_cast<long long>(b) * T * row + static_cast<long long>(h) * N;

  for (int idx = tid; idx < N * ld; idx += kThreads) S[idx] = 0.f;
  for (int n = tid; n < N; n += kThreads) us[n] = u[h * N + n];

  for (int t0 = 0; t0 < T; t0 += C) {
    // 1. the chunk's rows of r, k, v and wlog
    for (int idx = tid; idx < C * N; idx += kThreads) {
      const int t = idx / N, n = idx - t * N;
      const long long g = base + (t0 + t) * row + n;
      rs[t * ld + n] = r[g];
      ks[t * ld + n] = k[g];
      vs[t * ld + n] = v[g];
      la[t * ld + n] = w[g];
    }
    __syncthreads();
    // 2. per channel: the inclusive cumsum of the log decays and q~, k~
    for (int n = tid; n < N; n += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float wl = la[t * ld + n];
        acc += wl;
        la[t * ld + n] = acc;
        qt[t * ld + n] = rs[t * ld + n] * expf(acc - wl);
        kt[t * ld + n] = ks[t * ld + n] * expf(-acc);
      }
      lend[n] = acc;
      aend[n] = expf(acc);
    }
    __syncthreads();
    // 3. the strictly lower q~ k~^T and the bonus diagonal r . (u * k)
    for (int idx = tid; idx < C * C; idx += kThreads) {
      const int t = idx / C, s = idx - t * C;
      float acc = 0.f;
      if (t > s) {
        for (int n = 0; n < N; ++n) acc += qt[t * ld + n] * kt[s * ld + n];
      }
      att[t * lc + s] = acc;
    }
    for (int t = tid; t < C; t += kThreads) {
      float acc = 0.f;
      for (int n = 0; n < N; ++n) acc += rs[t * ld + n] * (us[n] * ks[t * ld + n]);
      diag[t] = acc;
    }
    __syncthreads();
    // 4. y = att v + diag * v + q~ S (S from before this chunk); k -> k * exp(la_end - la)
    for (int idx = tid; idx < C * N; idx += kThreads) {
      const int t = idx / N, j = idx - t * N;
      float intra = 0.f;
      for (int s = 0; s < t; ++s) intra += att[t * lc + s] * vs[s * ld + j];
      intra += diag[t] * vs[t * ld + j];
      float inter = 0.f;
      for (int i = 0; i < N; ++i) inter += qt[t * ld + i] * S[i * ld + j];
      y[base + (t0 + t) * row + j] = intra + inter;
      ks[t * ld + j] *= expf(lend[j] - la[t * ld + j]);
    }
    __syncthreads();
    // 5. S <- exp(la_end) S + (k * exp(la_end - la))^T v
    for (int idx = tid; idx < N * N; idx += kThreads) {
      const int i = idx / N, j = idx - i * N;
      float acc = 0.f;
      for (int t = 0; t < C; ++t) acc += ks[t * ld + i] * vs[t * ld + j];
      S[i * ld + j] = aend[i] * S[i * ld + j] + acc;
    }
    __syncthreads();
  }
}

}  // namespace

// r, k, v, wlog, y: (b, t, h, n) contiguous float32; u: (h, n).  Returns
// cudaErrorInvalidValue for shapes the kernel does not take (n or chunk
// outside [1, 64], t not a positive multiple of chunk, b * h past the
// grid), else the launch's cudaError_t.
extern "C" int pax_wkv6(const void* r, const void* k, const void* v, const void* wlog,
                        const void* u, void* y, long long b, long long t, long long h,
                        long long n, long long chunk, void* stream) {
  if (b <= 0 || h <= 0 || b * h > 0x7fffffffLL || t <= 0 || t > 0x7fffffffLL || n < 1 ||
      n > kMaxN || chunk < 1 || chunk > kMaxChunk || t % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = static_cast<int>(n), C = static_cast<int>(chunk);
  const int smem = static_cast<int>(smem_floats(N, C) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(wkv6_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_fwd<<<static_cast<unsigned>(b * h), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(wlog), static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<int>(t), static_cast<int>(h), N, C);
  return static_cast<int>(cudaGetLastError());
}
