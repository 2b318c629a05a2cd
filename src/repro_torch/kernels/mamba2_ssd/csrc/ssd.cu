// Mamba2 SSD chunked scan, forward from a zero state, for Hopper (sm_90a),
// in float32 on the CUDA cores.
//
// Replaces the Pallas kernel `ssd` of src/repro/kernels/mamba2_ssd/kernel.py
// (the `_ssd_kernel` body).  Per (batch, head) with decay rate a < 0 and skip
// weight d, one chunk of c steps holds x (c, P), dt (c,), B and C (c, N); the
// running state S is (P, N).  The function is the reference's:
//
//   la      = inclusive cumsum of dt * a over the chunk's steps
//   M[t, s] = (C_t . B_s) * exp(la_t - la_s) * dt_s  for t >= s, else 0
//   y       = M x + (C * exp(la)) S^T + d * x
//   S      <- exp(la_end) * S + x^T (B * exp(la_end - la) * dt)
//
// with S = 0 before the first chunk; the output `y` of a chunk reads the
// state from before that chunk's update, and the final state is dropped.
// exp(la_t - la_s) is formed only where t >= s: above the diagonal the
// exponent is positive and may overflow, and inf * 0 would be NaN where the
// reference's `where` simply drops it.  Every other exponent is <= 0.
//
// Layout: the model's, read in place: x and y are (Bb, T, H, P), dt is
// (Bb, T, H), B and C are (Bb, T, N), shared by the H heads of a batch row
// (Mamba2 with one group), and A, D are (H,); all contiguous float32.  The
// reference's wrapper broadcasts B and C to every head and transposes to
// (Bb*H, T, .); here head bh reads batch row bh / H of B and C directly.
//
// Bound on this card: bytes.  At the main path's shape (zamba2-2.7b, Bb=4,
// T=2048, H=80, P=N=64, chunk 64) x and y are 336 MB, dt 2.6 MB and B, C
// 4.2 MB (0.102 ms at 3.35 TB/s) against 2.15e10 FLOP of the four products
// per chunk (0.043 ms at the TF32 tensor-core rate, 0.32 ms at the
// 67 TFLOP/s CUDA-core rate).  This first kernel is right and simple: its
// products run on the CUDA cores out of shared memory, so shared-memory
// bandwidth, not HBM, limits it; wgmma with TMA-fed tiles is a later
// redesign's work.
//
// Design, one thread block of 256 threads per (b, h):
// * The TPU's sequential chunk grid axis becomes a loop inside the block;
//   S (at most 64 x 64 floats) stays in shared memory across it.
// * Tile rows are padded by one float so the column walks (B rows by a warp
//   of s, S rows by a warp of p) hit distinct banks.
// * Per chunk: stage x, dt, B, C; the cumsum of the log decays and the
//   per-step factors exp(la) and exp(la_end - la) * dt; the masked c x c
//   matrix M; y; the state update, which also folds the factor into B.
//   __syncthreads() separates the phases, the last one guards the next
//   chunk's staging.
//
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the entry point returns the launch's cudaError_t.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 64;       // head width
constexpr int kMaxN = 64;       // state width
constexpr int kMaxChunk = 64;   // steps per chunk

// Floats of dynamic shared memory for head width p, state width n, chunk c.
__host__ __device__ constexpr int smem_floats(int p, int n, int c) {
  return p * (n + 1) + c * (p + 1) + 2 * c * (n + 1) + c * (c + 1) + 4 * c;
}

__global__ void __launch_bounds__(kThreads)
ssd_fwd(const float* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const float* __restrict__ Bm,
        const float* __restrict__ Cm, const float* __restrict__ Dv, float* __restrict__ y,
        int T, int H, int P, int N, int C) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldp = P + 1, lc = C + 1;
  float* S = smem;               // [P][ldn] carried state S[p][n]
  float* xs = S + P * ldn;       // [C][ldp] x
  float* bs = xs + C * ldp;      // [C][ldn] B
  float* cs = bs + C * ldn;      // [C][ldn] C
  float* M = cs + C * ldn;       // [C][lc]  the masked token-mixing matrix
  float* dts = M + C * lc;       // [C]      dt
  float* la = dts + C;           // [C]      inclusive cumsum of dt * a
  float* ela = la + C;           // [C]      exp(la)
  float* kf = ela + C;           // [C]      exp(la_end - la) * dt

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = A[h], d = Dv[h];
  const long long xrow = static_cast<long long>(H) * P;   // x, y: from step t to t + 1
  const long long xbase = static_cast<long long>(b) * T * xrow + static_cast<long long>(h) * P;
  const long long tb = static_cast<long long>(b) * T;     // this batch row's first step

  for (int idx = tid; idx < P * ldn; idx += kThreads) S[idx] = 0.f;

  for (int t0 = 0; t0 < T; t0 += C) {
    // 1. the chunk's x, dt, B and C
    for (int idx = tid; idx < C * P; idx += kThreads) {
      const int t = idx / P, p = idx - t * P;
      xs[t * ldp + p] = x[xbase + (t0 + t) * xrow + p];
    }
    for (int idx = tid; idx < C * N; idx += kThreads) {
      const int t = idx / N, n = idx - t * N;
      const long long g = (tb + t0 + t) * N + n;
      bs[t * ldn + n] = Bm[g];
      cs[t * ldn + n] = Cm[g];
    }
    for (int t = tid; t < C; t += kThreads) dts[t] = dt[(tb + t0 + t) * H + h];
    __syncthreads();
    // 2. the inclusive cumsum of the log decays dt * a
    for (int t = tid; t < C; t += kThreads) {
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += dts[s] * a;
      la[t] = acc;
    }
    __syncthreads();
    const float la_end = la[C - 1];
    for (int t = tid; t < C; t += kThreads) {
      ela[t] = expf(la[t]);
      kf[t] = expf(la_end - la[t]) * dts[t];
    }
    // 3. M = (C B^T) * exp(la_t - la_s) * dt_s on and below the diagonal
    for (int idx = tid; idx < C * C; idx += kThreads) {
      const int t = idx / C, s = idx - t * C;
      float m = 0.f;
      if (t >= s) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb += cs[t * ldn + n] * bs[s * ldn + n];
        m = cb * expf(la[t] - la[s]) * dts[s];
      }
      M[t * lc + s] = m;
    }
    __syncthreads();
    // 4. y = M x + (C * exp(la)) S^T + d * x, with S from before this chunk
    for (int idx = tid; idx < C * P; idx += kThreads) {
      const int t = idx / P, p = idx - t * P;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra += M[t * lc + s] * xs[s * ldp + p];
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter += (cs[t * ldn + n] * ela[t]) * S[p * ldn + n];
      y[xbase + (t0 + t) * xrow + p] = intra + inter + xs[t * ldp + p] * d;
    }
    __syncthreads();
    // 5. S <- exp(la_end) S + x^T (B * exp(la_end - la) * dt)
    const float a_end = expf(la_end);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx - p * N;
      float acc = 0.f;
      for (int t = 0; t < C; ++t) acc += xs[t * ldp + p] * (bs[t * ldn + n] * kf[t]);
      S[p * ldn + n] = a_end * S[p * ldn + n] + acc;
    }
    __syncthreads();
  }
}

}  // namespace

// x, y: (bb, t, h, p); dt: (bb, t, h); B, C: (bb, t, n); A, D: (h,); all
// contiguous float32.  Returns cudaErrorInvalidValue for shapes the kernel
// does not take (p, n or chunk outside [1, 64], t not a positive multiple of
// chunk, bb * h past the grid), else the launch's cudaError_t.
extern "C" int pax_ssd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, void* y, long long bb, long long t,
                       long long h, long long p, long long n, long long chunk, void* stream) {
  if (bb <= 0 || h <= 0 || bb * h > 0x7fffffffLL || t <= 0 || t > 0x7fffffffLL || p < 1 ||
      p > kMaxP || n < 1 || n > kMaxN || chunk < 1 || chunk > kMaxChunk || t % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int P = static_cast<int>(p), N = static_cast<int>(n), Ch = static_cast<int>(chunk);
  const int smem = static_cast<int>(smem_floats(P, N, Ch) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd<<<static_cast<unsigned>(bb * h), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<int>(t), static_cast<int>(h), P, N, Ch);
  return static_cast<int>(cudaGetLastError());
}
