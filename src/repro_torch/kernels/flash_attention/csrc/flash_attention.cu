// Flash attention, forward, for Hopper (sm_90a): grouped-query attention with
// an online softmax, causal or not, in float32 on the CUDA cores, for float32
// inputs.  (bf16 inputs run on the tensor cores: flash_attention_wgmma.cu.)
//
// Replaces, for f32 inputs, the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py (the `_attn_kernel` body).  In
// the kernel's layout, q (BH, S, D) and k/v (BKV, S, D), with query head bh
// reading kv row bh / (BH / BKV):
//
//   o[bh, i] = sum_j softmax_j(scale * q[bh, i] . k[kv, j]) v[kv, j],
//   scale = f32(1 / sqrt(D)), keys j > i masked to -1e30 under `causal`,
//
// computed as the TPU kernel computes it: a running max m (from -1e30), a
// running denominator l and an f32 accumulator rescaled by exp(m_old - m_new)
// at every kv tile, and o = acc / max(l, 1e-30) cast to the output dtype.
// The arithmetic is f32, as the reference's `.astype(jnp.float32)`.
//
// Bound on this card: operations.  At the main path's shape (qwen2-0.5b,
// B=4, S=2048, 14/2 heads, D=64) the causal work is 4*B*H*D*S(S+1)/2 = 3.0e10
// FLOP against 67 MB of f32 q, k, v and o.  The products stay on the CUDA
// cores in f32 (67 TFLOP/s, so no faster than about 0.45 ms), by decision:
// TF32 products would break the f32 tolerance of 2e-5, and a product split
// into three bf16 terms is a design of its own.
//
// Design, one thread block per (bh, 64-query tile), 256 threads:
// * The grid runs in parallel and in no order, so the TPU's sequential kv
//   grid axis becomes a loop inside the block, and m, l and the accumulator
//   live in registers across it.
// * q and each 64-key tile of k are staged transposed in shared memory
//   ([D][64] floats), so each thread reads four query rows and four keys as
//   one float4 each per step of d and accumulates a 4 x 4 block of scores;
//   the v tile stays row-major and p goes through shared memory transposed,
//   so the p.v product is again float4 reads and 16 FMAs per step.
// * A row's 16 threads share its max and sum through __shfl_xor_sync.
// * kv tiles strictly above the diagonal are skipped under `causal`, and the
//   query tiles are scheduled longest first.
// * A ragged S is masked in the kernel (keys at or past S get p = 0, query
//   rows past S are not stored): no padded copies, so a non-causal call never
//   lets padding into the softmax.
// * Any D that is a multiple of 8 up to 256; the output columns a thread
//   holds are 64*g + 4*tx + [0, 4) for g < G = ceil(D / 64).
//
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the entry point returns the launch's cudaError_t.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per kv tile (== kBQ: one staging routine)
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 block of scores each
constexpr int kPS = kBQ + 4;    // row stride of the transposed p tile (16-byte rows)
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

// Rows [row0, row0 + 64) of an (S, D) matrix into dst[d * 64 + r], zero past S.
__device__ __forceinline__ void stage_transposed(float* dst, const float* src, int row0, int S,
                                                 int D) {
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx % kBQ, d = idx / kBQ;
    const int row = row0 + r;
    dst[idx] = row < S ? src[static_cast<long long>(row) * D + d] : 0.f;
  }
}

// Rows [row0, row0 + 64) of an (S, D) matrix into dst[r * D + d], zero past S.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int row0, int S, int D) {
  const float* base = src + static_cast<long long>(row0) * D;
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    dst[idx] = row0 + idx / D < S ? base[idx] : 0.f;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int S, int D, int group, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [D][kBQ]  q tile, transposed
  float* kt = qt + D * kBQ;       // [D][kBK]  k tile, transposed
  float* vs = kt + D * kBK;       // [kBK][D]  v tile
  float* pt = vs + kBK * D;       // [kBK][kPS] p tile, transposed

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBQ;  // longest rows first
  const int bh = blockIdx.x;
  const long long head = static_cast<long long>(S) * D;
  const float* kh = k + (bh / group) * head;
  const float* vh = v + (bh / group) * head;
  const int tx = threadIdx.x & 15;  // score columns 4*tx + j, output columns 64*g + 4*tx + j
  const int ty = threadIdx.x >> 4;  // rows 4*ty + i

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  stage_transposed(qt, q + bh * head, q0, S, D);
  int nk = (S + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);  // skip tiles above the diagonal
  for (int tile = 0; tile < nk; ++tile) {
    const int k0 = tile * kBK;
    stage_transposed(kt, kh, k0, S, D);
    stage_rows(vs, vh, k0, S, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kBQ + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kBK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        const bool valid = kpos < S && (!causal || qpos >= kpos);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        const bool valid = kpos < S && (!causal || qpos >= kpos);
        s[i][j] = valid ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kPS + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + kk * kPS + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = 64 * g + 4 * tx;
        if (col < D) {
          const float4 w = *reinterpret_cast<const float4*>(vs + kk * D + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * g + 0] = fmaf(pv[i], w.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(pv[i], w.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(pv[i], w.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(pv[i], w.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites kt, vs and pt
  }

  float* oh = o + bh * head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = 64 * g + 4 * tx;
      if (col < D) {
#pragma unroll
        for (int j = 0; j < 4; ++j) oh[static_cast<long long>(qpos) * D + col + j] =
            acc[i][4 * g + j] / denom;
      }
    }
  }
}

template <int G>
int launch(const void* q, const void* k, const void* v, void* o, long long bh, int S, int D,
           int group, int causal, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>((3 * D * kBQ + kBK * kPS) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_fwd<G><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, D, group, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (bh, s, d), k/v (bkv, s, d), o (bh, s, d), all contiguous f32.  Returns
// cudaErrorInvalidValue for shapes the kernel does not take, else the
// launch's cudaError_t.
extern "C" int pax_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   long long bh, long long bkv, long long s, long long d,
                                   int causal, void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv != 0 || bh > 0x7fffffffLL || s <= 0 ||
      (s + kBQ - 1) / kBQ > 65535 || d < 8 || d > kMaxD || d % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const int group = static_cast<int>(bh / bkv);
  const int S = static_cast<int>(s), D = static_cast<int>(d);
  if (D <= 64) return launch<1>(q, k, v, o, bh, S, D, group, causal, scale, st);
  if (D <= 128) return launch<2>(q, k, v, o, bh, S, D, group, causal, scale, st);
  if (D <= 192) return launch<3>(q, k, v, o, bh, S, D, group, causal, scale, st);
  return launch<4>(q, k, v, o, bh, S, D, group, causal, scale, st);
}
