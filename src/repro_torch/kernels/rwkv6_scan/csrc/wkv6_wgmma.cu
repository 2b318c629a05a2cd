// WKV6 chunked scan, forward from a zero state, for Hopper (sm_90a): the four
// products of every chunk on the tensor cores, as 3xTF32 wgmma, with the next
// chunk's loads in flight while this chunk computes.
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
// overflows float32 here as it does there (ROADMAP, open questions): the
// outputs that are not finite in the plain form are not finite here either
// (NaN where the plain form may hold inf), because the TF32 split keeps a
// non-finite value non-finite (kernels/csrc/tf32_wgmma.cuh) when A, whose
// entries there are inf or NaN, is split for the last product.  The mask is
// a select: above the diagonal whatever q~ k~^T gave, inf or NaN, is dropped
// as the reference's `where` drops it.
//
// Layout: the model's, read in place (no transposed copies): r, k, v, wlog
// and y are (B, T, H, N) contiguous float32 at any 4-byte aligned base, u is
// (H, N).  The rows of one (b, h) lie H * N floats apart.
//
// Bound on this card: bytes.  At the main path's shape (rwkv6-7b, B=4,
// T=2048, H=64, N=64, chunk 32) the four inputs and the output are 671 MB,
// 0.200 ms at 3.35 TB/s.  The four products are 1.29e10 FLOP; as 3xTF32 the
// tensor cores do 3.87e10, 0.078 ms at the 495 TFLOP/s dense TF32 rate.
//
// Why 3xTF32.  wgmma takes TF32 operands (10 stored mantissa bits).  One TF32
// rounding of the operands leaves the gate of 3e-4 against the plain chunked
// form (an emulation on the CPU at B=1, T=256, H=4, N=64, chunk 32: 3.8e-2 and
// 4.1e-2 off it on the sweep's and the models' inputs); each operand as
// hi = tf32(a) plus lo = tf32(a - hi), three products hi.hi + hi.lo + lo.hi
// into one f32 accumulator, stays inside it (2.7e-5; tests/test_torch_wkv6.py
// holds both emulations to the gate).  The cumsum, the exponentials, the
// bonus diagonal d_t = r_t . (u * k_t), the exp(la_end) scaling and the
// state's update stay f32 on the CUDA cores; the state product goes to a
// fresh accumulator each chunk and is added to exp(la_end) S in f32.
//
// Closeness to float64.  Two choices keep the kernel as close to the plain
// form run in f64 as the plain form in f32 is (chip_smoke.py holds it within
// twice at rwkv6-7b's shape, chunk 32; the 64-step tiles of chunks 33 to 64,
// with no registers for the second accumulators below, are only logged
// against f64, at chunk 64): q~'s exponent la - wlog is taken as the step
// before's la, the very value k~ of that step was scaled with, so the
// dominant q~_t k~_{t-1} term loses nothing to the cumsum's rounding at
// large |la|; and, at 32-step tiles, the hi.lo and lo.hi terms of A and Y^T
// go to accumulators of their own, summed in f32, since every wgmma into a
// large accumulator moves it further from f64 (both measured on the card at
// rwkv6-7b's shape: PERF.md).
//
// Design, one block of one warpgroup (128 threads) per (b, h):
// * The TPU's sequential chunk grid axis becomes a loop inside the block.  The
//   state is kept transposed, S^T (j, i), in registers (64 x 64 f32 over 128
//   threads: 32 a thread), and the chunk's products are, with M the chunk's
//   rows padded to a tile of CT = 32 steps (64 for chunks of 33 to 64):
//     A   = q~ k~^T                (t, s)  SS, K = i, m64nCT: the CT rows of q~
//                                          read as wgmma's 64 (rows past CT
//                                          give output rows that are dropped)
//     Y^T = S^T q~^T               (j, t)  RS: S^T's accumulator fragments are
//                                          the A registers, K = i, m64nCT
//     Y^T += v^T (M)^T             (j, t)  SS, K = s, m64nCT, where M is A
//                                          masked strictly below the diagonal
//                                          with d on it
//     S^T <- S^T diag(exp(la_end)) + v^T kk   (j, i)  SS, K = t, m64n64k8,
//                                          kk = k * exp(la_end - la)
// * tf32 wgmma takes both operands K-major, in the no-swizzle layout of
//   kernels/csrc/tf32_wgmma.cuh.  q~ and k~ (t, i) and M (t, s) are stored as
//   they come; v and kk arrive t-major and are transposed by the threads that
//   split them, and one v^T tile serves two products.
// * The accumulator fragment of an f32 wgmma holds columns 2q and 2q + 1 of
//   each 8-column group (q = lane % 4), the TF32 A register fragment columns
//   q and q + 4.  So S^T goes to the RS product with K permuted within each
//   8-group: hardware k = q carries i = 2q, k = q + 4 carries i = 2q + 1, and
//   q~ and k~ are stored with that order of i (i~), which leaves q~ k~^T as it
//   is.  kk and exp(la_end) index S^T's columns in their natural order, as
//   the state product's accumulator holds them.
// * Loads.  The chunk's rows of r, k, v and wlog land in a staging area by
//   cp.async (16 bytes a copy when N = 64, chunk = 32 and the bases are
//   16-byte aligned, else 4 bytes an element), issued as soon as the chunk
//   before has been read out of it, so they are in flight during that chunk's
//   products; the chunk after is prefetched into L2 at the same time.  Rows
//   are 68 floats apart, so the 16-byte reads of a quarter-warp hit distinct
//   banks.  Padding (steps past the chunk, channels past N) is zero and stays
//   zero: zero log decays carry la_end to the padded rows, and zero r, k, v
//   give zero tile entries.
// * Per chunk: (A) lane = step, warp = 16 channels: the cumsum as a warp
//   shuffle scan (chunk 32 is the warp width), q~ and k~ split to their tiles,
//   kk in place of k in the staging area, the bonus partial sums; (B) lane =
//   channel: v^T and kk^T split to their tiles; then the next chunk's loads,
//   and the products as three wgmma batches in flight together (A, the state
//   product, S^T q~^T), then M from A and the last product.  ptxas injects a
//   warpgroup.arrive (note C7519) before some wgmma batches whose registers it
//   cannot prove idle; it is not an error.
// * N = 64 with chunk 32 (rwkv6-7b) is a compile-time case of the same code
//   (kFull), free of bounds tests.  Other N and chunks go through zero-padded
//   tiles, issuing only the k8 steps that hold data.
// * Shared memory at CT = 32: five hi/lo tile pairs (q~, k~, v^T, kk^T, M;
//   72 KB) and the staging area (34 KB): two blocks an SM.  At CT = 64 M
//   takes k~'s place once A is done, and one block fits an SM.
//
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the entry point returns the launch's cudaError_t.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

using namespace pax_tf32;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kMax = 64;        // N and chunk
constexpr int kLd = 68;         // staging row stride in floats

// Dynamic shared memory of the kernel at chunk tile CT, in bytes from its base.
template <int CT>
struct Smem {
  static constexpr int kRowTile = CT * kMax * 4;   // q~, k~: CT rows (t), K = i~
  static constexpr int kColTile = kMax * CT * 4;   // v^T, kk^T: 64 rows (j, i), K = t
  static constexpr int kMTile = CT * CT * 4;       // M: CT rows (t), K = s
  static constexpr bool kMAlias = CT == 64;        // M in k~'s place
  static constexpr int kQ = 0;                     // hi, then lo; the 64-row reads of
  static constexpr int kK = kQ + 2 * kRowTile;     // q~ past its CT rows stay inside
  static constexpr int kV = kK + 2 * kRowTile;
  static constexpr int kKK = kV + 2 * kColTile;
  static constexpr int kM = kMAlias ? kK : kKK + 2 * kColTile;
  static constexpr int kStg = kKK + 2 * kColTile + (kMAlias ? 0 : 2 * kMTile);
  static constexpr int kVec = kStg + 4 * CT * kLd * 4;   // r, k (then kk), v, wlog
  static constexpr int kBytes = kVec + (2 * kMax + 4 * CT) * 4;  // u, exp(la_end), d parts
};

// Eight floats of a staging row (16-byte aligned) into registers.
__device__ __forceinline__ void get8(float* d, const float* s) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  d[0] = a.x;
  d[1] = a.y;
  d[2] = a.z;
  d[3] = a.w;
  d[4] = b.x;
  d[5] = b.y;
  d[6] = b.z;
  d[7] = b.w;
}

// kFull: N = 64, chunk 32 and 16-byte aligned inputs (rwkv6-7b), known at
// compile time, so no load, store or mask carries a bounds test.
template <bool kFull, int CT>
__global__ void __launch_bounds__(kThreads, CT == 32 ? 2 : 1)
wkv6_fwd_wgmma(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, float* __restrict__ y, int T, int H, int N_,
               int C_) {
  using L = Smem<CT>;
  constexpr int R = CT / 32;    // steps a lane holds in phase A: lane, lane + 32
  constexpr int NA = CT / 2;    // accumulator floats a thread of an m64nCT product
  constexpr bool kSplit = CT == 32;   // A's and Y^T's correction terms apart (below)
  const int N = kFull ? kMax : N_, C = kFull ? 32 : C_;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* q_t = smem + L::kQ;
  uint8_t* k_t = smem + L::kK;
  uint8_t* v_t = smem + L::kV;
  uint8_t* kk_t = smem + L::kKK;
  uint8_t* m_t = smem + L::kM;
  float* stg = reinterpret_cast<float*>(smem + L::kStg);   // [4][CT][kLd]
  float* us = reinterpret_cast<float*>(smem + L::kVec);    // [64] this head's u
  float* aend = us + kMax;                                 // [64] exp(la_end)
  float* dpart = aend + kMax;                              // [4][CT] r . (u * k) by warp
  const uint32_t q_addr = smem_u32(q_t), k_addr = smem_u32(k_t), v_addr = smem_u32(v_t);
  const uint32_t kk_addr = smem_u32(kk_t), m_addr = smem_u32(m_t);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int row = H * N;                                   // from step t to t + 1
  const long long base = static_cast<long long>(b) * T * row + static_cast<long long>(h) * N;
  const float* const src[4] = {r, k, v, w};
  const int kN = (N + 7) / 8, kC = (C + 7) / 8;            // k8 steps over i and over t
  const int r0 = 16 * warp + lane / 4;                     // fragment rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);                           // fragment columns 8 j + c0 + {0, 1}

  // The chunk at t0 into the staging area (its valid rows and channels only)
  auto load_chunk = [&](int t0) {
    if constexpr (kFull) {
#pragma unroll
      for (int m = 0; m < 16; ++m) {   // 4 tensors x 32 rows x 16 boxes of 16 bytes
        const int x = m / 4, t = 8 * (m % 4) + tid / 16, col = 4 * (tid % 16);
        cp_async16(stg + (x * CT + t) * kLd + col,
                   src[x] + base + static_cast<long long>(t0 + t) * row + col);
      }
      if (t0 + C < T) {   // the chunk after into L2
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* p = tid < 64 ? src[2 * m] : src[2 * m + 1];
          const int t = (tid / 2) % 32;
          prefetch_l2(p + base + static_cast<long long>(t0 + C + t) * row + 32 * (tid % 2));
        }
      }
    } else {
      for (int idx = tid; idx < C * N; idx += kThreads) {
        const int t = idx / N, n = idx - t * N;
        const long long g = base + static_cast<long long>(t0 + t) * row + n;
#pragma unroll
        for (int x = 0; x < 4; ++x) cp_async4(stg + (x * CT + t) * kLd + n, src[x] + g);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < 4 * CT * kLd; i += kThreads) stg[i] = 0.f;
  for (int n = tid; n < kMax; n += kThreads) {
    us[n] = n < N ? u[h * N + n] : 0.f;
    aend[n] = 0.f;
  }
  __syncthreads();   // the zeros are down before any copy lands
  load_chunk(0);

  float S[32];       // S^T (j, i) as an m64n64 accumulator
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += C) {
    cp_async_wait_all();
    __syncthreads();   // the chunk's rows are in; the last chunk's products are done

    // A. Lane = step t (and t + 32 at CT = 64), warp = channels 16 warp + [0, 16)
    // in two passes of 8 (n0 = 8 g): la by a warp scan, q~ and k~ to their
    // tiles in the order i~ (channels n0 + 0, 2, 4, 6 at columns n0 .. n0 + 3,
    // the odd ones at n0 + 4 .. n0 + 7), kk in place of k, exp(la_end), and
    // the bonus partial sums.
    float dsum[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) dsum[rr] = 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n0 = 16 * warp + 8 * p;
      if (!kFull && n0 >= N) continue;
      float rv[R][8], kv[R][8], la[R][8];   // la: wlog, then its inclusive cumsum
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int t = lane + 32 * rr;
        get8(rv[rr], stg + t * kLd + n0);
        get8(kv[rr], stg + (CT + t) * kLd + n0);
        get8(la[rr], stg + (3 * CT + t) * kLd + n0);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float x = __shfl_up_sync(0xffffffffu, la[rr][c], o);
            if (lane >= o) la[rr][c] += x;
          }
        }
      }
      if constexpr (R == 2) {
#pragma unroll
        for (int c = 0; c < 8; ++c) la[1][c] += __shfl_sync(0xffffffffu, la[0][c], 31);
      }
      // la_prev = la - wlog, taken as the step before's la (0 before the first),
      // so that q~_t k~_{t-1} = r_t k_{t-1} to the rounding of two exponentials
      // (la_t - wlog_t in f32 is that value only to a few ulps of |la|, which
      // grows along the chunk)
      float lp[R][8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float carry = __shfl_sync(0xffffffffu, la[0][c], 31);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const float up = __shfl_up_sync(0xffffffffu, la[rr][c], 1);
          lp[rr][c] = lane > 0 ? up : rr == 0 ? 0.f : carry;
        }
      }
      float lend[8];   // la at the tile's last step: the chunk's last, the padding adds 0
#pragma unroll
      for (int c = 0; c < 8; ++c) lend[c] = __shfl_sync(0xffffffffu, la[R - 1][c], 31);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int t = lane + 32 * rr;
        float q[8], kt[8], kk[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          q[c] = rv[rr][c] * expf(lp[rr][c]);
          kt[c] = kv[rr][c] * expf(-la[rr][c]);
          kk[c] = kv[rr][c] * expf(lend[c] - la[rr][c]);
          dsum[rr] += rv[rr][c] * (us[n0 + c] * kv[rr][c]);
        }
        put_split4<L::kRowTile>(q_t, tile_off<CT>(t, n0), q[0], q[2], q[4], q[6]);
        put_split4<L::kRowTile>(q_t, tile_off<CT>(t, n0 + 4), q[1], q[3], q[5], q[7]);
        put_split4<L::kRowTile>(k_t, tile_off<CT>(t, n0), kt[0], kt[2], kt[4], kt[6]);
        put_split4<L::kRowTile>(k_t, tile_off<CT>(t, n0 + 4), kt[1], kt[3], kt[5], kt[7]);
        *reinterpret_cast<float4*>(stg + (CT + t) * kLd + n0) =
            make_float4(kk[0], kk[1], kk[2], kk[3]);
        *reinterpret_cast<float4*>(stg + (CT + t) * kLd + n0 + 4) =
            make_float4(kk[4], kk[5], kk[6], kk[7]);
      }
      if (lane == 31) {
#pragma unroll
        for (int c = 0; c < 8; ++c) aend[n0 + c] = expf(lend[c]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) dpart[warp * CT + lane + 32 * rr] = dsum[rr];
    __syncthreads();

    // B. Lane = channel n, CT / 2 steps a thread: v^T (j, t) and kk^T (i, t),
    // a column box of 4 steps a store (conflict-free reads and stores)
    {
      const int n = tid % kMax, tb = (tid / kMax) * (CT / 2);
#pragma unroll
      for (int t4 = 0; t4 < CT / 8; ++t4) {
        const int t = tb + 4 * t4;
        float vv[4], kq[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          vv[e] = stg[(2 * CT + t + e) * kLd + n];
          kq[e] = stg[(CT + t + e) * kLd + n];
        }
        put_split4<L::kColTile>(v_t, tile_off<kMax>(n, t), vv[0], vv[1], vv[2], vv[3]);
        put_split4<L::kColTile>(kk_t, tile_off<kMax>(n, t), kq[0], kq[1], kq[2], kq[3]);
      }
    }
    fence_async_smem();
    __syncthreads();   // every tile is down and the staging area is free

    if (t0 + C < T) load_chunk(t0 + C);

    // C. A = q~ k~^T, the state product v^T kk and Y^T = S^T q~^T, in flight
    // together; S^T's A fragments: k8 step kk holds i = 8 kk + 2q at hardware
    // k q and i = 8 kk + 2q + 1 at k q + 4, rows r0 and r0 + 8.
    uint32_t s_hi[32], s_lo[32];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split_tf32(S[4 * kk + 0], s_hi[4 * kk + 0], s_lo[4 * kk + 0]);  // (r0, 2q)
      split_tf32(S[4 * kk + 2], s_hi[4 * kk + 1], s_lo[4 * kk + 1]);  // (r0 + 8, 2q)
      split_tf32(S[4 * kk + 1], s_hi[4 * kk + 2], s_lo[4 * kk + 2]);  // (r0, 2q + 1)
      split_tf32(S[4 * kk + 3], s_hi[4 * kk + 3], s_lo[4 * kk + 3]);  // (r0 + 8, 2q + 1)
    }
    // At CT = 32 the hi.lo and lo.hi terms of A and Y^T go to accumulators of
    // their own (cor_*), added in f32 once the products are done (the tensor
    // cores' f32 sums drift from f64 with every wgmma into a large one); at
    // CT = 64 the registers are not there and each product has one.
    float acc_a[NA], acc_y[NA], acc_s[32], cor_a[NA], cor_y[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc_a[i] = acc_y[i] = cor_a[i] = cor_y[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_s[i] = 0.f;
    fence_regs<32>(s_hi);
    fence_regs<32>(s_lo);
    fence_regs<NA>(acc_a);
    fence_regs<NA>(acc_y);
    fence_regs<32>(acc_s);
    if constexpr (kSplit) {
      fence_regs<NA>(cor_a);
      fence_regs<NA>(cor_y);
    }
    wgmma_fence();
    if constexpr (kSplit) {
      mma_ss_3x_split<CT, CT, L::kRowTile, CT, L::kRowTile, kMax / 8>(acc_a, cor_a, q_addr,
                                                                       k_addr, kN, 0);
    } else {
      mma_ss_3x<CT, CT, L::kRowTile, CT, L::kRowTile, kMax / 8>(acc_a, q_addr, k_addr, kN, 0);
    }
    wgmma_commit();
    mma_ss_3x<kMax, kMax, L::kColTile, kMax, L::kColTile, CT / 8>(acc_s, v_addr, kk_addr, kC, 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kMax / 8; ++kk) {
      if (kk < kN) {
        const uint64_t bh = tile_desc<CT>(q_addr, kk);
        const uint64_t bl = tile_desc<CT>(q_addr + L::kRowTile, kk);
        float* cy = kSplit ? cor_y : acc_y;
        mma_rs<CT>(cy, s_hi + 4 * kk, bl, kk > 0);
        mma_rs<CT>(cy, s_lo + 4 * kk, bh, 1);
        mma_rs<CT>(acc_y, s_hi + 4 * kk, bh, kSplit ? kk > 0 : 1);
      }
    }
    wgmma_commit();
    wgmma_wait<2>();
    fence_regs<NA>(acc_a);
    if constexpr (kSplit) {
      fence_regs<NA>(cor_a);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc_a[i] += cor_a[i];
    }

    // D. M = A strictly below the diagonal, d_t on it, 0 elsewhere and past the
    // chunk (a select: whatever A holds above the diagonal is dropped) -> its
    // tile as (t, s).  At CT = 32 the rows t < 32 are warps 0 and 1's.
    if constexpr (L::kMAlias) __syncthreads();   // every warp's A is done reading k~
    if (CT == 64 || warp < 2) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int t = r0 + 8 * ii;
        const float d_t = dpart[t] + dpart[CT + t] + dpart[2 * CT + t] + dpart[3 * CT + t];
#pragma unroll
        for (int jj = 0; jj < CT / 8; ++jj) {
          float mv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int s = 8 * jj + c0 + c;
            mv[c] = t >= C ? 0.f : s < t ? acc_a[4 * jj + 2 * ii + c] : s == t ? d_t : 0.f;
          }
          put_split2<L::kMTile>(m_t, tile_off<CT>(t, 8 * jj + c0), mv[0], mv[1]);
        }
      }
    }
    fence_async_smem();
    __syncthreads();

    // E. Y^T += v^T M^T; then y = Y^T at rows t < C, columns j < N, and
    // S^T <- S^T diag(exp(la_end)) + the state product, in f32
    fence_regs<NA>(acc_y);
    wgmma_fence();
    if constexpr (kSplit) {
      mma_ss_3x_split<CT, kMax, L::kColTile, CT, L::kMTile, CT / 8>(acc_y, cor_y, v_addr, m_addr,
                                                                    kC, 1);
    } else {
      mma_ss_3x<CT, kMax, L::kColTile, CT, L::kMTile, CT / 8>(acc_y, v_addr, m_addr, kC, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NA>(acc_y);
    if constexpr (kSplit) {
      fence_regs<NA>(cor_y);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc_y[i] += cor_y[i];
    }
    fence_regs<32>(acc_s);
    fence_regs<32>(s_hi);
    fence_regs<32>(s_lo);
    float* yc = y + base + static_cast<long long>(t0) * row;
#pragma unroll
    for (int jj = 0; jj < CT / 8; ++jj) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = r0 + 8 * ii, t = 8 * jj + c0 + c;
          if (kFull || (j < N && t < C)) yc[t * row + j] = acc_y[4 * jj + 2 * ii + c];
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = aend[8 * jj + c0 + c];
        S[4 * jj + c] = e * S[4 * jj + c] + acc_s[4 * jj + c];
        S[4 * jj + 2 + c] = e * S[4 * jj + 2 + c] + acc_s[4 * jj + 2 + c];
      }
    }
  }
}

template <bool kFull, int CT>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_fwd_wgmma<kFull, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<CT>::kBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(wkv6_fwd_wgmma<kFull, CT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool kFull, int CT>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
           long long b, long long t, long long h, long long n, long long chunk,
           cudaStream_t stream) {
  cudaError_t err = configure<kFull, CT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_fwd_wgmma<kFull, CT><<<static_cast<unsigned>(b * h), kThreads, Smem<CT>::kBytes, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<int>(t), static_cast<int>(h), static_cast<int>(n), static_cast<int>(chunk));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// r, k, v, wlog, y: (b, t, h, n) contiguous float32; u: (h, n).  Returns
// cudaErrorInvalidValue for shapes the kernel does not take (n or chunk
// outside [1, 64], t not a positive multiple of chunk, b * h past the grid,
// h * n * 64 past an int), else the launch's cudaError_t.
extern "C" int pax_wkv6_wgmma(const void* r, const void* k, const void* v, const void* wlog,
                              const void* u, void* y, long long b, long long t, long long h,
                              long long n, long long chunk, void* stream) {
  if (b <= 0 || h <= 0 || b * h > 0x7fffffffLL || t <= 0 || t > 0x7fffffffLL || n < 1 ||
      n > kMax || chunk < 1 || chunk > kMax || t % chunk != 0 || h * n * kMax > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool full = n == kMax && chunk == 32 && aligned16(r) && aligned16(k) &&
                    aligned16(v) && aligned16(wlog);
  if (full) return launch<true, 32>(r, k, v, wlog, u, y, b, t, h, n, chunk, st);
  if (chunk <= 32) return launch<false, 32>(r, k, v, wlog, u, y, b, t, h, n, chunk, st);
  return launch<false, 64>(r, k, v, wlog, u, y, b, t, h, n, chunk, st);
}

// Blocks of the kernel at N = 64, chunk 32 that one SM holds at once (its
// registers and shared memory as built), into *blocks.  Returns the
// cudaError_t.
extern "C" int pax_wkv6_wgmma_blocks_per_sm(int* blocks) {
  cudaError_t err = configure<true, 32>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, wkv6_fwd_wgmma<true, 32>, kThreads, Smem<32>::kBytes));
}
