// Mamba2 SSD chunked scan, forward from a zero state, for Hopper (sm_90a):
// the four products of every chunk on the tensor cores, as 3xTF32 wgmma.
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
// with S = 0 before the first chunk; a chunk's `y` reads the state from
// before that chunk's update, and the final state is dropped.  exp(la_t -
// la_s) is formed only where t >= s: above the diagonal the exponent is
// positive and may overflow, and inf * 0 would be NaN where the reference's
// `where` simply drops it.
//
// Layout: the model's, read in place: x and y are (Bb, T, H, P), dt is
// (Bb, T, H), B and C are (Bb, T, N), shared by the H heads of a batch row
// (Mamba2 with one group), and A, D are (H,); all contiguous float32, any
// 4-byte aligned base.  Head bh reads batch row bh / H of B and C.
//
// Bound on this card: bytes.  At the main path's shape (zamba2-2.7b, Bb=4,
// T=2048, H=80, P=N=64, chunk 64) x and y are 336 MB, dt 2.6 MB and B, C
// 4.2 MB: 0.102 ms at 3.35 TB/s.  The four products are 2.15e10 FLOP; as
// 3xTF32 the tensor cores do three times that, 6.45e10, 0.130 ms at the
// 495 TFLOP/s dense TF32 rate: this kernel's own floor, of the order of the
// bytes bound.
//
// Why 3xTF32.  The inputs are f32 and wgmma takes TF32 operands (10 stored
// mantissa bits).  One TF32 rounding of the operands leaves the gate of
// 3e-4 against the plain chunked form (an emulation on the CPU at B=1,
// T=256, H=4, P=N=64, chunk 64: 6.2e-2 and 8.7e-2 off it on the sweep's and
// the models' inputs); each operand as hi = tf32(a) plus lo = tf32(a - hi),
// three products hi.hi + hi.lo + lo.hi into one f32 accumulator, stays
// inside it (3.1e-5 and 2.3e-5; tests/test_torch_ssd.py holds both
// emulations to the gate).  Both terms are rounded explicitly, to nearest
// with ties away as cvt.rna.tf32.f32 rounds (wgmma would truncate a raw f32
// bit pattern, and lo must be what the hardware's hi leaves out), without the
// shared split's screen for NaN and the top of the range: every exponent
// here is <= 0, so finite inputs make no non-finite value, and with the
// screen the generic path's registers spill (264 bytes; measured on the
// card).  A NaN or inf input, which the unscreened split may turn finite,
// is restored by a pass after the scan (pax_ssd_nan_pass): flags of the
// non-finite inputs by (batch row, chunk), OR-ed over the chunks so far,
// and NaN written only where they say the plain form is not finite.  The
// cumsum, the exponentials, the mask and the dt and exp(la_end - la)
// scalings stay f32 on the CUDA cores, and so does the state's update: the
// state product goes to a fresh accumulator each chunk, added to
// exp(la_end) S in f32 (S carried through the tensor cores' accumulator
// drifted further from an f64 run than the plain f32 form does).
//
// Design, one block of one warpgroup (128 threads) per (b, h):
// * The TPU's sequential chunk grid axis becomes a loop inside the block;
//   S (64 x 64 f32 over 128 threads: 32 a thread) stays in registers.
// * Every operand tile is 64 x 64 f32 in wgmma's no-swizzle K-major layout
//   (8-row x 16-byte core matrices; a column box of 4 floats holds all 64
//   rows), zero-padded: P, N and the chunk may be anything in [1, 64], and
//   only the k8 steps that hold data are issued.  Six tiles (three hi/lo
//   pairs, 96 KB) put two blocks on an SM:
//     c_t  C (t, n~)  A of C B^T, B operand of S C^T
//     x_t  x^T (p, s) A of x^T M^T and of the state product
//     w_t  B (s, n~) for C B^T, then M (t, s), then (B kf)^T (n, t).
//   tf32 wgmma takes both operands K-major (the transpose bits exist only
//   for 16-bit types), so x and B, which arrive t-major, are transposed by
//   the threads that split them.
// * Loads.  Every element passes through registers to be split (and x and
//   B to be transposed), so there is no raw staging ring (48 KB a stage
//   would cost the second resident block).  B and C are shared by the H
//   heads of a batch row: at P = N = chunk = 64 (kFull) a pre-pass kernel,
//   ssd_split_bc, splits each (batch row, chunk)'s C and B once into the
//   tiles' exact layout in global memory, and the scan brings them in with
//   two 32 KB bulk copies (cp.async.bulk, TMA without a tensor map) on
//   mbarriers: the next chunk's C as soon as S C^T has read c_t, B when
//   the chunk starts.  x, and C and B at other shapes, are loaded by the
//   threads with 4-byte loads that fill whole 32-byte sectors (so N=3 rows
//   of 12 bytes and views at any 4-byte offset need no second route), all
//   issued before the first store, after the rows were prefetched into L2
//   during the chunk before; the other resident block covers what latency
//   is left.
// * Products, in the transposed form that keeps S in registers:
//     G   = C B^T          (t, s)  SS, K = n
//     Y^T = S C^T          (p, t)  RS: S's accumulator fragments are the A
//                                  registers, K = n; then column t *= exp(la_t)
//     Y^T += x^T (M + dI)^T (p, t) SS, K = s: M from G, masked and scaled,
//                                  with the skip weight d on its diagonal
//     S   = exp(la_end) S + x^T (B kf)   SS, K = t
// * The accumulator fragment of an f32 wgmma holds columns 2q and 2q + 1 of
//   each 8-column group (q = lane % 4), the TF32 A register fragment columns
//   q and q + 4.  So S goes to the RS product as registers with K permuted
//   within each 8-group: hardware k = q carries n = 2q, k = q + 4 carries
//   n = 2q + 1.  C and B are stored with that same order of n (n~), which
//   leaves C B^T unchanged.  M goes through shared memory.
// * Registers: 255 at most with two blocks an SM, so nothing waits in them
//   that can be fetched again: B is loaded a second time (from L2) for
//   (B kf)^T while x^T M^T runs, and S C^T goes in four quarters of two k8
//   steps so that a quarter of S's hi/lo fragments are live at a time.
// * la is a warp scan (warp 0, two values a lane).  Threads write tiles
//   through the generic proxy, so each hand-over to wgmma is
//   fence.proxy.async + __syncthreads.
// * P = N = chunk = 64 (the repo's Mamba2 configs) is a compile-time case
//   of the same code (kFull), free of bounds tests.
//
// The helpers (the TF32 split, the tile layout, the descriptors, the tf32
// wgmma forms, the bulk copy) know nothing of the scan; they live in
// kernels/csrc/tf32_wgmma.cuh, shared with the wkv6 scan.
//
// The launches use the caller's stream, allocate nothing (the caller passes
// the split tiles' buffer) and do not synchronise; the entry point returns
// the first failed launch's cudaError_t.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

using namespace pax_tf32;

constexpr int kThreads = 128;                // one warpgroup
constexpr int kTile = 64;                    // every operand tile is 64 x 64 f32
constexpr int kTileBytes = kTile * kTile * 4;
constexpr int kMax = 64;                     // P, N and chunk
constexpr int kSmem = 6 * kTileBytes + 4 * kTile * 4 + 2 * 8;  // tiles, vectors, mbarriers

// C and B of one (batch row, chunk), at N = chunk = 64, as the hi/lo tiles
// the scan reads (C (t, n~) hi, lo, then B (s, n~) hi, lo: 64 KB), so that
// the H heads of a batch row share one split and every block brings its
// tiles in with two bulk copies.  Grid (chunks, batch rows).
__global__ void __launch_bounds__(kThreads)
ssd_split_bc(const float* __restrict__ Bm, const float* __restrict__ Cm,
             uint8_t* __restrict__ tiles, int T) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int tr = tid % 8, m = (tid / 8) % 4;
  const long long row0 = static_cast<long long>(blockIdx.y) * T + blockIdx.x * kTile;
  const float* cc = Cm + row0 * kTile;
  const float* bc = Bm + row0 * kTile;
  uint8_t* out =
      tiles + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * 4 * kTileBytes;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int t = 8 * (2 * warp + u) + tr;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * g + 2 * m + e, off = tile_off<kTile>(t, 8 * g + m + 4 * e);
        put_split<kTileBytes, false>(out, off, cc[t * kTile + n]);
        put_split<kTileBytes, false>(out + 2 * kTileBytes, off, bc[t * kTile + n]);
      }
    }
  }
}

// Accumulator fragment of wgmma m64n64 (f32), for thread t of the warpgroup:
// element [4 j + 2 i + c] is row 16 (t / 32) + (t % 32) / 4 + 8 i, column
// 8 j + 2 (t % 4) + c.
//
// kFull: P = N = C = 64 (every Mamba2 config of the repo), known at compile
// time, so no load, store or mask carries a bounds test.
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 2)
ssd_fwd_wgmma(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ Dv, float* __restrict__ y,
              const uint8_t* __restrict__ tiles, int T, int H, int P_, int N_, int C_) {
  const int P = kFull ? kTile : P_, N = kFull ? kTile : N_, C = kFull ? kTile : C_;
  extern __shared__ __align__(128) uint8_t smem_raw[];  // 16-byte aligned tiles
  uint8_t* c_t = smem_raw;
  uint8_t* x_t = c_t + 2 * kTileBytes;
  uint8_t* w_t = x_t + 2 * kTileBytes;
  float* dts = reinterpret_cast<float*>(w_t + 2 * kTileBytes);  // dt, 0 past the chunk
  float* la = dts + kTile;                                       // inclusive cumsum of dt a
  float* ela = la + kTile;                                       // exp(la)
  float* kf = ela + kTile;                                       // exp(la_end - la) dt
  uint64_t* bar_c = reinterpret_cast<uint64_t*>(kf + kTile);     // kFull: c_t landed
  uint64_t* bar_b = bar_c + 1;                                   // kFull: B in w_t landed
  const uint32_t c_addr = smem_u32(c_t), x_addr = smem_u32(x_t), w_addr = smem_u32(w_t);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = A[h], dskip = Dv[h];
  const int xrow = H * P;                                 // x, y: from step t to t + 1
  const long long xbase = static_cast<long long>(b) * T * xrow + static_cast<long long>(h) * P;
  const long long tb = static_cast<long long>(b) * T;     // this batch row's first step
  const int kN = (N + 7) / 8, kC = (C + 7) / 8;           // k8 steps over n and over the chunk
  const int r0 = 16 * warp + lane / 4;                    // fragment rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);                          // fragment columns 8 j + c0 + {0, 1}

  const int tr = tid % 8, m = (tid / 8) % 4;
  float S[32];    // the state (p, n)
  float acc[32];  // G (t, s), then Y^T (p, t), then the state product
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = 0.f;
  // kFull: this batch row's split C and B tiles, chunk by chunk
  const uint8_t* bc_tiles =
      kFull ? tiles + static_cast<long long>(b) * (T / kTile) * 4 * kTileBytes : nullptr;
  if (kFull && tid == 0) {
    mbar_init(bar_c, 1);
    mbar_init(bar_b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load(c_t, bc_tiles, 2 * kTileBytes, bar_c);
  }

  for (int t0 = 0; t0 < T; t0 += C) {
    __syncthreads();  // the previous chunk's products are done with every tile
    const uint32_t parity = (t0 / C) & 1;
    if (kFull && tid == 0) {
      bulk_load(w_t, bc_tiles + (t0 / C) * 4 * kTileBytes + 2 * kTileBytes, 2 * kTileBytes,
                bar_b);
    }
    const float* xc = x + xbase + static_cast<long long>(t0) * xrow;
    const float* bc = Bm + (tb + t0) * N;
    const float* cc = Cm + (tb + t0) * N;
    const float* dtc = dt + (tb + t0) * H + h;
    if (t0 + C < T) {  // the next chunk's rows into L2 (128-byte lines)
      const int t = tid % 64, half = tid / 64;
      if (t < C && 32 * half < P) {
        prefetch_l2(xc + static_cast<long long>(C + t) * xrow + 32 * half);
      }
      if (half == 0 && t < C) prefetch_l2(dtc + static_cast<long long>(C + t) * H);
      if (32 * tid < C * N) {
        prefetch_l2(bc + C * N + 32 * tid);
        if (!kFull) prefetch_l2(cc + C * N + 32 * tid);  // else C comes split
      }
    }

    // 0. the chunk's inputs: x at rows t = 4 (4 warp + v) + lane / 8 and
    // p = 8 k + lane % 8; warp 0 dt at steps lane and lane + 32; and, unless
    // the pre-pass split them (kFull), C at rows t = 8 (2 warp + u) + tid % 8
    // and n = 8 g + 2 m + e (m = (tid / 8) % 4), B at x's rows and
    // n = 8 k + lane % 8.  Zero past the chunk, N and P.  All loads before
    // the first store.
    float cv[32], bv[32], xv[32], d0 = 0.f, d1 = 0.f;
    if constexpr (!kFull) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 8 * (2 * warp + u) + tr;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * g + 2 * m + e;
            cv[16 * u + 2 * g + e] = (t < C && n < N) ? cc[t * N + n] : 0.f;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = 4 * (4 * warp + v) + lane / 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int n = 8 * k + lane % 8;
          bv[4 * k + v] = (t < C && n < N) ? bc[t * N + n] : 0.f;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int t = 4 * (4 * warp + v) + lane / 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int p = 8 * k + lane % 8;
        xv[4 * k + v] = (t < C && p < P) ? xc[t * xrow + p] : 0.f;
      }
    }
    if (warp == 0) {
      d0 = lane < C ? dtc[lane * H] : 0.f;
      d1 = lane + 32 < C ? dtc[(lane + 32) * H] : 0.f;
    }

    // 1. x -> x_t as x^T (p, t), and C -> c_t and B -> w_t as (t, n~), hi/lo.
    // n~: n = 8 g + r sits at column 8 g + r / 2 + 4 (r % 2).  The C and x^T
    // stores are conflict-free, B's 2-way.
    const int r = lane % 8;
    if constexpr (!kFull) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int g = 0; g < 8; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            put_split<kTileBytes, false>(
                c_t, tile_off<kTile>(8 * (2 * warp + u) + tr, 8 * g + m + 4 * e),
                cv[16 * u + 2 * g + e]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = 4 * (4 * warp + v) + lane / 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          put_split<kTileBytes, false>(w_t, tile_off<kTile>(t, 8 * k + r / 2 + 4 * (r % 2)),
                                       bv[4 * k + v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int t = 4 * (4 * warp + v) + lane / 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        put_split<kTileBytes, false>(x_t, tile_off<kTile>(8 * k + r, t), xv[4 * k + v]);
      }
    }
    // warp 0: la = cumsum(dt a) as a warp scan, exp(la), exp(la_end - la) dt
    if (warp == 0) {
      float s0 = d0 * a, s1 = d1 * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, s0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, s1, o);
        if (lane >= o) {
          s0 += u0;
          s1 += u1;
        }
      }
      s1 += __shfl_sync(0xffffffffu, s0, 31);
      const float la_end = __shfl_sync(0xffffffffu, C <= 32 ? s0 : s1, (C - 1) % 32);
      dts[lane] = d0;
      dts[lane + 32] = d1;
      la[lane] = s0;
      la[lane + 32] = s1;
      ela[lane] = expf(s0);
      ela[lane + 32] = expf(s1);
      kf[lane] = expf(la_end - s0) * d0;
      kf[lane + 32] = expf(la_end - s1) * d1;
    }
    fence_async_smem();
    __syncthreads();
    if (kFull) {
      mbar_wait(bar_c, parity);
      mbar_wait(bar_b, parity);
    }

    // 2. G = C B^T (t, s)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;  // (not live across the loads)
    fence_regs<32>(acc);
    wgmma_fence();
    mma_ss_3x<64, kTile, kTileBytes, kTile, kTileBytes, kTile / 8>(acc, c_addr, w_addr, kN, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(acc);

    // 3. M = G * exp(la_t - la_s) * dt_s on and below the diagonal, plus d on
    // it (the skip term d x rides the product M x) -> w_t as (t, s), once
    // every warp's C B^T is done reading B there
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = r0 + 8 * i;
      const float la_t = la[t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float mv[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int s = 8 * j + c0 + c;
          const float mts = acc[4 * j + 2 * i + c] * __expf(la_t - la[s]) * dts[s];
          mv[c] = (t < C && s <= t) ? (s == t ? mts + dskip : mts) : 0.f;
        }
        put_split2<kTileBytes, false>(w_t, tile_off<kTile>(t, 8 * j + c0), mv[0], mv[1]);
      }
    }
    fence_async_smem();
    __syncthreads();

    // 4-5. Y^T = S C^T (p, t), in quarters of two k8 steps so that only a
    // quarter of S's hi/lo A fragments are live: k8 step j holds n = 8 j + 2q
    // at hardware k q and n = 8 j + 2q + 1 at k q + 4, rows r0 and r0 + 8.
#pragma unroll
    for (int quarter = 0; quarter < 4; ++quarter) {
      uint32_t s_hi[8], s_lo[8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * quarter + jj;
        split_tf32<false>(S[4 * j + 0], s_hi[4 * jj + 0], s_lo[4 * jj + 0]);  // (r0, 2q)
        split_tf32<false>(S[4 * j + 2], s_hi[4 * jj + 1], s_lo[4 * jj + 1]);  // (r0 + 8, 2q)
        split_tf32<false>(S[4 * j + 1], s_hi[4 * jj + 2], s_lo[4 * jj + 2]);  // (r0, 2q + 1)
        split_tf32<false>(S[4 * j + 3], s_hi[4 * jj + 3], s_lo[4 * jj + 3]);  // (r0 + 8, 2q + 1)
      }
      if (2 * quarter < kN) {
        fence_regs<8>(s_hi);
        fence_regs<8>(s_lo);
        fence_regs<32>(acc);
        wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int kk = 2 * quarter + jj;
          if (kk < kN) {
            const uint64_t bh = tile_desc<kTile>(c_addr, kk);
            const uint64_t bl = tile_desc<kTile>(c_addr + kTileBytes, kk);
            mma_rs<64>(acc, s_hi + 4 * jj, bl, kk > 0);
            mma_rs<64>(acc, s_lo + 4 * jj, bh, 1);
            mma_rs<64>(acc, s_hi + 4 * jj, bh, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<32>(acc);
      }
    }
    // column t of Y^T times exp(la_t)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float e = ela[8 * j + c0 + c];
        acc[4 * j + c] *= e;
        acc[4 * j + 2 + c] *= e;
      }
    }

    // 6. Y^T += x^T (M + d I)^T, meanwhile B again (from L2) for (B kf)^T;
    // then y = Y^T at rows t < C, columns p < P
    fence_regs<32>(acc);
    wgmma_fence();
    mma_ss_3x<64, kTile, kTileBytes, kTile, kTileBytes, kTile / 8>(acc, x_addr, w_addr, kC, 1);
    wgmma_commit();
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int t = 4 * (4 * warp + v) + lane / 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = 8 * k + lane % 8;
        bv[4 * k + v] = (t < C && n < N) ? bc[t * N + n] : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs<32>(acc);
    float* yc = y + xbase + static_cast<long long>(t0) * xrow;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int t = 8 * j + c0 + c, p = r0 + 8 * i;
          if (t < C && p < P) yc[t * xrow + p] = acc[4 * j + 2 * i + c];
        }
      }
    }

    // 7. (B kf)^T (n, t) -> w_t once every warp's x^T M^T is done reading M
    // (conflict-free); every warp is done with c_t too, so the next chunk's
    // C tiles may come in
    __syncthreads();
    if (kFull && tid == 0 && t0 + C < T) {
      bulk_load(c_t, bc_tiles + (t0 / C + 1) * 4 * kTileBytes, 2 * kTileBytes, bar_c);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int t = 4 * (4 * warp + v) + lane / 8;
      const float k = kf[t];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        put_split<kTileBytes, false>(w_t, tile_off<kTile>(8 * nb + lane % 8, t),
                                     bv[4 * nb + v] * k);
      }
    }
    fence_async_smem();
    __syncthreads();

    // 8. S = exp(la_end) S + x^T (B kf), the product in a fresh accumulator
    // and the sum in f32
    wgmma_fence();
    mma_ss_3x<64, kTile, kTileBytes, kTile, kTileBytes, kTile / 8>(acc, x_addr, w_addr, kC, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(acc);
    const float a_end = ela[C - 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = a_end * S[i] + acc[i];
  }
}

// The non-finite pass (after the scan, on the same stream).  The scan's TF32
// split is unscreened, so a NaN or inf input can come out finite; the plain
// chunked form's non-finite outputs follow from where its inputs are not
// finite, chunk by chunk (ref.ssd_nonfinite_mask is the same rule in torch):
//   x at (b, s, h, p)  -> column p of head h, from s's chunk on;
//   dt at (b, s, h)    -> all of head h, from s's chunk on;
//   B at (b, s, .)     -> every head, from s's chunk on;
//   C at (b, t, .)     -> row t only.
// Flags (one byte each, after a 4-byte "any" word the entry point zeroes):
// fC (bb, t), fB (bb, nc), fdt (bb, nc, h), fx (bb, nc, h, p).  Both kernels
// run on grid (ceil(h p / 128), nc, bb): thread j of a block is (h, p) =
// (j / p, j % p) of one (batch row, chunk), so its loads of x, one per row of
// the chunk, are coalesced 4-byte words.  The main kernel is not touched.
struct NanFlags {
  int* any;
  uint8_t *fC, *fB, *fdt, *fx;
  __device__ NanFlags(uint8_t* base, int bb, int t, int nc, int h) {
    any = reinterpret_cast<int*>(base);
    fC = base + 4;
    fB = fC + static_cast<long long>(bb) * t;
    fdt = fB + static_cast<long long>(bb) * nc;
    fx = fdt + static_cast<long long>(bb) * nc * h;
  }
};

__global__ void __launch_bounds__(kThreads)
ssd_nan_flags(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              uint8_t* __restrict__ base, int T, int H, int P, int N, int chunk) {
  const int tid = threadIdx.x, c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int hp = H * P, j = blockIdx.x * kThreads + tid;
  NanFlags f(base, gridDim.z, T, nc, H);
  const long long row0 = static_cast<long long>(b) * T + static_cast<long long>(c) * chunk;
  const long long bc = static_cast<long long>(b) * nc + c;
  bool bad = false;
  if (j < hp) {
    const float* xr = x + row0 * hp + j;
    for (int t = 0; t < chunk; ++t) bad |= !isfinite(xr[static_cast<long long>(t) * hp]);
    f.fx[bc * hp + j] = bad;
  }
  if (j < H) {
    bool d = false;
    const float* dr = dt + row0 * H + j;
    for (int t = 0; t < chunk; ++t) d |= !isfinite(dr[static_cast<long long>(t) * H]);
    f.fdt[bc * H + j] = d;
    bad |= d;
  }
  if (blockIdx.x == 0) {  // B and C: thread t reads row t of the chunk
    bool rb = false;
    if (tid < chunk) {
      const float* br = Bm + (row0 + tid) * N;
      const float* cr = Cm + (row0 + tid) * N;
      bool rc = false;
      for (int n = 0; n < N; ++n) {
        rb |= !isfinite(br[n]);
        rc |= !isfinite(cr[n]);
      }
      f.fC[row0 + tid] = rc;
      bad |= rc;
    }
    const int any_b = __syncthreads_or(rb);
    if (tid == 0) f.fB[bc] = any_b != 0;
    bad |= any_b != 0;
  }
  if (bad) atomicOr(f.any, 1);
}

// NaN at every output the flags poison: nothing at all (one load a thread)
// unless some input was not finite.
__global__ void __launch_bounds__(kThreads)
ssd_nan_apply(float* __restrict__ y, uint8_t* __restrict__ base, int T, int H, int P,
              int chunk) {
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int hp = H * P, j = blockIdx.x * kThreads + threadIdx.x;
  NanFlags f(base, gridDim.z, T, nc, H);
  if (*f.any == 0 || j >= hp) return;
  const int h = j / P;
  bool run = false;  // the flags of this chunk and every earlier one
  for (int k = 0; k <= c; ++k) {
    const long long bk = static_cast<long long>(b) * nc + k;
    run |= f.fx[bk * hp + j] | f.fdt[bk * H + h] | f.fB[bk];
  }
  const long long row0 = static_cast<long long>(b) * T + static_cast<long long>(c) * chunk;
  for (int t = 0; t < chunk; ++t) {
    if (run || f.fC[row0 + t]) y[(row0 + t) * hp + j] = __int_as_float(0x7fffffff);
  }
}

template <bool kFull>
cudaError_t configure() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_wgmma<kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_fwd_wgmma<kFull>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool kFull>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           const void* D, void* y, void* tiles, long long bb, long long t, long long h,
           long long p, long long n, long long chunk, cudaStream_t stream) {
  cudaError_t err = configure<kFull>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kFull) {
    ssd_split_bc<<<dim3(static_cast<unsigned>(t / kTile), static_cast<unsigned>(bb)), kThreads, 0,
                   stream>>>(static_cast<const float*>(B), static_cast<const float*>(C),
                             static_cast<uint8_t*>(tiles), static_cast<int>(t));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_fwd_wgmma<kFull><<<static_cast<unsigned>(bb * h), kThreads, kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<float*>(y), static_cast<const uint8_t*>(tiles), static_cast<int>(t),
      static_cast<int>(h), static_cast<int>(p), static_cast<int>(n), static_cast<int>(chunk));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (bb, t, h, p); dt: (bb, t, h); B, C: (bb, t, n); A, D: (h,); all
// contiguous float32.  tiles: at p = n = chunk = 64, a 16-byte aligned
// buffer of bb * (t / 64) * 64 KB for B's and C's split tiles (else unused).
// Returns cudaErrorInvalidValue for shapes the kernel does not take (p, n or
// chunk outside [1, 64], t not a positive multiple of chunk, bb * h past the
// grid, h * p * 64 past an int) or a missing tiles buffer, else the first
// failed launch's cudaError_t.
extern "C" int pax_ssd_wgmma(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, const void* D, void* y, void* tiles, long long bb,
                             long long t, long long h, long long p, long long n,
                             long long chunk, void* stream) {
  if (bb <= 0 || h <= 0 || bb * h > 0x7fffffffLL || t <= 0 || t > 0x7fffffffLL || p < 1 ||
      p > kMax || n < 1 || n > kMax || chunk < 1 || chunk > kMax || t % chunk != 0 ||
      h * p * kMax > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool full = p == kMax && n == kMax && chunk == kMax;
  if (full && (tiles == nullptr || reinterpret_cast<uintptr_t>(tiles) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return full ? launch<true>(x, dt, A, B, C, D, y, tiles, bb, t, h, p, n, chunk, st)
              : launch<false>(x, dt, A, B, C, D, y, tiles, bb, t, h, p, n, chunk, st);
}

// Bytes of the non-finite pass's flag buffer for these dims.
extern "C" long long pax_ssd_nan_flag_bytes(long long bb, long long t, long long h,
                                            long long p, long long chunk) {
  const long long nc = t / chunk;
  return 4 + bb * t + bb * nc * (1 + h + h * p);
}

// The non-finite pass over y, the scan's output of the same inputs (see
// ssd_nan_flags): y takes NaN wherever the plain chunked form is not finite.
// flags: pax_ssd_nan_flag_bytes(...) bytes of scratch, 4-byte aligned.
// Returns cudaErrorInvalidValue for the shapes pax_ssd_wgmma refuses, else
// the first failed call's cudaError_t.
extern "C" int pax_ssd_nan_pass(const void* x, const void* dt, const void* B, const void* C,
                                void* y, void* flags, long long bb, long long t, long long h,
                                long long p, long long n, long long chunk, void* stream) {
  if (bb <= 0 || bb > 65535 || h <= 0 || t <= 0 || t > 0x7fffffffLL || p < 1 || p > kMax ||
      n < 1 || n > kMax || chunk < 1 || chunk > kMax || t % chunk != 0 || t / chunk > 65535 ||
      h * p * kMax > 0x7fffffffLL || flags == nullptr ||
      reinterpret_cast<uintptr_t>(flags) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, 4, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((h * p + kThreads - 1) / kThreads),
                  static_cast<unsigned>(t / chunk), static_cast<unsigned>(bb));
  const int T = static_cast<int>(t), H = static_cast<int>(h), P = static_cast<int>(p);
  const int K = static_cast<int>(chunk);
  ssd_nan_flags<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<uint8_t*>(flags), T, H, P,
      static_cast<int>(n), K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_nan_apply<<<grid, kThreads, 0, st>>>(static_cast<float*>(y),
                                           static_cast<uint8_t*>(flags), T, H, P, K);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel at P = N = chunk = 64 that one SM holds at once (its
// registers and shared memory as built), into *blocks.  Returns the
// cudaError_t.
extern "C" int pax_ssd_wgmma_blocks_per_sm(int* blocks) {
  cudaError_t err = configure<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_fwd_wgmma<true>, kThreads, kSmem));
}
