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
// bit pattern, and lo must be what the hardware's hi leaves out).  The
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
// The helpers above the kernel (the TF32 split, the tile layout, the
// descriptors and the m64n64k8 tf32 wgmma forms) know nothing of the scan.
//
// The launches use the caller's stream, allocate nothing (the caller passes
// the split tiles' buffer) and do not synchronise; the entry point returns
// the first failed launch's cudaError_t.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                // one warpgroup
constexpr int kTile = 64;                    // every operand tile is 64 x 64 f32
constexpr int kTileBytes = kTile * kTile * 4;
constexpr int kBoxBytes = kTile * 16;        // one column box: 4 floats x 64 rows
constexpr int kMax = 64;                     // P, N and chunk
constexpr int kSmem = 6 * kTileBytes + 4 * kTile * 4 + 2 * 8;  // tiles, vectors, mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- TF32 ------------------------------------------------------------------
// a rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero), in two integer operations: the conversion itself
// compiles to a longer sequence that also screens NaN and infinity.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
// a -> hi = tf32(a) and lo = tf32(a - hi): hi + lo carries 21 of a's bits.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// -- 64 x 64 K-major tiles, no swizzle ---------------------------------------
// Byte offset of (row, col), col along K: column box col / 4, row's 16 bytes.
__device__ __forceinline__ int tile_off(int row, int col) {
  return (col >> 2) * kBoxBytes + row * 16 + (col & 3) * 4;
}
// A hi/lo pair is two tiles, lo kTileBytes after hi.
__device__ __forceinline__ void put_split(uint8_t* pair, int off, float a) {
  uint32_t hi, lo;
  split_tf32(a, hi, lo);
  *reinterpret_cast<uint32_t*>(pair + off) = hi;
  *reinterpret_cast<uint32_t*>(pair + kTileBytes + off) = lo;
}
// Two K-neighbours (col even) in one 8-byte store per term.
__device__ __forceinline__ void put_split2(uint8_t* pair, int off, float a, float b) {
  uint2 hi, lo;
  split_tf32(a, hi.x, lo.x);
  split_tf32(b, hi.y, lo.y);
  *reinterpret_cast<uint2*>(pair + off) = hi;
  *reinterpret_cast<uint2*>(pair + kTileBytes + off) = lo;
}
// The 128-byte line of global memory at p into L2.
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
// -- mbarrier and bulk copies (TMA without a tensor map) --------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) from global memory to
// shared memory, completing on `bar` (armed here for exactly these bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// -- wgmma ------------------------------------------------------------------
// Shared-memory matrix descriptor, no swizzle: start address, LBO (the byte
// step between core matrices along K) and SBO (along M or N), each >> 4.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}
// k8 step kk of a 64 x 64 tile: column boxes 2 kk and 2 kk + 1.
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  return desc(tile + kk * 2 * kBoxBytes, kBoxBytes, 128);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 8] . B[8 x 64], tf32, both K-major in shared memory.
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] (registers, tf32) . B[8 x 64], B K-major in shared memory.
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A . B^T over `ksteps` k8 steps in 3xTF32, A and B hi/lo tile pairs.
__device__ __forceinline__ void mma_ss_3x(float* d, uint32_t a, uint32_t b, int ksteps,
                                          int accumulate) {
#pragma unroll
  for (int kk = 0; kk < kTile / 8; ++kk) {
    if (kk < ksteps) {
      const uint64_t ah = tile_desc(a, kk), al = tile_desc(a + kTileBytes, kk);
      const uint64_t bh = tile_desc(b, kk), bl = tile_desc(b + kTileBytes, kk);
      mma_ss(d, ah, bl, accumulate || kk > 0);
      mma_ss(d, al, bh, 1);
      mma_ss(d, ah, bh, 1);
    }
  }
}

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
        const int n = 8 * g + 2 * m + e, off = tile_off(t, 8 * g + m + 4 * e);
        put_split(out, off, cc[t * kTile + n]);
        put_split(out + 2 * kTileBytes, off, bc[t * kTile + n]);
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
            put_split(c_t, tile_off(8 * (2 * warp + u) + tr, 8 * g + m + 4 * e),
                      cv[16 * u + 2 * g + e]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = 4 * (4 * warp + v) + lane / 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          put_split(w_t, tile_off(t, 8 * k + r / 2 + 4 * (r % 2)), bv[4 * k + v]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int t = 4 * (4 * warp + v) + lane / 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) put_split(x_t, tile_off(8 * k + r, t), xv[4 * k + v]);
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
    mma_ss_3x(acc, c_addr, w_addr, kN, 0);
    wgmma_commit();
    wgmma_wait_all();
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
        put_split2(w_t, tile_off(t, 8 * j + c0), mv[0], mv[1]);
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
        split_tf32(S[4 * j + 0], s_hi[4 * jj + 0], s_lo[4 * jj + 0]);  // (r0, 2q)
        split_tf32(S[4 * j + 2], s_hi[4 * jj + 1], s_lo[4 * jj + 1]);  // (r0 + 8, 2q)
        split_tf32(S[4 * j + 1], s_hi[4 * jj + 2], s_lo[4 * jj + 2]);  // (r0, 2q + 1)
        split_tf32(S[4 * j + 3], s_hi[4 * jj + 3], s_lo[4 * jj + 3]);  // (r0 + 8, 2q + 1)
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
            const uint64_t bh = tile_desc(c_addr, kk), bl = tile_desc(c_addr + kTileBytes, kk);
            mma_rs(acc, s_hi + 4 * jj, bl, kk > 0);
            mma_rs(acc, s_lo + 4 * jj, bh, 1);
            mma_rs(acc, s_hi + 4 * jj, bh, 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
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
    mma_ss_3x(acc, x_addr, w_addr, kC, 1);
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
    wgmma_wait_all();
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
        put_split(w_t, tile_off(8 * nb + lane % 8, t), bv[4 * nb + v] * k);
      }
    }
    fence_async_smem();
    __syncthreads();

    // 8. S = exp(la_end) S + x^T (B kf), the product in a fresh accumulator
    // and the sum in f32
    wgmma_fence();
    mma_ss_3x(acc, x_addr, w_addr, kC, 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(acc);
    const float a_end = ela[C - 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) S[i] = a_end * S[i] + acc[i];
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

// Blocks of the kernel at P = N = chunk = 64 that one SM holds at once (its
// registers and shared memory as built), into *blocks.  Returns the
// cudaError_t.
extern "C" int pax_ssd_wgmma_blocks_per_sm(int* blocks) {
  cudaError_t err = configure<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_fwd_wgmma<true>, kThreads, kSmem));
}
