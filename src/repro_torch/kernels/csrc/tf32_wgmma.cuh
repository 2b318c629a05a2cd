// Helpers for float32 scans on Hopper's tensor cores (sm_90a) as 3xTF32 wgmma,
// shared by the scan kernels (mamba2_ssd/csrc/ssd_wgmma.cu,
// rwkv6_scan/csrc/wkv6_wgmma.cu).  They know nothing of a scan: the TF32
// split, the no-swizzle K-major tile layout and its descriptors, the
// m64n32k8 and m64n64k8 tf32 wgmma forms (shared-memory and register A), and
// the asynchronous copies (cp.async, the bulk copy on an mbarrier).
//
// The build (repro_torch/kernels/_build.py) passes this directory with -I and
// hashes every header in it into each library's name, so an edited header
// never loads a stale library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pax_tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- TF32 ------------------------------------------------------------------
// a rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero), in two integer operations: the conversion itself
// compiles to a longer sequence that also screens NaN and infinity.  Only
// for |a| below kTf32Top: the card's NaN, 0x7fffffff, would carry into the
// sign bit and come out as -0, and the top of the finite range as infinity.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
// The least |a| that tf32_rna would round to infinity.
constexpr float kTf32Top = 0x1.ffep127f;
// a -> hi = tf32(a) and lo = tf32(a - hi): hi + lo carries 21 of a's bits.
// kScreen: at and above kTf32Top (and for NaN) hi is a truncated instead, so
// that a NaN or an infinity stays non-finite in hi and a finite a finite: a
// product with a non-finite operand is then not finite, as it is in f32.
// Without the screen (one compare and one select less a value) a NaN may come
// out as +-0 and the top of the finite range as infinity: only a scan whose
// own arithmetic makes no non-finite value from finite inputs may go without.
template <bool kScreen = true>
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = !kScreen || fabsf(a) < kTf32Top ? tf32_rna(a) : __float_as_uint(a) & 0xffffe000u;
  lo = tf32_rna(a - __uint_as_float(hi));
}

// -- K-major tiles, no swizzle ------------------------------------------------
// A tile of `Rows` rows (M or N) holds its K columns in column boxes of 4
// floats: box col / 4 is Rows x 16 bytes, row after row (8-row x 16-byte core
// matrices).  Byte offset of (row, col):
template <int Rows>
__device__ __forceinline__ int tile_off(int row, int col) {
  return (col >> 2) * (Rows * 16) + row * 16 + (col & 3) * 4;
}
// A hi/lo pair is two tiles, lo `Lo` bytes after hi; kScreen as split_tf32's.
template <int Lo, bool kScreen = true>
__device__ __forceinline__ void put_split(uint8_t* pair, int off, float a) {
  uint32_t hi, lo;
  split_tf32<kScreen>(a, hi, lo);
  *reinterpret_cast<uint32_t*>(pair + off) = hi;
  *reinterpret_cast<uint32_t*>(pair + Lo + off) = lo;
}
// Two K-neighbours (col even) in one 8-byte store per term.
template <int Lo, bool kScreen = true>
__device__ __forceinline__ void put_split2(uint8_t* pair, int off, float a, float b) {
  uint2 hi, lo;
  split_tf32<kScreen>(a, hi.x, lo.x);
  split_tf32<kScreen>(b, hi.y, lo.y);
  *reinterpret_cast<uint2*>(pair + off) = hi;
  *reinterpret_cast<uint2*>(pair + Lo + off) = lo;
}
// A whole column box of one row (col a multiple of 4) in one 16-byte store per term.
template <int Lo, bool kScreen = true>
__device__ __forceinline__ void put_split4(uint8_t* pair, int off, float a, float b, float c,
                                           float d) {
  uint4 hi, lo;
  split_tf32<kScreen>(a, hi.x, lo.x);
  split_tf32<kScreen>(b, hi.y, lo.y);
  split_tf32<kScreen>(c, hi.z, lo.z);
  split_tf32<kScreen>(d, hi.w, lo.w);
  *reinterpret_cast<uint4*>(pair + off) = hi;
  *reinterpret_cast<uint4*>(pair + Lo + off) = lo;
}

// -- asynchronous copies -------------------------------------------------------
// The 128-byte line of global memory at p into L2.
__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}
// cp.async: 16 bytes (both ends 16-byte aligned; L2 only) or 4 bytes from
// global to shared memory, completing in the issuing thread's commit groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
// mbarrier and bulk copies (TMA without a tensor map)
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
// k8 step kk of a tile of `Rows` rows: column boxes 2 kk and 2 kk + 1.
template <int Rows>
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int kk) {
  return desc(tile + kk * 2 * (Rows * 16), Rows * 16, 128);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Until at most `Pending` committed groups are still in flight.
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(Pending) : "memory");
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

// d[64 x N] (+)= A[64 x 8] . B[8 x N], tf32, both K-major in shared memory;
// N is 64 (32 accumulator floats a thread) or 32 (16).
template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 32, "m64n64k8 or m64n32k8");
  if constexpr (N == 64) {
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
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d[64 x N] (+)= A[64 x 8] (registers, tf32) . B[8 x N], B K-major in shared memory.
template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db,
                                       int accumulate) {
  static_assert(N == 64 || N == 32, "m64n64k8 or m64n32k8");
  if constexpr (N == 64) {
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
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}

// d[64 x N] (+)= A . B^T over `ksteps` k8 steps (at most KMax) in 3xTF32:
// hi.lo + lo.hi + hi.hi.  A and B are hi/lo pairs of K-major tiles, A of RowsA
// rows (its 64 rows of M read from there on), B of RowsB rows (N of them
// read), each lo LoA or LoB bytes after its hi.
template <int N, int RowsA, int LoA, int RowsB, int LoB, int KMax>
__device__ __forceinline__ void mma_ss_3x(float* d, uint32_t a, uint32_t b, int ksteps,
                                          int accumulate) {
#pragma unroll
  for (int kk = 0; kk < KMax; ++kk) {
    if (kk < ksteps) {
      const uint64_t ah = tile_desc<RowsA>(a, kk), al = tile_desc<RowsA>(a + LoA, kk);
      const uint64_t bh = tile_desc<RowsB>(b, kk), bl = tile_desc<RowsB>(b + LoB, kk);
      mma_ss<N>(d, ah, bl, accumulate || kk > 0);
      mma_ss<N>(d, al, bh, 1);
      mma_ss<N>(d, ah, bh, 1);
    }
  }
}

// As mma_ss_3x, but the hi.lo and lo.hi terms go to a second accumulator
// `e`, so that `d` takes one rounding per k8 step instead of three; the
// caller adds the two in f32.
template <int N, int RowsA, int LoA, int RowsB, int LoB, int KMax>
__device__ __forceinline__ void mma_ss_3x_split(float* d, float* e, uint32_t a, uint32_t b,
                                                int ksteps, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < KMax; ++kk) {
    if (kk < ksteps) {
      const uint64_t ah = tile_desc<RowsA>(a, kk), al = tile_desc<RowsA>(a + LoA, kk);
      const uint64_t bh = tile_desc<RowsB>(b, kk), bl = tile_desc<RowsB>(b + LoB, kk);
      mma_ss<N>(e, ah, bl, accumulate || kk > 0);
      mma_ss<N>(e, al, bh, 1);
      mma_ss<N>(d, ah, bh, accumulate || kk > 0);
    }
  }
}

}  // namespace pax_tf32
