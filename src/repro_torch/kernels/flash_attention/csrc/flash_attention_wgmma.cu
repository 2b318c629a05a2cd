// Flash attention, forward, bf16 inputs, on Hopper's tensor cores (sm_90a):
// wgmma on bf16 tiles that TMA brings into shared memory.
//
// Replaces, for bf16 inputs, the Pallas kernel `_attn_kernel` of
// src/repro/kernels/flash_attention/kernel.py:75 (f32 inputs stay on the
// CUDA-core kernel of flash_attention.cu).  In the kernel's layout, q (BH, S, D)
// and k/v (BKV, S, D), query head bh reading kv row bh / (BH / BKV):
//
//   o[bh, i] = sum_j softmax_j(scale * q[bh, i] . k[kv, j]) v[kv, j],
//   scale = 1 / sqrt(D), keys j > i masked under `causal`, keys j >= S never seen,
//
// with a running max m (from -1e30), a running denominator l summed from the
// f32 p, an f32 accumulator rescaled by exp(m_old - m_new) at every kv tile,
// and o = acc / max(l, 1e-30) rounded once to bf16.
//
// Bound on this card: operations.  At the main path's shape (qwen2-0.5b,
// B=4, S=2048, 14/2 heads, D=64, causal) the work is 4*B*H*D*S(S+1)/2 =
// 3.01e10 FLOP, 0.030 ms at 989 TFLOP/s, against 33.6 MB of q, k, v and o
// (0.010 ms at 3.35 TB/s).  The exponentials are a second limit at D=64:
// B*H*S^2/2 = 1.17e8 `exp`s, about 0.03 ms on the SFUs (16 a clock an SM).
//
// Why P is carried as two bf16 terms.  wgmma takes bf16 operands, so the
// second product P.V needs P in bf16, while the reference keeps p in f32.
// One bf16 rounding of p costs 2^-9 of sum_j |p_j v_j| / l in every output,
// which for an output near zero is far outside chip_smoke.py's gate for the
// full-width bf16 rows (|err| <= 1e-5 + 2^-6 |want|).  Emulated on the CPU at
// B=1, S=2048, 14/2 heads, D=64, bf16 inputs from seed 2:
//
//   how P is carried                     max abs err   gate excess
//   f32 p                                0.00195       -9.9e-6 (passes)
//   one bf16(p)                          0.0078        +1.4e-3 (97,990 of 1.84M fail)
//   bf16(p) + bf16(p - bf16(p))          0.0039        -9.1e-6 (passes)
//
// So P goes to the tensor cores as p_hi = bf16(p) and p_lo = bf16(p - p_hi):
// two wgmma on the same V tile into one f32 accumulator, 1.5x the function's
// FLOPs on the tensor cores.  (tests/test_torch_flash_attention.py holds the
// emulation to the gate.)  Q.K^T multiplies bf16 values, whose products are
// exact in f32, as in the reference's f32 dot.
//
// Design, one block per (bh, 64 * NWG query rows), longest query tiles first:
// * NWG consumer warpgroups (2 for D <= 128, 1 above, for registers: the O
//   accumulator of 64 x D f32 is D / 2 registers a thread) of 64 query rows
//   each, and one producer warp whose lane 0 issues every TMA load: the q tile
//   once, then the K and V tiles of 64 keys into a ring of kStages stages with
//   an mbarrier per stage for "full" (TMA transaction bytes) and one for
//   "empty" (every consumer thread arrives when its wgmma reads are done).
//   The "empty" barrier counts arrivals, not whose they are: it is sound only
//   because every consumer thread arrives on a phase of it after waiting on
//   the same phase of the stage's "full" barriers, so no warpgroup can arrive
//   for the stage's next tile before the producer has seen this one drained.
// * Shared-memory tiles are wgmma's no-swizzle layout: each TMA box is 8
//   columns (16 bytes) by all the tile's rows, so an 8 x 8 core matrix is 128
//   contiguous bytes and the boxes of one tile stack along the columns.  Any
//   D that is a multiple of 8 is one layout: D is padded to DP, the next
//   multiple of 16, by TMA's zero fill of the columns past D (D=80 needs no
//   padding and no swizzle atom wider than its 160-byte rows), and rows past
//   S arrive as zeros, which the mask hides.
// * S = Q.K^T: wgmma m64n64k16, A (q) and B (k, K-major) from shared memory,
//   f32 accumulator in registers.
// * Online softmax on the accumulator fragment, in base 2 (scale folded with
//   log2 e): the mask (keys at or past S, keys after the query under
//   `causal`) writes -1e30 before the row max, only on tiles that need it,
//   and exp2 of it is 0.  Every row sees key 0 in its first tile, so m is
//   finite from there on.  Each thread sums its share of l; the quad's
//   shares are added once, at the end.  Tiles strictly above the diagonal
//   are not loaded.  A loaded tile can lie wholly above one warpgroup's rows
//   only as the block's last tile (warpgroup 0's, with two warpgroups): that
//   warpgroup stops there without arriving on its "empty" barrier, which no
//   load waits on.
// * O += P.V: the S fragment becomes the A registers of wgmma directly (the
//   f32 accumulator and the bf16 A fragment share a layout), V is read from
//   shared memory as an MN-major B (16-bit types allow it), in n64 and n16
//   pieces of DP.
// * Epilogue: o = acc / max(l, 1e-30) as bf16 pairs, rows past S and
//   columns past D not stored.
// * GQA: query head bh reads kv row bh / group through the K/V tensor maps'
//   third coordinate.
//
// TMA descriptors are encoded on the host for every call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (so the
// library needs no -lcuda), and passed as __grid_constant__ parameters.
// The launch uses the caller's stream, allocates nothing and does not
// synchronise; the entry point returns a cudaError_t.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;          // keys per K/V tile
constexpr int kWarpgroup = 128;  // threads of a warpgroup
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

template <int DP>
struct Cfg {
  static_assert(DP % 16 == 0 && DP >= 16 && DP <= kMaxD, "DP: a multiple of 16 up to 256");
  static constexpr int kNWG = DP <= 128 ? 2 : 1;       // consumer warpgroups
  static constexpr int kBQ = 64 * kNWG;                // query rows per block
  static constexpr int kStages = DP <= 128 ? 3 : 2;    // K/V ring depth
  static constexpr int kThreads = kNWG * kWarpgroup + 32;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;
  static constexpr int kBarriers = 1 + 3 * kStages;    // q full; k full, v full, empty per stage
  static constexpr int kSmem = 128 + kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarrier --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
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

// -- TMA: one box of 8 columns x rows, coordinates (column, row, head) -----
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(head)
      : "memory");
}

// -- wgmma ------------------------------------------------------------------
// Shared-memory matrix descriptor, no swizzle: start address, LBO (the byte
// step between core matrices along K) and SBO (along M or N), each >> 4.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
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

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both K-major in shared memory.
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64], B MN-major in shared memory.
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] += A[64 x 16] (registers) . B[16 x 16], B MN-major in shared memory.
__device__ __forceinline__ void mma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) -> the bf16 pair bf16(a), bf16(b) and the pair of what it left out.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// Accumulator fragment of wgmma m64nN (f32), for thread t of a warpgroup:
// element [4 * j + 2 * i + c] is row 16 * (t / 32) + (t % 32) / 4 + 8 * i,
// column 8 * j + 2 * (t % 4) + c.  The A register fragment of a k16 step
// holds, as bf16 pairs, rows (t % 32) / 4 + {0, 8} of the warp's 16 and
// columns 2 * (t % 4) + {0, 1} + {0, 8}: the accumulator's n8 blocks 2s and
// 2s + 1, so P's step s is built from S's elements 8s .. 8s + 7.
template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
                int D, int group, int causal, float scale_log2) {
  using C = Cfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  uint8_t* qs = base;                                   // DP / 8 boxes of kBQ x 16 bytes
  uint8_t* ks = qs + C::kQBytes;                        // stage s: ks + s * kTileBytes
  uint8_t* vs = ks + C::kStages * C::kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + C::kStages * C::kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* empty = v_full + C::kStages;

  const int nq = (S + C::kBQ - 1) / C::kBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * C::kBQ;  // longest rows first
  const int bh = blockIdx.x;
  int nk = (S + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + C::kBQ - 1) / kBK + 1);  // no tile above the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, C::kNWG * kWarpgroup);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == C::kNWG) {  // the producer warp: lane 0 issues every load
    if (threadIdx.x == C::kNWG * kWarpgroup) {
      const int kv = bh / group;
      mbar_expect_tx(q_full, C::kQBytes);
      for (int g = 0; g < DP / 8; ++g) tma_load(qs + g * C::kBQ * 16, &tq, q_full, 8 * g, q0, bh);
      for (int t = 0; t < nk; ++t) {
        const int s = t % C::kStages;
        if (t >= C::kStages) mbar_wait(empty + s, ((t / C::kStages) - 1) & 1);
        mbar_expect_tx(k_full + s, C::kTileBytes);
        for (int g = 0; g < DP / 8; ++g)
          tma_load(ks + s * C::kTileBytes + g * kBK * 16, &tk, k_full + s, 8 * g, t * kBK, kv);
        mbar_expect_tx(v_full + s, C::kTileBytes);
        for (int g = 0; g < DP / 8; ++g)
          tma_load(vs + s * C::kTileBytes + g * kBK * 16, &tv, v_full + s, 8 * g, t * kBK, kv);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows q0 + 64 * wg + [0, 64)
  const int tid = threadIdx.x % kWarpgroup;
  const int lane = tid % 32;
  const int row_first = q0 + 64 * wg;
  const int row0 = row_first + 16 * (tid / 32) + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);                          // + 8 j + {0, 1}
  const uint32_t q_addr = smem_u32(qs) + 64 * wg * 16;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  float sc[32];  // S, then P, of the current tile
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int t = 0; t < nk; ++t) {
    const int s = t % C::kStages;
    const uint32_t parity = (t / C::kStages) & 1;
    const int k0 = t * kBK;
    // every key after every row of this warpgroup: the block's last tile
    if (causal && k0 > row_first + 63) break;
    mbar_wait(k_full + s, parity);

    const uint32_t k_addr = smem_u32(ks + s * C::kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma_ss_n64(sc, desc(q_addr + kk * 2 * C::kBQ * 16, C::kBQ * 16, 128),
                 desc(k_addr + kk * 2 * kBK * 16, kBK * 16, 128), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);

    const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > row_first);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[4 * j + 2 * i + c] * scale_log2;
          if (masked) {
            const int key = k0 + 8 * j + col0 + c;
            if (key >= S || (causal && key > row0 + 8 * i)) x = kNegInf;
          }
          sc[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(sc[4 * j + 2 * i + c] - m[i]);  // 0 where masked
          sc[4 * j + 2 * i + c] = p;
          l[i] += p;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j + 0] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    uint32_t p_hi[16], p_lo[16];  // k16 step s: registers 4 s .. 4 s + 3
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      split_bf16(sc[8 * st + 0], sc[8 * st + 1], p_hi[4 * st + 0], p_lo[4 * st + 0]);
      split_bf16(sc[8 * st + 2], sc[8 * st + 3], p_hi[4 * st + 1], p_lo[4 * st + 1]);
      split_bf16(sc[8 * st + 4], sc[8 * st + 5], p_hi[4 * st + 2], p_lo[4 * st + 2]);
      split_bf16(sc[8 * st + 6], sc[8 * st + 7], p_hi[4 * st + 3], p_lo[4 * st + 3]);
    }

    mbar_wait(v_full + s, parity);
    const uint32_t v_addr = smem_u32(vs + s * C::kTileBytes);
    fence_regs<DP / 2>(acc);
    fence_regs<16>(p_hi);
    fence_regs<16>(p_lo);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      // V's 16 keys of this step: two core matrices of 8 keys (128 bytes
      // apart) along K; 8-column boxes kBK * 16 bytes apart along N
#pragma unroll
      for (int n0 = 0; n0 + 64 <= DP; n0 += 64) {
        const uint64_t db = desc(v_addr + st * 256 + (n0 / 8) * kBK * 16, 128, kBK * 16);
        mma_rs_n64(acc + n0 / 2, p_hi + 4 * st, db);
        mma_rs_n64(acc + n0 / 2, p_lo + 4 * st, db);
      }
#pragma unroll
      for (int n0 = DP / 64 * 64; n0 < DP; n0 += 16) {
        const uint64_t db = desc(v_addr + st * 256 + (n0 / 8) * kBK * 16, 128, kBK * 16);
        mma_rs_n16(acc + n0 / 2, p_hi + 4 * st, db);
        mma_rs_n16(acc + n0 / 2, p_lo + 4 * st, db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<DP / 2>(acc);
    mbar_arrive(empty + s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<long long>(bh) * S + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * i] / denom, acc[4 * j + 2 * i + 1] / denom);
      }
    }
  }
}

// -- host -------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (heads, s, d) bf16, row-major, read as boxes of 8 columns x `rows` rows of
// one head; out-of-bounds columns and rows read as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, long long heads, long long s,
              long long d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d * 2),
                                 static_cast<cuuint64_t>(s * d * 2)};
  const cuuint32_t box[3] = {8, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, long long bh, long long bkv,
           int S, int D, cudaStream_t stream, int causal) {
  using C = Cfg<DP>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, bh, S, D, C::kBQ) || !make_map(encode, &tk, k, bkv, S, D, kBK) ||
      !make_map(encode, &tv, v, bkv, S, D, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((S + C::kBQ - 1) / C::kBQ));
  flash_fwd_wgmma<DP><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, D, static_cast<int>(bh / bkv), causal,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (bh, s, d), k/v (bkv, s, d), o (bh, s, d), all contiguous bf16 with
// 16-byte aligned bases.  Returns cudaErrorInvalidValue for shapes the kernel
// does not take (or a tensor map the driver refuses), cudaErrorNotSupported
// when the driver has no cuTensorMapEncodeTiled, else the launch's cudaError_t.
extern "C" int pax_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                         long long bh, long long bkv, long long s, long long d,
                                         int causal, void* stream) {
  if (bh <= 0 || bkv <= 0 || bh % bkv != 0 || bh > 0x7fffffffLL || s <= 0 ||
      (s + 63) / 64 > 65535 || d < 8 || d > kMaxD || d % 8 != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = static_cast<int>(s), D = static_cast<int>(d);
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 2: return launch<32>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 3: return launch<48>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 4: return launch<64>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 5: return launch<80>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 6: return launch<96>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 7: return launch<112>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 8: return launch<128>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 9: return launch<144>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 10: return launch<160>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 11: return launch<176>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 12: return launch<192>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 13: return launch<208>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 14: return launch<224>(q, k, v, o, bh, bkv, S, D, st, causal);
    case 15: return launch<240>(q, k, v, o, bh, bkv, S, D, st, causal);
    default: return launch<256>(q, k, v, o, bh, bkv, S, D, st, causal);
  }
}
