// Flash attention for Hopper (sm_90a), forward and backward, bound from Python
// with ctypes (repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_attn_kernel
// (launched by flash_attention_bhsd).  It computes the same function:
// softmax(q k^T / sqrt(dh)) v under the mask k < Skv & q < Sq & causal (k <= q)
// & window (k > q - window), with an fp32 running max m, denominator l and
// accumulator; fully masked rows give 0; query head h reads kv head h / (H / KV).
// (B, S, H, dh) is read and written in place through strides.
//
// What bounds it on an H100: Q K^T and P V do 4 * dh flops per unmasked (q, k)
// pair, against 2 bytes per element of Q, K, V and O read or written once.  The
// served batch of short prompts (B4 S512, dh 120) is bound by HBM bytes; the
// training step (B2 S2048) and the long prompt (B1 S5120, window 4096) by
// tensor-core operations.  Three kernels:
//  * attn_fwd_bf16_tma, the bf16 path of every shipped config.  Persistent:
//    one block per SM walks the (128-row q tile, head, batch) work items,
//    longest causal rows first.  Three warpgroups.  Warpgroup 0 gives up its
//    registers (setmaxnreg) and one of its threads issues TMA: an item's Q,
//    then its K and V tiles of 128 rows into a two-stage ring, each with its
//    own full / empty mbarrier pair, running ahead into the next item.  TMA
//    computes the addresses and swizzles rows by 128 bytes; rows past S
//    arrive as zeros.  Warpgroups 1 and 2 own 64 q rows each and run both
//    products on wgmma: S = Q K^T with both operands in shared memory, then
//    O += P V with P converted in registers from S's accumulator and V read
//    transposed from shared memory.  A step issues tile i's Q K^T and tile
//    i - 1's P V, then runs tile i's softmax while that P V is in flight; the
//    two warpgroups take turns to issue, so one's softmax also overlaps the
//    other's products.  The softmax keeps four independent max and sum chains
//    a row and uses ex2.approx.ftz.  kv tiles wholly outside the causal /
//    window band are never loaded and only tiles on the band's edges mask.
//    The output leaves through a shared-memory buffer by a TMA store that
//    clips rows past Sq, while the next item starts.  Two instances: LSE
//    false is the serving and prefill kernel; LSE true also writes each
//    row's log-sum-exp for the backward, in base 2 of the scaled scores as
//    its ex2 softmax has it, lse2 = log2 sum_k 2^(s_k scale log2 e) =
//    m scale log2 e + log2 l (natural lse = lse2 ln 2), -inf for a row that
//    sees no key.
//    Measured (scripts/flash_ablation_torch.py): at dh 120 the K and V
//    loads alone take about 80% of the kernel's time at B2 S2048, 1.7x
//    their time at dh 128: rows of 240 bytes sit across 128-byte lines.  A
//    second box that ran past dh (TMA fills those columns with zeros) was
//    2-5% slower overall, so for 64 < dh < 128 it ends at dh and repeats
//    columns dh - 64..63 of the first, which the kernel zeroes in Q.  The
//    mma.sync kernel below had every warp pull whole K and V tiles through
//    ldmatrix, bound by shared-memory bandwidth at half the tensor rate.
//  * attn_fwd_bf16_sync, for bf16 inputs TMA cannot describe (a data pointer
//    or stride not a multiple of 16 bytes, so any dh % 8 != 0): mma.sync
//    m16n8k16, four warps of 16 q rows, a two-stage cp.async ring, ldmatrix.
//  * attn_fwd_f32, fp32 FMA on CUDA cores, no TF32, for the fp32 checks.
// The mma.sync and fp32 kernels also compute the reference's attn_accum_bf16
// mode (src/repro/models/layers.py::chunked_attention with accum_bf16), for a
// Params::accum_chunk > 0, in their ACC_BF16 instances: P and V are rounded
// to bf16 and P V accumulates in fp32 within a KV chunk of accum_chunk rows;
// at each chunk's end that partial sum is rounded to bf16 and folded into a
// bf16 accumulator, acc = bf16(bf16(acc * bf16(f)) + bf16(partial)), f the
// rescale from the previous fold's row max; m and l stay fp32.  A chunk
// boundary inside a KV tile (or an mma k-step) splits its keys by a mask.  The
// row max moves per tile, not per chunk as in the reference, so P is rounded
// at another scale and the result is not bit-equal to the plain version.  The
// ACC_BF16 = false instances are the fp32-accumulating kernels unchanged.
// It is a numerics mode, not a speed path: the TMA kernel has no such mode.
//
// Backward of the TMA forward, three kernels.  The TPU kernel has no backward
// (the reference trains through jax.grad of its chunked jnp form); these
// replace that recomputed, differentiated form on the card.  Work: five
// products of 2 dh flops a visible (q, k) pair and query head (S, dP, dV, dK,
// dQ: 2.5 times the forward's), against q, k, v, o, dO read and dq, dk, dv
// written once in bf16 and an fp32 dQ accumulator: bound by tensor-core
// operations at the training shapes.
//  * attn_bwd_prep: D = rowsum(dO o O) in fp32, and the dQ accumulator zeroed.
//  * attn_bwd_main: one block a (batch, kv head, 128-key tile), in key-tile
//    order so a causal band's longest blocks start first; K and V stay in
//    shared memory, dK and dV accumulate in fp32 registers over the q tiles
//    of 64 rows the band touches and the G query heads of the kv head, so
//    they are written once with no reduction pass.  The producer warp
//    streams Q, dO (TMA) and lse, D (bulk copies) through a two-stage ring.
//    Two consumer warpgroups own 64 keys each and recompute S^T = K Q^T and
//    dP^T = V dO^T on wgmma, form P^T = exp2(S^T scale log2 e - lse2) and
//    dS^T = P^T (dP^T - D) in registers (only tiles on the band's edges
//    mask), and accumulate dV += P^T dO and dK += dS^T Q on wgmma with P^T
//    and dS^T rounded to bf16 as register operands (as the forward rounds
//    P).  dS^T goes to shared memory in bf16; once both warpgroups wrote
//    theirs, dQ = dS K over the tile's 128 keys runs on wgmma (dh <= 64: the
//    warpgroups take turns; else each owns a 64-column half) and is added to
//    the fp32 accumulator with float2 atomics, whose order varies from run
//    to run.  Instances for dh <= 64 (64-wide tiles) and dh <= 128 (two
//    64-column halves; past dh TMA fills zeros).
//  * attn_bwd_dq: dq = scale x the accumulator, in bf16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;   // q rows per block
constexpr int BN = 64;   // kv rows per tile
constexpr int DP = 128;  // head_dim as padded in shared memory

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, KV, dh;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window;  // window < 0: no window
  float scale;
  int vec;  // every row start is 16-byte aligned: load 16 bytes at a time
  int col2;  // TMA kernel: first column of a tile's second 64-column box
  int accum_chunk;  // mma.sync / fp32 kernels: > 0 for bf16 accumulation over
                    // KV chunks of this many rows (ACC_BF16), 0 for fp32
  float* lse;       // TMA kernel's LSE instance: (B, H, lse_sp) fp32, lse_sp >= Sq a
  int lse_sp;       // multiple of 128 (rows past Sq get -inf)
};

// (Params or BwdParams)
template <typename P>
__device__ __forceinline__ bool allowed(const P& p, int qp, int kp) {
  return kp < p.Skv && qp < p.Sq && (!p.causal || kp <= qp) &&
         (p.window < 0 || kp > qp - p.window);
}

// kv tiles [t0, t1) of KN rows that hold at least one position the q tile of
// QM rows at q0 may see.
template <int QM, int KN>
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int& t0, int& t1) {
  int lo = 0, hi = p.Skv;
  if (p.causal) hi = min(hi, q0 + QM);
  if (p.window >= 0) lo = max(lo, q0 - p.window + 1);
  t0 = lo / KN;
  t1 = hi > lo ? (hi + KN - 1) / KN : t0;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One element of the bf16 accumulator at a chunk's end:
// bf16(bf16(acc * fb) + bf16(part)), fb the rescale already rounded to bf16.
__device__ __forceinline__ float fold_bf16(float acc, float fb, float part) {
  return bf16_round(bf16_round(acc * fb) + bf16_round(part));
}

// The rescale of a fold, in bf16: 2^(mb - m) (exp(mb - m) when natural) from
// the previous fold's row max mb to the running max m; 0 before any key.
template <bool BASE2>
__device__ __forceinline__ float fold_scale(float mb, float m) {
  return mb == -INFINITY ? 0.f : bf16_round(BASE2 ? exp2f(mb - m) : expf(mb - m));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __ushort_as_bfloat16(0); }

// Copies rows [row0, row0 + ROWS) of one (S, dh) head slice with row stride ss
// into shared memory (row stride LD, DP columns); rows >= nrows and columns
// >= dh are zero.
template <typename T, int ROWS, int LD, int NT>
__device__ __forceinline__ void load_tile(T* sm, const T* g, long long ss, int row0,
                                          int nrows, int dh, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = DP / VEC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * VEC, gr = row0 + r;
    T* dst = sm + r * LD + c;
    if (vec && gr < nrows && c + VEC <= dh) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(g + gr * ss + c);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        dst[j] = (gr < nrows && c + j < dh) ? g[gr * ss + c + j] : zero<T>();
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 through mma.sync, for inputs the TMA kernel cannot take
// ---------------------------------------------------------------------------
constexpr int LDH = DP + 8;  // 272-byte rows: ldmatrix rows hit 32 distinct banks
constexpr int NT_BF16 = 128;
constexpr int STAGES = 2;    // K/V tiles in flight: load tile t+1 while computing t
constexpr size_t SMEM_BF16 = size_t(2 * STAGES * BN) * LDH * sizeof(bf16);
static_assert(BM <= BN, "the Q tile borrows the K buffer of stage 1");

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte global -> shared copy that bypasses registers; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr))
               : "memory");
}

// Starts the copy of a bf16 tile (as load_tile) with cp.async when every row
// start is 16-byte aligned and dh % 8 == 0; otherwise copies it synchronously.
template <int ROWS>
__device__ __forceinline__ void load_tile_bf16(bf16* sm, const bf16* g, long long ss, int row0,
                                               int nrows, int dh, int vec) {
  if (!vec) {
    load_tile<bf16, ROWS, LDH, NT_BF16>(sm, g, ss, row0, nrows, dh, 0);
    return;
  }
  constexpr int CPR = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT_BF16) {
    const int r = i / CPR, c = (i % CPR) * 8, gr = row0 + r;
    const bool ok = gr < nrows && c < dh;
    cp_async16(sm + r * LDH + c, ok ? g + gr * ss + c : g, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bits of a packed pair of bf16 P values (keys key and key + 1) whose
// keys lie in [lo, hi); the others zeroed.
__device__ __forceinline__ uint32_t keep_keys(uint32_t w, int key, int lo, int hi) {
  const uint32_t lo_half = key >= lo && key < hi ? 0x0000ffffu : 0u;
  const uint32_t hi_half = key + 1 >= lo && key + 1 < hi ? 0xffff0000u : 0u;
  return w & (lo_half | hi_half);
}

// Fragment layout of m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16x16, row): a0 (g, 2c..2c+1)  a1 (g+8, 2c..)  a2 (g, 2c+8..)  a3 (g+8, 2c+8..)
//   B (16x8, col):  b0 (k 2c..2c+1, n g)  b1 (k 2c+8..2c+9, n g)
//   C (16x8):       c0,c1 (g, 2c..2c+1)   c2,c3 (g+8, 2c..2c+1)
// K tiles are stored [kv][d], so ldmatrix gives Q K^T's B fragments as they are;
// V tiles are stored [kv][d] too, and ldmatrix.trans gives P V's.
// 68 KB of shared memory and at most 168 registers a thread let 3 blocks share
// an SM; the ACC_BF16 instance (a bf16 accumulator beside the fp32 one) 2.
template <bool ACC_BF16>
__global__ void __launch_bounds__(NT_BF16, ACC_BF16 ? 2 : 3) attn_fwd_bf16_sync(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* KVs = reinterpret_cast<bf16*>(smem);  // stage s: K tile at 2 s BN LDH, then V
  bf16* Qs = KVs + 2 * BN * LDH;  // stage 1's K buffer, free until tile t0 + 1 loads

  const int n_qt = (p.Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - blockIdx.x) * BM;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  auto load_kv = [&](int t, int stage) {
    bf16* ks = KVs + stage * 2 * BN * LDH;
    load_tile_bf16<BN>(ks, kg, p.k_ss, t * BN, p.Skv, p.dh, p.vec);
    load_tile_bf16<BN>(ks + BN * LDH, vg, p.v_ss, t * BN, p.Skv, p.dh, p.vec);
  };

  int t0, t1;
  kv_tiles<BM, BN>(p, q0, t0, t1);
  load_tile_bf16<BM>(Qs, qg, p.q_ss, q0, p.Sq, p.dh, p.vec);
  cp_async_commit();
  if (t0 < t1) load_kv(t0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; tile t0 may still be in flight
  __syncthreads();  // (the loop's first barrier keeps Qs intact until all read it)

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const bf16* a = Qs + r0 * LDH + ks * 16 + 2 * c;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(a);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(a + 8 * LDH);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(a + 8);
    qf[ks][3] = *reinterpret_cast<const uint32_t*>(a + 8 * LDH + 8);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, base-2 units
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the denominator
  const float sl2 = p.scale * 1.4426950408889634f;
  const int qp0 = q0 + r0, qp1 = qp0 + 8;
  // ACC_BF16: acc holds the current chunk's partial sum, ab the bf16
  // accumulator (rows r0 and r0 + 8, columns 2c, 2c + 1 of each d-tile),
  // relative to the row maxima mb0, mb1 of the last fold
  [[maybe_unused]] __nv_bfloat162 ab[ACC_BF16 ? DP / 8 : 1][2];
  [[maybe_unused]] float mb0 = -INFINITY, mb1 = -INFINITY;
  if constexpr (ACC_BF16) {
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) ab[dn][0] = ab[dn][1] = __floats2bfloat162_rn(0.f, 0.f);
  }
  [[maybe_unused]] auto fold = [&]() {
    if constexpr (ACC_BF16) {
      const float f0 = fold_scale<true>(mb0, m0), f1 = fold_scale<true>(mb1, m1);
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        const float2 a0 = __bfloat1622float2(ab[dn][0]), a1 = __bfloat1622float2(ab[dn][1]);
        ab[dn][0] = __floats2bfloat162_rn(fold_bf16(a0.x, f0, acc[dn][0]),
                                          fold_bf16(a0.y, f0, acc[dn][1]));
        ab[dn][1] = __floats2bfloat162_rn(fold_bf16(a1.x, f1, acc[dn][2]),
                                          fold_bf16(a1.y, f1, acc[dn][3]));
        acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
      }
      mb0 = m0;
      mb1 = m1;
    }
  };

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % STAGES;
    __syncthreads();  // every warp is done with tile t - 1, whose stage is refilled next
    if (t + 1 < t1) load_kv(t + 1, st ^ 1);
    cp_async_commit();   // an empty group at the last tile keeps the count uniform
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const bf16* Ks = KVs + st * 2 * BN * LDH;
    const bf16* Vs = Ks + BN * LDH;

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < DP / 32; ++kp) {
        uint32_t kb[4];  // b0, b1 of k-steps 2kp and 2kp + 1
        ldsm_x4(kb, Ks + (nt * 8 + (lane & 7)) * LDH + kp * 32 + (lane >> 3) * 8);
        mma_bf16(s[nt], qf[2 * kp], kb[0], kb[1]);
        mma_bf16(s[nt], qf[2 * kp + 1], kb[2], kb[3]);
      }
    }

    // Only tiles that cross the diagonal, the window's edge or a sequence end
    // need the element mask.
    const int k0 = t * BN;
    const bool edge = k0 + BN > p.Skv || q0 + BM > p.Sq || (p.causal && k0 + BN - 1 > q0) ||
                      (p.window >= 0 && k0 <= q0 + BM - 1 - p.window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + nt * 8 + 2 * c + j;
        s[nt][j] = (!edge || allowed(p, qp0, kp)) ? s[nt][j] * sl2 : -INFINITY;
        s[nt][2 + j] = (!edge || allowed(p, qp1, kp)) ? s[nt][2 + j] * sl2 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
    // a row's 64 scores sit in the 4 lanes of one quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;  // fully masked so far
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = m0 == -INFINITY ? 0.f : exp2f(m0 - ms0);
    const float corr1 = m1 == -INFINITY ? 0.f : exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = exp2f(s[nt][j] - ms0);  // masked: exp2(-inf) = 0
        s[nt][2 + j] = exp2f(s[nt][2 + j] - ms1);
        rs0 += s[nt][j];
        rs1 += s[nt][2 + j];
      }
    }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      acc[dn][0] *= corr0;
      acc[dn][1] *= corr0;
      acc[dn][2] *= corr1;
      acc[dn][3] *= corr1;
    }

    // O += P V: the C fragments of S tiles 2j, 2j+1 are the A fragment of k-step j
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t a[4] = {pack_f32(s[2 * j][0], s[2 * j][1]),
                             pack_f32(s[2 * j][2], s[2 * j][3]),
                             pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
      auto pv = [&](const uint32_t (&pa)[4]) {
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t vb[4];  // b0, b1 of d-tiles 2dp and 2dp + 1
          ldsm_x4_t(vb, Vs + (j * 16 + (lane & 15)) * LDH + (2 * dp + (lane >> 4)) * 8);
          mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      };
      if constexpr (!ACC_BF16) {
        pv(a);
      } else {
        // the k-step's 16 keys in segments between chunk boundaries; a
        // segment ending on a boundary folds (the same for the whole warp)
        const int kb = k0 + 16 * j;
        for (int lo = kb; lo < kb + 16;) {
          const int nb = (lo / p.accum_chunk + 1) * p.accum_chunk;
          const int hi = min(nb, kb + 16);
          if (lo == kb && hi == kb + 16) {
            pv(a);
          } else {
            const uint32_t am[4] = {keep_keys(a[0], kb + 2 * c, lo, hi),
                                    keep_keys(a[1], kb + 2 * c, lo, hi),
                                    keep_keys(a[2], kb + 2 * c + 8, lo, hi),
                                    keep_keys(a[3], kb + 2 * c + 8, lo, hi)};
            pv(am);
          }
          if (hi == nb) fold();
          lo = hi;
        }
      }
    }
  }
  if constexpr (ACC_BF16) fold();  // the last chunk's partial sum

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = dn * 8 + 2 * c + j;
      if (d < p.dh) {
        float o0 = acc[dn][j], o1 = acc[dn][2 + j];
        if constexpr (ACC_BF16) {
          const float2 a0 = __bfloat1622float2(ab[dn][0]), a1 = __bfloat1622float2(ab[dn][1]);
          o0 = j ? a0.y : a0.x;
          o1 = j ? a1.y : a1.x;
        }
        if (qp0 < p.Sq) og[qp0 * p.o_ss + d] = __float2bfloat16(o0 * inv0);
        if (qp1 < p.Sq) og[qp1 * p.o_ss + d] = __float2bfloat16(o1 * inv1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA into an mbarrier ring, wgmma for both products, one
// producer warpgroup beside two consumer warpgroups (see the note at the top).
//
// Shared memory, every tile in 64-column halves of 128-byte rows as TMA's
// 128-byte swizzle lays them out (16-byte piece j of row r at piece j ^ r % 8):
//   Q   [half][BM_T rows][64]         32 KB, one work item's
//   O   [half][BM_T rows][64]         32 KB, the output on its way to a TMA store
//   K_s [half][BN_T rows][64]         32 KB a stage
//   V_s [half][BN_T rows][64]         32 KB a stage
//   mbarriers: Q full, Q empty; per stage K full, K empty, V full, V empty
// ---------------------------------------------------------------------------
constexpr int BM_T = 128;  // q rows per block: 64 per consumer warpgroup
constexpr int BN_T = 128;  // kv rows per tile
constexpr int STAGES_T = 2;
constexpr int NT_T = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int HALF_Q = BM_T * 128;   // bytes of a 64-column half of the Q tile
constexpr int HALF_KV = BN_T * 128;  // ... of a K or V tile
constexpr int OFF_O = 2 * HALF_Q;
constexpr int OFF_K = 4 * HALF_Q;    // stage s: K at OFF_K + 4 s HALF_KV, V after it
constexpr int OFF_BAR = OFF_K + 4 * STAGES_T * HALF_KV;
constexpr size_t SMEM_T = OFF_BAR + 8 * (2 + 4 * STAGES_T) + 1024;  // + alignment slack
enum { K_FULL, K_EMPTY, V_FULL, V_EMPTY };

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// 2^x on the special-function unit, subnormal results flushed to 0; 2^-inf = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Box (64 columns, 1 head, rows, 1 batch) at (col, head, row, batch) -> shared
// memory, completing on `bar`.  Columns past dh and rows past S arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}
// Shared memory -> the box at (col, head, row, batch); columns past dh and
// rows past S are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int head,
                                          int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma operand descriptor of a 128-byte-swizzled tile: start address, leading
// and stride byte offsets (16-byte units), layout 1 = 128-byte swizzle.
// K-major (Q, K): 8-row groups 1024 bytes apart; a k-step of 16 moves the
// start 32 bytes inside the 128-byte row.  MN-major (V): 8-row groups of kv
// 1024 bytes apart (stride), the two 64-column halves HALF_KV apart (leading).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         uint64_t(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across an
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, fp32) = A B (scale_d 0) or D + A B (scale_d 1): A 64 x 16 and B
// 16 x 128, both bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A B: A 64 x 16 bf16 in registers (the mma.sync A
// fragment layout, warp w holding rows 16w..16w+15), B 16 x 128 bf16 in
// shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Online softmax of one kv tile at k0 for the thread's rows qp0 and qp1 (of
// the warpgroup's 64 at qc): masks the raw scores sc (tiles on the band's
// edges only), updates the running max m and the thread's share of the
// denominator l, replaces sc by exp2 of the scaled scores (P), and returns in
// corr the factors that rescale the accumulator.  Maxima and sums run as four
// independent chains a row, so two warps a scheduler keep it busy.
__device__ __forceinline__ void online_softmax(float (&sc)[64], const Params& p, int k0, int qc,
                                               int qp0, int qp1, int c, float sl2, float& m0,
                                               float& m1, float& l0, float& l1, float& corr0,
                                               float& corr1) {
  if (k0 + BN_T > p.Skv || qc + 64 > p.Sq || (p.causal && k0 + BN_T - 1 > qc) ||
      (p.window >= 0 && k0 <= qc + 63 - p.window)) {
    // row qp sees kv positions lo..hi (allowed() as an interval)
    auto hi = [&](int qp) {
      return qp >= p.Sq ? -1 : p.causal ? min(qp, p.Skv - 1) : p.Skv - 1;
    };
    auto lo = [&](int qp) { return p.window >= 0 ? qp - p.window + 1 : 0; };
    const int lo0 = lo(qp0), hi0 = hi(qp0), lo1 = lo(qp1), hi1 = hi(qp1);
#pragma unroll
    for (int n = 0; n < BN_T / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + n * 8 + 2 * c + j;
        if (kp < lo0 || kp > hi0) sc[4 * n + j] = -INFINITY;
        if (kp < lo1 || kp > hi1) sc[4 * n + 2 + j] = -INFINITY;
      }
    }
  }
  float x0[4], x1[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) x0[a] = x1[a] = -INFINITY;
#pragma unroll
  for (int n = 0; n < BN_T / 8; ++n) {
    x0[n % 4] = fmaxf(x0[n % 4], fmaxf(sc[4 * n], sc[4 * n + 1]));
    x1[n % 4] = fmaxf(x1[n % 4], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  float mx0 = fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3]));
  float mx1 = fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3]));
  // a row's 128 scores sit in the 4 lanes of one quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0 * sl2;  // fully masked so far
  const float ms1 = mn1 == -INFINITY ? 0.f : mn1 * sl2;
  corr0 = m0 == -INFINITY ? 0.f : exp2_ftz(fmaf(m0, sl2, -ms0));
  corr1 = m1 == -INFINITY ? 0.f : exp2_ftz(fmaf(m1, sl2, -ms1));
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int a = 0; a < 4; ++a) x0[a] = x1[a] = 0.f;
#pragma unroll
  for (int n = 0; n < BN_T / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[4 * n + j] = exp2_ftz(fmaf(sc[4 * n + j], sl2, -ms0));  // masked: exp2(-inf) = 0
      sc[4 * n + 2 + j] = exp2_ftz(fmaf(sc[4 * n + 2 + j], sl2, -ms1));
    }
    x0[n % 4] += sc[4 * n] + sc[4 * n + 1];
    x1[n % 4] += sc[4 * n + 2] + sc[4 * n + 3];
  }
  l0 = l0 * corr0 + ((x0[0] + x0[1]) + (x0[2] + x0[3]));
  l1 = l1 * corr1 + ((x1[0] + x1[1]) + (x1[2] + x1[3]));
}

// P (fp32, the layout of a Q K^T accumulator) as bf16 A fragments of P V:
// the scores of kv columns 16k..16k+15 are k-step k's fragment.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[BN_T / 16][4]) {
#pragma unroll
  for (int n = 0; n < BN_T / 8; ++n) {
    pa[n / 2][2 * (n % 2)] = pack_f32(sc[4 * n], sc[4 * n + 1]);
    pa[n / 2][2 * (n % 2) + 1] = pack_f32(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

// Fragment layout of a 64 x 128 fp32 wgmma accumulator d (warp w of the
// warpgroup, g = lane / 4, c = lane % 4): d[4n + j] is (row 16w + g, column
// 8n + 2c + j) and d[4n + 2 + j] is (row 16w + g + 8, same column), j = 0, 1.
// So the scores of kv columns 16i..16i+15 are, packed to bf16 pairs, the A
// fragment of P V's k-step i.
template <bool LSE>
__global__ void __launch_bounds__(NT_T, 1)
    attn_fwd_bf16_tma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, Params p, int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (sm - raw);
  const uint32_t q_full = sm + OFF_BAR, q_empty = q_full + 8;
  auto bar = [&](int kind, int s) { return sm + OFF_BAR + 8 * (2 + 4 * s + kind); };
  auto k_tile = [&](int s) { return sm + OFF_K + 4 * s * HALF_KV; };
  auto parity = [](int i) { return uint32_t(i / STAGES_T) & 1; };  // of ring slot i

  // Work item w is a (q tile, head, batch); items run longest causal rows
  // first, heads fastest, and block x takes items x, x + gridDim.x, ...
  const int n_qt = (p.Sq + BM_T - 1) / BM_T;
  struct Item {
    int q0, h, b, t0, t1;
  };
  auto item = [&](int w) {
    Item it;
    const int rest = w % (n_items / n_qt);
    it.q0 = (n_qt - 1 - w / (n_items / n_qt)) * BM_T;
    it.h = rest % p.H;
    it.b = rest / p.H;
    kv_tiles<BM_T, BN_T>(p, it.q0, it.t0, it.t1);
    return it;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);  // one arrival from each consumer warpgroup
    for (int s = 0; s < STAGES_T; ++s) {
      mbar_init(bar(K_FULL, s), 1);
      mbar_init(bar(V_FULL, s), 1);
      mbar_init(bar(K_EMPTY, s), 2);
      mbar_init(bar(V_EMPTY, s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full, running ahead into the next
    // item; the warpgroup gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int slot = 0;  // ring slots filled so far
      for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
        const Item it = item(w);
        const int kvh = it.h / (p.H / p.KV);
        mbar_wait(q_empty, (j & 1) ^ 1);  // the previous item's Q K^T are done
        mbar_expect_tx(q_full, 2 * HALF_Q);
        tma_load(sm, &tq, q_full, 0, it.h, it.q0, it.b);
        tma_load(sm + HALF_Q, &tq, q_full, p.col2, it.h, it.q0, it.b);
        for (int t = it.t0; t < it.t1; ++t, ++slot) {
          const int s = slot % STAGES_T;
          const uint32_t ph = parity(slot), ks = k_tile(s), vs = ks + 2 * HALF_KV;
          mbar_wait(bar(K_EMPTY, s), ph ^ 1);  // the first round passes at once
          mbar_expect_tx(bar(K_FULL, s), 2 * HALF_KV);
          tma_load(ks, &tk, bar(K_FULL, s), 0, kvh, t * BN_T, it.b);
          tma_load(ks + HALF_KV, &tk, bar(K_FULL, s), p.col2, kvh, t * BN_T, it.b);
          mbar_wait(bar(V_EMPTY, s), ph ^ 1);
          mbar_expect_tx(bar(V_FULL, s), 2 * HALF_KV);
          tma_load(vs, &tv, bar(V_FULL, s), 0, kvh, t * BN_T, it.b);
          tma_load(vs + HALF_KV, &tv, bar(V_FULL, s), p.col2, kvh, t * BN_T, it.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: q rows 64 cw.. of a tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int rt = cw * 64 + warp * 16 + g;  // this thread's rows of the Q tile: rt, rt + 8
    const uint32_t qa = sm + cw * (HALF_Q / 2);  // this warpgroup's rows of each Q half
    const uint32_t oa = qa + OFF_O;              // ... and of each O half
    const float sl2 = p.scale * 1.4426950408889634f;
    float o[64], sc[64];
    uint32_t pa[BN_T / 16][4];  // P of the tile whose P V is next

    // S = Q K^T of ring slot i over dh padded to 128: 8 k-steps, 4 in each
    // 64-column half
    auto issue_qk = [&](int i) {
      const uint32_t ks = k_tile(i % STAGES_T);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss(sc, sw128_desc(qa + (kk / 4) * HALF_Q + (kk % 4) * 32, 16, 1024),
                 sw128_desc(ks + (kk / 4) * HALF_KV + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
    };
    // O += P V of ring slot i: P from registers, V read transposed from shared memory
    auto issue_pv = [&](int i) {
      const uint32_t vs = k_tile(i % STAGES_T) + 2 * HALF_KV;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN_T / 16; ++kk)
        wgmma_rs(o, pa[kk], sw128_desc(vs + kk * 16 * 128, HALF_KV, 1024));
      wgmma_commit();
    };

    if (cw == 1) bar_arrive(3, 256);  // the first warpgroup issues first
    int slot = 0;  // ring slot of the item's first kv tile
    for (int w = blockIdx.x, j = 0; w < n_items; w += gridDim.x, ++j) {
      const Item it = item(w);
      const int qc = it.q0 + cw * 64, qp0 = it.q0 + rt, qp1 = qp0 + 8;
      const int n_t = it.t1 - it.t0;
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;  // running max of the raw scores
      float l0 = 0.f, l1 = 0.f;              // this thread's share of the denominator
      float corr0 = 0.f, corr1 = 0.f;
      auto rescale = [&]() {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          o[4 * n] *= corr0;
          o[4 * n + 1] *= corr0;
          o[4 * n + 2] *= corr1;
          o[4 * n + 3] *= corr1;
        }
      };

      // Step i issues tile i's Q K^T and tile i - 1's P V, then runs tile i's
      // softmax while that P V is in flight.  The two warpgroups take turns
      // to issue (ping-pong), so one's softmax overlaps the other's products.
      mbar_wait(q_full, j & 1);
      if (p.col2 < 64) {
        // the second box repeats columns col2..63 of the first: zero them in
        // this warpgroup's rows of Q, so Q K^T counts them once
        const int chunks = (64 - p.col2) / 8;
        for (int x = tid; x < 64 * chunks; x += 128) {
          const int r = cw * 64 + x / chunks;
          *reinterpret_cast<uint4*>(smem + HALF_Q + r * 128 + (((x % chunks) ^ (r & 7)) << 4)) =
              make_uint4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      }
      if (n_t == 0 && tid == 0) mbar_arrive(q_empty);
      if (n_t > 0) {
        bar_sync(3 + cw, 256);
        mbar_wait(bar(K_FULL, slot % STAGES_T), parity(slot));
        issue_qk(slot);
        bar_arrive(4 - cw, 256);
        wgmma_wait<0>();
        fence_regs(sc);
        if (tid == 0) {
          mbar_arrive(bar(K_EMPTY, slot % STAGES_T));
          if (n_t == 1) mbar_arrive(q_empty);  // Q may take the next item's
        }
        online_softmax(sc, p, it.t0 * BN_T, qc, qp0, qp1, c, sl2, m0, m1, l0, l1, corr0, corr1);
        pack_p(sc, pa);
      }
      for (int i = 1; i < n_t; ++i) {
        const int s = (slot + i) % STAGES_T, sp = (slot + i - 1) % STAGES_T;
        bar_sync(3 + cw, 256);
        mbar_wait(bar(K_FULL, s), parity(slot + i));
        issue_qk(slot + i);
        rescale();  // to tile i - 1's running max, while Q K^T runs
        mbar_wait(bar(V_FULL, sp), parity(slot + i - 1));
        issue_pv(slot + i - 1);
        bar_arrive(4 - cw, 256);
        wgmma_wait<1>();  // Q K^T of tile i has landed; P V of tile i - 1 runs on
        fence_regs(sc);
        if (tid == 0) {
          mbar_arrive(bar(K_EMPTY, s));
          if (i == n_t - 1) mbar_arrive(q_empty);
        }
        online_softmax(sc, p, (it.t0 + i) * BN_T, qc, qp0, qp1, c, sl2, m0, m1, l0, l1, corr0,
                       corr1);
        wgmma_wait<0>();
        fence_regs(o);
        if (tid == 0) mbar_arrive(bar(V_EMPTY, sp));
        pack_p(sc, pa);
      }
      if (n_t > 0) {
        const int s = (slot + n_t - 1) % STAGES_T;
        bar_sync(3 + cw, 256);
        rescale();
        mbar_wait(bar(V_FULL, s), parity(slot + n_t - 1));
        issue_pv(slot + n_t - 1);
        bar_arrive(4 - cw, 256);
        wgmma_wait<0>();
        fence_regs(o);
        if (tid == 0) mbar_arrive(bar(V_EMPTY, s));
      }
      slot += n_t;

      // epilogue: O / l in bf16 into this warpgroup's rows of the O buffer,
      // once the previous item's store has read them, then one TMA store of
      // each half, left to finish while the next item runs
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
      if constexpr (LSE) {
        // each row's log2-sum-exp2 of its scaled scores, -inf where no key is allowed
        if (c == 0) {
          float* lr = p.lse + (long long)(it.b * p.H + it.h) * p.lse_sp + it.q0 + rt;
          lr[0] = m0 == -INFINITY ? -INFINITY : m0 * sl2 + log2f(l0);
          lr[8] = m1 == -INFINITY ? -INFINITY : m1 * sl2 + log2f(l1);
        }
      }
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        unsigned char* row = smem + OFF_O + (n / 8) * HALF_Q + ((((n % 8) ^ g) << 4) | (c * 4));
        *reinterpret_cast<uint32_t*>(row + rt * 128) =
            pack_f32(o[4 * n] * inv0, o[4 * n + 1] * inv0);
        *reinterpret_cast<uint32_t*>(row + (rt + 8) * 128) =
            pack_f32(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if (tid == 0 && qc < p.Sq) {
        tma_store(&to, oa, 0, it.h, qc, it.b);
        tma_store(&to, oa + HALF_Q, p.col2, it.h, qc, it.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMA.  Thread (rg, cg) = (tid / 16, tid % 16) owns q rows
// 4rg..4rg+3, score columns cg + 16j and output columns cg + 16e.
// ---------------------------------------------------------------------------
constexpr int LDF = DP + 4;
constexpr int LDP = BN + 1;
constexpr int NT_F32 = 256;
constexpr size_t SMEM_F32 = (size_t(BM + 2 * BN) * LDF + size_t(BM) * LDP) * sizeof(float);

template <bool ACC_BF16>
__global__ void __launch_bounds__(NT_F32) attn_fwd_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BM * LDF;
  float* Vs = Ks + BN * LDF;
  float* Ps = Vs + BN * LDF;

  const int n_qt = (p.Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KV);
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile<float, BM, LDF, NT_F32>(Qs, qg, p.q_ss, q0, p.Sq, p.dh, p.vec);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * DP; i += NT_F32) Qs[(i / DP) * LDF + i % DP] *= p.scale;

  // ACC_BF16: acc holds the current chunk's partial sum, accb the bf16
  // accumulator relative to the row maxima mb of the last fold
  float acc[4][DP / 16], m[4], l[4];
  [[maybe_unused]] float accb[4][ACC_BF16 ? DP / 16 : 1], mb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    mb[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DP / 16; ++e) acc[i][e] = 0.f;
    if constexpr (ACC_BF16) {
#pragma unroll
      for (int e = 0; e < DP / 16; ++e) accb[i][e] = 0.f;
    }
  }
  [[maybe_unused]] auto fold = [&]() {
    if constexpr (ACC_BF16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float f = fold_scale<false>(mb[i], m[i]);
#pragma unroll
        for (int e = 0; e < DP / 16; ++e) {
          accb[i][e] = fold_bf16(accb[i][e], f, acc[i][e]);
          acc[i][e] = 0.f;
        }
        mb[i] = m[i];
      }
    }
  };

  int t0, t1;
  kv_tiles<BM, BN>(p, q0, t0, t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // Q scaled; previous K, V and P fully read
    load_tile<float, BN, LDF, NT_F32>(Ks, kg, p.k_ss, k0, p.Skv, p.dh, p.vec);
    load_tile<float, BN, LDF, NT_F32>(Vs, vg, p.v_ss, k0, p.Skv, p.dh, p.vec);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * rg + i) * LDF + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 16 * j) * LDF + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * rg + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!allowed(p, qp, k0 + cg + 16 * j)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - ms);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - ms);  // masked: exp(-inf) = 0
        Ps[(4 * rg + i) * LDP + cg + 16 * j] = ACC_BF16 ? bf16_round(pv) : pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < DP / 16; ++e) acc[i][e] *= corr;
    }
    __syncthreads();  // P complete

    // ACC_BF16: the next chunk boundary after this tile's first key
    [[maybe_unused]] int nb = ACC_BF16 ? (k0 / p.accum_chunk + 1) * p.accum_chunk : 0;
    for (int kk = 0; kk < BN; ++kk) {
      float pv[4], vv[DP / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * rg + i) * LDP + kk];
#pragma unroll
      for (int e = 0; e < DP / 16; ++e)
        vv[e] = ACC_BF16 ? bf16_round(Vs[kk * LDF + cg + 16 * e]) : Vs[kk * LDF + cg + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DP / 16; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
      if constexpr (ACC_BF16) {
        if (k0 + kk + 1 == nb) {  // a chunk ends after this key
          fold();
          nb += p.accum_chunk;
        }
      }
    }
  }
  if constexpr (ACC_BF16) fold();  // the last chunk's partial sum

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * rg + i;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    if (qp < p.Sq) {
#pragma unroll
      for (int e = 0; e < DP / 16; ++e) {
        const int d = cg + 16 * e;
        if constexpr (ACC_BF16) {
          if (d < p.dh) og[qp * p.o_ss + d] = accb[i][e] * inv;
        } else {
          if (d < p.dh) og[qp * p.o_ss + d] = acc[i][e] * inv;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward on TMA and wgmma (attn_bwd_*; see the note at the top).  Shared
// memory of attn_bwd_main, 64-column halves of 128-byte swizzled rows as in
// the forward, DH2 halves a head (1 for dh <= 64, 2 for dh <= 128):
//   K, V  [half][BK_B keys][64]          the block's tiles, loaded once
//   dS^T  [2][BK_B keys][64 q]           two buffers, alternate steps
//   ring  [stage]: Q, dO [half][BQ_B rows][64]
//   stat  [stage]: lse[BQ_B], D[BQ_B]    fp32
//   mbarriers: K/V full; per stage full, empty
// ---------------------------------------------------------------------------
constexpr int BQ_B = 64;       // q rows a step of the backward's loop
constexpr int BK_B = 128;      // keys a block owns: 64 per consumer warpgroup
constexpr int STAGES_B = 2;    // (Q, dO, lse, D) tiles in flight
constexpr int NT_B = 384;      // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int NT_PASS = 256;   // the prep and dQ passes

template <int DH2>
struct BwdSmem {
  static constexpr int HALF_K = BK_B * 128;  // a 64-column half of the K or V tile
  static constexpr int HALF_Q = BQ_B * 128;  // ... of a Q or dO tile
  static constexpr int OFF_V = DH2 * HALF_K;
  static constexpr int OFF_DS = 2 * DH2 * HALF_K;
  static constexpr int OFF_RING = OFF_DS + 2 * BK_B * 128;
  static constexpr int STAGE = 2 * DH2 * HALF_Q;  // Q, then dO
  static constexpr int OFF_STAT = OFF_RING + STAGES_B * STAGE;
  static constexpr int OFF_BAR = OFF_STAT + STAGES_B * 2 * BQ_B * 4;
  static constexpr size_t BYTES = OFF_BAR + 8 * (1 + 2 * STAGES_B) + 1024;  // + alignment slack
};

struct BwdParams {
  const float* lse;  // (B, H, Sp): the forward's log2-sum-exp2 of the scaled scores
  const float* dd;   // (B, H, Sp): D = rowsum(dO o O), 0 past Sq
  float* dq_acc;     // (B, H, Sp, 64 DH2): dQ / scale, summed over the key tiles
  bf16* dk;          // (B, Skv, KV, dh), contiguous
  bf16* dv;          // (B, Skv, KV, dh), contiguous
  int B, Sq, Skv, H, KV, dh, Sp;
  int causal, window;  // window < 0: no window
  float scale;
};

// What the prep and dQ passes read and write.
struct PassParams {
  const bf16* o;
  const bf16* dout;
  bf16* dq;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh;
  float* dd;
  float* acc;
  int B, Sq, H, dh, Sp, dp2;  // dp2: the accumulator's row, 64 DH2
  float scale;
};

// Copies `bytes` contiguous bytes global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// D (64 x 64, fp32) = A B (scale_d 0) or D + A B: A 64 x 16 and B 16 x 64, bf16
// in shared memory, 128-byte swizzle; TA / TB 0 for K-major, 1 for MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, fp32) += A B: A in registers as for wgmma_rs, B 16 x 64 bf16 in
// shared memory, MN-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64 DH2, fp32) += A B, B the 64 DH2 columns of a Q or dO tile
template <int DH2>
__device__ __forceinline__ void wgmma_rs_dh(float (&d)[32 * DH2], const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (DH2 == 1)
    wgmma_rs64(d, a, db);
  else
    wgmma_rs(d, a, db);
}

// A wgmma accumulator of R registers (64 x R / 2, fp32) as bf16 A fragments of
// its columns in k-steps of 16 (the layout note above attn_fwd_bf16_tma).
template <int R>
__device__ __forceinline__ void pack_frag(const float (&x)[R], uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int n = 0; n < R / 4; ++n) {
    a[n / 2][2 * (n % 2)] = pack_f32(x[4 * n], x[4 * n + 1]);
    a[n / 2][2 * (n % 2) + 1] = pack_f32(x[4 * n + 2], x[4 * n + 3]);
  }
}

// D = rowsum(dO o O) in fp32 for each (batch, head, q < Sp), 0 past Sq, and the
// row's dQ accumulator zeroed: one warp a row.
__global__ void __launch_bounds__(NT_PASS) attn_bwd_prep(PassParams p) {
  const long long row = (long long)blockIdx.x * (NT_PASS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.H * p.Sp) return;
  const long long q = row % p.Sp, h = row / p.Sp % p.H, b = row / ((long long)p.Sp * p.H);
  float s = 0.f;
  if (q < p.Sq) {
    const bf16* o = p.o + b * p.o_sb + q * p.o_ss + h * p.o_sh;
    const bf16* d = p.dout + b * p.do_sb + q * p.do_ss + h * p.do_sh;
    for (int x = 2 * lane; x < p.dh; x += 64) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + x));
      const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + x));
      s += a.x * e.x + a.y * e.y;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.dd[row] = s;
  float* acc = p.acc + row * p.dp2;
  for (int x = 2 * lane; x < p.dp2; x += 64) *reinterpret_cast<float2*>(acc + x) = make_float2(0.f, 0.f);
}

// dQ = scale x its accumulator, in bf16: two columns a thread.
__global__ void __launch_bounds__(NT_PASS) attn_bwd_dq(PassParams p) {
  const long long i = (long long)blockIdx.x * NT_PASS + threadIdx.x;
  const int pairs = p.dh / 2;
  if (i >= (long long)p.B * p.Sq * p.H * pairs) return;
  const int x = 2 * int(i % pairs);
  long long r = i / pairs;
  const long long h = r % p.H;
  r /= p.H;
  const long long q = r % p.Sq, b = r / p.Sq;
  const float2 a =
      *reinterpret_cast<const float2*>(p.acc + ((b * p.H + h) * p.Sp + q) * p.dp2 + x);
  *reinterpret_cast<uint32_t*>(p.dq + b * p.dq_sb + q * p.dq_ss + h * p.dq_sh + x) =
      pack_f32(a.x * p.scale, a.y * p.scale);
}

// One block owns one (batch, kv head, BK_B-key tile): K and V stay in shared
// memory, dK and dV in registers.  It walks the q tiles its band touches and,
// within each, the G query heads of its kv head; warpgroup 0's one thread
// streams their Q, dO, lse and D through the ring.  Consumer warpgroup cw owns
// keys 64 cw..64 cw + 63 of the tile; a step (q tile, head):
//   S^T = K Q^T, dP^T = V dO^T                       wgmma, both from shared memory
//   P^T = exp2(S^T scale log2 e - lse), dS^T = P^T (dP^T - D)   in registers
//   dV += P^T dO, dK += dS^T Q                       wgmma, A from registers
//   dS^T in bf16 to shared memory; after both warpgroups wrote theirs,
//   dQ / scale = dS K for 64 columns (dh <= 64: the warpgroups take turns;
//   else each its half), added to the fp32 accumulator with float2 atomics.
// Fragment layout of a 64 x N accumulator as at attn_fwd_bf16_tma: the
// thread's rows are keys 16 warp + g and + 8 of its warpgroup's 64, its
// columns q rows 8n + 2c + j.
template <int DH2>
__global__ void __launch_bounds__(NT_B, 1)
    attn_bwd_main(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  BwdParams p) {
  using L = BwdSmem<DH2>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sm = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (sm - raw);
  const uint32_t kv_full = sm + L::OFF_BAR;
  auto full = [&](int s) { return sm + L::OFF_BAR + 8 * (1 + 2 * s); };
  auto empty = [&](int s) { return sm + L::OFF_BAR + 8 * (2 + 2 * s); };
  auto stage = [&](int s) { return sm + L::OFF_RING + s * L::STAGE; };
  auto stat = [&](int s) { return L::OFF_STAT + s * 2 * BQ_B * 4; };  // offset of lse, then D

  // key tiles in order, batch and kv head fastest: a causal band's longest
  // blocks start first
  const int bk = blockIdx.x % (p.B * p.KV), kt = blockIdx.x / (p.B * p.KV);
  const int kvh = bk % p.KV, b = bk / p.KV, G = p.H / p.KV;
  const int k0 = kt * BK_B, k1 = min(k0 + BK_B, p.Skv);
  // the rows that see a key of the tile: causal q >= k, window q < k + window
  const int qlo = p.causal ? k0 : 0;
  const int qhi = p.window >= 0 ? min(p.Sq, k1 - 1 + p.window) : p.Sq;
  const int qt0 = qlo / BQ_B;
  const int n_it = qhi > qlo ? ((qhi + BQ_B - 1) / BQ_B - qt0) * G : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES_B; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * DH2 * L::HALF_K);
      for (int hh = 0; hh < DH2; ++hh) {
        tma_load(sm + hh * L::HALF_K, &tk, kv_full, 64 * hh, kvh, k0, b);
        tma_load(sm + L::OFF_V + hh * L::HALF_K, &tv, kv_full, 64 * hh, kvh, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES_B, h = kvh * G + it % G, q0 = (qt0 + it / G) * BQ_B;
        const uint32_t qs = stage(s);
        mbar_wait(empty(s), ((it / STAGES_B) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full(s), 2 * DH2 * L::HALF_Q + 2 * BQ_B * 4);
        for (int hh = 0; hh < DH2; ++hh) {
          tma_load(qs + hh * L::HALF_Q, &tq, full(s), 64 * hh, h, q0, b);
          tma_load(qs + (DH2 + hh) * L::HALF_Q, &tdo, full(s), 64 * hh, h, q0, b);
        }
        const long long row = (long long)(b * p.H + h) * p.Sp + q0;
        bulk_load(sm + stat(s), p.lse + row, BQ_B * 4, full(s));
        bulk_load(sm + stat(s) + BQ_B * 4, p.dd + row, BQ_B * 4, full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int kr = 64 * cw + 16 * warp + g;  // this thread's keys of the tile: kr, kr + 8
    const uint32_t ka = sm + 64 * cw * 128, va = ka + L::OFF_V;  // its warpgroup's K, V rows
    const float sl2 = p.scale * 1.4426950408889634f;
    float dv[32 * DH2], dk[32 * DH2];
#pragma unroll
    for (int i = 0; i < 32 * DH2; ++i) dv[i] = dk[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES_B, h = kvh * G + it % G, q0 = (qt0 + it / G) * BQ_B;
      const uint32_t qs = stage(s), dos = qs + DH2 * L::HALF_Q;
      const uint32_t dsb = sm + L::OFF_DS + (it & 1) * BK_B * 128;
      const float* lse_s = reinterpret_cast<const float*>(smem + stat(s));
      const float* d_s = lse_s + BQ_B;
      float st[32], dp[32];
      mbar_wait(full(s), (it / STAGES_B) & 1);
      fence_regs(st);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * DH2; ++kk)
        wgmma_ss64<0, 0>(st, sw128_desc(ka + (kk / 4) * L::HALF_K + (kk % 4) * 32, 16, 1024),
                         sw128_desc(qs + (kk / 4) * L::HALF_Q + (kk % 4) * 32, 16, 1024),
                         kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4 * DH2; ++kk)
        wgmma_ss64<0, 0>(dp, sw128_desc(va + (kk / 4) * L::HALF_K + (kk % 4) * 32, 16, 1024),
                         sw128_desc(dos + (kk / 4) * L::HALF_Q + (kk % 4) * 32, 16, 1024),
                         kk > 0);
      wgmma_commit();
      // only tiles on the band's edges or past a sequence's end mask
      const bool edge = k0 + BK_B > p.Skv || q0 + BQ_B > p.Sq ||
                        (p.causal && k0 + BK_B - 1 > q0) ||
                        (p.window >= 0 && k0 <= q0 + BQ_B - 1 - p.window);
      wgmma_wait<1>();
      fence_regs(st);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n + 2 * c + j;
          float l = lse_s[col];
          l = l == -INFINITY ? INFINITY : l;  // a row that sees no key: P = 0
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = st[4 * n + 2 * r + j];
            const float e = x * sl2 - l;
            x = (edge && !allowed(p, q0 + col, k0 + kr + 8 * r)) ? 0.f : exp2_ftz(e);
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dd = d_s[8 * n + 2 * c + j];
          dp[4 * n + j] = st[4 * n + j] * (dp[4 * n + j] - dd);
          dp[4 * n + 2 + j] = st[4 * n + 2 + j] * (dp[4 * n + 2 + j] - dd);
        }
      }
      uint32_t pa[4][4], da[4][4];  // P^T and dS^T in bf16, k-steps of 16 q rows
      pack_frag(st, pa);
      pack_frag(dp, da);
      // dS^T into this warpgroup's rows of the buffer, for dQ
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        unsigned char* row = smem + (dsb - sm) + ((n ^ g) << 4) + 4 * c;
        *reinterpret_cast<uint32_t*>(row + kr * 128) = da[n / 2][2 * (n % 2)];
        *reinterpret_cast<uint32_t*>(row + (kr + 8) * 128) = da[n / 2][2 * (n % 2) + 1];
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      // dV += P^T dO and dK += dS^T Q: dO and Q read transposed
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ_B / 16; ++kk)
        wgmma_rs_dh<DH2>(dv, pa[kk], sw128_desc(dos + kk * 16 * 128, L::HALF_Q, 1024));
#pragma unroll
      for (int kk = 0; kk < BQ_B / 16; ++kk)
        wgmma_rs_dh<DH2>(dk, da[kk], sw128_desc(qs + kk * 16 * 128, L::HALF_Q, 1024));
      wgmma_commit();
      bar_sync(1, 256);  // both warpgroups' dS^T are in the buffer
      if (DH2 == 2 || (it & 1) == cw) {
        // dQ / scale = dS K over the tile's keys for 64 columns: dS read
        // transposed from its buffer, K from its tile
        const int hh = DH2 == 2 ? cw : 0;
        float acc[32];
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK_B / 16; ++kk)
          wgmma_ss64<1, 1>(acc, sw128_desc(dsb + kk * 16 * 128, L::HALF_Q, 1024),
                           sw128_desc(sm + hh * L::HALF_K + kk * 16 * 128, L::HALF_K, 1024),
                           kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        float* dst = p.dq_acc + ((long long)(b * p.H + h) * p.Sp + q0 + 16 * warp + g) * (64 * DH2) +
                     64 * hh + 2 * c;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          atomicAdd(reinterpret_cast<float2*>(dst + 8 * n), make_float2(acc[4 * n], acc[4 * n + 1]));
          atomicAdd(reinterpret_cast<float2*>(dst + 8 * 64 * DH2 + 8 * n),
                    make_float2(acc[4 * n + 2], acc[4 * n + 3]));
        }
      } else {
        wgmma_wait<0>();
      }
      fence_regs(dv);
      fence_regs(dk);
      if (tid == 0) mbar_arrive(empty(s));
    }

    // dK (times scale) and dV in bf16; keys past Skv and columns past dh are not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + kr + 8 * r;
      if (key < p.Skv) {
        const long long off = ((long long)b * p.Skv + key) * p.KV * p.dh + (long long)kvh * p.dh;
#pragma unroll
        for (int n = 0; n < 8 * DH2; ++n) {
          const int col = 8 * n + 2 * c;
          if (col < p.dh) {
            *reinterpret_cast<uint32_t*>(p.dk + off + col) =
                pack_f32(dk[4 * n + 2 * r] * p.scale, dk[4 * n + 2 * r + 1] * p.scale);
            *reinterpret_cast<uint32_t*>(p.dv + off + col) =
                pack_f32(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
          }
        }
      }
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// Sets a kernel's dynamic shared-memory limit once per device, not per launch,
// and returns the device's SM count in *sms if asked.
template <typename Kernel>
cudaError_t smem_limit_once(Kernel* kernel, size_t bytes, unsigned long long& done,
                            int* sms = nullptr) {
  static int sm_count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(done >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    done |= 1ull << dev;
  }
  if (sms) *sms = sm_count[dev];
  return cudaSuccess;
}

// Makes `device` current for the guard's lifetime, and its primary context
// current on the calling thread: autograd's backward thread may have none
// bound yet, and cuTensorMapEncodeTiled then fails (CUDA_ERROR_INVALID_CONTEXT).
struct DeviceGuard {
  int prev = -1;
  cudaError_t set(int device) {
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess) return err;
    if (cur != device) prev = cur;
    return cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Fills everything but the window, the causal flag and the vec flag.
bool fill_params(Params& p, const void* q, const void* k, const void* v, void* o, int B, int Sq,
                 int Skv, int H, int KV, int dh, const long long* strides, float scale) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || dh <= 0 || dh > DP)
    return false;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.KV = KV;
  p.dh = dh;
  long long* dst[12] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
                        &p.v_sb, &p.v_ss, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh};
  for (int i = 0; i < 12; ++i) *dst[i] = strides[i];
  p.scale = scale;
  p.accum_chunk = 0;
  p.lse = nullptr;
  p.lse_sp = 0;
  return true;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once through the CUDA runtime
// (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map (dh, heads, seq, batch) over a bf16 tensor with element strides
// (sb, ss, sh) and unit stride on dh, read in boxes of (64, 1, rows, 1) with
// the 128-byte swizzle.  A dimension of size 1 takes the stride a contiguous
// tensor would have, since its own may be any value.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int dh, int heads, int seq,
              int batch, long long sb, long long ss, long long sh, int rows) {
  if (heads == 1) sh = dh;
  if (seq == 1) ss = sh * heads;
  if (batch == 1) sb = ss * seq;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(heads), cuuint64_t(seq),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

unsigned long long smem_set_sync = 0, smem_set_f32 = 0, smem_set_tma = 0, smem_set_tma_lse = 0;
unsigned long long smem_set_bwd1 = 0, smem_set_bwd2 = 0;
unsigned long long smem_set_sync_acc = 0, smem_set_f32_acc = 0;

}  // namespace

// q: (B, Sq, H, dh), k/v: (B, Skv, KV, dh), o: (B, Sq, H, dh), all of one dtype
// (bf16 if is_bf16, else fp32) with unit stride on dh, on CUDA device
// `device`.  strides holds the (batch, seq, head) element strides of q, k, v,
// o in that order.  window < 0 means no window.  bf16 runs the mma.sync
// kernel, for inputs TMA cannot describe and for bf16 accumulation.
// accum_chunk > 0 accumulates P V in bf16 over KV chunks of that many rows
// (the ACC_BF16 instances), 0 in fp32; < 0 is refused.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int is_bf16, int B, int Sq, int Skv, int H, int KV,
                                         int dh, const long long* strides, int causal,
                                         int window, float scale, int accum_chunk, int device,
                                         void* stream) {
  DeviceGuard guard;
  if (const cudaError_t err = guard.set(device)) return int(err);
  Params p;
  if (accum_chunk < 0 || !fill_params(p, q, k, v, o, B, Sq, Skv, H, KV, dh, strides, scale))
    return int(cudaErrorInvalidValue);
  p.accum_chunk = accum_chunk;
  const long long vec_elems = is_bf16 ? 8 : 4;
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && dh % vec_elems == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % vec_elems == 0;
  p.vec = vec;
  p.causal = causal;
  p.window = window;

  const dim3 grid((Sq + BM - 1) / BM, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && accum_chunk > 0) {
    err = smem_limit_once(attn_fwd_bf16_sync<true>, SMEM_BF16, smem_set_sync_acc);
    if (err != cudaSuccess) return int(err);
    attn_fwd_bf16_sync<true><<<grid, NT_BF16, SMEM_BF16, st>>>(p);
  } else if (is_bf16) {
    err = smem_limit_once(attn_fwd_bf16_sync<false>, SMEM_BF16, smem_set_sync);
    if (err != cudaSuccess) return int(err);
    attn_fwd_bf16_sync<false><<<grid, NT_BF16, SMEM_BF16, st>>>(p);
  } else if (accum_chunk > 0) {
    err = smem_limit_once(attn_fwd_f32<true>, SMEM_F32, smem_set_f32_acc);
    if (err != cudaSuccess) return int(err);
    attn_fwd_f32<true><<<grid, NT_F32, SMEM_F32, st>>>(p);
  } else {
    err = smem_limit_once(attn_fwd_f32<false>, SMEM_F32, smem_set_f32);
    if (err != cudaSuccess) return int(err);
    attn_fwd_f32<false><<<grid, NT_F32, SMEM_F32, st>>>(p);
  }
  return int(cudaGetLastError());
}

// The bf16 forward on TMA and wgmma; arguments as repro_flash_attention_fwd's.
// Every data pointer must be 16-byte aligned and every (batch, seq, head)
// stride of a dimension longer than 1 a positive multiple of 8 elements, with
// dh % 8 == 0: the caller (kernel.tma_path) sends only such inputs here.  An
// input the tensor maps cannot describe returns cudaErrorInvalidValue and
// launches nothing.  A non-null lse, (B, H, lse_sp) fp32 with lse_sp a multiple
// of 128 and >= Sq, runs the instance that also writes each row's log2-sum-exp2
// (the backward's statistics); null runs the one that writes o alone.
extern "C" int repro_flash_attention_fwd_tma(const void* q, const void* k, const void* v, void* o,
                                             int B, int Sq, int Skv, int H, int KV, int dh,
                                             const long long* strides, int causal, int window,
                                             float scale, float* lse, int lse_sp, int device,
                                             void* stream) {
  DeviceGuard guard;
  if (const cudaError_t err = guard.set(device)) return int(err);
  Params p;
  if (!fill_params(p, q, k, v, o, B, Sq, Skv, H, KV, dh, strides, scale))
    return int(cudaErrorInvalidValue);
  p.vec = 1;
  // for 64 < dh < 128 the second box ends at dh (see the note at the top)
  p.col2 = dh > 64 && dh < 128 ? dh - 64 : 64;
  p.causal = causal;
  p.window = window;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return int(cudaErrorNotSupported);
  alignas(64) CUtensorMap tq, tk, tv, to;
  const long long* s = strides;
  if (!make_map(encode, &tq, q, dh, H, Sq, B, s[0], s[1], s[2], BM_T) ||
      !make_map(encode, &tk, k, dh, KV, Skv, B, s[3], s[4], s[5], BN_T) ||
      !make_map(encode, &tv, v, dh, KV, Skv, B, s[6], s[7], s[8], BN_T) ||
      !make_map(encode, &to, o, dh, H, Sq, B, s[9], s[10], s[11], BM_T / 2))
    return int(cudaErrorInvalidValue);
  if (lse && (lse_sp % BM_T || lse_sp < Sq)) return int(cudaErrorInvalidValue);
  p.lse = lse;
  p.lse_sp = lse_sp;
  int sms = 0;
  cudaError_t err = lse ? smem_limit_once(attn_fwd_bf16_tma<true>, SMEM_T, smem_set_tma_lse, &sms)
                        : smem_limit_once(attn_fwd_bf16_tma<false>, SMEM_T, smem_set_tma, &sms);
  if (err != cudaSuccess) return int(err);
  // persistent: one block per SM walks the (q tile, head, batch) items
  const int n_items = (Sq + BM_T - 1) / BM_T * H * B;
  const int grid = n_items < sms ? n_items : sms;
  if (lse)
    attn_fwd_bf16_tma<true><<<grid, NT_T, SMEM_T, static_cast<cudaStream_t>(stream)>>>(
        tq, tk, tv, to, p, n_items);
  else
    attn_fwd_bf16_tma<false><<<grid, NT_T, SMEM_T, static_cast<cudaStream_t>(stream)>>>(
        tq, tk, tv, to, p, n_items);
  return int(cudaGetLastError());
}

// The backward of the TMA forward (attn_bwd_prep, attn_bwd_main, attn_bwd_dq,
// in that order on `stream`).  q, o, dout, dq: (B, Sq, H, dh); k, v, dk, dv:
// (B, Skv, KV, dh); bf16, dh % 8 == 0, dh <= 128.  strides holds the (batch,
// seq, head) element strides of q, k, v, o, dout and dq in that order; dk and
// dv are contiguous.  lse: (B, H, Sp), the LSE forward's; dd: (B, H, Sp) and
// dq_acc: (B, H, Sp, 64 or 128) fp32 work buffers, Sp >= Sq a multiple of 128.  q,
// k, v and dout must be as the forward's TMA kernel takes them (kernel.tma_path).
// Returns cudaGetLastError() after the last launch, or the first error.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* dd, float* dq_acc, void* dq, void* dk, void* dv,
                                         int B, int Sq, int Skv, int H, int KV, int dh,
                                         const long long* strides, int Sp, int causal, int window,
                                         float scale, int device, void* stream) {
  DeviceGuard guard;
  if (const cudaError_t err = guard.set(device)) return int(err);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || dh <= 0 || dh > DP ||
      dh % 8 || Sp % BM_T || Sp < Sq)
    return int(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (!encode) return int(cudaErrorNotSupported);
  const long long* s = strides;
  alignas(64) CUtensorMap tq, tk, tv, tdo;
  if (!make_map(encode, &tq, q, dh, H, Sq, B, s[0], s[1], s[2], BQ_B) ||
      !make_map(encode, &tk, k, dh, KV, Skv, B, s[3], s[4], s[5], BK_B) ||
      !make_map(encode, &tv, v, dh, KV, Skv, B, s[6], s[7], s[8], BK_B) ||
      !make_map(encode, &tdo, dout, dh, H, Sq, B, s[12], s[13], s[14], BQ_B))
    return int(cudaErrorInvalidValue);
  const int dh2 = dh > 64 ? 2 : 1;
  PassParams pp;
  pp.o = static_cast<const bf16*>(o);
  pp.dout = static_cast<const bf16*>(dout);
  pp.dq = static_cast<bf16*>(dq);
  long long* dst[9] = {&pp.o_sb, &pp.o_ss, &pp.o_sh, &pp.do_sb, &pp.do_ss,
                       &pp.do_sh, &pp.dq_sb, &pp.dq_ss, &pp.dq_sh};
  for (int i = 0; i < 9; ++i) *dst[i] = s[9 + i];
  pp.dd = dd;
  pp.acc = dq_acc;
  pp.B = B;
  pp.Sq = Sq;
  pp.H = H;
  pp.dh = dh;
  pp.Sp = Sp;
  pp.dp2 = 64 * dh2;
  pp.scale = scale;
  BwdParams p;
  p.lse = lse;
  p.dd = dd;
  p.dq_acc = dq_acc;
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.H = H;
  p.KV = KV;
  p.dh = dh;
  p.Sp = Sp;
  p.causal = causal;
  p.window = window;
  p.scale = scale;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * H * Sp;
  attn_bwd_prep<<<unsigned((rows + NT_PASS / 32 - 1) / (NT_PASS / 32)), NT_PASS, 0, st>>>(pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((Skv + BK_B - 1) / BK_B * KV * B));
  if (dh2 == 1) {
    err = smem_limit_once(attn_bwd_main<1>, BwdSmem<1>::BYTES, smem_set_bwd1);
    if (err != cudaSuccess) return int(err);
    attn_bwd_main<1><<<grid, NT_B, BwdSmem<1>::BYTES, st>>>(tq, tk, tv, tdo, p);
  } else {
    err = smem_limit_once(attn_bwd_main<2>, BwdSmem<2>::BYTES, smem_set_bwd2);
    if (err != cudaSuccess) return int(err);
    attn_bwd_main<2><<<grid, NT_B, BwdSmem<2>::BYTES, st>>>(tq, tk, tv, tdo, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long pairs = (long long)B * Sq * H * (dh / 2);
  attn_bwd_dq<<<unsigned((pairs + NT_PASS - 1) / NT_PASS), NT_PASS, 0, st>>>(pp);
  return int(cudaGetLastError());
}
