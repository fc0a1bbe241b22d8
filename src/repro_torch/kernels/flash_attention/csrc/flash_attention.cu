// Flash-attention forward for Hopper (sm_90a), bound from Python with ctypes
// (repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::_attn_kernel
// (launched by flash_attention_bhsd).  It computes the same function:
// softmax(q k^T / sqrt(dh)) v under the mask k < Skv & q < Sq & causal (k <= q)
// & window (k > q - window), with an fp32 running max m, denominator l and
// accumulator; fully masked rows give 0; query head h reads kv head h / (H / KV).
//
// What bounds it on an H100: Q K^T and P V do 4 * dh flops per unmasked (q, k)
// pair, against 2 bytes per element of Q, K, V and O read or written once.  A
// batch of short prompts (S = 512, dh = 120) is bound by HBM bytes; a long prompt
// (S = 5120, window 4096) by tensor-core operations.  What the design does:
//  * one block per (64-row q tile, head, batch).  The TPU's sequential kv grid
//    axis becomes a loop inside the block, and kv tiles wholly outside the
//    causal / window band are never loaded, so work follows the band and a
//    windowed prompt costs O(S * window), not O(S^2);
//  * bf16: mma.sync m16n8k16 with fp32 accumulation.  Each of 4 warps owns 16
//    q rows; its Q fragments, the S tile and the output accumulator stay in
//    registers, and P is re-packed from the S accumulator straight into the A
//    operand of P V, so scores never touch shared or device memory.  K and V
//    tiles stream through a two-stage cp.async ring (tile t + 1 loads while
//    tile t computes) and reach the tensor cores through ldmatrix; only tiles
//    on the diagonal or the window's edge evaluate the element mask;
//  * fp32: FMA on CUDA cores, no TF32, so the result holds the fp32 reference;
//  * (B, S, H, dh) is read in place through strides (no transpose or pad pass
//    in HBM); dh <= 128 is zero-padded to 128 in shared memory only, so
//    dh = 120 costs one idle 8-wide column of each product.
// Not yet used: TMA, wgmma, warp specialisation.

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
};

__device__ __forceinline__ bool allowed(const Params& p, int qp, int kp) {
  return kp < p.Skv && qp < p.Sq && (!p.causal || kp <= qp) &&
         (p.window < 0 || kp > qp - p.window);
}

// kv tiles [t0, t1) that hold at least one position the q tile at q0 may see.
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int& t0, int& t1) {
  int lo = 0, hi = p.Skv;
  if (p.causal) hi = min(hi, q0 + BM);
  if (p.window >= 0) lo = max(lo, q0 - p.window + 1);
  t0 = lo / BN;
  t1 = hi > lo ? (hi + BN - 1) / BN : t0;
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
// bf16: tensor cores through mma.sync
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

// Fragment layout of m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16x16, row): a0 (g, 2c..2c+1)  a1 (g+8, 2c..)  a2 (g, 2c+8..)  a3 (g+8, 2c+8..)
//   B (16x8, col):  b0 (k 2c..2c+1, n g)  b1 (k 2c+8..2c+9, n g)
//   C (16x8):       c0,c1 (g, 2c..2c+1)   c2,c3 (g+8, 2c..2c+1)
// K tiles are stored [kv][d], so ldmatrix gives Q K^T's B fragments as they are;
// V tiles are stored [kv][d] too, and ldmatrix.trans gives P V's.
// 68 KB of shared memory and at most 168 registers a thread let 3 blocks share an SM.
__global__ void __launch_bounds__(NT_BF16, 3) attn_fwd_bf16(Params p) {
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
  kv_tiles(p, q0, t0, t1);
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
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t vb[4];  // b0, b1 of d-tiles 2dp and 2dp + 1
        ldsm_x4_t(vb, Vs + (j * 16 + (lane & 15)) * LDH + (2 * dp + (lane >> 4)) * 8);
        mma_bf16(acc[2 * dp], a, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
  }

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
        if (qp0 < p.Sq) og[qp0 * p.o_ss + d] = __float2bfloat16(acc[dn][j] * inv0);
        if (qp1 < p.Sq) og[qp1 * p.o_ss + d] = __float2bfloat16(acc[dn][2 + j] * inv1);
      }
    }
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

  float acc[4][DP / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DP / 16; ++e) acc[i][e] = 0.f;
  }

  int t0, t1;
  kv_tiles(p, q0, t0, t1);
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
        Ps[(4 * rg + i) * LDP + cg + 16 * j] = pv;
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

    for (int kk = 0; kk < BN; ++kk) {
      float pv[4], vv[DP / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * rg + i) * LDP + kk];
#pragma unroll
      for (int e = 0; e < DP / 16; ++e) vv[e] = Vs[kk * LDF + cg + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DP / 16; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * rg + i;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    if (qp < p.Sq) {
#pragma unroll
      for (int e = 0; e < DP / 16; ++e) {
        const int d = cg + 16 * e;
        if (d < p.dh) og[qp * p.o_ss + d] = acc[i][e] * inv;
      }
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// q: (B, Sq, H, dh), k/v: (B, Skv, KV, dh), o: (B, Sq, H, dh), all of one dtype
// (bf16 if is_bf16, else fp32) with unit stride on dh.  strides holds the
// (batch, seq, head) element strides of q, k, v, o in that order.  window < 0
// means no window.  Launches on `stream` and returns cudaGetLastError().
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int is_bf16, int B, int Sq, int Skv, int H, int KV,
                                         int dh, const long long* strides, int causal,
                                         int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 || dh <= 0 || dh > DP)
    return int(cudaErrorInvalidValue);
  Params p;
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
  const long long vec_elems = is_bf16 ? 8 : 4;
  bool vec = aligned16(q) && aligned16(k) && aligned16(v) && dh % vec_elems == 0;
  for (int i = 0; i < 12; ++i) {
    *dst[i] = strides[i];
    if (i < 9) vec = vec && strides[i] % vec_elems == 0;
  }
  p.vec = vec;
  p.causal = causal;
  p.window = window;
  p.scale = scale;

  const dim3 grid((Sq + BM - 1) / BM, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(attn_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(SMEM_BF16));
    if (err != cudaSuccess) return int(err);
    attn_fwd_bf16<<<grid, NT_BF16, SMEM_BF16, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(SMEM_F32));
    if (err != cudaSuccess) return int(err);
    attn_fwd_f32<<<grid, NT_F32, SMEM_F32, st>>>(p);
  }
  return int(cudaGetLastError());
}
