// Gated linear recurrence (the ssm_scan forward) for Hopper (sm_90a), as the
// chunked recurrence, bound from Python with ctypes
// (repro_torch/kernels/ssm_scan/kernel.py).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py::_ssm_kernel
// (launched by ssm_scan_bthk).  It computes the same function: per (b, h),
// with an fp32 state S of K x V,
//
//     S_t = diag(exp g_t) S_{t-1} + k_t^T v_t
//     y_t = q_t S_t                                   (no u: inclusive)
//     y_t = q_t S_{t-1} + (sum_k q_tk u_k k_tk) v_t     (u given: rwkv6 bonus)
//
// and returns y (in q's dtype) and the final state (fp32).  q, k, v are fp32
// or bf16; g, u and the initial state are fp32.
//
// What bounds it on an H100: the step form does 4 K V fp32 operations per
// (token, head) against 2 (2K + 2V) + 4K bytes of q, k, v, y and g.  At the
// served rwkv6 shapes (H 64, K = V = 64, bf16) the bytes take 0.0313 /
// 0.0754 ms at B4 T512 / B1 T5120 at 3.35 TB/s, the step form's operations
// 0.0321 / 0.0801 ms at 67 TFLOP/s: bound by operations, barely.  A kernel
// in the step form cannot get near that: each step of S depends on the one
// before it, so a block that walks T token by token waits on a chain of T
// dependent updates (the first version of this kernel spent about 170 ns a
// step).  What the design does about it:
//  * the chunked form: T is walked in chunks of L = 32 tokens and the state
//    is carried once per chunk, not once per token.  Within a chunk
//        y = qd S + A v + (q u k) v,   S <- diag(D_L) S + kd^T v
//    with qd = q e^{zq} (z the cumulative log decay from the chunk's start,
//    zq = z - g with u), kd = k e^{z_L - z}, and A the L x L lower
//    triangle of decayed q.k products.  The serial chain is T / L links of
//    three small matrix products, and all that does not need the state
//    (qd, kd, A) is computed off it;
//  * no exponent is ever positive: every decay factor is a product of
//    per-step decays a_t = exp(g_t) <= 1.  A is built from sub-chunks of
//    R = 4 tokens: a diagonal R x R block takes the exact decay between j
//    and i's read point as a running product of a_t; an off-diagonal block
//    (i in sub-chunk a, j in an earlier b) is factorised about the end of b,
//    (q_i e^{zq_i - z_bend}) . (k_j e^{z_bend - z_j}), both sides <= 1, so a
//    strong decay underflows harmlessly to 0 where a factorisation about a
//    sub-chunk's start would overflow;
//  * a block stages a chunk's raw q, k, g and v rows once with cp.async for
//    all its columns of V, ahead of use, converts them to fp32 and takes
//    exp(g) once per (t, k);
//  * K <= 64 (the served shapes) takes the tensor-core kernel below: the
//    products on mma.sync in TF32 with a 3-way split for fp32 accuracy,
//    warps specialised into a prep group, one chunk ahead, and a state
//    group that holds S in registers for the whole run;
//  * K up to 128 takes the first kernel: the same chunks with every product
//    in fp32 FFMA, register-tiled, one block per (b, h, 32 columns of V);
//  * q, k and g are read in place through their (b, t, h) strides, so
//    mamba's layout costs no copy: its q and k are C_t and B_t, one row per
//    (b, t) for every head (head stride 0), and its g one log decay per
//    (b, t, h) (g_head), staged as one value a row and read at k = 0.
//    Contiguous (B, T, H, K) operands (rwkv6's) take their own instance of
//    the tensor-core kernel, addressed with one row stride (DENSE);
//  * T, K (<= 128) and V need not be multiples of anything: the ragged last
//    chunk, rows of K past the data and columns past V are masked in the
//    kernel, so no padding pass runs in device memory.  Offsets are 64-bit.
//    The shared-memory limit is set once per device, not per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int L = 32;       // tokens per chunk: the state is carried once per chunk
constexpr int R = 4;        // tokens per sub-chunk (the diagonal blocks of A)
constexpr int NS = L / R;   // sub-chunks per chunk
constexpr int NPAIR = NS * (NS - 1) / 2;  // off-diagonal sub-chunk pairs (a > b)
constexpr int VB = 32;      // columns of V per block
constexpr int NT = 256;     // threads per block: 8 warps
constexpr int MAX_K = 128;
constexpr int LP = 36;      // row stride of the [k][t] arrays written per (k, sub-chunk)
constexpr int SW = 40;      // row stride of the product operands qd, A^T, v and S

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  const float* u;   // (H, K) or null: no bonus, inclusive readout
  const float* s0;  // (B, H, K, V) or null: zeros
  void* y;
  float* s_fin;
  int B, T, H, K, V;
  int vec_qk, vec_g, vec_v, vec_y;  // rows may be moved 16 (y: 4 elements) at a time
};

// How q, k and g are laid out: their element strides over (b, t, h), K with
// unit stride (a head stride of 0 reads one row for every head: mamba's C_t
// and B_t), and whether g holds one log decay per (b, t, h) for every k.  A
// kernel argument of its own: with these fields inside Params, ptxas spilled
// 12-32 bytes in the 128-register bf16 tensor-core instances (none without).
struct Strides {
  long long q_sb, q_st, q_sh, k_sb, k_st, k_sh, g_sb, g_st, g_sh;
  int g_head;
  int dense;  // q, k, g are contiguous (B, T, H, K): one row stride, H K, for all three
};

// Where the rows of (b, h) start in q, k and g: through their strides, or
// at one element offset in all three.
template <typename T>
struct Rows {
  const T* q;
  const T* k;
  const float* g;
  __device__ Rows(const Params& p, const Strides& sd, int b, int h)
      : q(static_cast<const T*>(p.q) + b * sd.q_sb + h * sd.q_sh),
        k(static_cast<const T*>(p.k) + b * sd.k_sb + h * sd.k_sh),
        g(p.g + b * sd.g_sb + h * sd.g_sh) {}
  __device__ Rows(const void* q0, const void* k0, const float* g0, long long at)
      : q(static_cast<const T*>(q0) + at), k(static_cast<const T*>(k0) + at), g(g0 + at) {}
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the N latest groups landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies `rows` rows of `n` elements (global row stride gstride) into shared
// memory (row stride sstride): 16 bytes a cp.async where every row start is
// 16-byte aligned and n fills whole 16-byte pieces, else element by element.
template <int NTH, typename T>
__device__ __forceinline__ void stage_rows(T* sm, int sstride, const T* g, long long gstride,
                                           int rows, int n, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = n / E;
    if ((per_row & (per_row - 1)) == 0) {  // a power of two: shifts, no division
      const int sh = __ffs(per_row) - 1;
      for (int i = threadIdx.x; i < rows << sh; i += NTH) {
        const int r = i >> sh, c = (i & (per_row - 1)) * E;
        cp_async16(sm + r * sstride + c, g + r * gstride + c);
      }
    } else {
      for (int i = threadIdx.x; i < rows * per_row; i += NTH) {
        const int r = i / per_row, c = (i % per_row) * E;
        cp_async16(sm + r * sstride + c, g + r * gstride + c);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += NTH) {
      const int r = i / n, c = i % n;
      sm[r * sstride + c] = g[r * gstride + c];
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// acc[r][c] += x[r] * y[c]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 x, const float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xs[r], ys[c], acc[r][c]);
}

// Sums a 4 x 4 tile over the 4 lanes that differ in lane bits 0-1, leaving
// each lane one row of the sum: row 2 * (lane & 1) + (lane >> 1 & 1).
__device__ __forceinline__ void reduce_rows(const float (&acc)[4][4], float (&out)[4], int lane) {
  const bool h1 = lane & 1, h2 = lane & 2;
  float half[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float keep = h1 ? acc[r + 2][c] : acc[r][c];
      const float send = h1 ? acc[r][c] : acc[r + 2][c];
      half[r][c] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float keep = h2 ? half[1][c] : half[0][c];
    const float send = h2 ? half[0][c] : half[1][c];
    out[c] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
}

__device__ __forceinline__ void store_y(float* y, const float (&x)[4], int n, bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(y) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    for (int c = 0; c < n; ++c) y[c] = x[c];
  }
}
__device__ __forceinline__ void store_y(bf16* y, const float (&x)[4], int n, bool vec) {
  if (vec && n == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]), hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 w;
    w.x = *reinterpret_cast<unsigned*>(&lo);
    w.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(y) = w;
  } else {
    for (int c = 0; c < n; ++c) y[c] = __float2bfloat16(x[c]);
  }
}

// ---------------------------------------------------------------------------
// The fp32 kernel (K up to 128): one block of 8 warps per (b, h, 32 columns
// of V); per chunk (1) per (sub-chunk, k) the running products q', k' and
// the sub-chunk decays; (2) qd, kd and the decays between sub-chunks; (3) A
// as 4 x 4 tiles over K slices; (4) y (a depth-K + L product, K split over 4
// lanes and reduced by shuffles) and the new state, which each thread keeps
// for its KP / 32 x 4 cells in registers; (5) the state to shared memory as
// the next chunk's operand.
// ---------------------------------------------------------------------------
// Shared memory of one block, in floats, then the raw staging in T.
template <typename T, int KP>
struct Layout {
  static constexpr int QF = 0;                 // q, [k][t] (LP): the diagonal blocks
  static constexpr int KF = QF + KP * LP;      // k
  static constexpr int AF = KF + KP * LP;      // a = exp(g)
  static constexpr int QP = AF + KP * LP;      // q' = q w (to the sub-chunk's start)
  static constexpr int KQ = QP + KP * LP;      // k' = k r (to the sub-chunk's end)
  static constexpr int QD = KQ + KP * LP;      // qd, [k][t] (SW)
  static constexpr int KD = QD + KP * SW;      // kd, [t][k]
  static constexpr int MX = KD + L * KP;       // M_ab, [pair][k]
  static constexpr int DS = MX + NPAIR * KP;   // D_s, [s][k]
  static constexpr int AT = DS + NS * KP;      // A^T, [j][i] (SW)
  static constexpr int VF = AT + L * SW;       // v, [t][j] (SW)
  static constexpr int SS = VF + L * SW;       // S, [k][j] (SW)
  static constexpr int BP = SS + KP * SW;      // bonus partials, [k / 32][t]
  static constexpr int RG = BP + 4 * L;        // raw g, [t][k]
  static constexpr int FLOATS = RG + L * KP;
  static constexpr size_t BYTES = FLOATS * sizeof(float) + (2 * L * KP + L * VB) * sizeof(T);
};

template <typename T, int KP, bool U>
__global__ void __launch_bounds__(NT, 1) ssm_scan_kernel(const Params p, const Strides sd) {
  using LY = Layout<T, KP>;
  constexpr int KR = KP / 32;         // state rows per thread
  constexpr int TPT = NS * KP / NT;   // (sub-chunk, k) tasks per thread: 1, 2 or 4
  static_assert(TPT * NT == NS * KP && KP % 32 == 0, "tasks must tile the block");
  const int j0 = blockIdx.x * VB, h = blockIdx.y, b = blockIdx.z;
  const int vw = min(VB, p.V - j0);   // columns of this block inside V
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) float sm[];
  float *QF = sm + LY::QF, *KF = sm + LY::KF, *AF = sm + LY::AF, *QP = sm + LY::QP,
        *KQ = sm + LY::KQ, *QD = sm + LY::QD, *KD = sm + LY::KD, *MX = sm + LY::MX,
        *DS = sm + LY::DS, *AT = sm + LY::AT, *VF = sm + LY::VF, *SS = sm + LY::SS,
        *BP = sm + LY::BP, *rg = sm + LY::RG;
  T* rq = reinterpret_cast<T*>(sm + LY::FLOATS);
  T* rk = rq + L * KP;
  T* rv = rk + L * KP;

  const long long HV = static_cast<long long>(p.H) * p.V;  // elements of v per time step
  const long long bth = static_cast<long long>(b) * p.T * p.H + h;  // (b, t = 0, h) of v, y
  const Rows<T> rows_in(p, sd, b, h);
  const T* gv = static_cast<const T*>(p.v) + bth * p.V + j0;
  T* gy = static_cast<T*>(p.y) + bth * p.V + j0;
  const long long sbase = (static_cast<long long>(b) * p.H + h) * p.K;  // row (b, h, 0)

  // the state: this thread's rows skb * KR + r and columns 4 scb + c
  const int scb = lane & 7, skb = warp * 4 + lane / 8;
  float S[KR][4];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kk = skb * KR + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * scb + c;
      S[r][c] = (p.s0 != nullptr && kk < p.K && j < vw) ? p.s0[(sbase + kk) * p.V + j0 + j] : 0.f;
    }
    st4(SS + kk * SW + 4 * scb, S[r]);
  }
  for (int i = tid; i < L * SW; i += NT) AT[i] = 0.f;  // the tiles above the diagonal stay 0

  // this thread's prep tasks: (sub-chunk tid / KP + i * NT / KP, k = tid % KP)
  const int pk = tid % KP;
  const int gk_n = sd.g_head ? 1 : p.K, gk = sd.g_head ? 0 : pk;  // g's row length, k's place
  const float u_k = (U && pk < p.K) ? p.u[static_cast<long long>(h) * p.K + pk] : 0.f;

  auto issue = [&](int c) {
    const int t0 = c * L, rows = min(L, p.T - t0);
    stage_rows<NT>(rq, KP, rows_in.q + t0 * sd.q_st, sd.q_st, rows, p.K, p.vec_qk);
    stage_rows<NT>(rk, KP, rows_in.k + t0 * sd.k_st, sd.k_st, rows, p.K, p.vec_qk);
    stage_rows<NT>(rg, KP, rows_in.g + t0 * sd.g_st, sd.g_st, rows, gk_n, p.vec_g);
    stage_rows<NT>(rv, VB, gv + t0 * HV, HV, rows, vw, p.vec_v);
    cp_async_commit();
  };

  const int nchunks = (p.T + L - 1) / L;
  if (nchunks > 0) issue(0);
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * L, nt = min(L, p.T - t0);
    cp_async_wait_all();
    __syncthreads();

    // (1) per (sub-chunk s, k): fp32 rows, a = exp(g), q' = q w, k' = k r, D_s
    float qp[TPT][R], kp[TPT][R];
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int s = tid / KP + i * (NT / KP);
      float qv[R], kv[R], av[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = s * R + r;
        const bool ok = t < nt && pk < p.K;  // past T or K: q = k = 0, a = 1 (inert)
        qv[r] = ok ? to_f(rq[t * KP + pk]) : 0.f;
        kv[r] = ok ? to_f(rk[t * KP + pk]) : 0.f;
        av[r] = ok ? expf(rg[t * KP + gk]) : 1.f;
      }
      st4(QF + pk * LP + s * R, qv);
      st4(KF + pk * LP + s * R, kv);
      st4(AF + pk * LP + s * R, av);
      float w = 1.f;  // decay from the sub-chunk's start to t's read point
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!U) w *= av[r];
        qp[i][r] = qv[r] * w;
        if (U) w *= av[r];
      }
      float rr = 1.f;  // decay from t to the sub-chunk's end
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        kp[i][r] = kv[r] * rr;
        rr *= av[r];
      }
      st4(QP + pk * LP + s * R, qp[i]);
      st4(KQ + pk * LP + s * R, kp[i]);
      DS[s * KP + pk] = w;
      if (U) {  // sum over k of q u k for the sub-chunk's 4 tokens: this warp's 32 k
        float bq[R];
#pragma unroll
        for (int r = 0; r < R; ++r) bq[r] = qv[r] * u_k * kv[r];
        const bool b4 = lane & 16, b3 = lane & 8;
        float x0 = (b4 ? bq[2] : bq[0]) + __shfl_xor_sync(0xffffffffu, b4 ? bq[0] : bq[2], 16);
        float x1 = (b4 ? bq[3] : bq[1]) + __shfl_xor_sync(0xffffffffu, b4 ? bq[1] : bq[3], 16);
        float x = (b3 ? x1 : x0) + __shfl_xor_sync(0xffffffffu, b3 ? x0 : x1, 8);
#pragma unroll
        for (int off = 4; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
        if ((lane & 7) == 0) BP[(pk / 32) * L + s * R + 2 * b4 + b3] = x;
      }
    }
    for (int e = tid; e < L * VB; e += NT) {
      const int t = e / VB, j = e % VB;
      VF[t * SW + j] = (t < nt && j < vw) ? to_f(rv[t * VB + j]) : 0.f;
    }
    __syncthreads();
    if (c + 1 < nchunks) issue(c + 1);  // the raw buffers are free again

    // (2) qd = q' P_s, kd = k' Q_s, and M_ab for the pairs (a = s, b < s)
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int s = tid / KP + i * (NT / KP);
      float P = 1.f, Q = 1.f;
      for (int cc = 0; cc < s; ++cc) P *= DS[cc * KP + pk];
      for (int cc = s + 1; cc < NS; ++cc) Q *= DS[cc * KP + pk];
      float qd[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        qd[r] = qp[i][r] * P;
        KD[(s * R + r) * KP + pk] = kp[i][r] * Q;
      }
      st4(QD + pk * SW + s * R, qd);
      float m = 1.f;
      for (int sb = s - 1; sb >= 0; --sb) {
        MX[(s * (s - 1) / 2 + sb) * KP + pk] = m;
        m *= DS[sb * KP + pk];
      }
    }
    __syncthreads();

    // (3) A in 4 x 4 tiles, each over 4 interleaved K slices (k = 4 i + slice)
    // whose lanes sum by shuffles: warp 0 the 8 diagonal tiles, warps 1-4 the
    // 28 off-diagonal ones
    if (warp < 5) {
      const int tile = tid / 4, sl = tid % 4;
      const bool live = tile < NS + NPAIR;
      float acc[4][4] = {};
      int ta = 0, tb = 0;
      if (tile < NS) {
        ta = tb = tile;
        for (int kk = sl; kk < KP; kk += 4) {
          const float4 q4 = ld4(QF + kk * LP + ta * R), k4 = ld4(KF + kk * LP + ta * R),
                       a4 = ld4(AF + kk * LP + ta * R);
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w},
                      av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int i = 0; i < R; ++i) {
            float x = qv[i];
            if (!U) acc[i][i] = fmaf(x, kv[i], acc[i][i]);
#pragma unroll
            for (int j = i - 1; j >= 0; --j) {
              if (!U || j < i - 1) x *= av[j + 1];
              acc[i][j] = fmaf(x, kv[j], acc[i][j]);
            }
          }
        }
      } else {
        const int pair = live ? tile - NS : 0;
        while ((ta + 1) * ta / 2 <= pair) ++ta;  // pair = ta (ta - 1) / 2 + tb
        tb = pair - ta * (ta - 1) / 2;
        for (int kk = live ? sl : KP; kk < KP; kk += 4) {
          const float m = MX[pair * KP + kk];
          float4 q4 = ld4(QP + kk * LP + ta * R);
          q4.x *= m; q4.y *= m; q4.z *= m; q4.w *= m;
          outer4(acc, q4, ld4(KQ + kk * LP + tb * R));
        }
      }
      float row[4];
      reduce_rows(acc, row, lane);
      const int i = 2 * (lane & 1) + (lane >> 1 & 1);
      if (live) {
#pragma unroll
        for (int j = 0; j < 4; ++j) AT[(tb * R + j) * SW + ta * R + i] = row[j];
      }
    }
    __syncthreads();

    // (4a) the state: S <- D_L S + kd^T v, in registers
    {
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        float dl = 1.f;
#pragma unroll
        for (int s = 0; s < NS; ++s) dl *= DS[s * KP + skb * KR + r];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) S[r][cc] *= dl;
      }
#pragma unroll 8
      for (int t = 0; t < L; ++t) {
        const float4 v4 = ld4(VF + t * SW + 4 * scb);
        const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
        const float* kd = KD + t * KP + skb * KR;
        float kr[KR];
        if constexpr (KR == 4) {
          const float4 x = ld4(kd);
          kr[0] = x.x; kr[1] = x.y; kr[2] = x.z; kr[3] = x.w;
        } else if constexpr (KR == 2) {
          const float2 x = *reinterpret_cast<const float2*>(kd);
          kr[0] = x.x; kr[1] = x.y;
        } else {
          kr[0] = kd[0];
        }
#pragma unroll
        for (int r = 0; r < KR; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) S[r][cc] = fmaf(kr[r], vs[cc], S[r][cc]);
      }
    }
    // (4b) y = qd S + A v + bonus v: a 4 x 4 tile of (t, column) per lane
    // group, its depth (K, then L) split over the 4 lanes of the group
    {
      const int sl = lane & 3, cb = 4 * (warp & 1) + (lane >> 2 & 3);
      const int rb = 2 * (warp >> 1) + (lane >> 4);
      float acc[4][4] = {};
#pragma unroll 4
      for (int kk = sl; kk < KP; kk += 4)
        outer4(acc, ld4(QD + kk * SW + 4 * rb), ld4(SS + kk * SW + 4 * cb));
#pragma unroll 4
      for (int s = sl; s < L; s += 4)
        outer4(acc, ld4(AT + s * SW + 4 * rb), ld4(VF + s * SW + 4 * cb));
      float row[4];
      reduce_rows(acc, row, lane);
      const int t = 4 * rb + 2 * (lane & 1) + (lane >> 1 & 1);
      if (U) {
        float bonus = 0.f;
#pragma unroll
        for (int w = 0; w < KP / 32; ++w) bonus += BP[w * L + t];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) row[cc] = fmaf(bonus, VF[t * SW + 4 * cb + cc], row[cc]);
      }
      if (t < nt && 4 * cb < vw)
        store_y(gy + (t0 + t) * HV + 4 * cb, row, min(4, vw - 4 * cb), p.vec_y);
    }
    __syncthreads();
    // (5) the new state as the next chunk's operand
#pragma unroll
    for (int r = 0; r < KR; ++r) st4(SS + (skb * KR + r) * SW + 4 * scb, S[r]);
  }
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kk = skb * KR + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * scb + c;
      if (kk < p.K && j < vw) p.s_fin[(sbase + kk) * p.V + j0 + j] = S[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (K <= 64).  The same chunks, with the products on
// mma.sync m16n8k8 in TF32 with fp32 accumulators.  fp32 accuracy takes the
// 3-way split, x = hi + lo with hi = tf32(x) and lo = tf32(x - hi):
// x y = hi hi' + hi lo' + lo hi' to about 2^-22 of x y.  bf16 v is exact in
// TF32 (its lo is 0), so a product with it takes two.
//
// The warps are specialised, so that the serial chain holds only the
// products that need the state:
//  * 12 prep warps walk the chunks one ahead: they stage the raw rows, take
//    the per-(sub-chunk, k) products, then qd, kd, the decays and A (fp32
//    FFMA in 4 x 4 tiles, with the u bonus on A's diagonal), and write them,
//    split into hi and lo, to one of two operand buffers;
//  * VB / 16 state warps each hold 16 columns of the transposed state S^T
//    (16 x K, fp32) in accumulator tiles for the whole run.  Per chunk they
//    take y^T = S^T qd^T + v^T A^T (S^T moves from accumulator to operand
//    layout by shuffles inside each quad, no shared memory), store y, then
//    S^T <- S^T diag(D_L) + v^T kd, and hand the buffer back.
// Named barriers pass each buffer between the two groups (FULL: written,
// EMPTY: read); the prep warps sync among themselves on a third.  A block
// takes 64 columns of V when B H V / 64 blocks fill the card, else 32.
// At K = 128 the operands would not fit in shared memory, and the fp32
// kernel above runs.  ptxas: the bf16 instances (the served ones) spill
// nothing; fp32 inputs at K = 64 spill 4-12 bytes, since fp32 v adds a lo
// half to every v fragment and a thread has at most 128 registers here.
// ---------------------------------------------------------------------------
constexpr int NPREP = 384;  // threads of the prep warps: 12 warps, first in the block
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PREP = 5;  // named barriers (+ buffer)

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}
__device__ __forceinline__ void split_store(float* hi, float* lo, float x) {
  const float h = tf32(x);
  *hi = h;
  *lo = tf32(x - h);
}
__device__ __forceinline__ float exp_fast(float x) {  // e^x, ex2.approx: 2 ulp
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// d += a b for one m16n8k8 tile
__device__ __forceinline__ void mma8(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}
// The A fragment (16 rows x 8 of depth) of an operand stored [depth][row]
// with row stride w, from depth d0 and row r0; g = lane / 4, c = lane % 4.
__device__ __forceinline__ void frag_a(float (&a)[4], const float* p, int w, int d0, int r0,
                                       int g, int c) {
  a[0] = p[(d0 + c) * w + r0 + g];
  a[1] = p[(d0 + c) * w + r0 + g + 8];
  a[2] = p[(d0 + c + 4) * w + r0 + g];
  a[3] = p[(d0 + c + 4) * w + r0 + g + 8];
}
// The B fragment (8 of depth x 8 columns) of an operand stored [depth][col].
__device__ __forceinline__ void frag_b(float (&b)[2], const float* p, int w, int d0, int c0,
                                       int g, int c) {
  b[0] = p[(d0 + c) * w + c0 + g];
  b[1] = p[(d0 + c + 4) * w + c0 + g];
}
// An accumulator tile (16 x 8) as the A fragment of the next product: the
// columns move inside each quad of lanes.
__device__ __forceinline__ void acc_to_a(float (&a)[4], const float (&d)[4], int lane) {
  const int src = (lane & ~3) | ((lane & 3) >> 1), odd = lane & 1;
  float x[4], y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[e] = __shfl_sync(0xffffffffu, d[e], src);
    y[e] = __shfl_sync(0xffffffffu, d[e], src + 2);
  }
  a[0] = odd ? x[1] : x[0];
  a[1] = odd ? x[3] : x[2];
  a[2] = odd ? y[1] : y[0];
  a[3] = odd ? y[3] : y[2];
}

// One level of a sum across lanes that leaves each lane half of the values:
// the lanes with `up` keep v[HALF..2 HALF), the others v[0..HALF), each
// summed with its partner's (lane ^ mask) copy, into v[0..HALF).
template <int HALF, int N>
__device__ __forceinline__ void sum_half(float (&v)[N], bool up, int mask) {
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    const float keep = up ? v[e + HALF] : v[e], send = up ? v[e] : v[e + HALF];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

__device__ __forceinline__ void store1(float* y, float x) { *y = x; }
__device__ __forceinline__ void store1(bf16* y, float x) { *y = __float2bfloat16(x); }

// Shared memory of the tensor-core kernel, in floats: two operand buffers
// (hi / lo: the split halves of an operand), the prep warps' own arrays,
// then the raw staging ring in T.
template <typename T, int KP, int VBM>
struct LayoutM {
  static constexpr int NSTG = sizeof(T) == 2 ? 2 : 1;  // raw stages (fp32: room for one)
  static constexpr int KDW = KP + 8;             // row strides that keep fragments
  static constexpr int VW = VBM + 8;             // free of bank conflicts
  // one operand buffer, in floats from its start
  static constexpr int QDH = 0;                  // qd, [k][t] (SW)
  static constexpr int QDL = QDH + KP * SW;
  static constexpr int KDH = QDL + KP * SW;      // kd, [t][k] (KDW)
  static constexpr int KDL = KDH + L * KDW;
  static constexpr int ATH = KDL + L * KDW;      // A^T, [s][t] (SW)
  static constexpr int ATL = ATH + L * SW;
  static constexpr int VFH = ATL + L * SW;       // v, [t][j] (VW)
  static constexpr int VFL = VFH + L * VW;       // (fp32 v only)
  static constexpr int DL = VFL + (sizeof(T) == 2 ? 0 : L * VW);  // D_L, [k]
  static constexpr int BUF = DL + KP;
  // the prep warps' arrays, after the two buffers
  static constexpr int QF = 2 * BUF;             // q, k, a: [k][t] (LP), the diagonal tiles
  static constexpr int KF = QF + KP * LP;
  static constexpr int AF = KF + KP * LP;
  static constexpr int QP = AF + KP * LP;        // q', k': the off-diagonal tiles
  static constexpr int KQ = QP + KP * LP;
  static constexpr int MX = KQ + KP * LP;        // M_ab, [pair][k]
  static constexpr int DS = MX + NPAIR * KP;     // D_s, [s][k]
  static constexpr int UU = DS + NS * KP;        // u, [k]
  static constexpr int RG = UU + KP;             // raw g, NSTG x [t][k]
  static constexpr int FLOATS = RG + NSTG * L * KP;
  static constexpr int RAW = 2 * L * KP + L * VBM;  // raw q, k, v of one stage, in T
  static constexpr size_t BYTES = FLOATS * sizeof(float) + NSTG * RAW * sizeof(T);
};

template <typename T, int KP, bool U, int VBM, bool DENSE>
__global__ void __launch_bounds__(NPREP + 2 * VBM, 1)
    ssm_scan_kernel_mma(const Params p, const Strides sd) {
  using LY = LayoutM<T, KP, VBM>;
  constexpr bool V_EXACT = sizeof(T) == 2;  // bf16 v: exact in TF32, no lo half
  constexpr int NTH = NPREP + 2 * VBM;      // VBM / 16 state warps
  constexpr int NTASK = NS * KP;            // (sub-chunk, k) tasks of the prep warps
  constexpr int TPP = (NTASK + NPREP - 1) / NPREP;
  constexpr int NKT = KP / 8;               // 8-column tiles of the state's K
  constexpr int KDW = LY::KDW, VW = LY::VW, NSTG = LY::NSTG;
  const int j0 = blockIdx.x * VBM, h = blockIdx.y, b = blockIdx.z;
  const int vw = min(VBM, p.V - j0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c4 = lane % 4;

  extern __shared__ __align__(16) float sm[];
  float *QF = sm + LY::QF, *KF = sm + LY::KF, *AF = sm + LY::AF, *QP = sm + LY::QP,
        *KQ = sm + LY::KQ, *MX = sm + LY::MX, *DS = sm + LY::DS, *UU = sm + LY::UU;
  T* const raw = reinterpret_cast<T*>(sm + LY::FLOATS);

  const long long HK = static_cast<long long>(p.H) * p.K;
  const long long HV = static_cast<long long>(p.H) * p.V;
  const long long bth = static_cast<long long>(b) * p.T * p.H + h;
  const long long sbase = (static_cast<long long>(b) * p.H + h) * p.K;
  const int nchunks = (p.T + L - 1) / L;

  for (int i = tid; i < 2 * LY::BUF; i += NTH) sm[i] = 0.f;  // A^T above the diagonal: 0
  for (int i = tid; i < KP; i += NTH)
    UU[i] = (U && i < p.K) ? p.u[static_cast<long long>(h) * p.K + i] : 0.f;
  __syncthreads();

  if (tid < NPREP) {
    // ---- the prep warps ----
    // DENSE (rwkv6's operands): q, k and g addressed with one row stride, as
    // before the kernel took strides; through the strides this instance ran
    // 2.4% slower at B1 T5120, H 64 (H100)
    const Rows<T> rows_in = DENSE ? Rows<T>(p.q, p.k, p.g, bth * p.K) : Rows<T>(p, sd, b, h);
    const long long sq = DENSE ? HK : sd.q_st, sk = DENSE ? HK : sd.k_st,
                    sg = DENSE ? HK : sd.g_st;
    const T* gv = static_cast<const T*>(p.v) + bth * p.V + j0;
    const int gk_n = DENSE || !sd.g_head ? p.K : 1;  // g's row length: K, or one per (b, t, h)
    // chunk c's raw rows sit in stage c % NSTG; every issue commits one
    // cp.async group, empty past the last chunk, so that the wait counts
    auto issue = [&](int c) {
      if (c * L < p.T) {
        const int t0 = c * L, rows = min(L, p.T - t0), st = c % NSTG;
        T* rq = raw + st * LY::RAW;
        stage_rows<NPREP>(rq, KP, rows_in.q + t0 * sq, sq, rows, p.K, p.vec_qk);
        stage_rows<NPREP>(rq + L * KP, KP, rows_in.k + t0 * sk, sk, rows, p.K, p.vec_qk);
        stage_rows<NPREP>(sm + LY::RG + st * L * KP, KP, rows_in.g + t0 * sg, sg, rows, gk_n,
                          p.vec_g);
        stage_rows<NPREP>(rq + 2 * L * KP, VBM, gv + t0 * HV, HV, rows, vw, p.vec_v);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int c = 0; c < NSTG; ++c) issue(c);
    for (int c = 0; c < nchunks; ++c) {
      const int t0 = c * L, nt = min(L, p.T - t0), ob = c & 1;
      float* buf = sm + ob * LY::BUF;
      const T* rq = raw + (c % NSTG) * LY::RAW;
      const T* rk = rq + L * KP;
      const T* rv = rk + L * KP;
      const float* rg = sm + LY::RG + (c % NSTG) * L * KP;
      if (c >= 2) bar_sync(BAR_EMPTY + ob, NTH);  // the state warps have read this buffer
      cp_async_wait<NSTG - 1>();
      bar_sync(BAR_PREP, NPREP);

      // (1) per (sub-chunk s, k): fp32 rows, a = exp(g), q' = q w, k' = k r, D_s
      float qp[TPP][R], kp[TPP][R];
#pragma unroll
      for (int i = 0; i < TPP; ++i) {
        const int task = tid + i * NPREP, s = task / KP, k = task % KP;
        if (task < NTASK) {
          const int gk = DENSE || !sd.g_head ? k : 0;  // k's place in a row of g
          float qv[R], kv[R], av[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int t = s * R + r;
            const bool ok = t < nt && k < p.K;  // past T or K: q = k = 0, a = 1 (inert)
            qv[r] = ok ? to_f(rq[t * KP + k]) : 0.f;
            kv[r] = ok ? to_f(rk[t * KP + k]) : 0.f;
            av[r] = ok ? exp_fast(rg[t * KP + gk]) : 1.f;
          }
          st4(QF + k * LP + s * R, qv);
          st4(KF + k * LP + s * R, kv);
          st4(AF + k * LP + s * R, av);
          float w = 1.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (!U) w *= av[r];
            qp[i][r] = qv[r] * w;
            if (U) w *= av[r];
          }
          float rr = 1.f;
#pragma unroll
          for (int r = R - 1; r >= 0; --r) {
            kp[i][r] = kv[r] * rr;
            rr *= av[r];
          }
          st4(QP + k * LP + s * R, qp[i]);
          st4(KQ + k * LP + s * R, kp[i]);
          DS[s * KP + k] = w;
        }
      }
      for (int e = tid; e < L * VBM; e += NPREP) {
        const int t = e / VBM, j = e % VBM;
        const float x = (t < nt && j < vw) ? to_f(rv[t * VBM + j]) : 0.f;
        if (V_EXACT) buf[LY::VFH + t * VW + j] = x;
        else split_store(buf + LY::VFH + t * VW + j, buf + LY::VFL + t * VW + j, x);
      }
      bar_sync(BAR_PREP, NPREP);
      issue(c + NSTG);  // into the stage just read

      // (2) qd = q' P_s and kd = k' Q_s, split; M_ab for (a = s, b < s); D_L
#pragma unroll
      for (int i = 0; i < TPP; ++i) {
        const int task = tid + i * NPREP, s = task / KP, k = task % KP;
        if (task < NTASK) {
          float d[NS], P = 1.f, Q = 1.f, DLk = 1.f;
#pragma unroll
          for (int cc = 0; cc < NS; ++cc) d[cc] = DS[cc * KP + k];
#pragma unroll
          for (int cc = 0; cc < NS; ++cc) {
            if (cc < s) P *= d[cc];
            if (cc > s) Q *= d[cc];
            DLk *= d[cc];
          }
          float qh[R], ql[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float x = qp[i][r] * P;
            qh[r] = tf32(x);
            ql[r] = tf32(x - qh[r]);
            split_store(buf + LY::KDH + (s * R + r) * KDW + k,
                        buf + LY::KDL + (s * R + r) * KDW + k, kp[i][r] * Q);
          }
          st4(buf + LY::QDH + k * SW + s * R, qh);
          st4(buf + LY::QDL + k * SW + s * R, ql);
          float m = 1.f;  // M_{s, sb}, walking sb down from s - 1
#pragma unroll
          for (int sb = NS - 2; sb >= 0; --sb) {
            if (sb < s) {
              MX[(s * (s - 1) / 2 + sb) * KP + k] = m;
              m *= d[sb];
            }
          }
          if (s == 0) buf[LY::DL + k] = DLk;
        }
      }
      bar_sync(BAR_PREP, NPREP);

      // (3) A: lanes 0-223 the 28 off-diagonal tiles, 8 lanes each over
      // k = 8 i + lane % 8; lanes 224-351 the 8 diagonal tiles, 16 lanes each
      // over k = 16 i + lane % 16; lanes sum by shuffles; A split as written
      if (tid < 224) {
        const int pair = tid / 8, sl = tid % 8;
        int ta = 1;
        while ((ta + 1) * ta / 2 <= pair) ++ta;  // pair = ta (ta - 1) / 2 + tb
        const int tb = pair - ta * (ta - 1) / 2;
        float v[16] = {};
#pragma unroll
        for (int i = 0; i < KP / 8; ++i) {
          const int kk = sl + 8 * i;
          const float m = MX[pair * KP + kk];
          const float4 q4 = ld4(QP + kk * LP + ta * R), k4 = ld4(KQ + kk * LP + tb * R);
          const float qs[4] = {q4.x * m, q4.y * m, q4.z * m, q4.w * m},
                      ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int i2 = 0; i2 < 4; ++i2)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[4 * i2 + j] = fmaf(qs[i2], ks[j], v[4 * i2 + j]);
        }
        sum_half<8>(v, lane & 1, 1);
        sum_half<4>(v, lane & 2, 2);
        sum_half<2>(v, lane & 4, 4);
        const int e = 8 * (lane & 1) + 4 * (lane >> 1 & 1) + 2 * (lane >> 2 & 1);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int at = (tb * R + ((e + x) & 3)) * SW + ta * R + ((e + x) >> 2);
          split_store(buf + LY::ATH + at, buf + LY::ATL + at, v[x]);
        }
      } else if (tid < 352) {
        const int tile = (tid - 224) / 16, sl = tid % 16;
        float v[16] = {};
#pragma unroll
        for (int i = 0; i < KP / 16; ++i) {
          const int kk = sl + 16 * i;
          const float4 q4 = ld4(QF + kk * LP + tile * R), k4 = ld4(KF + kk * LP + tile * R),
                       a4 = ld4(AF + kk * LP + tile * R);
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w}, kv[4] = {k4.x, k4.y, k4.z, k4.w},
                      av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float uk = UU[kk];
#pragma unroll
          for (int i2 = 0; i2 < R; ++i2) {
            float x = qv[i2];
            // without u, i reads its own step; with u, the bonus q u k instead
            v[5 * i2] = fmaf(U ? x * uk : x, kv[i2], v[5 * i2]);
#pragma unroll
            for (int j = i2 - 1; j >= 0; --j) {
              if (!U || j < i2 - 1) x *= av[j + 1];
              v[4 * i2 + j] = fmaf(x, kv[j], v[4 * i2 + j]);
            }
          }
        }
        sum_half<8>(v, lane & 1, 1);
        sum_half<4>(v, lane & 2, 2);
        sum_half<2>(v, lane & 4, 4);
        sum_half<1>(v, lane & 8, 8);
        const int e = 8 * (lane & 1) + 4 * (lane >> 1 & 1) + 2 * (lane >> 2 & 1) + (lane >> 3 & 1);
        const int at = (tile * R + (e & 3)) * SW + tile * R + (e >> 2);
        split_store(buf + LY::ATH + at, buf + LY::ATL + at, v[0]);
      }
      bar_arrive(BAR_FULL + ob, NTH);  // chunk c's operands are written
    }
    cp_async_wait<0>();
  } else {
    // ---- the state warps: S^T rows (columns of V) 16 sw .. 16 sw + 15 ----
    const int sw = warp - NPREP / 32, jr = 16 * sw;
    T* gy = static_cast<T*>(p.y) + bth * p.V + j0;
    // S[n]: the tile of K columns 8 n .. 8 n + 7; element e at row
    // jr + g + 8 (e / 2), column 8 n + 2 c4 + e % 2
    float S[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = jr + g + 8 * (e >> 1), kk = 8 * n + 2 * c4 + (e & 1);
        S[n][e] = (p.s0 != nullptr && kk < p.K && j < vw) ? p.s0[(sbase + kk) * p.V + j0 + j]
                                                           : 0.f;
      }
    for (int c = 0; c < nchunks; ++c) {
      const int t0 = c * L, nt = min(L, p.T - t0), ob = c & 1;
      const float* buf = sm + ob * LY::BUF;
      bar_sync(BAR_FULL + ob, NTH);
      // y^T (16 columns of V x 32 tokens) = S^T qd^T + v^T A^T, the lo
      // products in their own accumulators
      float acc[4][4] = {}, acl[4][4] = {};
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        float ah[4], al[4];
        acc_to_a(ah, S[n], lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = ah[e];
          ah[e] = tf32(x);
          al[e] = tf32(x - ah[e]);
        }
#pragma unroll
        for (int tt = 0; tt < 4; ++tt) {
          float bh[2], bl[2];
          frag_b(bh, buf + LY::QDH, SW, 8 * n, 8 * tt, g, c4);
          frag_b(bl, buf + LY::QDL, SW, 8 * n, 8 * tt, g, c4);
          mma8(acc[tt], ah, bh);
          mma8(acl[tt], ah, bl);
          mma8(acl[tt], al, bh);
        }
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float vh[4], vl[4];
        frag_a(vh, buf + LY::VFH, VW, 8 * ks, jr, g, c4);
        if (!V_EXACT) frag_a(vl, buf + LY::VFL, VW, 8 * ks, jr, g, c4);
#pragma unroll
        for (int tt = ks; tt < 4; ++tt) {  // A is 0 above the diagonal
          float bh[2], bl[2];
          frag_b(bh, buf + LY::ATH, SW, 8 * ks, 8 * tt, g, c4);
          frag_b(bl, buf + LY::ATL, SW, 8 * ks, 8 * tt, g, c4);
          mma8(acc[tt], vh, bh);
          mma8(acl[tt], vh, bl);
          if (!V_EXACT) mma8(acl[tt], vl, bh);
        }
      }
#pragma unroll
      for (int tt = 0; tt < 4; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = jr + g + 8 * (e >> 1), t = 8 * tt + 2 * c4 + (e & 1);
          if (t < nt && j < vw) store1(gy + (t0 + t) * HV + j, acc[tt][e] + acl[tt][e]);
        }
      // S^T <- S^T diag(D_L) + v^T kd
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[n][e] *= buf[LY::DL + 8 * n + 2 * c4 + (e & 1)];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        float vh[4], vl[4];
        frag_a(vh, buf + LY::VFH, VW, 8 * ks, jr, g, c4);
        if (!V_EXACT) frag_a(vl, buf + LY::VFL, VW, 8 * ks, jr, g, c4);
#pragma unroll
        for (int n = 0; n < NKT; ++n) {
          float bh[2], bl[2];
          frag_b(bh, buf + LY::KDH, KDW, 8 * ks, 8 * n, g, c4);
          frag_b(bl, buf + LY::KDL, KDW, 8 * ks, 8 * n, g, c4);
          mma8(S[n], vh, bh);
          mma8(S[n], vh, bl);
          if (!V_EXACT) mma8(S[n], vl, bh);
        }
      }
      if (c + 2 < nchunks) bar_arrive(BAR_EMPTY + ob, NTH);  // the prep warps may refill it
    }
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = jr + g + 8 * (e >> 1), kk = 8 * n + 2 * c4 + (e & 1);
        if (kk < p.K && j < vw) p.s_fin[(sbase + kk) * p.V + j0 + j] = S[n][e];
      }
  }
}

// Sets `kernel`'s shared-memory limit once per device (bit `dev` of `done`),
// then launches it on a (V / vb, H, B) grid.
template <typename Kernel>
cudaError_t launch(Kernel* kernel, size_t smem, int threads, int vb, unsigned long long& done,
                   const Params& p, const Strides& sd, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(done >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    done |= 1ull << dev;
  }
  const dim3 grid((p.V + vb - 1) / vb, p.H, p.B);
  kernel<<<grid, threads, smem, stream>>>(p, sd);
  return cudaGetLastError();
}

// The SM count of the current device, read once per device.
cudaError_t sm_count(int* sms) {
  static int count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[dev];
  return cudaSuccess;
}

template <typename T, int KP, bool U, int VBM, bool DENSE>
cudaError_t launch_mma_vb(const Params& p, const Strides& sd, cudaStream_t stream) {
  constexpr size_t smem = LayoutM<T, KP, VBM>::BYTES;
  static_assert(smem <= 232448, "more shared memory than a block may have");
  static unsigned long long done = 0;
  return launch(ssm_scan_kernel_mma<T, KP, U, VBM, DENSE>, smem, NPREP + 2 * VBM, VBM, done, p,
                sd, stream);
}

template <typename T, int KP, bool U, int VBM>
cudaError_t launch_mma_layout(const Params& p, const Strides& sd, cudaStream_t stream) {
  return sd.dense ? launch_mma_vb<T, KP, U, VBM, true>(p, sd, stream)
                 : launch_mma_vb<T, KP, U, VBM, false>(p, sd, stream);
}

// 64 columns of V a block where that fills the card, else 32
template <typename T, int KP, bool U>
cudaError_t launch_mma(const Params& p, const Strides& sd, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long blocks64 = static_cast<long long>(p.B) * p.H * ((p.V + 63) / 64);
  return blocks64 >= sms ? launch_mma_layout<T, KP, U, 64>(p, sd, stream)
                         : launch_mma_layout<T, KP, U, 32>(p, sd, stream);
}

template <typename T, int KP, bool U>
cudaError_t launch_f32(const Params& p, const Strides& sd, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, KP>::BYTES;
  static_assert(smem <= 232448, "more shared memory than a block may have");
  static unsigned long long done = 0;
  return launch(ssm_scan_kernel<T, KP, U>, smem, NT, VB, done, p, sd, stream);
}

template <typename T, bool U>
cudaError_t dispatch_k(const Params& p, const Strides& sd, cudaStream_t stream) {
  if (p.K <= 32) return launch_mma<T, 32, U>(p, sd, stream);
  if (p.K <= 64) return launch_mma<T, 64, U>(p, sd, stream);
  return launch_f32<T, 128, U>(p, sd, stream);
}

template <typename T>
cudaError_t dispatch(const Params& p, const Strides& sd, cudaStream_t stream) {
  return p.u != nullptr ? dispatch_k<T, true>(p, sd, stream)
                        : dispatch_k<T, false>(p, sd, stream);
}

}  // namespace

// y (B, T, H, V) in q's type and s_fin (B, H, K, V) fp32 from q, k (B, T, H, K)
// and contiguous v (B, T, H, V) of one type (is_bf16: bf16, else fp32), g fp32,
// u (H, K) fp32 or null, s0 (B, H, K, V) fp32 or null, on `stream`.  q, k and
// g are read through their (b, t, h) element strides, K with unit stride; g
// holds K log decays per (b, t, h), or one for every k where g_head is set.
// vec_qk / vec_g: every row of q and k / g starts 16-byte aligned and fills
// whole 16-byte pieces.  Returns the launch's cudaError_t (0 on success).
extern "C" int repro_ssm_scan_fwd(const void* q, const void* k, const void* v, const float* g,
                                  const float* u, const float* s0, void* y, float* s_fin,
                                  int is_bf16, int B, int T, int H, int K, int V,
                                  long long q_sb, long long q_st, long long q_sh,
                                  long long k_sb, long long k_st, long long k_sh,
                                  long long g_sb, long long g_st, long long g_sh, int g_head,
                                  int vec_qk, int vec_g, int vec_v, void* stream) {
  if (B < 0 || T < 0 || H < 0 || K < 1 || K > MAX_K || V < 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const int vec_y = V % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  // contiguous (B, T, H, K): an axis of one entry may have any stride
  const long long HK = static_cast<long long>(H) * K;
  auto contiguous = [&](long long sb, long long st, long long sh) {
    return (B == 1 || sb == T * HK) && (T == 1 || st == HK) && (H == 1 || sh == K);
  };
  const int dense = !g_head && contiguous(q_sb, q_st, q_sh) && contiguous(k_sb, k_st, k_sh) &&
                    contiguous(g_sb, g_st, g_sh);
  // a row of one g per (b, t, h) is staged element by element
  const Params p{q, k, v, g, u, s0, y, s_fin, B, T, H, K, V,
                 vec_qk, g_head ? 0 : vec_g, vec_v, vec_y};
  const Strides sd{q_sb, q_st, q_sh, k_sb, k_st, k_sh, g_sb, g_st, g_sh, g_head, dense};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<bf16>(p, sd, s) : dispatch<float>(p, sd, s));
}
