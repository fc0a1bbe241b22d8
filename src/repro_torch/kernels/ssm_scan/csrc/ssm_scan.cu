// Gated linear recurrence (the ssm_scan forward) for Hopper (sm_90a), bound
// from Python with ctypes (repro_torch/kernels/ssm_scan/kernel.py).
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
// What bounds it on an H100: the step form does two multiply-adds, about
// 4 * K * V fp32 operations, per (token, head), against 768 bytes at
// K = V = 64 in bf16 (q, k, v and y at 2 bytes, g at 4, each moved once):
// 21 operations a byte, just above the fp32 CUDA cores' balance of
// 67e12 / 3.35e12 = 20.  So the bf16 served shapes are bound by operations,
// barely; in fp32 (1280 bytes) they are bound by bytes.  What the design
// does:
//  * the TPU kernel's sequential chunk grid axis, whose state lives in VMEM
//    scratch, becomes a loop over T inside one block: blocks run in no order,
//    so nothing may carry state from one block to another;
//  * the recurrence is independent across the V columns of S, so one block
//    walks T for one (b, h) and a tile of 16 columns, and B * H * V / 16
//    blocks fill the card (256 at B1, H64, V64);
//  * a thread owns one column and K / 8 rows of the state, in registers.  Its
//    partial y of each step goes to shared memory, and the 8 partials of a
//    (t, column) are added once the chunk is done, so the steps of a chunk
//    depend on each other only through S (one multiply-add a row) and the
//    compiler can overlap them;
//  * 32 time steps of q, k, g (32 x K) and of the tile of v are staged into
//    shared memory with cp.async while the block computes the previous 32;
//    exp(g), the conversion to fp32 and the u bonus are done once per
//    (t, k) when a chunk lands, not once per column; rows are laid out so
//    that each thread reads its K / 8 rows as float4 without bank conflicts;
//  * the step form in fp32 on CUDA cores: no tensor cores, no TF32.  The
//    chunked form on tensor cores (mma / wgmma) is later work;
//  * T, K (<= 128) and V need not be multiples of anything: the ragged last
//    chunk, rows of K past the data and columns past V are masked in the
//    kernel, so no padding pass runs in device memory.  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int L = 32;        // time steps per staged chunk
constexpr int KG = 8;        // threads sharing a column: lane bits 2-4
constexpr int CW = 4;        // columns per warp: lane bits 0-1
constexpr int NW = 4;        // warps per block
constexpr int VT = CW * NW;  // columns per block
constexpr int NT = 32 * NW;  // threads per block
constexpr int MAX_K = 128;
constexpr int YP_LD = VT + 4;  // row of the partial-y array: the 8 k groups hit 8 bank quads

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
  int vec_qk, vec_g, vec_v;  // rows may be copied 16 bytes at a time
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies `rows` rows of `n` elements (global row stride gstride) into shared
// memory (row stride sstride): 16 bytes a cp.async where every row start is
// 16-byte aligned and n fills whole 16-byte pieces, else element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(T* sm, int sstride, const T* g, long long gstride,
                                           int rows, int n, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = n / E;
    for (int i = threadIdx.x; i < rows * per_row; i += NT) {
      const int r = i / per_row, c = (i % per_row) * E;
      cp_async16(sm + r * sstride + c, g + r * gstride + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += NT) {
      const int r = i / n, c = i % n;
      sm[r * sstride + c] = g[r * gstride + c];
    }
  }
}

// Where row kk of a staged time step sits in the fp32 work arrays.  The
// thread of k group kg owns rows kg * KR .. kg * KR + KR - 1.  For KR >= 4
// its rows are stored as float4 groups 32 floats apart, so the 8 groups of a
// warp read 128 consecutive bytes; for KR < 4 they are contiguous.
template <int KR>
__device__ __forceinline__ int widx(int kk) {
  if constexpr (KR >= 4) {
    const int kg = kk / KR, r = kk % KR;
    return (r / 4) * 32 + kg * 4 + (r % 4);
  } else {
    return kk;
  }
}

template <int KR>
__device__ __forceinline__ void load_rows(float (&dst)[KR], const float* row, int kg) {
  if constexpr (KR >= 4) {
#pragma unroll
    for (int rq = 0; rq < KR / 4; ++rq) {
      const float4 x = *reinterpret_cast<const float4*>(row + rq * 32 + kg * 4);
      dst[rq * 4 + 0] = x.x;
      dst[rq * 4 + 1] = x.y;
      dst[rq * 4 + 2] = x.z;
      dst[rq * 4 + 3] = x.w;
    }
  } else if constexpr (KR == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row + kg * 2);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
    dst[0] = row[kg];
  }
}

template <typename T, int KR>
constexpr size_t smem_bytes() {
  constexpr int KP = KG * KR;
  return (2 * L * KP + L * VT) * sizeof(T) +
         (4 * L * KP + L * VT + L * KG * YP_LD + L) * sizeof(float);
}

template <typename T, int KR>
__global__ void __launch_bounds__(NT) ssm_scan_kernel(const Params p) {
  constexpr int KP = KG * KR;           // K padded to 8 * KR
  constexpr int UPL = (KP + 31) / 32;   // rows per lane in the staging pass
  const int j0 = blockIdx.x * VT, h = blockIdx.y, b = blockIdx.z;
  const int vw = min(VT, p.V - j0);     // columns of this tile inside V
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kg = lane / CW, jl = warp * CW + lane % CW;
  const bool col_ok = jl < vw;
  const bool use_u = p.u != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  T* rq = reinterpret_cast<T*>(smem);   // raw chunk as copied: L x KP
  T* rk = rq + L * KP;                  // L x KP
  T* rv = rk + L * KP;                  // L x VT
  float* rg = reinterpret_cast<float*>(rv + L * VT);  // L x KP
  float* fq = rg + L * KP;              // fp32 work arrays, rows at widx
  float* fk = fq + L * KP;
  float* fe = fk + L * KP;              // exp(g)
  float* fv = fe + L * KP;              // L x VT
  float* yp = fv + L * VT;              // L x KG x YP_LD: partial y of each k group
  float* bonus = yp + L * KG * YP_LD;   // L: sum_k q u k

  const long long HK = static_cast<long long>(p.H) * p.K;  // elements per time step
  const long long HV = static_cast<long long>(p.H) * p.V;
  const long long bth = static_cast<long long>(b) * p.T * p.H + h;  // (b, t = 0, h)
  const T* gq = static_cast<const T*>(p.q) + bth * p.K;
  const T* gk = static_cast<const T*>(p.k) + bth * p.K;
  const float* gg = p.g + bth * p.K;
  const T* gv = static_cast<const T*>(p.v) + bth * p.V + j0;
  T* gy = static_cast<T*>(p.y) + bth * p.V + j0;
  const long long sbase = (static_cast<long long>(b) * p.H + h) * p.K;  // row (b, h, 0)

  float S[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kk = kg * KR + r;
    S[r] = (p.s0 != nullptr && kk < p.K && col_ok) ? p.s0[(sbase + kk) * p.V + j0 + jl] : 0.f;
  }
  float u_l[UPL];
#pragma unroll
  for (int i = 0; i < UPL; ++i) {
    const int kk = lane + 32 * i;
    u_l[i] = (use_u && kk < p.K) ? p.u[static_cast<long long>(h) * p.K + kk] : 0.f;
  }

  auto issue = [&](int c) {
    const int t0 = c * L, rows = min(L, p.T - t0);
    stage_rows<T>(rq, KP, gq + t0 * HK, HK, rows, p.K, p.vec_qk);
    stage_rows<T>(rk, KP, gk + t0 * HK, HK, rows, p.K, p.vec_qk);
    stage_rows<float>(rg, KP, gg + t0 * HK, HK, rows, p.K, p.vec_g);
    stage_rows<T>(rv, VT, gv + t0 * HV, HV, rows, vw, p.vec_v);
    cp_async_commit();
  };

  const int nchunks = (p.T + L - 1) / L;
  if (nchunks > 0) issue(0);
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * L, nt = min(L, p.T - t0);
    cp_async_wait_all();
    __syncthreads();
    // the landed chunk to fp32 work arrays: exp(g) and the bonus once per (t, k)
    for (int t = warp; t < nt; t += NW) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < UPL; ++i) {
        const int kk = lane + 32 * i;
        if (kk < KP) {
          float qv = 0.f, kv = 0.f, gl = 0.f;  // rows past K: q = k = 0, exp(0) = 1
          if (kk < p.K) {
            qv = to_f(rq[t * KP + kk]);
            kv = to_f(rk[t * KP + kk]);
            gl = rg[t * KP + kk];
          }
          const int w = t * KP + widx<KR>(kk);
          fq[w] = qv;
          fk[w] = kv;
          fe[w] = expf(gl);
          part = fmaf(qv * u_l[i], kv, part);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) bonus[t] = part;
      if (lane < VT) fv[t * VT + lane] = lane < vw ? to_f(rv[t * VT + lane]) : 0.f;
    }
    __syncthreads();
    if (c + 1 < nchunks) issue(c + 1);  // the raw buffers are free again

    // the recurrence over this chunk's steps
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      float qr[KR], kr[KR], er[KR];
      load_rows<KR>(qr, fq + t * KP, kg);
      load_rows<KR>(kr, fk + t * KP, kg);
      load_rows<KR>(er, fe + t * KP, kg);
      const float vj = fv[t * VT + jl];
      float y0 = 0.f, y1 = 0.f;
      if (use_u) {  // read S_{t-1}, then decay and add
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          if (r & 1) y1 = fmaf(qr[r], S[r], y1);
          else y0 = fmaf(qr[r], S[r], y0);
          S[r] = fmaf(er[r], S[r], kr[r] * vj);
        }
      } else {      // decay and add, then read S_t
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          S[r] = fmaf(er[r], S[r], kr[r] * vj);
          if (r & 1) y1 = fmaf(qr[r], S[r], y1);
          else y0 = fmaf(qr[r], S[r], y0);
        }
      }
      yp[(t * KG + kg) * YP_LD + jl] = y0 + y1;
    }
    __syncthreads();
    // y of the chunk: the 8 partials of each (t, column), plus the bonus
    for (int i = tid; i < nt * VT; i += NT) {
      const int t = i / VT, jj = i % VT;
      float y = bonus[t] * fv[t * VT + jj];  // bonus is 0 without u
#pragma unroll
      for (int g = 0; g < KG; ++g) y += yp[(t * KG + g) * YP_LD + jj];
      if (jj < vw) gy[(t0 + t) * HV + jj] = from_f<T>(y);
    }
  }
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kk = kg * KR + r;
    if (kk < p.K && col_ok) p.s_fin[(sbase + kk) * p.V + j0 + jl] = S[r];
  }
}

template <typename T, int KR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, KR>();
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_kernel<T, KR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.V + VT - 1) / VT, p.H, p.B);
  ssm_scan_kernel<T, KR><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.K <= 8) return launch<T, 1>(p, stream);
  if (p.K <= 16) return launch<T, 2>(p, stream);
  if (p.K <= 32) return launch<T, 4>(p, stream);
  if (p.K <= 64) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

}  // namespace

// y (B, T, H, V) in q's type and s_fin (B, H, K, V) fp32 from contiguous
// q, k (B, T, H, K), v (B, T, H, V) of one type (is_bf16: bf16, else fp32),
// g (B, T, H, K) fp32, u (H, K) fp32 or null, s0 (B, H, K, V) fp32 or null,
// on `stream`.  Returns the launch's cudaError_t (0 on success).
extern "C" int repro_ssm_scan_fwd(const void* q, const void* k, const void* v, const float* g,
                                  const float* u, const float* s0, void* y, float* s_fin,
                                  int is_bf16, int B, int T, int H, int K, int V, int vec_qk,
                                  int vec_g, int vec_v, void* stream) {
  if (B < 0 || T < 0 || H < 0 || K < 1 || K > MAX_K || V < 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const Params p{q, k, v, g, u, s0, y, s_fin, B, T, H, K, V, vec_qk, vec_g, vec_v};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<bf16>(p, s) : dispatch<float>(p, s));
}
