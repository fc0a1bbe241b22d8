// Mamba-1 selective scan (the forward) for Hopper (sm_90a), bound from Python
// with ctypes (repro_torch/kernels/selective_scan/kernel.py).
//
// Replaces no TPU kernel: the JAX package has no Mamba-1 mixer.  It was added
// for the published Jamba mixer (models/transformer.py::mamba1_apply), whose
// decay differs per (channel, state), so that the chunked ssm_scan kernel,
// which takes one decay per key and head, would need a (B, T, D, N) fp32
// decay tensor in device memory (34 GB at T = 65536, D = 8192, N = 16) and
// V = 1 per "head".  Per batch row b and channel c, with an fp32 state s of N:
//
//     s_t[n] = exp(dt_t[c] A[c, n]) s_{t-1}[n] + dt_t[c] B_t[n] u_t[c]
//     y_t[c] = sum_n C_t[n] s_t[n] + D[c] u_t[c]
//
// u, B, C and y are fp32 or bf16 (one type), dt, A, D and the states fp32.
//
// What bounds it on an H100: per (t, c) it reads u and dt and writes y, 8 bytes
// in bf16, and does 5 N operations, 16 of them exponentials.  At T = 65536, D =
// 8192 the bytes take 1.28 ms at 3.35 TB/s and the operations 0.64 ms at 67
// TFLOP/s; the exponentials run on the SMs' special-function units, 16 a clock
// an SM, about 2.2 ms at the card's clock.  What the design does about it:
//  * no (B, T, D, N) tensor exists anywhere: exp(dt A) and dt B u are formed
//    in registers, and u, dt, B and C are read once from device memory;
//  * a block takes 32 channels (a warp's lanes, so every row of u, dt and y
//    is one coalesced piece) and its 4 warps take 4 of the 16 states each:
//    4 times the warps of one thread a channel, so that at batch 1 every SM
//    has warps on all four of its schedulers to keep the exponential units
//    busy.  Each warp's part of y_t goes to shared memory, and the 4 parts
//    are summed once a chunk, so no step waits on another warp;
//  * the block walks T in chunks of 64 steps, staging the next chunk's rows
//    of u, dt, B and C with cp.async while it computes the current one;
//  * the exponential is one ex2.approx with A log2(e) taken once a thread;
//    B and C are converted to fp32 once a chunk, so a step reads a thread's
//    4 of each as one 16-byte load;
//  * every row (D % 32 == 0, N == 16; the wrapper checks) is whole 16-byte
//    pieces, so nothing is masked but the ragged last chunk of T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int N = 16;          // states per channel
constexpr int CH = 32;         // channels per block: a warp's lanes
constexpr int NW = 4;          // warps per block
constexpr int SPW = N / NW;    // states a thread carries (4: one float4 of B and C)
static_assert(SPW == 4, "a thread reads its B and C as one float4 each");
constexpr int NT = CH * NW;    // threads per block
constexpr int TC = 64;         // time steps a chunk stages
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* u;     // (B, T, D)
  const float* dt;   // (B, T, D)
  const float* A;    // (D, N)
  const void* Bm;    // (B, T, N)
  const void* Cm;    // (B, T, N)
  const float* Dv;   // (D,) or null
  const float* s0;   // (B, D, N) or null: zeros
  void* y;           // (B, T, D)
  float* s_fin;      // (B, D, N)
  int B, T, D;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One stage of shared memory: a chunk's rows of u, dt, B and C.
template <typename T>
struct Stage {
  T u[TC][CH];
  float dt[TC][CH];
  T b[TC][N];
  T c[TC][N];
};

template <typename T>
struct Smem {
  Stage<T> st[2];
  float b[TC][N];       // the current chunk's B and C in fp32
  float c[TC][N];
  float y[NW][TC][CH];  // each warp's part of y
};

// Issues the cp.async copies of rows [t0, t0 + nt) of block (b, c0) into `s`.
template <typename T>
__device__ __forceinline__ void stage(Stage<T>& s, const Params& p, int b, int c0, int t0,
                                      int nt) {
  constexpr int PU = CH * sizeof(T) / 16, PD = CH * 4 / 16, PB = N * sizeof(T) / 16;
  constexpr int PR = PU + PD + 2 * PB;  // 16-byte pieces a row
  const long long row0 = static_cast<long long>(b) * p.T + t0;
  for (int i = threadIdx.x; i < nt * PR; i += NT) {
    const int r = i / PR, k = i % PR;
    const long long row = row0 + r;
    if (k < PU) {
      cp_async16(reinterpret_cast<char*>(s.u[r]) + 16 * k,
                 reinterpret_cast<const char*>(static_cast<const T*>(p.u) + row * p.D + c0) + 16 * k);
    } else if (k < PU + PD) {
      cp_async16(reinterpret_cast<char*>(s.dt[r]) + 16 * (k - PU),
                 reinterpret_cast<const char*>(p.dt + row * p.D + c0) + 16 * (k - PU));
    } else if (k < PU + PD + PB) {
      cp_async16(reinterpret_cast<char*>(s.b[r]) + 16 * (k - PU - PD),
                 reinterpret_cast<const char*>(static_cast<const T*>(p.Bm) + row * N) +
                     16 * (k - PU - PD));
    } else {
      cp_async16(reinterpret_cast<char*>(s.c[r]) + 16 * (k - PU - PD - PB),
                 reinterpret_cast<const char*>(static_cast<const T*>(p.Cm) + row * N) +
                     16 * (k - PU - PD - PB));
    }
  }
}

// grid (D / 32, B), 128 threads: lane = channel c0 + lane, warp w = states
// [4 w, 4 w + 4).
template <typename T>
__global__ void __launch_bounds__(NT) selective_scan_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int lane = threadIdx.x % CH, w = threadIdx.x / CH;
  const int c0 = blockIdx.x * CH, b = blockIdx.y, c = c0 + lane;
  const long long sc = (static_cast<long long>(b) * p.D + c) * N + w * SPW;

  float a2[SPW], s[SPW];
  const float4 a4 = *reinterpret_cast<const float4*>(p.A + static_cast<long long>(c) * N + w * SPW);
  a2[0] = a4.x * LOG2E, a2[1] = a4.y * LOG2E, a2[2] = a4.z * LOG2E, a2[3] = a4.w * LOG2E;
  if (p.s0 != nullptr) {
    const float4 s4 = *reinterpret_cast<const float4*>(p.s0 + sc);
    s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
  } else {
#pragma unroll
    for (int j = 0; j < SPW; ++j) s[j] = 0.f;
  }
  const float dskip = p.Dv != nullptr ? p.Dv[c] : 0.f;
  T* y = static_cast<T*>(p.y) + static_cast<long long>(b) * p.T * p.D + c;

  const int chunks = (p.T + TC - 1) / TC;
  if (chunks > 0) stage(sm.st[0], p, b, c0, 0, min(TC, p.T));
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * TC, nt = min(TC, p.T - t0);
    cp_async_wait_all();
    __syncthreads();  // chunk k landed; every thread is done with chunk k - 1
    if (k + 1 < chunks) stage(sm.st[(k + 1) & 1], p, b, c0, t0 + TC, min(TC, p.T - t0 - TC));
    cp_async_commit();
    const Stage<T>& st = sm.st[k & 1];
    for (int i = threadIdx.x; i < nt * N; i += NT) {  // B and C once in fp32
      sm.b[i / N][i % N] = to_f(st.b[i / N][i % N]);
      sm.c[i / N][i % N] = to_f(st.c[i / N][i % N]);
    }
    __syncthreads();
    // unrolled: a later step's loads and exponentials do not wait on the state
#pragma unroll 8
    for (int t = 0; t < nt; ++t) {
      const float d = st.dt[t][lane];
      const float du = d * to_f(st.u[t][lane]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sm.b[t][w * SPW]);
      const float4 c4 = *reinterpret_cast<const float4*>(&sm.c[t][w * SPW]);
      s[0] = fmaf(ex2(d * a2[0]), s[0], du * b4.x);
      s[1] = fmaf(ex2(d * a2[1]), s[1], du * b4.y);
      s[2] = fmaf(ex2(d * a2[2]), s[2], du * b4.z);
      s[3] = fmaf(ex2(d * a2[3]), s[3], du * b4.w);
      sm.y[w][t][lane] = fmaf(c4.x, s[0], fmaf(c4.y, s[1], fmaf(c4.z, s[2], c4.w * s[3])));
    }
    __syncthreads();
    // lane = i % CH for every i this thread takes, so D[c] is the thread's own
    for (int i = threadIdx.x; i < nt * CH; i += NT) {
      const int t = i / CH;
      const float v = sm.y[0][t][lane] + sm.y[1][t][lane] + sm.y[2][t][lane] + sm.y[3][t][lane];
      store(y + static_cast<long long>(t0 + t) * p.D, fmaf(dskip, to_f(st.u[t][lane]), v));
    }
  }
  *reinterpret_cast<float4*>(p.s_fin + sc) = make_float4(s[0], s[1], s[2], s[3]);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<T>);
  static_assert(smem <= 232448, "more shared memory than a block may have");
  static unsigned long long done = 0;  // devices whose limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(done >> dev & 1)) {
    err = cudaFuncSetAttribute(selective_scan_fwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    done |= 1ull << dev;
  }
  selective_scan_fwd_kernel<T><<<dim3(p.D / CH, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// y (B, T, D) in u's type and s_fin (B, D, N) fp32 from contiguous u (B, T, D),
// dt (B, T, D) fp32, A (D, N) fp32, B and C (B, T, N) of u's type (is_bf16:
// bf16, else fp32), D (D,) fp32 or null and s0 (B, D, N) fp32 or null, on
// `stream`.  Needs N == 16, D % 32 == 0 and 16-byte aligned pointers.
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_selective_scan_fwd(const void* u, const float* dt, const float* A,
                                        const void* Bm, const void* Cm, const float* Dv,
                                        const float* s0, void* y, float* s_fin, int is_bf16,
                                        int B, int T, int D, int n_state, void* stream) {
  if (n_state != N || B < 0 || T < 0 || D < 0 || D % CH || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  const Params p{u, dt, A, Bm, Cm, Dv, s0, y, s_fin, B, T, D};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<bf16>(p, s) : launch<float>(p, s));
}
