// lanesum32 checksum of a byte buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/checksum/kernel.py::_checksum_kernel
// (launched by checksum_lanes).  The buffer is read as little-endian uint32
// words w_i, the last 1-3 bytes zero-padded into one more word, and
//
//     a = sum_i w_i             mod 2^32
//     b = sum_i (i + 1) * w_i   mod 2^32
//
// are added into out[0] and out[1], which the caller has zeroed.  The digest
// is f"{b:08x}{a:08x}" (src/repro/kernels/checksum/ops.py:48).
//
// Bound: bytes.  Each byte is read once and there are two multiply-adds per
// word, so the least time is nbytes / 3.35e12 s on an H100 SXM.  The design
// follows from that:
// - the TPU's 8x128 lane blocks and its sequential grid are gone: a
//   grid-stride loop over 16-byte vector loads, four of them in flight per
//   thread, a grid of a few blocks per SM;
// - the word index is 64-bit, so buffers above 2^31 bytes index right, and
//   the weight is (uint32)(i + 1), so it wraps exactly as (i + 1) mod 2^32;
// - addition mod 2^32 does not depend on order, so warp shuffles, one
//   shared-memory pass and one atomicAdd per block give a bit-exact,
//   deterministic result;
// - where the buffer does not start on a 16-byte boundary, the words before
//   the first boundary are read one by one; where it does not start on a
//   4-byte boundary (a view of a 1- or 2-byte type at an odd offset), every
//   word is built from single bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ void add_word(uint32_t w, unsigned long long i,
                                         uint32_t& a, uint32_t& b) {
  a += w;
  b += w * static_cast<uint32_t>(i + 1ull);
}

__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p, int n) {
  uint32_t w = 0;
  for (int k = 0; k < n; ++k) w |= static_cast<uint32_t>(p[k]) << (8 * k);
  return w;
}

__device__ __forceinline__ void add_vec(uint4 v, unsigned long long word,
                                        uint32_t& a, uint32_t& b) {
  const uint32_t i1 = static_cast<uint32_t>(word + 1ull);
  a += v.x + v.y + v.z + v.w;
  b += v.x * i1 + v.y * (i1 + 1u) + v.z * (i1 + 2u) + v.w * (i1 + 3u);
}

__global__ void __launch_bounds__(kThreads)
lanesum32_kernel(const uint8_t* __restrict__ p, unsigned long long nbytes,
                 unsigned int* __restrict__ out) {
  const unsigned long long tid =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  const unsigned long long nwords = nbytes / 4;  // full words
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  uint32_t a = 0, b = 0;

  if (addr % 4 != 0) {
    // misaligned view: every word from single bytes
    for (unsigned long long i = tid; i < nwords; i += stride)
      add_word(load_bytes(p + 4 * i, 4), i, a, b);
  } else {
    // head: single words up to the first 16-byte boundary
    unsigned long long head = ((16 - addr % 16) % 16) / 4;
    if (head > nwords) head = nwords;
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(p);
    if (tid < head) add_word(__ldg(pw + tid), tid, a, b);
    // body: 16-byte vectors from word `head` on, kUnroll loads in flight
    const uint4* pv = reinterpret_cast<const uint4*>(pw + head);
    const unsigned long long nvec = (nwords - head) / 4;
    unsigned long long j = tid;
    for (; j + (kUnroll - 1) * stride < nvec; j += kUnroll * stride) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(pv + j + u * stride);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_vec(v[u], head + 4 * (j + u * stride), a, b);
    }
    for (; j < nvec; j += stride) add_vec(__ldg(pv + j), head + 4 * j, a, b);
    // words after the last whole vector
    for (unsigned long long i = head + 4 * nvec + tid; i < nwords; i += stride)
      add_word(__ldg(pw + i), i, a, b);
  }
  // the last 1-3 bytes, zero-padded into word `nwords`
  const int tail = static_cast<int>(nbytes % 4);
  if (tail && tid == 0) add_word(load_bytes(p + 4 * nwords, tail), nwords, a, b);

  // block reduction: warp shuffles, then warp 0 over the warps' sums
  __shared__ uint32_t sa[kThreads / 32], sb[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kThreads / 32 ? sa[lane] : 0u;
    b = lane < kThreads / 32 ? sb[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      atomicAdd(out, a);
      atomicAdd(out + 1, b);
    }
  }
}

}  // namespace

// Adds the lanesum32 (a, b) of the nbytes bytes at `data` into out[0], out[1]
// on `stream`.  Returns the launch's cudaError_t (0 on success).
extern "C" int repro_lanesum32(const void* data, long long nbytes, void* out,
                               void* stream) {
  if (nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough threads for one 16-byte vector each, at most kBlocksPerSm blocks per SM
  const long long vecs = nbytes / 16 + 1;
  long long blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  lanesum32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<unsigned long long>(nbytes),
      static_cast<unsigned int*>(out));
  return static_cast<int>(cudaGetLastError());
}
