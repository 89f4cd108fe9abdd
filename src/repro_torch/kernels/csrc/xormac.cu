// NH universal hash of optBlk MAC payloads ("Integ Engine"), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel in repro/kernels/xormac/kernel.py:
//   nh_hash_kernel_call  (body _nh_kernel):  for each row n of an (N, L)
//   u32 payload (an optBlk's data lanes followed by its 8 binding words)
//   and one (L,) u32 key,
//     NH = sum_i (m[2i] + k[2i] mod 2^32) * (m[2i+1] + k[2i+1] mod 2^32)
//          mod 2^64,
//   stored as (hi, lo) u32.  The TPU kernel builds the 64-bit sum from
//   16-bit halves because its vector unit has no 64-bit integers (exact
//   while L/2 <= 65536); here each thread accumulates in a native uint64,
//   and any summation order gives the same value mod 2^64.  The TPU
//   version's tile_n padding is dropped: the grid covers N exactly and
//   masks the edge.
//
// Bound on the H100: bytes.  At the weights boundary's 64-byte optBlk
// (L = 24) a row moves 96 bytes in and 8 out, against 12 multiply-adds.
// Design: one thread per row, its lanes read as 16-byte loads (8-byte
// ones when L is not a multiple of 4); the key is staged in shared memory
// in chunks of kKeyChunk lanes, which every thread of a warp reads at the
// same address (a broadcast).  One chunk covers every optBlk up to 16 KB;
// longer rows loop over chunks, so any L the contract allows runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kKeyChunk = 4096;  // 16 KB of key per pass

__device__ __forceinline__ unsigned long long nh_pair(uint32_t a, uint32_t b,
                                                      uint32_t ka,
                                                      uint32_t kb) {
  return static_cast<unsigned long long>(a + ka) *
         static_cast<unsigned long long>(b + kb);
}

// kVec: 4 = uint4 loads (L % 4 == 0), 2 = uint2 loads (L even).
template <int kVec>
__global__ void nh_hash_kernel(const uint32_t* __restrict__ payload,
                               const uint32_t* __restrict__ key_g,
                               uint2* __restrict__ out, int n, int lanes) {
  __shared__ __align__(16) uint32_t key[kKeyChunk];
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = idx < n;
  unsigned long long acc = 0;
  for (int c0 = 0; c0 < lanes; c0 += kKeyChunk) {
    const int len = min(kKeyChunk, lanes - c0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < len; i += blockDim.x) key[i] = key_g[c0 + i];
    __syncthreads();
    if (!live) continue;
    const uint32_t* row = payload + idx * lanes + c0;
    if constexpr (kVec == 4) {
      const uint4* r = reinterpret_cast<const uint4*>(row);
      for (int j = 0; j < len / 4; ++j) {
        const uint4 m = r[j];
        const uint32_t* k = key + 4 * j;
        acc += nh_pair(m.x, m.y, k[0], k[1]);
        acc += nh_pair(m.z, m.w, k[2], k[3]);
      }
    } else {
      const uint2* r = reinterpret_cast<const uint2*>(row);
      for (int j = 0; j < len / 2; ++j) {
        const uint2 m = r[j];
        acc += nh_pair(m.x, m.y, key[2 * j], key[2 * j + 1]);
      }
    }
  }
  if (live) {
    out[idx] = make_uint2(static_cast<uint32_t>(acc >> 32),
                          static_cast<uint32_t>(acc));
  }
}

}  // namespace

// payload (n, lanes) u32, key (lanes,) u32, out (n, 2) u32 (hi, lo).
// lanes must be even.  Returns cudaError_t (0 on success).
extern "C" int nh_hash(const void* payload, const void* key, void* out, int n,
                       int lanes, void* stream) {
  if (n < 0 || lanes < 2 || lanes % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto* p = static_cast<const uint32_t*>(payload);
  const auto* k = static_cast<const uint32_t*>(key);
  auto* o = static_cast<uint2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (lanes % 4 == 0) {
    nh_hash_kernel<4><<<blocks, kThreads, 0, s>>>(p, k, o, n, lanes);
  } else {
    nh_hash_kernel<2><<<blocks, kThreads, 0, s>>>(p, k, o, n, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
