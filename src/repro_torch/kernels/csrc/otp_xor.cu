// B-AES diversify + XOR ("Crypt Engine", paper Fig. 3(a)), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel in repro/kernels/otp_xor/kernel.py:
//   otp_xor  (body _otp_xor_kernel):  out[n, 4s + l] = data[n, 4s + l]
//                                       ^ base[n, l] ^ div[s, l]
// over (N, 4S) u32 data lanes, (N, 4) u32 base OTPs (one AES output per
// wide block) and (S, 4) u32 per-segment diversifiers (row 0 zero, rows
// 1..10 round keys 1..10 in narrow mode).  The TPU version pads N to its
// tile_n and walks a sequential grid; here a grid-stride loop covers the
// N * S segments exactly.
//
// Bound on the H100: bytes.  Per 64-byte block (S = 4) the pass must read
// data 64 + base 16 and write out 64 = 144 bytes, against two XORs per
// lane.  Design: one thread per 16-byte segment, loaded and stored as one
// uint4, so neighbouring threads touch neighbouring addresses; the base
// OTP of a block is read by its S threads from the same 16 bytes (one
// sector, served by L1/L2 after the first); the S diversifiers are staged
// in shared memory once per thread block (dynamic, 16 S bytes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void otp_xor_kernel(const uint4* __restrict__ data,
                               const uint4* __restrict__ base,
                               const uint4* __restrict__ div_g,
                               uint4* __restrict__ out, unsigned total,
                               unsigned s) {
  extern __shared__ uint4 divs[];
  for (unsigned i = threadIdx.x; i < s; i += blockDim.x) divs[i] = div_g[i];
  __syncthreads();

  // total < 2^31 (the wrapper checks), so idx + stride cannot wrap.
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const unsigned blk = idx / s;
    const unsigned seg = idx - blk * s;
    const uint4 d = data[idx];
    const uint4 b = base[blk];
    const uint4 v = divs[seg];
    uint4 o;
    o.x = d.x ^ b.x ^ v.x;
    o.y = d.y ^ b.y ^ v.y;
    o.z = d.z ^ b.z ^ v.z;
    o.w = d.w ^ b.w ^ v.w;
    out[idx] = o;
  }
}

}  // namespace

// data/out (n, 4s) u32, base (n, 4) u32, div (s, 4) u32.  Returns
// cudaError_t (0 on success).
extern "C" int otp_xor(const void* data, const void* base, const void* div,
                       void* out, int n, int s, void* stream) {
  const long long total = static_cast<long long>(n) * s;
  if (n < 0 || s < 1 || total >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  // At most 16 waves of resident blocks (132 SMs x 8 blocks of 256
  // threads); the grid-stride loop covers the rest.
  if (blocks > 132 * 16 * 8) blocks = 132 * 16 * 8;
  const size_t smem = static_cast<size_t>(s) * sizeof(uint4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        otp_xor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  otp_xor_kernel<<<static_cast<int>(blocks), threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<const uint4*>(base),
      static_cast<const uint4*>(div), static_cast<uint4*>(out),
      static_cast<unsigned>(total), static_cast<unsigned>(s));
  return static_cast<int>(cudaGetLastError());
}
