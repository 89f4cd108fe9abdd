// AES-128-CTR keystream for SeDA's counter blocks, for Hopper (sm_90a).
//
// Replaces the TPU kernels in repro/kernels/aes_ctr/kernel.py:
//   aes_ctr_keystream        (body _aes_ctr_kernel): AES-128 of (N, 4) u32
//                            counter words under one (11, 16) key schedule,
//                            giving (N, 4) u32 one-time-pad lanes;
//   aes_ctr_keystream_multi  (body _aes_ctr_kernel_multi): the same, but
//                            each block under its own schedule.  The TPU
//                            kernel takes a per-block (N, 11, 16) table
//                            gathered from the key bank; here the kernel
//                            takes the bank itself, (K, 11, 16), and one
//                            int32 row per block, and stages the whole
//                            bank in shared memory (K * 176 bytes, 2 KB
//                            at K = 12) once per thread block.  That keeps
//                            the mixed keystream bound by operations, as
//                            the single-key one is: a per-block table read
//                            from device memory would add 176 bytes a
//                            block and make it bound by bytes.
//
// Byte orders follow the TPU kernel exactly: each counter word is unpacked
// big-endian into the 16-byte state (_unpack_counter_bytes) and the output
// state is packed into little-endian u32 lanes (_pack_lanes_le).  The state
// is FIPS column-major (byte i = row i % 4, column i / 4).  SubBytes is one
// table lookup, which gives the same bytes as both TPU variants ("take"
// gathers the table, "onehot" multiplies a one-hot by it on the MXU).
//
// Bound on the H100: operations.  A block moves 32 bytes (16 in, 16 out)
// but costs about a thousand byte-wide integer operations (10 rounds of
// SubBytes, MixColumns, AddRoundKey).  Design: one thread per 16-byte
// counter block, loaded and stored as one 16-byte access; the 256-byte
// S-box and the 176-byte schedule are staged in shared memory once per
// thread block; the state stays in registers and the 10 rounds are fully
// unrolled, so ShiftRows is register renaming and costs nothing.  The
// S-box lookups are data-dependent shared-memory reads (bank conflicts are
// the known cost of this simple form).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t xtime(uint32_t x) {
  return ((x << 1) ^ ((x >> 7) * 0x1Bu)) & 0xFFu;
}

// One counter block through AES-128 under the schedule rk (176 bytes),
// with the S-box and schedule in shared memory.
__device__ __forceinline__ uint4 aes_block(const uint4 c, const uint8_t* rk,
                                           const uint8_t* sbox) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t s[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s[4 * j + b] = ((w[j] >> (24 - 8 * b)) & 0xFFu) ^ rk[4 * j + b];
    }
  }

#pragma unroll
  for (int r = 1; r < 10; ++r) {
    uint32_t t[16];
    // SubBytes + ShiftRows: t[row + 4 col] = S[s[row + 4 ((col + row) % 4)]].
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = i & 3, col = i >> 2;
      t[i] = sbox[s[row + 4 * ((col + row) & 3)]];
    }
    // MixColumns + AddRoundKey.
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const uint32_t a0 = t[4 * col], a1 = t[4 * col + 1];
      const uint32_t a2 = t[4 * col + 2], a3 = t[4 * col + 3];
      const uint32_t x0 = xtime(a0), x1 = xtime(a1);
      const uint32_t x2 = xtime(a2), x3 = xtime(a3);
      const uint8_t* k = rk + 16 * r + 4 * col;
      s[4 * col + 0] = x0 ^ x1 ^ a1 ^ a2 ^ a3 ^ k[0];
      s[4 * col + 1] = a0 ^ x1 ^ x2 ^ a2 ^ a3 ^ k[1];
      s[4 * col + 2] = a0 ^ a1 ^ x2 ^ x3 ^ a3 ^ k[2];
      s[4 * col + 3] = x0 ^ a0 ^ a1 ^ a2 ^ x3 ^ k[3];
    }
  }

  uint32_t lanes[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t lane = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * j + b;
      const int row = i & 3, col = i >> 2;
      const uint32_t byte = sbox[s[row + 4 * ((col + row) & 3)]] ^ rk[160 + i];
      lane |= byte << (8 * b);
    }
    lanes[j] = lane;
  }
  return make_uint4(lanes[0], lanes[1], lanes[2], lanes[3]);
}

__global__ void aes_ctr_keystream_kernel(const uint4* __restrict__ counters,
                                         const uint8_t* __restrict__ round_keys,
                                         const uint8_t* __restrict__ sbox_g,
                                         uint4* __restrict__ out, int n) {
  __shared__ uint8_t sbox[256];
  __shared__ uint8_t rk[176];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sbox[i] = sbox_g[i];
  for (int i = threadIdx.x; i < 176; i += blockDim.x) rk[i] = round_keys[i];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  out[idx] = aes_block(counters[idx], rk, sbox);
}

// Dynamic shared memory: the S-box (256 B), then the K schedules.
__global__ void aes_ctr_keystream_multi_kernel(
    const uint4* __restrict__ counters, const uint8_t* __restrict__ bank_g,
    const int* __restrict__ rows, const uint8_t* __restrict__ sbox_g,
    uint4* __restrict__ out, int n, int k) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sbox = smem;
  uint8_t* bank = smem + 256;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sbox[i] = sbox_g[i];
  for (int i = threadIdx.x; i < 176 * k; i += blockDim.x) bank[i] = bank_g[i];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  // Rows outside the bank are refused on the host; clamp so a bad row
  // can never read outside shared memory.
  const int r = min(max(rows[idx], 0), k - 1);
  out[idx] = aes_block(counters[idx], bank + 176 * r, sbox);
}

}  // namespace

// counters: (n, 4) u32, round_keys: (11, 16) u8, sbox: (256,) u8,
// out: (n, 4) u32; all device pointers, 16-byte aligned rows.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aes_ctr_keystream(const void* counters, const void* round_keys,
                                 const void* sbox, void* out, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  aes_ctr_keystream_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(counters),
      static_cast<const uint8_t*>(round_keys),
      static_cast<const uint8_t*>(sbox), static_cast<uint4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// counters: (n, 4) u32, bank: (k, 11, 16) u8, rows: (n,) int32,
// sbox: (256,) u8, out: (n, 4) u32.  Returns cudaError_t (0 on success).
extern "C" int aes_ctr_keystream_multi(const void* counters, const void* bank,
                                       const void* rows, const void* sbox,
                                       void* out, int n, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = 256 + 176 * static_cast<size_t>(k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        aes_ctr_keystream_multi_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  aes_ctr_keystream_multi_kernel<<<blocks, threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(counters), static_cast<const uint8_t*>(bank),
      static_cast<const int*>(rows), static_cast<const uint8_t*>(sbox),
      static_cast<uint4*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}
