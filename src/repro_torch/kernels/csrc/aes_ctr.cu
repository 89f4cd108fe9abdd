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
//                            bank in shared memory once per thread block,
//                            so a block's schedule costs no device-memory
//                            bytes.
//
// Byte orders follow the TPU kernel exactly: each counter word is unpacked
// big-endian into the 16-byte state (_unpack_counter_bytes) and the output
// state is packed into little-endian u32 lanes (_pack_lanes_le).  The state
// is FIPS column-major (byte i = row i % 4, column i / 4); here it is held
// as four u32 columns, row r in bits 8r..8r+7, which is exactly the lane
// packing, and a counter word becomes its column by one byte swap.
//
// Bound on the H100: operations.  A block moves 32 bytes (16 in, 16 out)
// but AES-128 is ten rounds of SubBytes, ShiftRows, MixColumns and
// AddRoundKey on it, and a table-driven round is limited by how many
// instructions and shared-memory lookups the SMs execute.  Design:
// - Word-wide T-table rounds.  One table, Te0[x] = (2 S[x], S[x], S[x],
//   3 S[x]) from the low byte up (built on the host, see
//   aes_ctr/kernel.py), is the MixColumns column of S[x] in row 0; rows
//   1, 2 and 3 are Te0 rotated left by 8, 16 and 24 bits.  Te2 = Te0
//   rotated by 16 is staged beside it, so an output column is
//   Te0[a] ^ Te2[c] ^ rotl8(Te0[b] ^ Te2[d]) ^ key: 4 lookups, one funnel
//   shift and three 3-input XORs.  ShiftRows is register renaming.  The
//   last round reads S[x] as byte 1 of the same Te0 entries.
// - Conflict-free lookups addressed by one instruction.  Each table
//   entry is 256 bytes of shared memory: Te0[x] once per lane at byte
//   4 L, Te2[x] once per lane at byte 128 + 4 L (64 KB in all).  Lane L
//   always reads bank L, so each of a block's 160 data-dependent lookups
//   is one wavefront whatever the data, and its byte address
//   256 x + 4 L (+ 128) is one byte permute of the state word with a
//   per-lane constant.
// - Round keys as words: 11 16-byte shared loads per block, from a
//   staged copy of the schedule (single key: the same address in every
//   lane, a broadcast) or of the bank row (mixed: broadcast when a
//   warp's rows agree, as on the serving path, where a row covers a
//   whole page).
// - Persistent blocks: as many 256-thread blocks as the card holds at
//   once (SMs x resident blocks); each stages the tables (and the
//   schedules) once and walks the counters with a grid stride, one
//   16-byte load and one 16-byte store per counter block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kEntryBytes = 256;                  // Te0 and Te2, per lane
constexpr int kTableBytes = 256 * kEntryBytes;    // 64 KB
constexpr int kRowWords = 11;                     // uint4 round keys per row

// The byte address of table entry (byte R of x) for this lane: byte R of
// x above the per-lane offset off (< 256) in one PRMT, so 256 x + off.
template <int R>
__device__ __forceinline__ uint32_t entry_at(uint32_t x, uint32_t off) {
  return __byte_perm(x, off, 0x5504u | (R << 4));
}

template <int R>
__device__ __forceinline__ uint32_t look(const unsigned char* table,
                                         uint32_t x, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(table + entry_at<R>(x, off));
}

// Per-lane offsets of this lane's copies of Te0 and Te2 in an entry.
struct Lane {
  uint32_t te0, te2;
};

// One middle round's output column: SubBytes, ShiftRows (column c takes
// row r from column c + r) and MixColumns of a, b, c, d = columns c,
// c + 1, c + 2, c + 3, then AddRoundKey with k.
__device__ __forceinline__ uint32_t round_col(const unsigned char* table,
                                              Lane ln, uint32_t a,
                                              uint32_t b, uint32_t c,
                                              uint32_t d, uint32_t k) {
  const uint32_t odd = look<1>(table, b, ln.te0) ^ look<3>(table, d, ln.te2);
  return look<0>(table, a, ln.te0) ^ look<2>(table, c, ln.te2) ^
         __funnelshift_l(odd, odd, 8) ^ k;
}

// The last round's output column: SubBytes and ShiftRows only.  S[x] is
// byte 1 of Te0[x]; three byte permutes gather the four S bytes.
__device__ __forceinline__ uint32_t last_col(const unsigned char* table,
                                             Lane ln, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d, uint32_t k) {
  const uint32_t lo = __byte_perm(look<0>(table, a, ln.te0),
                                  look<1>(table, b, ln.te0), 0x0051u);
  const uint32_t hi = __byte_perm(look<2>(table, c, ln.te0),
                                  look<3>(table, d, ln.te0), 0x0051u);
  return __byte_perm(lo, hi, 0x5410u) ^ k;
}

// One counter block through AES-128 under the schedule rk (11 round keys,
// each four little-endian words, a column each) in shared memory.
__device__ __forceinline__ uint4 aes_block(const uint4 ctr, const uint4* rk,
                                           const unsigned char* table,
                                           Lane ln) {
  uint4 k = rk[0];
  uint32_t s0 = __byte_perm(ctr.x, 0u, 0x0123u) ^ k.x;
  uint32_t s1 = __byte_perm(ctr.y, 0u, 0x0123u) ^ k.y;
  uint32_t s2 = __byte_perm(ctr.z, 0u, 0x0123u) ^ k.z;
  uint32_t s3 = __byte_perm(ctr.w, 0u, 0x0123u) ^ k.w;
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    k = rk[r];
    const uint32_t t0 = round_col(table, ln, s0, s1, s2, s3, k.x);
    const uint32_t t1 = round_col(table, ln, s1, s2, s3, s0, k.y);
    const uint32_t t2 = round_col(table, ln, s2, s3, s0, s1, k.z);
    const uint32_t t3 = round_col(table, ln, s3, s0, s1, s2, k.w);
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
  }
  k = rk[10];
  return make_uint4(last_col(table, ln, s0, s1, s2, s3, k.x),
                    last_col(table, ln, s1, s2, s3, s0, k.y),
                    last_col(table, ln, s2, s3, s0, s1, k.z),
                    last_col(table, ln, s3, s0, s1, s2, k.w));
}

// Stage Te0 and Te2 = rotl16(Te0), 32 copies each, and the k schedules
// (11 uint4 each) after them; returns this lane's offsets.  Each half
// entry (128 bytes) is written as eight 16-byte stores that start at a
// lane-dependent slot, so the eight threads of a quarter-warp hit
// distinct banks.
__device__ __forceinline__ Lane stage(uint4* smem,
                                      const uint32_t* __restrict__ te0,
                                      const uint4* __restrict__ schedules,
                                      int k) {
  const int lane = threadIdx.x & (kLanes - 1);
  for (int i = threadIdx.x; i < 2 * 256; i += blockDim.x) {
    const uint32_t t = __ldg(te0 + (i >> 1));
    const uint32_t v = (i & 1) ? __funnelshift_l(t, t, 16) : t;
    const uint4 v4 = make_uint4(v, v, v, v);
    uint4* half = smem + 8 * i;                   // 128 bytes per half
#pragma unroll
    for (int j = 0; j < 8; ++j) half[(lane + j) & 7] = v4;
  }
  uint4* bank = smem + kTableBytes / 16;
  for (int i = threadIdx.x; i < kRowWords * k; i += blockDim.x) {
    bank[i] = __ldg(schedules + i);
  }
  return Lane{4u * lane, 128u + 4u * lane};
}

// Dynamic shared memory of both kernels: the tables (64 KB), then the
// schedules (176 bytes each; one for the single-key kernel).
__global__ void __launch_bounds__(kThreads) aes_ctr_keystream_kernel(
    const uint4* __restrict__ counters, const uint4* __restrict__ round_keys,
    const uint32_t* __restrict__ te0, uint4* __restrict__ out, unsigned n) {
  extern __shared__ uint4 smem[];
  const Lane ln = stage(smem, te0, round_keys, 1);
  __syncthreads();
  const unsigned char* table = reinterpret_cast<const unsigned char*>(smem);
  const uint4* rk = smem + kTableBytes / 16;

  // n < 2^31 (the wrapper checks), so i + stride cannot wrap.
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = aes_block(__ldg(counters + i), rk, table, ln);
  }
}

__global__ void __launch_bounds__(kThreads) aes_ctr_keystream_multi_kernel(
    const uint4* __restrict__ counters, const uint4* __restrict__ bank_g,
    const int* __restrict__ rows, const uint32_t* __restrict__ te0,
    uint4* __restrict__ out, unsigned n, int k) {
  extern __shared__ uint4 smem[];
  const Lane ln = stage(smem, te0, bank_g, k);
  __syncthreads();
  const unsigned char* table = reinterpret_cast<const unsigned char*>(smem);
  const uint4* bank = smem + kTableBytes / 16;

  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    // Rows outside the bank are refused on the host; clamp so a bad row
    // can never read outside shared memory.
    const int r = min(max(__ldg(rows + i), 0), k - 1);
    out[i] = aes_block(__ldg(counters + i), bank + kRowWords * r, table, ln);
  }
}

// Thread blocks for n counters: as many as the card keeps resident at
// once with smem bytes of dynamic shared memory each, and no more than n
// needs; 0 with the error in *err.
template <typename Kernel>
int persistent_blocks(Kernel kernel, size_t smem, long long n,
                      cudaError_t* err) {
  int dev = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) {
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (*err == cudaSuccess && smem > 48 * 1024) {
    *err = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  if (*err == cudaSuccess) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, smem);
  }
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  const long long need = (n + kThreads - 1) / kThreads;
  const long long full = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(need < full ? need : full);
}

size_t shared_bytes(int k) {
  return kTableBytes + 16 * kRowWords * static_cast<size_t>(k);
}

}  // namespace

// counters: (n, 4) u32, round_keys: (11, 16) u8, te0: (256,) u32,
// out: (n, 4) u32; all device pointers, 16-byte aligned rows; n < 2^31.
// Returns the launch's cudaError_t (0 on success).
extern "C" int aes_ctr_keystream(const void* counters, const void* round_keys,
                                 const void* te0, void* out, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaError_t err;
  const size_t smem = shared_bytes(1);
  const int blocks =
      persistent_blocks(aes_ctr_keystream_kernel, smem, n, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  aes_ctr_keystream_kernel<<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(counters),
      static_cast<const uint4*>(round_keys), static_cast<const uint32_t*>(te0),
      static_cast<uint4*>(out), static_cast<unsigned>(n));
  return static_cast<int>(cudaGetLastError());
}

// counters: (n, 4) u32, bank: (k, 11, 16) u8, rows: (n,) int32,
// te0: (256,) u32, out: (n, 4) u32.  Returns cudaError_t (0 on success).
extern "C" int aes_ctr_keystream_multi(const void* counters, const void* bank,
                                       const void* rows, const void* te0,
                                       void* out, int n, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaError_t err;
  const size_t smem = shared_bytes(k);
  const int blocks =
      persistent_blocks(aes_ctr_keystream_multi_kernel, smem, n, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  aes_ctr_keystream_multi_kernel<<<blocks, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(counters), static_cast<const uint4*>(bank),
      static_cast<const int*>(rows), static_cast<const uint32_t*>(te0),
      static_cast<uint4*>(out), static_cast<unsigned>(n), k);
  return static_cast<int>(cudaGetLastError());
}

// The number of thread blocks a launch over many counters uses on the
// current device: k = 0 for the single-key kernel, else the mixed kernel
// over a k-row bank.  Negative cudaError_t on failure.
extern "C" int aes_ctr_grid_blocks(int k) {
  cudaError_t err;
  const long long many = 1LL << 40;
  const int blocks =
      k == 0 ? persistent_blocks(aes_ctr_keystream_kernel, shared_bytes(1),
                                 many, &err)
             : persistent_blocks(aes_ctr_keystream_multi_kernel,
                                 shared_bytes(k), many, &err);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
