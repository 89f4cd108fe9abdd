// Fused B-AES crypt + NH hash of SeDA optBlks, for Hopper (sm_90a).
//
// Replaces the TPU kernels in repro/kernels/fused_crypt_mac/kernel.py:
//   fused_crypt_mac        (body _fused_kernel):        out = in ^ pad, NH over
//                                                        the INCOMING bytes (read)
//   fused_crypt_mac_write  (body _fused_write_kernel):  out = in ^ pad, NH over
//                                                        the OUTGOING bytes (write)
//   fused_crypt_mac_mixed        (body _fused_kernel_mixed, via _call_mixed)
//   fused_crypt_mac_write_mixed  (body _fused_write_kernel_mixed): the same two
//                                passes with every block under its own key row
// pad[s] = base ^ div[s] for segment s of a block; NH over the block's 4S
// ciphertext lanes followed by its 8 binding words:
//   NH = sum_i (m[2i] + k[2i] mod 2^32) * (m[2i+1] + k[2i+1] mod 2^32) mod 2^64,
// stored as (hi, lo) u32.  The TPU kernel splits each product into 16-bit
// halves because its vector unit has no 64-bit integers; here native
// uint64 multiply-accumulate gives the same value mod 2^64.
//
// Shapes: in/out (N, 4S) u32, base (N, 4) u32, div (S, 4) u32, bind (N, 8)
// u32, key (4S + 8,) u32, nh (N, 2) u32, S in 1..11 at run time (the narrow
// B-AES envelope of kv_pages._kernel_read_ok).  The TPU version's tile_n
// padding is dropped: the grid covers N exactly and masks the edge.
//
// Bound on the H100: bytes.  Per 64-byte block (S = 4) the pass must read
// ct 64 + base 16 + bind 32 and write out 64 + nh 8 = 184 bytes, against
// about a hundred integer operations.  Design: one thread per optBlk; its
// lanes move as 16-byte loads and stores; div and the NH key (at most
// 44 + 52 words) are staged in shared memory once per thread block; the
// data is touched once, with the XOR and the hash from the same registers.
//
// Mixed-key variants.  The TPU kernels take per-block tables gathered from
// the key bank before the call: diversifiers (N, S, 4) and NH key rows
// (N, 4S + 8), 64 + 96 bytes a block at S = 4, which at the main path's
// 655,360 blocks are ~105 MB of extra traffic plus the gathers that write
// them.  Here the kernels take the bank itself, a diversifier bank
// (K, S, 4) u32 and an NH key bank (K, 4S + 8) u32, and one int32 row per
// block; each thread block stages both banks in shared memory (at K = 12,
// S = 4: 768 + 1152 bytes) and every thread indexes them by its row.  Per
// block the read then moves ct 64 + base 16 + bind 32 + row 4 + pt 64 +
// nh 8 = 188 bytes, 4 more than the single-key pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegments = 11;

__device__ __forceinline__ unsigned long long nh_pair(uint32_t a, uint32_t b,
                                                      uint32_t ka, uint32_t kb) {
  return static_cast<unsigned long long>(a + ka) *
         static_cast<unsigned long long>(b + kb);
}

template <bool kWrite>
__global__ void fused_crypt_mac_kernel(const uint4* __restrict__ in,
                                       const uint4* __restrict__ base,
                                       const uint4* __restrict__ div_g,
                                       const uint4* __restrict__ bind,
                                       const uint32_t* __restrict__ key_g,
                                       uint4* __restrict__ out,
                                       uint2* __restrict__ nh, int n, int s) {
  __shared__ uint4 div[kMaxSegments];
  __shared__ uint32_t key[4 * kMaxSegments + 8];
  for (int i = threadIdx.x; i < s; i += blockDim.x) div[i] = div_g[i];
  for (int i = threadIdx.x; i < 4 * s + 8; i += blockDim.x) key[i] = key_g[i];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;

  const uint4 b = base[idx];
  const uint4* row = in + static_cast<size_t>(idx) * s;
  uint4* orow = out + static_cast<size_t>(idx) * s;
  unsigned long long acc = 0;
  for (int j = 0; j < s; ++j) {
    const uint4 d = row[j];
    const uint4 dv = div[j];
    uint4 o;
    o.x = d.x ^ b.x ^ dv.x;
    o.y = d.y ^ b.y ^ dv.y;
    o.z = d.z ^ b.z ^ dv.z;
    o.w = d.w ^ b.w ^ dv.w;
    orow[j] = o;
    const uint4 c = kWrite ? o : d;
    const uint32_t* k = key + 4 * j;
    acc += nh_pair(c.x, c.y, k[0], k[1]);
    acc += nh_pair(c.z, c.w, k[2], k[3]);
  }
  const uint4 b0 = bind[2 * static_cast<size_t>(idx)];
  const uint4 b1 = bind[2 * static_cast<size_t>(idx) + 1];
  const uint32_t* k = key + 4 * s;
  acc += nh_pair(b0.x, b0.y, k[0], k[1]);
  acc += nh_pair(b0.z, b0.w, k[2], k[3]);
  acc += nh_pair(b1.x, b1.y, k[4], k[5]);
  acc += nh_pair(b1.z, b1.w, k[6], k[7]);
  nh[idx] = make_uint2(static_cast<uint32_t>(acc >> 32),
                       static_cast<uint32_t>(acc));
}

// Dynamic shared memory: the diversifier bank (k * s uint4), then the NH
// key bank (k * (4s + 8) u32).
template <bool kWrite>
__global__ void fused_crypt_mac_mixed_kernel(
    const uint4* __restrict__ in, const uint4* __restrict__ base,
    const uint4* __restrict__ div_g, const uint4* __restrict__ bind,
    const uint32_t* __restrict__ key_g, const int* __restrict__ rows,
    uint4* __restrict__ out, uint2* __restrict__ nh, int n, int s, int k) {
  extern __shared__ __align__(16) uint4 smem4[];
  uint4* div = smem4;
  uint32_t* key = reinterpret_cast<uint32_t*>(smem4 + k * s);
  const int key_len = 4 * s + 8;
  for (int i = threadIdx.x; i < k * s; i += blockDim.x) div[i] = div_g[i];
  for (int i = threadIdx.x; i < k * key_len; i += blockDim.x) key[i] = key_g[i];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  // Rows outside the bank are refused on the host; clamp so a bad row
  // can never read outside shared memory.
  const int r = min(max(rows[idx], 0), k - 1);
  const uint4* rdiv = div + r * s;
  const uint32_t* rkey = key + r * key_len;

  const uint4 b = base[idx];
  const uint4* row = in + static_cast<size_t>(idx) * s;
  uint4* orow = out + static_cast<size_t>(idx) * s;
  unsigned long long acc = 0;
  for (int j = 0; j < s; ++j) {
    const uint4 d = row[j];
    const uint4 dv = rdiv[j];
    uint4 o;
    o.x = d.x ^ b.x ^ dv.x;
    o.y = d.y ^ b.y ^ dv.y;
    o.z = d.z ^ b.z ^ dv.z;
    o.w = d.w ^ b.w ^ dv.w;
    orow[j] = o;
    const uint4 c = kWrite ? o : d;
    const uint32_t* kk = rkey + 4 * j;
    acc += nh_pair(c.x, c.y, kk[0], kk[1]);
    acc += nh_pair(c.z, c.w, kk[2], kk[3]);
  }
  const uint4 b0 = bind[2 * static_cast<size_t>(idx)];
  const uint4 b1 = bind[2 * static_cast<size_t>(idx) + 1];
  const uint32_t* kk = rkey + 4 * s;
  acc += nh_pair(b0.x, b0.y, kk[0], kk[1]);
  acc += nh_pair(b0.z, b0.w, kk[2], kk[3]);
  acc += nh_pair(b1.x, b1.y, kk[4], kk[5]);
  acc += nh_pair(b1.z, b1.w, kk[6], kk[7]);
  nh[idx] = make_uint2(static_cast<uint32_t>(acc >> 32),
                       static_cast<uint32_t>(acc));
}

template <bool kWrite>
int launch_mixed(const void* in, const void* base, const void* div,
                 const void* bind, const void* key, const void* rows,
                 void* out, void* nh, int n, int s, int k, void* stream) {
  if (s < 1 || s > kMaxSegments || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(k) * (16 * s + 4 * (4 * s + 8));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_crypt_mac_mixed_kernel<kWrite>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_crypt_mac_mixed_kernel<kWrite><<<blocks, threads, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<const uint4*>(base),
      static_cast<const uint4*>(div), static_cast<const uint4*>(bind),
      static_cast<const uint32_t*>(key), static_cast<const int*>(rows),
      static_cast<uint4*>(out), static_cast<uint2*>(nh), n, s, k);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWrite>
int launch(const void* in, const void* base, const void* div, const void* bind,
           const void* key, void* out, void* nh, int n, int s, void* stream) {
  if (s < 1 || s > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  fused_crypt_mac_kernel<kWrite><<<blocks, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<const uint4*>(base),
      static_cast<const uint4*>(div), static_cast<const uint4*>(bind),
      static_cast<const uint32_t*>(key), static_cast<uint4*>(out),
      static_cast<uint2*>(nh), n, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decrypt direction: NH over the incoming ciphertext.  Returns cudaError_t.
extern "C" int fused_crypt_mac(const void* ct, const void* base, const void* div,
                               const void* bind, const void* key, void* pt,
                               void* nh, int n, int s, void* stream) {
  return launch<false>(ct, base, div, bind, key, pt, nh, n, s, stream);
}

// Encrypt direction: NH over the fresh ciphertext.  Returns cudaError_t.
extern "C" int fused_crypt_mac_write(const void* pt, const void* base,
                                     const void* div, const void* bind,
                                     const void* key, void* ct, void* nh, int n,
                                     int s, void* stream) {
  return launch<true>(pt, base, div, bind, key, ct, nh, n, s, stream);
}

// Mixed-key decrypt: div (k, s, 4) u32, key (k, 4s + 8) u32, rows (n,)
// int32.  Returns cudaError_t.
extern "C" int fused_crypt_mac_mixed(const void* ct, const void* base,
                                     const void* div, const void* bind,
                                     const void* key, const void* rows,
                                     void* pt, void* nh, int n, int s, int k,
                                     void* stream) {
  return launch_mixed<false>(ct, base, div, bind, key, rows, pt, nh, n, s, k,
                             stream);
}

// Mixed-key encrypt: NH over the fresh ciphertext.  Returns cudaError_t.
extern "C" int fused_crypt_mac_write_mixed(const void* pt, const void* base,
                                           const void* div, const void* bind,
                                           const void* key, const void* rows,
                                           void* ct, void* nh, int n, int s,
                                           int k, void* stream) {
  return launch_mixed<true>(pt, base, div, bind, key, rows, ct, nh, n, s, k,
                            stream);
}
