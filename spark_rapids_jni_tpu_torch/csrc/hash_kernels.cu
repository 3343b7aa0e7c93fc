// Spark-exact hash contributions for Hopper (sm_90a).
//
// Replaces the four elementwise Pallas kernels of
// spark_rapids_jni_tpu/ops/hash_pallas.py that share its `_launch` scaffold:
//   srt_xx_hash_fixed8  <- _xx8_kernel   (xxhash64 of one 8-byte value)
//   srt_mm_hash_long    <- _long_kernel  (Spark Murmur3.hashLong contribution)
//   srt_mm_hash_int     <- _int_kernel   (Spark Murmur3.hashInt contribution)
//   srt_xx_hash_fixed4  <- _xx4_kernel   (xxhash64 of one 4-byte value)
// and the byte-string kernel with the tail that was left to XLA beside it:
//   srt_mm_hash_bytes   <- _bytes_words_kernel (hash_pallas.py:250) and
//                          _mm_bytes_tail (ops/hashing.py:162), see below.
//
// What bounds the four fixed-width kernels on the card: device-memory bytes.
// Each row reads 8 or 4 bytes of value and, with a per-row seed, 4 or 8
// bytes of running hash, and writes 4 or 8 bytes; the arithmetic is some
// 10-40 integer instructions a row, far under the card's integer rate at
// 3.35 TB/s.
//
// What the design does about it: one thread per row in a grid-stride loop, so
// neighbouring threads touch neighbouring addresses and every load and store
// is coalesced; each input is read once and each output written once, with no
// padding to tiles and no staging copy.  A scalar seed or running hash is a
// kernel argument, not a broadcast tensor, which saves its bytes.  The TPU
// kernel spelled every 64-bit operation in 32-bit limbs (Mosaic has no 64-bit
// lanes); Hopper has native 64-bit integer arithmetic, so the limbs are gone.
//
// Each extern "C" launcher enqueues on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMmC1 = 0xCC9E2D51u;
constexpr uint32_t kMmC2 = 0x1B873593u;

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kP3 = 0x165667B19E3779F9ull;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ull;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint32_t mm_mix_k1(uint32_t k1) {
  k1 *= kMmC1;
  k1 = rotl32(k1, 15);
  return k1 * kMmC2;
}

__device__ __forceinline__ uint32_t mm_mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t mm_fmix(uint32_t h, uint32_t length) {
  h ^= length;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint64_t xx_finalize(uint64_t h) {
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  return h ^ (h >> 32);
}

// A null pointer means "use the scalar": one kernel serves both seed forms.
__global__ void mm_hash_int_kernel(const int32_t* __restrict__ v,
                                   const uint32_t* __restrict__ h,
                                   uint32_t h_scalar,
                                   uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t hh = h ? h[i] : h_scalar;
    out[i] = mm_fmix(mm_mix_h1(hh, mm_mix_k1((uint32_t)v[i])), 4u);
  }
}

__global__ void mm_hash_long_kernel(const int64_t* __restrict__ v,
                                    const uint32_t* __restrict__ h,
                                    uint32_t h_scalar,
                                    uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t x = (uint64_t)v[i];
    uint32_t hh = h ? h[i] : h_scalar;
    hh = mm_mix_h1(hh, mm_mix_k1((uint32_t)(x & 0xFFFFFFFFull)));
    hh = mm_mix_h1(hh, mm_mix_k1((uint32_t)(x >> 32)));
    out[i] = mm_fmix(hh, 8u);
  }
}

__global__ void xx_hash_fixed4_kernel(const uint32_t* __restrict__ v,
                                      const uint64_t* __restrict__ seed,
                                      uint64_t seed_scalar,
                                      uint64_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint64_t h = (seed ? seed[i] : seed_scalar) + kP5 + 4u;
    h ^= (uint64_t)v[i] * kP1;
    h = rotl64(h, 23) * kP2 + kP3;
    out[i] = xx_finalize(h);
  }
}

__global__ void xx_hash_fixed8_kernel(const uint64_t* __restrict__ v,
                                      const uint64_t* __restrict__ seed,
                                      uint64_t seed_scalar,
                                      uint64_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint64_t h = (seed ? seed[i] : seed_scalar) + kP5 + 8u;
    uint64_t k1 = v[i] * kP2;
    k1 = rotl64(k1, 31) * kP1;
    h ^= k1;
    h = rotl64(h, 27) * kP1 + kP4;
    out[i] = xx_finalize(h);
  }
}

// Spark Murmur3.hashUnsafeBytes contribution of one byte string per row:
// every aligned 4-byte little-endian word gets the mixK1/mixH1 round (what
// _bytes_words_kernel computed), then each of the <=3 tail bytes is
// sign-extended to an int and gets a full round (Spark's deviation from
// canonical murmur3), then fmix with the row's byte length (what
// _mm_bytes_tail computed).  Row i is chars[starts[i] .. starts[i]+lens[i]),
// so one kernel serves a string column (starts = offsets[:-1]), decimal128's
// 16-byte big-endian rows, and each element step of a list walk.
//
// What bounds it: device-memory bytes, narrowly.  A row moves its own bytes
// plus 12-16 B of metadata and hashes (start, length, hash in, hash out); a
// word costs about 20 integer instructions (four byte loads assembled, two
// multiplies, two rotates, xor, multiply-add, loop), so at ~4 B a word the
// integer rate comes close to the memory rate.
//
// What the design does about it: one thread per row in a grid-stride loop,
// the running hash in a register, each byte read once straight from the
// Arrow buffer.  The TPU path bucketed rows by length, copied them into a
// padded [n, w] byte matrix, re-packed and transposed that into word tiles,
// and ran the tail as a second pass; none of that is carried over.  Byte
// loads are always right at the unaligned row starts of Arrow data and never
// read past a row's end, so the unpadded buffer is safe; a row of length 0
// reads nothing, so an empty buffer may be a null pointer.  What this simple
// design leaves on the table: a warp's 32 threads stream 32 different rows,
// so its loads are not coalesced and lean on L1 to reuse each line, and
// short and long rows in one warp diverge.  A warp per long row and 16-byte
// aligned loads with funnel shifts are later work.
__global__ void mm_hash_bytes_kernel(const uint8_t* __restrict__ chars,
                                     const int32_t* __restrict__ starts,
                                     const int32_t* __restrict__ lens,
                                     const uint32_t* __restrict__ h,
                                     uint32_t h_scalar,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t start = starts[i];
    const int32_t len = lens[i];
    const int32_t aligned = len & ~3;
    uint32_t hh = h ? h[i] : h_scalar;
    for (int32_t j = 0; j < aligned; j += 4) {
      const uint8_t* q = chars + start + j;
      const uint32_t k = (uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                         ((uint32_t)q[2] << 16) | ((uint32_t)q[3] << 24);
      hh = mm_mix_h1(hh, mm_mix_k1(k));
    }
    for (int32_t j = aligned; j < len; ++j) {
      const uint32_t k = (uint32_t)(int32_t)(int8_t)chars[start + j];
      hh = mm_mix_h1(hh, mm_mix_k1(k));
    }
    out[i] = mm_fmix(hh, (uint32_t)len);
  }
}

// Enough blocks to keep every SM full, capped so that large inputs loop
// inside the block instead of paying for millions of block launches.
unsigned grid_for(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  return (unsigned)(want < cap ? want : cap);
}

}  // namespace

extern "C" {

int srt_mm_hash_int(const void* v, const void* h, uint32_t h_scalar, void* out,
                    int64_t n, void* stream) {
  mm_hash_int_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)v, (const uint32_t*)h, h_scalar, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int srt_mm_hash_long(const void* v, const void* h, uint32_t h_scalar, void* out,
                     int64_t n, void* stream) {
  mm_hash_long_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)v, (const uint32_t*)h, h_scalar, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int srt_xx_hash_fixed4(const void* v, const void* seed, uint64_t seed_scalar,
                       void* out, int64_t n, void* stream) {
  xx_hash_fixed4_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)v, (const uint64_t*)seed, seed_scalar, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

int srt_xx_hash_fixed8(const void* v, const void* seed, uint64_t seed_scalar,
                       void* out, int64_t n, void* stream) {
  xx_hash_fixed8_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)v, (const uint64_t*)seed, seed_scalar, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

int srt_mm_hash_bytes(const void* chars, const void* starts, const void* lens,
                      const void* h, uint32_t h_scalar, void* out, int64_t n,
                      void* stream) {
  mm_hash_bytes_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (const int32_t*)starts, (const int32_t*)lens,
      (const uint32_t*)h, h_scalar, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
