// Spark-exact hash contributions for Hopper (sm_90a).
//
// Replaces the four elementwise Pallas kernels of
// spark_rapids_jni_tpu/ops/hash_pallas.py that share its `_launch` scaffold:
//   srt_xx_hash_fixed8  <- _xx8_kernel   (xxhash64 of one 8-byte value)
//   srt_mm_hash_long    <- _long_kernel  (Spark Murmur3.hashLong contribution)
//   srt_mm_hash_int     <- _int_kernel   (Spark Murmur3.hashInt contribution)
//   srt_xx_hash_fixed4  <- _xx4_kernel   (xxhash64 of one 4-byte value)
// and the byte-string kernel with the tail that was left to XLA beside it,
// _bytes_words_kernel (hash_pallas.py:250) and _mm_bytes_tail
// (ops/hashing.py:162), as three entry points that read their bytes three
// ways (see below):
//   srt_mm_hash_strings     a string column through its Arrow offsets
//   srt_mm_hash_bytes       arbitrary (start, length) spans
//   srt_mm_hash_decimal128  DECIMAL128 (hi, lo), its Java bytes in registers
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
// synchronise, and returns cudaGetLastError() (or the error of the attribute
// call that preceded the launch).

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

// mm_hash_strings: threads per block, the shared-memory stages of a block
// and the bytes of each, and the bytes a tile aims at (see the kernel).
constexpr int kTileThreads = 128;
constexpr int kStages = 2;
constexpr int kStageBytes = 8192;
constexpr int kTileBytes = 6144;
constexpr int kMaxRowsPerThread = 8;
constexpr int kStringsSmem = kStages * kStageBytes;
// Above 48 KB a launch would need cudaFuncAttributeMaxDynamicSharedMemorySize.
static_assert(kStringsSmem <= 48 * 1024, "mm_hash_strings stages exceed 48 KB");

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

__device__ __forceinline__ uint32_t mm_round(uint32_t h1, uint32_t k1) {
  return mm_mix_h1(h1, mm_mix_k1(k1));
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
    out[i] = mm_fmix(mm_round(hh, (uint32_t)v[i]), 4u);
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
    hh = mm_round(hh, (uint32_t)(x & 0xFFFFFFFFull));
    hh = mm_round(hh, (uint32_t)(x >> 32));
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

// ---- Spark Murmur3.hashUnsafeBytes ------------------------------------------
//
// Each entry point computes the whole contribution of one byte string per
// row: every aligned 4-byte little-endian word gets the mixK1/mixH1 round
// (what _bytes_words_kernel computed), then each of the <=3 tail bytes is
// sign-extended to an int and gets a full round (Spark's deviation from
// canonical murmur3), then fmix with the row's byte length (what
// _mm_bytes_tail computed).  The TPU path bucketed rows by length, copied
// them into padded [n, w] byte matrices, re-packed and transposed those into
// word tiles and ran the tail as a second pass, because Pallas takes dense
// tiles; none of that is carried over.
//
// What bounds them: device-memory bytes.  A row moves its own bytes plus
// 8-16 B of offsets or spans and hashes; a word costs about a dozen integer
// instructions, so at ~4 B a word the integer rate sits near the memory rate
// and every instruction a word saves counts.

// Word loads for mm_hash_row: `Words(q)` returns the 4-byte word at the
// 4-aligned position q.  Positions keep the alignment of the absolute address
// modulo 16, so the byte order of a word is the same in both spaces.
struct GlobalWords {
  __device__ __forceinline__ uint32_t operator()(uintptr_t q) const {
    return __ldg(reinterpret_cast<const uint32_t*>(q));
  }
};

struct SharedWords {
  const uint8_t* base;
  __device__ __forceinline__ uint32_t operator()(uint32_t q) const {
    return *reinterpret_cast<const uint32_t*>(base + q);
  }
};

// One row of `len` bytes at position `pos`, chained onto `hh`.  Each word of
// the row is assembled from the two aligned words it straddles with one
// funnel shift; the shift is the same for every word of a row.  Only aligned
// words that hold at least one byte of the row are loaded: the word after
// each full word does, but for the last full word and the tail the next
// position is clamped to `qlast`, the word that holds the row's last byte
// (the clamp bites only where the shift is 0 and the next word is not
// needed).  Such a word never crosses a page, so no load can fault however
// the buffer is aligned, and a row of length 0 loads nothing.
template <class Pos, class Words>
__device__ __forceinline__ uint32_t mm_hash_row(Words words, Pos pos,
                                                int32_t len, uint32_t hh) {
  if (len > 0) {
    const uint32_t sh = (uint32_t)(pos & 3) * 8u;
    const Pos q0 = pos & ~(Pos)3;
    const Pos qlast = (pos + (Pos)(len - 1)) & ~(Pos)3;
    const Pos qw = q0 + (Pos)(len & ~3);  // the aligned word after the last full word
    uint32_t cur = words(q0);
    Pos q = q0;
#pragma unroll 4
    for (; q + 4 < qw; q += 4) {  // every full word but the last
      const uint32_t nxt = words(q + 4);
      hh = mm_round(hh, __funnelshift_r(cur, nxt, sh));
      cur = nxt;
    }
    if (q < qw) {  // the last full word
      q += 4;
      const uint32_t nxt = words(q < qlast ? q : qlast);
      hh = mm_round(hh, __funnelshift_r(cur, nxt, sh));
      cur = nxt;
    }
    // `cur` is now the word at q0 + 4 * (len / 4), which holds the first tail byte
    const int32_t tl = len & 3;
    if (tl) {
      const Pos qn = q + 4;
      const uint32_t bits = __funnelshift_r(cur, words(qn < qlast ? qn : qlast), sh);
      for (int32_t j = 0; j < tl; ++j) {
        hh = mm_round(hh, (uint32_t)(int32_t)(int8_t)(bits >> (8 * j)));
      }
    }
  }
  return mm_fmix(hh, (uint32_t)len);
}

// Entry 2, mm_hash_bytes: row i is chars[starts[i] .. starts[i]+lens[i]).
// It serves each element step of a list walk, whose spans are gathered in
// any order, so no block's rows are contiguous and there is nothing to
// stage: one thread per row in a grid-stride loop, the running hash in a
// register.  A word costs one aligned 4-byte load and one funnel shift, not
// four byte loads and six instructions to assemble them.  What it leaves: a
// warp's 32 threads still stream 32 different rows, so its loads are not
// coalesced and lean on L1 to reuse each line.
__global__ void mm_hash_bytes_kernel(const uint8_t* __restrict__ chars,
                                     const int32_t* __restrict__ starts,
                                     const int32_t* __restrict__ lens,
                                     const uint32_t* __restrict__ h,
                                     uint32_t h_scalar,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t hh = h ? h[i] : h_scalar;
    out[i] = mm_hash_row(GlobalWords{}, (uintptr_t)(chars + starts[i]), lens[i], hh);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, uintptr_t gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The staged window of the tile of rows [r0, r1): their bytes
// [offsets[r0], offsets[r1]) widened to whole aligned 16-byte chunks,
// [a0, end), cut to the stage's budget.  A tile of empty rows stages nothing.
struct Window {
  uintptr_t a0;
  uintptr_t end;
};

__device__ __forceinline__ Window tile_window(const uint8_t* chars,
                                              const int32_t* offsets, int64_t r0,
                                              int64_t r1) {
  const uintptr_t lo = (uintptr_t)(chars + offsets[r0]);
  const uintptr_t hi = (uintptr_t)(chars + offsets[r1]);
  const uintptr_t a0 = lo & ~(uintptr_t)15;
  uintptr_t end = (hi + 15) & ~(uintptr_t)15;
  if (hi == lo) end = a0;
  if (end - a0 > (uintptr_t)kStageBytes) end = a0 + kStageBytes;
  return Window{a0, end};
}

__device__ __forceinline__ void stage_tile(const Window& w, uint8_t* stage) {
  for (uintptr_t c = 16 * threadIdx.x; c < w.end - w.a0; c += 16 * kTileThreads) {
    cp_async16(stage + c, w.a0 + c);
  }
}

// Entry 1, mm_hash_strings: a string or binary column, row i is
// chars[offsets[i] .. offsets[i+1]).  A column's rows lie back to back in
// `chars`, so a tile of consecutive rows is one contiguous byte range.  The
// design for the card: a persistent grid in which each block walks tiles of
// consecutive rows.  Each tile's byte range is copied into shared memory with
// 16-byte cp.async loads on neighbouring aligned addresses (coalesced,
// whatever the rows' lengths), into one of kStages stages, so the next
// tiles' bytes are in flight while this one hashes.  Each thread then hashes
// its rows out of shared memory, assembling every word from two aligned
// 32-bit shared loads with a funnel shift.  A row that does not lie wholly
// inside the staged window (a tile larger than the stage's budget) is hashed
// from device memory by entry 2's code: columns hold strings of any length,
// so this is part of the design, not an error.
//
// A tile holds kTileThreads rows for each of a few rows per thread, as many
// as keep its bytes near kTileBytes at the column's mean row width (one for
// VARCHAR(100), three for CHAR(16)): every block computes the same count
// from offsets[0] and offsets[n], so the tiling needs no launch argument.
// Short rows would otherwise give small tiles, few bytes in flight and a
// block barrier every few words.  What it leaves: rows of different lengths
// still diverge within a warp, and a warp's shared loads of 32 rows at
// scattered positions conflict on banks.
__global__ void __launch_bounds__(kTileThreads)
    mm_hash_strings_kernel(const uint8_t* __restrict__ chars,
                           const int32_t* __restrict__ offsets,
                           const uint32_t* __restrict__ h, uint32_t h_scalar,
                           uint32_t* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) uint8_t stages[];
  const int64_t total = (int64_t)offsets[n] - offsets[0];
  const int64_t fit = total > 0 ? (int64_t)kTileBytes * n / (total * kTileThreads)
                                : kMaxRowsPerThread;
  const int64_t tile_rows =
      (fit < 1 ? 1 : fit > kMaxRowsPerThread ? kMaxRowsPerThread : fit) * kTileThreads;
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  auto window = [&](int64_t t) {
    const int64_t r0 = t * tile_rows;
    return tile_window(chars, offsets, r0, r0 + tile_rows < n ? r0 + tile_rows : n);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    const int64_t t = blockIdx.x + (int64_t)s * gridDim.x;
    if (t < tiles) stage_tile(window(t), stages + s * kStageBytes);
    cp_async_commit();
  }
  int b = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t ahead = t + (int64_t)(kStages - 1) * gridDim.x;
    if (ahead < tiles) {
      stage_tile(window(ahead), stages + (b + kStages - 1) % kStages * kStageBytes);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this tile's copies, issued kStages-1 tiles ago
    __syncthreads();
    const Window w = window(t);
    const SharedWords words{stages + b * kStageBytes};
    const int64_t r1 = (t + 1) * tile_rows < n ? (t + 1) * tile_rows : n;
    for (int64_t r = t * tile_rows + threadIdx.x; r < r1; r += kTileThreads) {
      const int32_t s = offsets[r];
      const int32_t len = offsets[r + 1] - s;
      const uintptr_t p = (uintptr_t)(chars + s);
      const uint32_t hh = h ? h[r] : h_scalar;
      if (len == 0 || p + (uintptr_t)len <= w.end) {
        out[r] = mm_hash_row(words, (uint32_t)(p - w.a0), len, hh);
      } else {
        out[r] = mm_hash_row(GlobalWords{}, p, len, hh);
      }
    }
    __syncthreads();  // every row read stage b before it is refilled
    b = b + 1 == kStages ? 0 : b + 1;
  }
}

// Entry 3, mm_hash_decimal128: Spark hashes a DECIMAL128 as the bytes of
// BigDecimal.unscaledValue().toByteArray(): the minimal big-endian two's
// complement of the 128-bit value, 1..16 bytes.  Each thread builds them in
// registers from (hi, lo): the length is the count of significant bits (of
// the value, or of its complement when negative) plus the sign bit, rounded
// up to bytes; the value is shifted left so that its bytes sit at the top of
// 128 bits; the big-endian words are then the 32-bit lanes from the top,
// byte-swapped, followed by the tail bytes of the next lane.  It reads 16 B a
// row and writes 4 (with 4 more of running hash in).  Building the bytes as
// [n, 16] rows in plain torch first, as the xxhash64 path still does, moves
// many times that through device memory.
__global__ void mm_hash_decimal128_kernel(const int64_t* __restrict__ hi,
                                          const uint64_t* __restrict__ lo,
                                          const uint32_t* __restrict__ h,
                                          uint32_t h_scalar,
                                          uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint64_t vh = (uint64_t)hi[i];
    const uint64_t vl = lo[i];
    const uint64_t sign = (uint64_t)((int64_t)vh >> 63);
    const uint64_t mh = vh ^ sign;
    const uint64_t ml = vl ^ sign;
    const int clz = mh ? __clzll((long long)mh) : 64 + __clzll((long long)ml);
    const int len = (128 - clz + 8) >> 3;  // significant bits + sign, in bytes
    const int s = 8 * (16 - len);          // 0..120; C++ leaves a shift by 64 undefined
    uint64_t th, tl;
    if (s == 0) {
      th = vh;
      tl = vl;
    } else if (s >= 64) {
      th = vl << (s - 64);
      tl = 0;
    } else {
      th = (vh << s) | (vl >> (64 - s));
      tl = vl << s;
    }
    const uint32_t lane[4] = {(uint32_t)(th >> 32), (uint32_t)th, (uint32_t)(tl >> 32),
                              (uint32_t)tl};
    const int nw = len >> 2;
    uint32_t hh = h ? h[i] : h_scalar;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (w < nw) hh = mm_round(hh, __byte_perm(lane[w], 0, 0x0123));
    }
    const uint32_t tail = nw == 0 ? lane[0] : nw == 1 ? lane[1] : nw == 2 ? lane[2] : lane[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < (len & 3)) {
        hh = mm_round(hh, (uint32_t)(int32_t)(int8_t)(tail >> (24 - 8 * j)));
      }
    }
    out[i] = mm_fmix(hh, (uint32_t)len);
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Enough blocks to keep every SM full, capped so that large inputs loop
// inside the block instead of paying for millions of block launches.
unsigned grid_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSm;
  return (unsigned)(want < cap ? want : cap);
}

// mm_hash_strings's block cap: as many blocks as fit on the card at once.
// The carveout and the occupancy query are made once, on the first launch;
// their error is returned by every launch.
struct StringsGrid {
  cudaError_t err;
  int64_t cap;
};

StringsGrid strings_grid() {
  cudaError_t e = cudaFuncSetAttribute(mm_hash_strings_kernel,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mm_hash_strings_kernel,
                                                      kTileThreads, kStringsSmem);
  }
  return StringsGrid{e, (int64_t)sm_count() * (per_sm > 0 ? per_sm : 1)};
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

// One block per tile up to as many blocks as fit on the card at once; the
// blocks then walk the remaining tiles.
int srt_mm_hash_strings(const void* chars, const void* offsets, const void* h,
                        uint32_t h_scalar, void* out, int64_t n, void* stream) {
  static const StringsGrid grid = strings_grid();
  if (grid.err != cudaSuccess) return (int)grid.err;
  const int64_t tiles = (n + kTileThreads - 1) / kTileThreads;  // at one row per thread
  const int64_t cap = grid.cap;
  mm_hash_strings_kernel<<<(unsigned)(tiles < cap ? tiles : cap), kTileThreads, kStringsSmem,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (const int32_t*)offsets, (const uint32_t*)h, h_scalar,
      (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

int srt_mm_hash_decimal128(const void* hi, const void* lo, const void* h,
                           uint32_t h_scalar, void* out, int64_t n, void* stream) {
  mm_hash_decimal128_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)hi, (const uint64_t*)lo, (const uint32_t*)h, h_scalar,
      (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
