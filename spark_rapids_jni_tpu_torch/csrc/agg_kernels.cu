// SegmentAgg's segment sum for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the reference's
// jax.ops.segment_sum (spark_rapids_jni_tpu/plans/compiler.py, the SegmentAgg
// emitter), which the port ran as torch's index_add_ into a zeroed grid with
// one spare bucket past its end: every dropped row (masked, or an id outside
// [0, num_segments)) made an atomic add of zero into that one bucket, and
// when nearly every row is dropped those adds serialize on one address.
//   srt_segment_sum  out[ids[i]] += values[i] for every i with
//                    0 <= ids[i] < num_segments; other rows are skipped
//
// What bounds it on the card: device-memory bytes.  Each id is read once
// (4 or 8 bytes a row), each kept row's value once, and the grid written
// once (the wrapper zeroes it); at 3.35 TB/s that is well under a
// millisecond for 134 M rows.
//
// What the design does about it: a grid-stride pass in which neighbouring
// threads read neighbouring ids (coalesced, four loads in flight a thread).
// A dropped row costs only the read of its id: its value is not loaded and
// no atomic is issued, so there is no spare bucket.  Kept rows go one of two
// ways, chosen from the grid's size alone:
//   - num_segments x sizeof(value) <= 48 KB: each block adds into a private
//     copy of the grid in shared memory, then flushes its non-zero bins with
//     one global atomic each (few distinct addresses, many rows);
//   - larger grids: kept rows add straight into the output with global
//     atomics, which spread over the grid's addresses.
// Integer sums are exact in any order: int64 adds through atomicAdd on
// unsigned long long, whose two's-complement wrap gives index_add_'s and
// the reference's bits, overflow included.  Float sums add in atomic order,
// as index_add_ on the card did.
//
// The extern "C" launcher enqueues on the given stream, does not
// synchronise, and returns cudaGetLastError() (or the error of the
// occupancy query that preceded the launch, or cudaErrorInvalidValue for an
// id width or value code it does not take).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kUnroll = 4;  // ids loaded per thread before any is used
// A block-private grid up to this size lives in shared memory; above 48 KB a
// launch would need cudaFuncAttributeMaxDynamicSharedMemorySize.
constexpr size_t kSharedGridBytes = 48 * 1024;

// value codes of srt_segment_sum (ops/agg_cuda.py VALUE_CODES)
enum ValueCode { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

__device__ __forceinline__ void atomic_add(int32_t* p, int32_t v) { atomicAdd((int*)p, (int)v); }
__device__ __forceinline__ void atomic_add(int64_t* p, int64_t v) {
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
}
__device__ __forceinline__ void atomic_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(double* p, double v) { atomicAdd(p, v); }

// An id is kept when 0 <= id < num_segments: one unsigned compare, since a
// negative id sign-extends to a value above every grid size.
template <typename Id>
__device__ __forceinline__ bool kept(Id id, uint64_t num_segments) {
  return (uint64_t)(int64_t)id < num_segments;
}

template <typename Id, typename V, bool kShared>
__global__ void segment_sum_kernel(const Id* __restrict__ ids, const V* __restrict__ vals,
                                   V* __restrict__ out, int64_t n, uint64_t num_segments) {
  extern __shared__ __align__(16) unsigned char smem[];
  V* bins = kShared ? reinterpret_cast<V*>(smem) : out;
  if (kShared) {
    for (uint64_t j = threadIdx.x; j < num_segments; j += blockDim.x) bins[j] = V(0);
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    Id k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) k[u] = ids[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kept(k[u], num_segments)) atomic_add(bins + k[u], vals[i + u * stride]);
    }
  }
  for (; i < n; i += stride) {
    const Id k = ids[i];
    if (kept(k, num_segments)) atomic_add(bins + k, vals[i]);
  }
  if (kShared) {
    __syncthreads();
    for (uint64_t j = threadIdx.x; j < num_segments; j += blockDim.x) {
      const V s = bins[j];
      if (s != V(0)) atomic_add(out + j, s);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <typename Id, typename V>
cudaError_t launch(const void* ids, const void* vals, void* out, int64_t n,
                   int64_t num_segments, cudaStream_t stream) {
  const size_t grid_bytes = (size_t)num_segments * sizeof(V);
  const int64_t want = (n + kThreads - 1) / kThreads;
  int64_t cap = (int64_t)sm_count() * kBlocksPerSm;
  if (grid_bytes <= kSharedGridBytes) {
    // as many blocks as fit on the card at once: each one flushes its grid
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_sum_kernel<Id, V, true>, kThreads, grid_bytes);
    if (e != cudaSuccess) return e;
    cap = (int64_t)sm_count() * (per_sm > 0 ? per_sm : 1);
    segment_sum_kernel<Id, V, true><<<(unsigned)(want < cap ? want : cap), kThreads,
                                      grid_bytes, stream>>>(
        (const Id*)ids, (const V*)vals, (V*)out, n, (uint64_t)num_segments);
  } else {
    segment_sum_kernel<Id, V, false><<<(unsigned)(want < cap ? want : cap), kThreads, 0,
                                       stream>>>(
        (const Id*)ids, (const V*)vals, (V*)out, n, (uint64_t)num_segments);
  }
  return cudaGetLastError();
}

template <typename Id>
cudaError_t launch_values(int value_code, const void* ids, const void* vals, void* out,
                          int64_t n, int64_t num_segments, cudaStream_t stream) {
  switch (value_code) {
    case kInt32: return launch<Id, int32_t>(ids, vals, out, n, num_segments, stream);
    case kInt64: return launch<Id, int64_t>(ids, vals, out, n, num_segments, stream);
    case kFloat32: return launch<Id, float>(ids, vals, out, n, num_segments, stream);
    case kFloat64: return launch<Id, double>(ids, vals, out, n, num_segments, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// (ids, id width in bytes: 4 or 8, values, value code, out[num_segments]
// zeroed, n, num_segments, stream)
int srt_segment_sum(const void* ids, int id_bytes, const void* vals, int value_code,
                    void* out, int64_t n, int64_t num_segments, void* stream) {
  if (n <= 0 || num_segments <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (id_bytes) {
    case 4: return (int)launch_values<int32_t>(value_code, ids, vals, out, n, num_segments, s);
    case 8: return (int)launch_values<int64_t>(value_code, ids, vals, out, n, num_segments, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
