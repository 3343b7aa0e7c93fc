// q97's key-space split on the host: a stable two-way partition of one
// table's (customer_sk, item_sk) int32 rows by one bit of the composite
// key's golden-ratio mixing hash.  Loaded with ctypes.CDLL by
// models/key_split.py, so the calling thread does not hold the GIL here.
//
// A row goes to side ((uint64)packed * 0x9E3779B97F4A7C15) >> bit & 1,
// where packed = (int64)cust << 32 | (int64)item & 0xFFFFFFFF: bit for bit
// the JAX package's _split_hash (models/q97.py), negative keys included.
//
// Two passes over row ranges, one thread a range, both in one call: the
// count pass counts each range's side-1 rows, the scatter pass recomputes
// the hash and writes each range's rows at its prefix offsets, side 0
// before side 1, into the caller's two arrays of the table's length.  The
// ranges follow from the row count alone.

#include <algorithm>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kRowsPerWorker = int64_t{1} << 22;
constexpr int kMaxWorkers = 8;
constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ull;

inline uint64_t side_of(int32_t cust, int32_t item, int bit) {
  const uint64_t packed = (uint64_t{static_cast<uint32_t>(cust)} << 32) |
                          uint64_t{static_cast<uint32_t>(item)};
  return (packed * kGolden) >> bit & 1u;
}

// The number of row ranges (and threads) that a table of n rows is cut into.
inline int workers_for(int64_t n) {
  return static_cast<int>(
      std::clamp<int64_t>((n + kRowsPerWorker - 1) / kRowsPerWorker, 1, kMaxWorkers));
}

inline int64_t range_start(int64_t n, int workers, int w) {
  return n / workers * w + std::min<int64_t>(w, n % workers);
}

// Runs fn(w) for every range w: ranges 1.. on threads of their own, range 0
// on the caller's; a range whose thread cannot start runs on the caller's.
template <typename Fn>
void for_each_range(int workers, Fn fn) {
  std::vector<std::thread> threads;
  threads.reserve(workers - 1);
  std::vector<int> inline_ranges{0};
  for (int w = 1; w < workers; ++w) {
    try {
      threads.emplace_back(fn, w);
    } catch (const std::system_error&) {
      inline_ranges.push_back(w);
    }
  }
  for (int w : inline_ranges) fn(w);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Writes side 0's rows to out_cust/out_item[0, n0) and side 1's to [n0, n),
// each side in input order, and returns n0.
int64_t srt_key_split(const int32_t* cust, const int32_t* item, int64_t n, int bit,
                      int32_t* out_cust, int32_t* out_item) {
  const int workers = workers_for(n);
  int64_t ones[kMaxWorkers];
  for_each_range(workers, [=, &ones](int w) {
    int64_t count = 0;
    for (int64_t r = range_start(n, workers, w), end = range_start(n, workers, w + 1);
         r < end; ++r)
      count += static_cast<int64_t>(side_of(cust[r], item[r], bit));
    ones[w] = count;
  });
  int64_t at0[kMaxWorkers], at1[kMaxWorkers];
  int64_t zeros_before = 0, ones_before = 0;
  for (int w = 0; w < workers; ++w) {
    at0[w] = zeros_before;
    at1[w] = ones_before;
    ones_before += ones[w];
    zeros_before += range_start(n, workers, w + 1) - range_start(n, workers, w) - ones[w];
  }
  const int64_t n0 = zeros_before;
  for_each_range(workers, [=, &at0, &at1](int w) {
    int32_t* dc[2] = {out_cust + at0[w], out_cust + n0 + at1[w]};
    int32_t* di[2] = {out_item + at0[w], out_item + n0 + at1[w]};
    for (int64_t r = range_start(n, workers, w), end = range_start(n, workers, w + 1);
         r < end; ++r) {
      const int32_t c = cust[r], i = item[r];
      const uint64_t s = side_of(c, i, bit);
      *dc[s]++ = c;
      *di[s]++ = i;
    }
  });
  return n0;
}

}  // extern "C"
