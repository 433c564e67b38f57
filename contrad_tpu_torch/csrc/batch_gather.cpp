// Native batch assembly for the host-fed data path (the port of
// contrad_tpu/data/native/batch_gather.cpp; host code, unchanged in what it
// computes).
//
// The hot operation of a host-fed step is gathering N sample rows from a
// (possibly memmapped) uint8 dataset into one contiguous batch buffer, the
// pinned host buffer the card copies from. For 512x512x3 images that is
// 12.6 MB at batch 16 and 50 MB at batch 64: a single-threaded memcpy (and
// page-in from the memmap) becomes the input bottleneck, so the gather fans
// out across threads.
//
// A plain C ABI, loaded with ctypes (contrad_tpu_torch/data/native.py).
//
// Build: g++ -O3 -shared -fPIC -pthread batch_gather.cpp -o libbatch_gather.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather rows src[indices[i]] -> dst[i], each row item_bytes long.
void gather_batch_u8(const uint8_t* src, const int64_t* indices,
                     int64_t n_indices, int64_t item_bytes, uint8_t* dst,
                     int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads == 1 || n_indices < n_threads) {
    for (int64_t i = 0; i < n_indices; ++i) {
      std::memcpy(dst + i * item_bytes, src + indices[i] * item_bytes,
                  static_cast<size_t>(item_bytes));
    }
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n_indices) break;
      std::memcpy(dst + i * item_bytes, src + indices[i] * item_bytes,
                  static_cast<size_t>(item_bytes));
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Fisher-Yates shuffle with SplitMix64: deterministic permutations computed
// natively, off the GIL, for sets of millions of rows.
static inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97f4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

void shuffled_indices(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t state = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(splitmix64(state) % (uint64_t)(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

}  // extern "C"
