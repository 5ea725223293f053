// Multi-threaded window gather for the token stream (the JAX package's
// dg_gather, midgpt_tpu/native/gather.cpp, carried over unchanged in
// behaviour).
//
// NumPy fancy indexing gathers on one thread and builds an int64 index
// matrix as large as the output. This gathers directly: threads take
// sequences from a shared counter, widen uint16 to int32 on the fly, and
// fill x and y (x shifted by one) in one pass over each source window.
//
// C ABI, bound with ctypes:
//   dg_gather(tokens, n_tokens, offsets, n_seqs, block_size, x_out, y_out,
//             n_threads)
//     tokens:  const uint16_t*  the token stream
//     offsets: const int64_t*   n_seqs window starts
//     x_out:   int32_t*         [n_seqs, block_size]
//     y_out:   int32_t*         [n_seqs, block_size] (x shifted by one)
//   returns 0, or -1 (writing nothing) if a window runs out of the stream.

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

int dg_gather(const uint16_t* tokens, int64_t n_tokens,
              const int64_t* offsets, int64_t n_seqs, int64_t block_size,
              int32_t* x_out, int32_t* y_out, int n_threads) {
  // every window is checked before any output is written
  for (int64_t s = 0; s < n_seqs; ++s) {
    if (offsets[s] < 0 || offsets[s] + block_size + 1 > n_tokens) return -1;
  }
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_seqs) n_threads = static_cast<int>(n_seqs);

  std::atomic<int64_t> next_seq{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t s = next_seq.fetch_add(1, std::memory_order_relaxed);
      if (s >= n_seqs) return;
      const uint16_t* src = tokens + offsets[s];
      int32_t* x = x_out + s * block_size;
      int32_t* y = y_out + s * block_size;
      int32_t prev = static_cast<int32_t>(src[0]);
      for (int64_t t = 0; t < block_size; ++t) {
        const int32_t cur = static_cast<int32_t>(src[t + 1]);
        x[t] = prev;
        y[t] = cur;
        prev = cur;
      }
    }
  };

  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int i = 0; i < n_threads; ++i) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return 0;
}

}  // extern "C"
