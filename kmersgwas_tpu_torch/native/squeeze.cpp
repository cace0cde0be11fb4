// Host squeeze + pack of raw .table rows for the port.
//
// A copy of kgt_squeeze_pack of kmersgwas_tpu/native/kgt_ingest.cpp (the
// port builds and loads its own host library and imports nothing of the
// JAX package); the bytes it writes are the same. Built at first use by
// kmersgwas_tpu_torch/native/__init__.py with the host C++ compiler.
#include <algorithm>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// raw:      n_rows x (1 + wf) uint64 table rows (k-mer word first)
// file_col: n_used column indices into the file's accession order
// Outputs (caller-allocated):
//   kmers_out  n_rows uint64
//   packed_out n_rows x w32 uint32 (LSB-first, zero-padded lanes)
//   pop_out    n_rows int32 popcount over used columns
//   keep_out   n_rows uint8 two-tail MAC mask (min_count <= pc <= n-min_count)
// Returns number of kept rows, or -1.
long long kgt_squeeze_pack(const unsigned long long* raw, long long n_rows,
                           int wf, const long long* file_col, int n_used,
                           int w32, unsigned long long min_count,
                           unsigned long long* kmers_out,
                           unsigned int* packed_out, int* pop_out,
                           unsigned char* keep_out) {
  if (w32 * 32 < n_used) return -1;
  // identity mapping (used columns == file columns 0..n_used-1, in order):
  // the squeeze degenerates to a word copy + popcount
  bool identity = true;
  for (int c = 0; c < n_used; ++c)
    if (file_col[c] != c) {
      identity = false;
      break;
    }

  auto process_range = [&](long long r0, long long r1, long long* kept_out_p) {
    long long kept = 0;
    for (long long r = r0; r < r1; ++r) {
      const unsigned long long* row = raw + r * (1 + wf);
      unsigned int* out = packed_out + r * w32;
      int pc = 0;
      std::memset(out, 0, sizeof(unsigned int) * w32);
      if (identity) {
        int nw64 = (n_used + 63) / 64;
        for (int w = 0; w < nw64; ++w) {
          unsigned long long v = row[1 + w];
          if (w == nw64 - 1 && (n_used & 63))
            v &= (1ull << (n_used & 63)) - 1;  // mask unused file columns
          pc += __builtin_popcountll(v);
          out[2 * w] = (unsigned int)v;
          if (2 * w + 1 < w32) out[2 * w + 1] = (unsigned int)(v >> 32);
        }
      } else {
        for (int c = 0; c < n_used; ++c) {
          long long fc = file_col[c];
          unsigned long long bit = (row[1 + (fc >> 6)] >> (fc & 63)) & 1ull;
          pc += (int)bit;
          out[c >> 5] |= (unsigned int)bit << (c & 31);
        }
      }
      kmers_out[r] = row[0];
      pop_out[r] = pc;
      unsigned char ok = (unsigned long long)pc >= min_count &&
                         (unsigned long long)pc <=
                             (unsigned long long)n_used - min_count;
      keep_out[r] = ok;
      kept += ok;
    }
    *kept_out_p = kept;
  };

  int n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  if (n_rows < 4096 || n_threads == 1) {
    long long kept = 0;
    process_range(0, n_rows, &kept);
    return kept;
  }
  std::vector<std::thread> threads;
  std::vector<long long> kept_parts(n_threads, 0);
  long long per = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long long r0 = t * per, r1 = std::min(n_rows, r0 + per);
    if (r0 >= r1) break;
    threads.emplace_back(process_range, r0, r1, &kept_parts[t]);
  }
  for (auto& th : threads) th.join();
  long long kept = 0;
  for (long long kp : kept_parts) kept += kp;
  return kept;
}

}  // extern "C"
