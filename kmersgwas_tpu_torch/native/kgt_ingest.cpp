// kgt_ingest: native host-side ingest of the PyTorch/CUDA port.
//
// A copy of the ingest half of kmersgwas_tpu/native/kgt_ingest.cpp (the
// squeeze stays in squeeze.cpp). It replaces the reference stack's external
// KMC 3 counter plus the C++ ingest binaries (kmers_add_strand_information,
// list_kmers_found_in_multiple_samples, build_kmers_table; the reference's
// src/) with one shared library:
//
//   * FASTA/FASTQ (optionally gzip) k-mer counting, canonized or as-read,
//     KMC-style sort-and-collapse with prefix-bucketed spilling so memory
//     stays bounded on large read sets
//   * strand-flag merge of the canonized + as-read count sets
//   * N-way union of per-sample strand lists with MAC + strand-form filters
//   * presence/absence table construction (bit-exact .table format:
//     AA BB CC DD | uint64 N | uint32 k | rows of kmer + ceil(N/64) words)
//
// All file formats match kmersgwas_tpu_torch/core/formats.py byte for byte;
// the package builds this library at first use and loads it through ctypes
// (native/__init__.py), and takes the NumPy route (ingest/) where it
// cannot be built.
//
// Build: g++ -std=c++17 -O3 -fPIC -shared -pthread -o libkgt_ingest.so
//        kgt_ingest.cpp -lz
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint64_t kMask62 = 0x3FFFFFFFFFFFFFFFull;
constexpr uint64_t kFlagCanon = 0x4000000000000000ull;
constexpr uint64_t kFlagNonCanon = 0x8000000000000000ull;

inline uint64_t reverse_complement(uint64_t x, uint32_t k) {
  x = ((x & 0xFFFFFFFF00000000ull) >> 32) | ((x & 0x00000000FFFFFFFFull) << 32);
  x = ((x & 0xFFFF0000FFFF0000ull) >> 16) | ((x & 0x0000FFFF0000FFFFull) << 16);
  x = ((x & 0xFF00FF00FF00FF00ull) >> 8) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x & 0xF0F0F0F0F0F0F0F0ull) >> 4) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x & 0xCCCCCCCCCCCCCCCCull) >> 2) | ((x & 0x3333333333333333ull) << 2);
  return (~x) >> (64 - 2 * k);
}

// --------------------------------------------------------------------------
// gz-or-plain line reader
// --------------------------------------------------------------------------
class LineReader {
 public:
  explicit LineReader(const char* path) : gz_(gzopen(path, "rb")) {}
  ~LineReader() {
    if (gz_) gzclose(gz_);
  }
  bool ok() const { return gz_ != nullptr; }
  bool getline(std::string& out) {
    out.clear();
    if (!gz_) return false;
    char buf[1 << 16];
    for (;;) {
      if (gzgets(gz_, buf, sizeof buf) == nullptr) return !out.empty();
      size_t n = std::strlen(buf);
      bool nl = n > 0 && buf[n - 1] == '\n';
      if (nl) --n;
      out.append(buf, n);
      if (nl) return true;
    }
  }

 private:
  gzFile gz_;
};

// --------------------------------------------------------------------------
// counting: emit k-mer codes per read, bucket by top bits, sort + collapse
// --------------------------------------------------------------------------
struct CountBuckets {
  // in-memory buckets; spill paths are created lazily when a bucket grows
  static constexpr int kBucketBits = 6;  // 64 buckets
  std::vector<std::vector<uint64_t>> mem;
  std::vector<FILE*> spill;
  std::string tmpdir;
  size_t max_in_mem;
  uint32_t k;

  CountBuckets(uint32_t k_, const std::string& tmp, size_t max_mem_kmers)
      : mem(1 << kBucketBits), spill(1 << kBucketBits, nullptr), tmpdir(tmp),
        max_in_mem(max_mem_kmers >> kBucketBits), k(k_) {}

  int bucket_of(uint64_t code) const {
    return static_cast<int>(code >> (2 * k > kBucketBits ? 2 * k - kBucketBits : 0)) &
           ((1 << kBucketBits) - 1);
  }

  void add(uint64_t code) {
    int b = bucket_of(code);
    auto& v = mem[b];
    v.push_back(code);
    if (v.size() >= max_in_mem) flush(b);
  }

  void flush(int b) {
    if (mem[b].empty()) return;
    if (!spill[b]) {
      std::string p = tmpdir + "/kgt_bucket_" + std::to_string(b) + ".tmp";
      spill[b] = std::fopen(p.c_str(), "wb+");
    }
    std::fwrite(mem[b].data(), sizeof(uint64_t), mem[b].size(), spill[b]);
    mem[b].clear();
    mem[b].shrink_to_fit();
  }
};

int8_t g_code_lut[256];
struct LutInit {
  LutInit() {
    std::memset(g_code_lut, -1, sizeof g_code_lut);
    g_code_lut[(unsigned)'A'] = 0;
    g_code_lut[(unsigned)'C'] = 1;
    g_code_lut[(unsigned)'G'] = 2;
    g_code_lut[(unsigned)'T'] = 3;
    g_code_lut[(unsigned)'a'] = 0;
    g_code_lut[(unsigned)'c'] = 1;
    g_code_lut[(unsigned)'g'] = 2;
    g_code_lut[(unsigned)'t'] = 3;
  }
} g_lut_init;

void emit_kmers(const std::string& seq, uint32_t k, bool canon, CountBuckets& cb) {
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  uint64_t code = 0;
  uint32_t run = 0;  // valid symbols in current window
  for (char c : seq) {
    int8_t s = g_code_lut[(unsigned char)c];
    if (s < 0) {
      run = 0;
      code = 0;
      continue;
    }
    code = ((code << 2) | (uint64_t)s) & mask;
    if (++run >= k) {
      uint64_t out = code;
      if (canon) {
        uint64_t rc = reverse_complement(code, k);
        if (rc < out) out = rc;
      }
      cb.add(out);
    }
  }
}

bool is_fasta_start(const std::string& line) { return !line.empty() && line[0] == '>'; }

// count one read file into the buckets
bool count_file(const char* path, uint32_t k, bool canon, CountBuckets& cb) {
  LineReader lr(path);
  if (!lr.ok()) return false;
  std::string line;
  if (!lr.getline(line)) return true;
  if (is_fasta_start(line)) {
    std::string seq;
    while (lr.getline(line)) {
      if (is_fasta_start(line)) {
        emit_kmers(seq, k, canon, cb);
        seq.clear();
      } else {
        seq += line;
      }
    }
    emit_kmers(seq, k, canon, cb);
  } else {
    // FASTQ: first line already consumed is a header (@...)
    std::string seq;
    for (;;) {
      if (!lr.getline(seq)) break;           // sequence
      emit_kmers(seq, k, canon, cb);
      if (!lr.getline(line)) break;          // '+'
      if (!lr.getline(line)) break;          // quals
      if (!lr.getline(line)) break;          // next header
    }
  }
  return true;
}

struct KCount {
  uint64_t kmer;
  uint64_t count;
};

// Buffered forward cursor over a sorted (by low 62 bits) uint64 list file.
// Memory stays bounded at kBufWords regardless of file size — the native
// analogue of the reference's load_kmers_upto_x streaming
// (src/kmers_single_database.cpp:158-177).
class ListCursor {
 public:
  static constexpr size_t kBufWords = 1 << 20;  // 8 MB per open file

  bool open(const char* path) {
    f_ = std::fopen(path, "rb");
    return f_ != nullptr;
  }
  ~ListCursor() {
    if (f_) std::fclose(f_);
  }
  bool eof_and_empty() const { return eof_ && pos_ >= buf_.size(); }
  // current element, or false when exhausted
  bool peek(uint64_t& out) {
    if (pos_ >= buf_.size() && !refill()) return false;
    out = buf_[pos_];
    return true;
  }
  void advance() { ++pos_; }

 private:
  bool refill() {
    if (eof_) return false;
    buf_.resize(kBufWords);
    size_t n = std::fread(buf_.data(), sizeof(uint64_t), kBufWords, f_);
    buf_.resize(n);
    pos_ = 0;
    if (n < kBufWords) eof_ = true;
    return n > 0;
  }
  FILE* f_ = nullptr;
  std::vector<uint64_t> buf_;
  size_t pos_ = 0;
  bool eof_ = false;
};

// Buffered writer: batches fwrite calls for word-at-a-time producers.
class WordWriter {
 public:
  explicit WordWriter(FILE* f) : f_(f) { buf_.reserve(kBufWords); }
  ~WordWriter() { flush(); }
  void put(uint64_t w) {
    buf_.push_back(w);
    if (buf_.size() >= kBufWords) flush();
  }
  void flush() {
    if (!buf_.empty()) {
      std::fwrite(buf_.data(), sizeof(uint64_t), buf_.size(), f_);
      buf_.clear();
    }
  }

 private:
  static constexpr size_t kBufWords = 1 << 18;
  FILE* f_;
  std::vector<uint64_t> buf_;
};

}  // namespace

extern "C" {

// Count k-mers across read files into a binary (uint64 kmer, uint64 count)
// record file, sorted by kmer. Returns #distinct k-mers or -1 on error.
long long kgt_count(const char** paths, int n_paths, unsigned k, int canonize,
                    unsigned long long min_count, const char* out_path,
                    const char* tmpdir, unsigned long long max_mem_kmers) {
  if (k < 2 || k > 31) return -1;
  CountBuckets cb(k, tmpdir ? tmpdir : "/tmp", max_mem_kmers ? max_mem_kmers : (1ull << 27));
  for (int i = 0; i < n_paths; ++i) {
    if (!count_file(paths[i], k, canonize != 0, cb)) return -1;
  }
  FILE* out = std::fopen(out_path, "wb");
  if (!out) return -1;
  long long distinct = 0;
  std::vector<uint64_t> pool;
  for (int b = 0; b < (1 << CountBuckets::kBucketBits); ++b) {
    pool.clear();
    pool.swap(cb.mem[b]);
    if (cb.spill[b]) {
      std::fflush(cb.spill[b]);
      long long sz;
      std::fseek(cb.spill[b], 0, SEEK_END);
      sz = std::ftell(cb.spill[b]);
      std::fseek(cb.spill[b], 0, SEEK_SET);
      size_t n = (size_t)sz / sizeof(uint64_t);
      size_t base = pool.size();
      pool.resize(base + n);
      if (std::fread(pool.data() + base, sizeof(uint64_t), n, cb.spill[b]) != n) {
        std::fclose(out);
        return -1;
      }
      std::fclose(cb.spill[b]);
      cb.spill[b] = nullptr;
    }
    if (pool.empty()) continue;
    std::sort(pool.begin(), pool.end());
    size_t i = 0;
    std::vector<KCount> recs;
    while (i < pool.size()) {
      size_t j = i;
      while (j < pool.size() && pool[j] == pool[i]) ++j;
      uint64_t c = j - i;
      if (c >= min_count) recs.push_back({pool[i], c});
      i = j;
    }
    if (!recs.empty())
      std::fwrite(recs.data(), sizeof(KCount), recs.size(), out);
    distinct += (long long)recs.size();
  }
  std::fclose(out);
  return distinct;
}

// Strand merge: canonized counts + as-read counts -> sorted strand list.
// Inputs are (kmer,count) record files from kgt_count. Returns #k-mers
// written, or -1 on error, -2 if some canonized k-mer lacks orientation
// evidence (reference: flag 00 error, kmers_add_strand_information.cpp:129).
long long kgt_strand_merge(const char* canon_path, const char* non_canon_path,
                           unsigned k, const char* out_path) {
  auto load = [](const char* p, std::vector<uint64_t>& v) -> bool {
    FILE* f = std::fopen(p, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    size_t n = (size_t)sz / sizeof(KCount);
    std::vector<KCount> recs(n);
    if (std::fread(recs.data(), sizeof(KCount), n, f) != n) {
      std::fclose(f);
      return false;
    }
    std::fclose(f);
    v.resize(n);
    for (size_t i = 0; i < n; ++i) v[i] = recs[i].kmer;
    return true;
  };
  std::vector<uint64_t> canon, nonc;
  if (!load(canon_path, canon) || !load(non_canon_path, nonc)) return -1;
  std::vector<uint64_t> flags(canon.size(), 0);
  for (uint64_t kk : nonc) {
    uint64_t rc = reverse_complement(kk, k);
    uint64_t key = kk < rc ? kk : rc;
    uint64_t flag = kk < rc ? 1 : 2;
    auto it = std::lower_bound(canon.begin(), canon.end(), key);
    if (it != canon.end() && *it == key) flags[it - canon.begin()] |= flag;
  }
  for (uint64_t f : flags)
    if (f == 0) return -2;
  FILE* out = std::fopen(out_path, "wb");
  if (!out) return -1;
  std::vector<uint64_t> words(canon.size());
  for (size_t i = 0; i < canon.size(); ++i)
    words[i] = canon[i] | (flags[i] << 62);
  // canon is sorted; low-62-bit order == canon order
  std::fwrite(words.data(), sizeof(uint64_t), words.size(), out);
  std::fclose(out);
  return (long long)canon.size();
}

// Union-filter N strand lists into the master list. Out-of-core: each list
// streams through a bounded ListCursor (8 MB/file), so N x billions of
// k-mers never sit in RAM — the reference's 5,000-slice bounded-memory
// design (list_kmers_found_in_multiple_samples.cpp:144-151).
//
// When write_stats != 0, also emits the reference's companion artifacts
// (list_kmers_found_in_multiple_samples.cpp:209-218), byte-identical to the
// Python route (ingest/union.py): <out>.no_pass_kmers (textual MAC-passing
// k-mers that failed the strand test), <out>.shareness, and the three
// (N+1)^2 .stats.{only_canonical,only_non_canonical,both} matrices.
// Returns #passing k-mers or -1.
long long kgt_list_union_stats(const char** paths, int n_samples, unsigned k,
                               unsigned long long mac, double min_strand_frac,
                               const char* out_path, int write_stats) {
  std::vector<ListCursor> cur(n_samples);
  for (int i = 0; i < n_samples; ++i)
    if (!cur[i].open(paths[i])) return -1;
  FILE* out = std::fopen(out_path, "wb");
  if (!out) return -1;
  FILE* nopass = nullptr;
  size_t nn = (size_t)n_samples + 1;
  std::vector<long long> share(nn, 0);
  std::vector<long long> mat_canon, mat_non, mat_both;
  if (write_stats) {
    std::string np_path = std::string(out_path) + ".no_pass_kmers";
    nopass = std::fopen(np_path.c_str(), "w");
    if (!nopass) {
      std::fclose(out);
      return -1;
    }
    std::fputs("kmer\tcount_all\tcanonical\tnon-canonical\tboth\n", nopass);
    mat_canon.assign(nn * nn, 0);
    mat_non.assign(nn * nn, 0);
    mat_both.assign(nn * nn, 0);
  }
  WordWriter writer(out);
  char kbuf[33];
  kbuf[k] = '\0';
  static const char kBases[4] = {'A', 'C', 'G', 'T'};
  // k-way merge over sorted (by low 62 bits) lists with the reference's
  // 3-counter semantics (list_kmers_found_in_multiple_samples.cpp:135-137)
  long long n_pass = 0;
  for (;;) {
    uint64_t lo = ~0ull, w;
    for (int i = 0; i < n_samples; ++i) {
      if (cur[i].peek(w)) {
        uint64_t v = w & kMask62;
        if (v < lo) lo = v;
      }
    }
    if (lo == ~0ull) break;
    uint64_t count_all = 0, count_canon = 0, count_non = 0;
    for (int i = 0; i < n_samples; ++i) {
      if (cur[i].peek(w) && (w & kMask62) == lo) {
        uint64_t flag = w >> 62;
        ++count_all;
        if (flag == 1) ++count_canon;
        if (flag == 2) ++count_non;
        cur[i].advance();
      }
    }
    uint64_t count_both = count_all - count_canon - count_non;
    bool pass_mac = count_all >= mac;
    bool pass = false;
    if (pass_mac) {
      double need = std::ceil(min_strand_frac * (double)count_all);
      pass = (double)(count_canon + count_both) >= need &&
             (double)(count_non + count_both) >= need;
    }
    if (pass) {
      writer.put(lo);
      ++n_pass;
    }
    if (write_stats) {
      if (pass) ++share[count_all];
      mat_canon[count_all * nn + count_canon] += 1;
      mat_non[count_all * nn + count_non] += 1;
      mat_both[count_all * nn + count_both] += 1;
      if (pass_mac && !pass && nopass) {
        for (unsigned i = 0; i < k; ++i)
          kbuf[i] = kBases[(lo >> (2 * (k - 1 - i))) & 3];
        std::fprintf(nopass, "%s\t%llu\t%llu\t%llu\t%llu\n", kbuf,
                     (unsigned long long)count_all,
                     (unsigned long long)count_canon,
                     (unsigned long long)count_non,
                     (unsigned long long)count_both);
      }
    }
  }
  writer.flush();
  std::fclose(out);
  if (write_stats) {
    std::fclose(nopass);
    std::string base(out_path);
    FILE* sf = std::fopen((base + ".shareness").c_str(), "w");
    if (sf) {
      std::fputs("kmer appearance\tcount\n", sf);
      for (size_t i = 0; i < nn; ++i)
        std::fprintf(sf, "%zu\t%lld\n", i, share[i]);
      std::fclose(sf);
    }
    auto dump_mat = [&](const char* suffix, const std::vector<long long>& m) {
      FILE* f = std::fopen((base + ".stats." + suffix).c_str(), "w");
      if (!f) return;
      for (size_t r = 0; r < nn; ++r) {
        for (size_t c = 0; c < nn; ++c)
          std::fprintf(f, c + 1 == nn ? "%lld\n" : "%lld\t", m[r * nn + c]);
      }
      std::fclose(f);
    };
    dump_mat("only_canonical", mat_canon);
    dump_mat("only_non_canonical", mat_non);
    dump_mat("both", mat_both);
  }
  return n_pass;
}

long long kgt_list_union(const char** paths, int n_samples, unsigned k,
                         unsigned long long mac, double min_strand_frac,
                         const char* out_path) {
  return kgt_list_union_stats(paths, n_samples, k, mac, min_strand_frac,
                              out_path, 0);
}

// Build the presence/absence table from sorted sample lists + master list.
// Bit-exact .table output. Returns #rows or -1.
long long kgt_build_table(const char** list_paths, int n_samples,
                          const char* master_path, const char* table_path,
                          unsigned k) {
  // Out-of-core: the master list streams in bounded chunks and every sample
  // list streams through a ListCursor, mirroring the reference's 5,000
  // threshold-bounded passes (build_kmers_table.cpp:98-103). Peak memory is
  // O(chunk x n_words + 8 MB x n_samples) regardless of table size.
  constexpr size_t kChunkRows = 1 << 21;  // 2M master rows per pass
  ListCursor master;
  if (!master.open(master_path)) return -1;
  std::vector<ListCursor> cur(n_samples);
  for (int s = 0; s < n_samples; ++s)
    if (!cur[s].open(list_paths[s])) return -1;

  FILE* out = std::fopen(table_path, "wb");
  if (!out) return -1;
  const unsigned char magic[4] = {0xAA, 0xBB, 0xCC, 0xDD};
  uint64_t n_acc = (uint64_t)n_samples;
  uint32_t klen = k;
  std::fwrite(magic, 1, 4, out);
  std::fwrite(&n_acc, sizeof n_acc, 1, out);
  std::fwrite(&klen, sizeof klen, 1, out);

  size_t n_words = ((size_t)n_samples + 63) / 64;
  std::vector<uint64_t> chunk;
  std::vector<uint64_t> rows;
  std::vector<uint64_t> rowbuf;
  long long n_rows = 0;
  for (;;) {
    chunk.clear();
    uint64_t w;
    while (chunk.size() < kChunkRows && master.peek(w)) {
      chunk.push_back(w);
      master.advance();
    }
    if (chunk.empty()) break;
    uint64_t chunk_max = chunk.back();
    rows.assign(chunk.size() * n_words, 0);
    for (int s = 0; s < n_samples; ++s) {
      uint64_t word = (uint64_t)s / 64, bit = (uint64_t)s % 64;
      size_t mi = 0;
      uint64_t sw;
      // consume every sample element <= chunk_max (two-pointer merge; both
      // sides sorted by the low 62 bits)
      while (cur[s].peek(sw)) {
        uint64_t v = sw & kMask62;
        if (v > chunk_max) break;
        while (mi < chunk.size() && chunk[mi] < v) ++mi;
        if (mi < chunk.size() && chunk[mi] == v)
          rows[mi * n_words + word] |= (1ull << bit);
        cur[s].advance();
      }
    }
    // interleave kmer + presence words and write the whole chunk at once
    rowbuf.resize(chunk.size() * (1 + n_words));
    for (size_t r = 0; r < chunk.size(); ++r) {
      rowbuf[r * (1 + n_words)] = chunk[r];
      std::memcpy(&rowbuf[r * (1 + n_words) + 1], &rows[r * n_words],
                  n_words * sizeof(uint64_t));
    }
    std::fwrite(rowbuf.data(), sizeof(uint64_t), rowbuf.size(), out);
    n_rows += (long long)chunk.size();
  }
  std::fclose(out);
  return n_rows;
}
}  // extern "C"
