// Native host scanner: tokenize + dedupe + hash one normalized byte chunk
// in a single pass. This is the ingest-side host hot loop — the dictionary
// build (runtime/dictionary.py) — which otherwise costs three C-level
// passes plus Python set churn per chunk (translate, split, set()).
//
// The port's copy of mapreduce_rust_tpu/native/loader.cpp, unchanged in
// code. The Rust original's equivalent work is wc::map's regex strip +
// split (src/app/wc.rs:6-13) plus DefaultHasher per pair
// (src/mr/worker.rs:111-115) — per-record, per-task, in Rust. Here one
// C++ pass per chunk feeds the egress dictionary while the card does the
// counting; the byte classes and the two polynomial hash lanes MUST match
// core/hashing.py exactly (tests/test_torch_native.py holds them to it).
//
// Exposed via a C ABI for ctypes (no pybind11 needed — see
// native/host.py).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

constexpr uint32_t H1_MULT = 0x01000193u;  // FNV-1a prime
constexpr uint32_t H1_INIT = 0x811C9DC5u;  // FNV offset basis
constexpr uint32_t H2_MULT = 1000003u;     // CPython string-hash prime
constexpr uint32_t H2_INIT = 0x9E3779B9u;  // golden ratio

// Byte classes (core/hashing.byte_class_tables): 0 = delete (ASCII
// punctuation), 1 = word char, 2 = whitespace.
struct Tables {
  uint8_t cls[256];
  Tables() {
    for (int b = 0; b < 256; ++b) cls[b] = 0;
    const char* ws = " \t\n\r\v\f";
    for (const char* p = ws; *p; ++p) cls[(uint8_t)*p] = 2;
    for (int b = 'a'; b <= 'z'; ++b) cls[b] = 1;
    for (int b = 'A'; b <= 'Z'; ++b) cls[b] = 1;
    for (int b = '0'; b <= '9'; ++b) cls[b] = 1;
    cls[(uint8_t)'_'] = 1;
    for (int b = 0x80; b < 256; ++b) cls[b] = 1;  // UTF-8 stays in words
  }
};
const Tables kTables;

// 16-byte slot, two per cache line: the duplicate test is
// (k1, k2, len, first-4-bytes) — all inline — so probing a duplicate (the
// overwhelmingly common case) costs ONE cache miss and never touches the
// words buffer. Equality short of full bytes is justified by the same
// birthday bound as the 64-bit key itself (~2^-64; SURVEY.md §7 hard part
// 3): the words ARE keyed by hash pair throughout the framework, and the
// Python layer still detects cross-word pair collisions at insert.
struct Slot {
  uint32_t k1, k2;
  uint32_t prefix;  // first up-to-4 cleaned bytes, zero-padded
  int32_t len;      // 0 = slot unused
};

// Decode one UTF-8 sequence at buf[p] (caller guarantees buf[p] >= 0x80).
// true  → valid codepoint: *cp set, *n = continuation bytes (advance n+1).
// false → invalid (stray continuation, truncation, overlong, surrogate,
//          out of range): caller advances by 1 and the byte is deleted —
//          Python's errors="replace" per bad byte, then U+FFFD → delete.
// THE single decode+validate used by every walker in this file
// (mr_normalize, mr_scan_count's hash pass and its reclean): stored word
// bytes are only correct if all walkers classify identically, so this
// logic must never be duplicated.
inline bool decode_utf8(const uint8_t* buf, int64_t len, int64_t p,
                        uint32_t* cp, int* n) {
  uint8_t c = buf[p];
  uint32_t v = 0;
  int k = 0;
  if ((c & 0xE0) == 0xC0) { v = c & 0x1F; k = 1; }
  else if ((c & 0xF0) == 0xE0) { v = c & 0x0F; k = 2; }
  else if ((c & 0xF8) == 0xF0) { v = c & 0x07; k = 3; }
  else return false;
  bool ok = (p + k < len);
  for (int j = 1; ok && j <= k; ++j) {
    if ((buf[p + j] & 0xC0) != 0x80) ok = false;
    else v = (v << 6) | (buf[p + j] & 0x3F);
  }
  if (!ok || v > 0x10FFFF || (v >= 0xD800 && v <= 0xDFFF) ||
      (k == 1 && v < 0x80) || (k == 2 && v < 0x800) || (k == 3 && v < 0x10000))
    return false;
  *cp = v;
  *n = k;
  return true;
}

}  // namespace

extern "C" {

// Scan [buf, buf+len): tokenize on whitespace, delete punctuation inside
// tokens, hash the cleaned word with both lanes, deduplicate EXACTLY (hash
// pair + bytes; two different words with equal pairs stay distinct so the
// Python side can detect the collision). Outputs:
//   words_out  — cleaned unique words, concatenated (capacity >= len)
//   ends_out   — exclusive end offset of word i in words_out
//   k1/k2_out  — hash lanes of word i
// Returns the number of unique words, or -1 if max_words was too small.
int64_t mr_scan_unique(const uint8_t* buf, int64_t len,
                       uint8_t* words_out, int64_t* ends_out,
                       uint32_t* k1_out, uint32_t* k2_out,
                       int64_t max_words) {
  // Open addressing with growth: start small (typical chunks have ~1
  // unique per 30 bytes), rehash at 70% load so the probe loop always has
  // empty slots — a table that fills completely would otherwise spin
  // forever on the first non-duplicate probe.
  int64_t cap = 1024;
  while (cap < (len / 16 + 16)) cap <<= 1;
  std::vector<Slot> table((size_t)cap);
  std::memset(table.data(), 0, sizeof(Slot) * (size_t)cap);

  // The candidate word is built IN PLACE at words_out+words_len: on insert
  // it is already where it belongs (no copy); on duplicate the next
  // candidate simply overwrites it. words_out has capacity >= len, and
  // committed + candidate bytes can never exceed the input length.
  int64_t n_unique = 0;
  int64_t words_len = 0;
  int64_t wlen = 0;  // candidate length

  auto grow = [&]() {
    int64_t ncap = cap << 1;
    std::vector<Slot> ntab((size_t)ncap);
    std::memset(ntab.data(), 0, sizeof(Slot) * (size_t)ncap);
    uint64_t nmask = (uint64_t)ncap - 1;
    for (int64_t j = 0; j < cap; ++j) {
      const Slot& s = table[j];
      if (!s.len) continue;
      uint64_t i = (((uint64_t)s.k1 << 32) | s.k2) & nmask;
      while (ntab[i].len) i = (i + 1) & nmask;
      ntab[i] = s;
    }
    table.swap(ntab);
    cap = ncap;
  };

  // Hash lanes accumulate incrementally as word bytes arrive — flush never
  // re-reads the word (one classify+hash pass over the input total).
  uint32_t h1 = H1_INIT, h2 = H2_INIT;

  auto flush = [&]() -> bool {
    if (wlen == 0) {
      h1 = H1_INIT;
      h2 = H2_INIT;
      return true;
    }
    if (n_unique * 10 >= cap * 7) grow();  // keep load factor < 0.7
    const uint8_t* cand = words_out + words_len;
    uint32_t prefix = 0;
    std::memcpy(&prefix, cand, (size_t)(wlen < 4 ? wlen : 4));
    uint64_t mask = (uint64_t)cap - 1;
    uint64_t i = (((uint64_t)h1 << 32) | h2) & mask;
    for (;;) {
      Slot& s = table[i];
      if (!s.len) {
        if (n_unique >= max_words) return false;
        s.k1 = h1;
        s.k2 = h2;
        s.prefix = prefix;
        s.len = (int32_t)wlen;
        words_len += wlen;  // bytes already in place — commit them
        ends_out[n_unique] = words_len;
        k1_out[n_unique] = h1;
        k2_out[n_unique] = h2;
        ++n_unique;
        break;
      }
      if (s.k1 == h1 && s.k2 == h2 && s.len == (int32_t)wlen && s.prefix == prefix) {
        break;  // duplicate — candidate bytes are simply overwritten next
      }
      i = (i + 1) & mask;  // probe: different word (or a true pair collision)
    }
    wlen = 0;
    h1 = H1_INIT;
    h2 = H2_INIT;
    return true;
  };

  for (int64_t p = 0; p < len; ++p) {
    uint8_t c = buf[p];
    uint8_t cls = kTables.cls[c];
    if (cls == 1) {
      words_out[words_len + wlen] = c;
      ++wlen;
      h1 = h1 * H1_MULT + c + 1;
      h2 = h2 * H2_MULT + c + 1;
    } else if (cls == 2) {
      if (!flush()) return -1;
    }  // cls == 0: punctuation — deleted, does not split the token
  }
  if (!flush()) return -1;
  return n_unique;
}

// Fused normalize + tokenize + dedupe + count over RAW UTF-8, one pass.
// Equivalent by construction to mr_normalize followed by mr_scan_unique —
// word-class bytes are hashed/appended verbatim, whitespace-class
// codepoints flush the token, delete-class codepoints vanish without
// splitting it — but touches every byte once instead of three times
// (normalize write + normalized read + scan). This is the map side of the
// host-map engine (runtime/driver.py _stream_host_map): the same token
// stream feeds the egress dictionary AND, with counts_out, the data plane
// update the device merges. The Rust original does its map here too — on
// the worker CPU (src/app/wc.rs:6-13) — the framework's job being the
// shuffle/reduce behind it.
//   counts_out[i] = occurrences of unique word i in this buffer.
// Returns unique-word count, or -1 if max_words was too small.
int64_t mr_scan_count(const uint8_t* buf, int64_t len,
                      const uint8_t* cpclass,  // [0x110000]
                      uint8_t* words_out, int64_t* ends_out,
                      uint32_t* k1_out, uint32_t* k2_out, uint32_t* counts_out,
                      int64_t max_words) {
  // Start cache-sized and grow at 70% load: sizing by len/16 would build a
  // table proportional to the WINDOW (20 MB for a 16 MB window) and turn
  // every probe into a DRAM miss; typical windows have far fewer uniques
  // than bytes/16, and growth amortizes for the ones that don't.
  int64_t cap = 1 << 15;
  // 16-byte slot, four per cache line. Duplicate test is (k1, k2, len):
  // the same ~2^-64 birthday bound that justifies keying the whole
  // framework on the hash pair (SURVEY.md §7 hard part 3) — word bytes are
  // not compared here (the hot loop no longer materializes them; see
  // flush/reclean below). mr_scan_unique keeps its byte-prefix check.
  struct CSlot {
    uint32_t k1, k2;
    int32_t len;   // 0 = unused
    uint32_t idx;  // output index (counts_out[idx] is this word's count)
  };
  std::vector<CSlot> table((size_t)cap);
  std::memset(table.data(), 0, sizeof(CSlot) * (size_t)cap);

  int64_t n_unique = 0;
  int64_t words_len = 0;
  int64_t wlen = 0;
  uint32_t h1 = H1_INIT, h2 = H2_INIT;

  auto grow = [&]() {
    int64_t ncap = cap << 1;
    std::vector<CSlot> ntab((size_t)ncap);
    std::memset(ntab.data(), 0, sizeof(CSlot) * (size_t)ncap);
    uint64_t nmask = (uint64_t)ncap - 1;
    for (int64_t j = 0; j < cap; ++j) {
      const CSlot& s = table[j];
      if (!s.len) continue;
      uint64_t i = (((uint64_t)s.k1 << 32) | s.k2) & nmask;
      while (ntab[i].len) i = (i + 1) & nmask;
      ntab[i] = s;
    }
    table.swap(ntab);
    cap = ncap;
  };

  // The hot loops hash WITHOUT materializing word bytes (the store per
  // byte and its bookkeeping cost ~15% of the scan). tok_start remembers
  // where the current token began in the RAW buffer; only when a key is
  // first inserted does reclean() walk that span again to extract the
  // cleaned bytes — re-walking is rare (once per unique word) and short.
  //
  // Measured dead ends (do not re-attempt without new evidence; A/B'd on
  // this image, 16 MB inputs, min-of-5): (a) batching the hash recurrence
  // 4 bytes/step via (b+1)*M^j tables — 188→169 MB/s on the reference
  // corpus; the serial multiply chain is already hidden by OoO overlap
  // with classification, and the table loads+extra bookkeeping only add
  // work. (b) software-pipelining flush() through a prefetch ring —
  // 188→170 MB/s on text-like vocabularies (≤100K distinct, table is
  // L2-resident); it only wins (+27%, 79→103 MB/s) at ≥1M distinct keys
  // per window, a profile none of the framework's workloads have.
  int64_t tok_start = -1;

  // Re-extract the cleaned word bytes of raw span [from, to) — the same
  // classification walk as the hashing pass, emitting instead of hashing.
  auto reclean = [&](int64_t from, int64_t to, uint8_t* dst) -> int64_t {
    int64_t o = 0;
    int64_t q = from;
    while (q < to) {
      uint8_t c = buf[q];
      if (c < 0x80) {
        if (kTables.cls[c] == 1) dst[o++] = c;
        ++q;
        continue;
      }
      uint32_t cp = 0;
      int n = 0;
      if (!decode_utf8(buf, len, q, &cp, &n)) {
        ++q;
        continue;
      }
      if (cpclass[cp] == 1)
        for (int j = 0; j <= n; ++j) dst[o++] = buf[q + j];
      q += n + 1;
    }
    return o;
  };

  // Close the current token whose raw span ends at `to` (exclusive).
  auto flush = [&](int64_t to) -> bool {
    if (wlen == 0) {
      h1 = H1_INIT;
      h2 = H2_INIT;
      return true;
    }
    if (n_unique * 10 >= cap * 7) grow();
    uint64_t mask = (uint64_t)cap - 1;
    uint64_t i = (((uint64_t)h1 << 32) | h2) & mask;
    for (;;) {
      CSlot& s = table[i];
      if (!s.len) {
        if (n_unique >= max_words) return false;
        s.k1 = h1;
        s.k2 = h2;
        s.len = (int32_t)wlen;
        s.idx = (uint32_t)n_unique;
        words_len += reclean(tok_start, to, words_out + words_len);
        ends_out[n_unique] = words_len;
        k1_out[n_unique] = h1;
        k2_out[n_unique] = h2;
        counts_out[n_unique] = 1;
        ++n_unique;
        break;
      }
      if (s.k1 == h1 && s.k2 == h2 && s.len == (int32_t)wlen) {
        ++counts_out[s.idx];
        break;
      }
      i = (i + 1) & mask;
    }
    wlen = 0;
    h1 = H1_INIT;
    h2 = H2_INIT;
    return true;
  };

  // One scalar byte/codepoint step; advances p. Returns false only on
  // max_words overflow. Shared by the non-ASCII block path and the tail.
  auto scalar_step = [&](int64_t& p) -> bool {
    uint8_t c = buf[p];
    if (c < 0x80) {  // ASCII — the kTables classes
      uint8_t cls = kTables.cls[c];
      if (cls == 1) {
        if (!wlen) tok_start = p;
        ++wlen;
        h1 = h1 * H1_MULT + c + 1;
        h2 = h2 * H2_MULT + c + 1;
      } else if (cls == 2) {
        if (!flush(p)) return false;
      }
      ++p;
      return true;
    }
    // Non-ASCII: decode exactly like mr_normalize, classify via cpclass.
    uint32_t cp = 0;
    int n = 0;
    if (!decode_utf8(buf, len, p, &cp, &n)) {
      ++p;  // invalid → U+FFFD → delete, resync at the next byte
      return true;
    }
    uint8_t cls = cpclass[cp];
    if (cls == 1) {  // word codepoint: original bytes, hashed verbatim
      if (!wlen) tok_start = p;
      for (int j = 0; j <= n; ++j) {
        uint8_t wc = buf[p + j];
        ++wlen;
        h1 = h1 * H1_MULT + wc + 1;
        h2 = h2 * H2_MULT + wc + 1;
      }
    } else if (cls == 2) {
      if (!flush(p)) return false;
    }
    p += n + 1;
    return true;
  };

  int64_t p = 0;
#ifdef __AVX2__
  // SIMD fast path: classify a 64-byte all-ASCII block into word /
  // whitespace / delete BIT MASKS with eight AVX2 ops, then walk only the
  // set bits. Removes the per-byte class lookup and its mispredicted
  // 3-way branch — the scalar loop's main cost — while producing exactly
  // the same (word bytes, flush points) event stream: delete bits are
  // simply absent from both masks, so punctuation still vanishes without
  // splitting the token. Any block containing a non-ASCII byte falls back
  // to the scalar stepper for its 64 bytes (UTF-8 may step past the block
  // edge; the next SIMD load is unaligned-safe).
  while (p + 64 <= len) {
    __m256i lo = _mm256_loadu_si256((const __m256i*)(buf + p));
    __m256i hi = _mm256_loadu_si256((const __m256i*)(buf + p + 32));
    uint32_t na_lo = (uint32_t)_mm256_movemask_epi8(lo);
    uint32_t na_hi = (uint32_t)_mm256_movemask_epi8(hi);
    if (na_lo | na_hi) {  // non-ASCII somewhere in the block
      int64_t stop = p + 64;
      while (p < stop) {
        if (!scalar_step(p)) return -1;
      }
      continue;
    }
    auto classify = [](__m256i v, uint32_t& w, uint32_t& s) {
      __m256i lower = _mm256_or_si256(v, _mm256_set1_epi8(0x20));
      __m256i alpha = _mm256_and_si256(
          _mm256_cmpgt_epi8(lower, _mm256_set1_epi8('a' - 1)),
          _mm256_cmpgt_epi8(_mm256_set1_epi8('z' + 1), lower));
      __m256i digit = _mm256_and_si256(
          _mm256_cmpgt_epi8(v, _mm256_set1_epi8('0' - 1)),
          _mm256_cmpgt_epi8(_mm256_set1_epi8('9' + 1), v));
      __m256i us = _mm256_cmpeq_epi8(v, _mm256_set1_epi8('_'));
      w = (uint32_t)_mm256_movemask_epi8(
          _mm256_or_si256(_mm256_or_si256(alpha, digit), us));
      __m256i sp = _mm256_cmpeq_epi8(v, _mm256_set1_epi8(' '));
      __m256i ctl = _mm256_and_si256(
          _mm256_cmpgt_epi8(v, _mm256_set1_epi8(8)),
          _mm256_cmpgt_epi8(_mm256_set1_epi8(14), v));  // \t\n\v\f\r
      s = (uint32_t)_mm256_movemask_epi8(_mm256_or_si256(sp, ctl));
    };
    uint32_t w_lo, s_lo, w_hi, s_hi;
    classify(lo, w_lo, s_lo);
    classify(hi, w_hi, s_hi);
    uint64_t m_word = ((uint64_t)w_hi << 32) | w_lo;
    uint64_t m_ws = ((uint64_t)s_hi << 32) | s_lo;
    while (m_ws) {
      int nxt = __builtin_ctzll(m_ws);
      uint64_t seg = nxt ? (m_word & ((1ULL << nxt) - 1)) : 0;
      while (seg) {
        int i = __builtin_ctzll(seg);
        uint8_t c = buf[p + i];
        if (!wlen) tok_start = p + i;
        ++wlen;
        h1 = h1 * H1_MULT + c + 1;
        h2 = h2 * H2_MULT + c + 1;
        seg &= seg - 1;
      }
      if (nxt < 63)  // consume bits <= nxt (seg bits hashed above)
        m_word &= ~((1ULL << (nxt + 1)) - 1);
      else
        m_word = 0;
      if (!flush(p + nxt)) return -1;
      m_ws &= m_ws - 1;
    }
    while (m_word) {  // trailing word bytes after the last whitespace
      int i = __builtin_ctzll(m_word);
      uint8_t c = buf[p + i];
      if (!wlen) tok_start = p + i;
      ++wlen;
      h1 = h1 * H1_MULT + c + 1;
      h2 = h2 * H2_MULT + c + 1;
      m_word &= m_word - 1;
    }
    p += 64;
  }
#endif
  while (p < len) {
    if (!scalar_step(p)) return -1;
  }
  if (!flush(len)) return -1;
  return n_unique;
}

// Fold-shard routing: xor-shift + splitmix64-multiplier bit mix
// of the packed key, then high-bits modulo — MUST stay identical to
// runtime/dictionary.shard_of_packed (the plain scan's router and the
// egress lookup), or a key's folds silently split across two
// shards. The mix exists because bare `packed % S` is the low bits of the
// h2 polynomial lane, where correlated token classes collapse onto one
// shard (zero fold parallelism).
inline int64_t shard_of_packed(uint64_t packed, int64_t n_shards) {
  uint64_t x = (packed ^ (packed >> 33)) * 0x9E3779B97F4A7C15ull;
  return (int64_t)((x >> 32) % (uint64_t)n_shards);
}

// Sharded variant of mr_scan_count: the same fused
// normalize+tokenize+dedupe+count pass, then a stable counting sort that
// groups the unique-word outputs by fold shard (shard_of_packed above —
// shared with the Python fold plane). Outputs:
//   words/ends/k1/k2/counts — grouped by shard, scan order WITHIN a shard
//     (ends stay global exclusive offsets over the grouped words buffer,
//     so shard s's bytes are one contiguous slice);
//   pos_out[g]            — the ORIGINAL scan index of grouped word g: the
//     router scatters keys/counts back to exact scan order for the device
//     merge stream, which is what keeps outputs bit-identical to the
//     unsharded engine (merge/evict order never changes);
//   shard_counts_out[s]   — unique words routed to shard s.
// The grouping pass is O(n_unique + word bytes) against a scan that
// already touched every input byte — the per-word Python routing loop it
// replaces was the host-glue bottleneck this kernel exists to kill.
// Returns the unique-word count, or -1 if max_words was too small.
int64_t mr_scan_count_sharded(const uint8_t* buf, int64_t len,
                              const uint8_t* cpclass,  // [0x110000]
                              int64_t n_shards,
                              uint8_t* words_out, int64_t* ends_out,
                              uint32_t* k1_out, uint32_t* k2_out,
                              uint32_t* counts_out,
                              int64_t* pos_out, int64_t* shard_counts_out,
                              int64_t max_words) {
  for (int64_t s = 0; s < n_shards; ++s) shard_counts_out[s] = 0;
  int64_t n = mr_scan_count(buf, len, cpclass, words_out, ends_out,
                            k1_out, k2_out, counts_out, max_words);
  if (n <= 0) return n;
  if (n_shards <= 1) {
    shard_counts_out[0] = n;
    for (int64_t i = 0; i < n; ++i) pos_out[i] = i;
    return n;
  }
  std::vector<int64_t> shard_of((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t packed = (((uint64_t)k1_out[i]) << 32) | k2_out[i];
    int64_t s = shard_of_packed(packed, n_shards);
    shard_of[i] = s;
    ++shard_counts_out[s];
  }
  // Stable grouped position per scan index (counting sort: scan order is
  // first-occurrence order, and the fold's collision policy — first word
  // wins — depends on preserving it within each shard).
  std::vector<int64_t> cur((size_t)n_shards, 0);
  for (int64_t s = 1; s < n_shards; ++s)
    cur[s] = cur[s - 1] + shard_counts_out[s - 1];
  std::vector<int64_t> gpos((size_t)n);
  for (int64_t i = 0; i < n; ++i) gpos[i] = cur[shard_of[i]]++;
  // Permute keys/counts; record the inverse (grouped -> scan) for the
  // router's device-order scatter.
  std::vector<uint32_t> tk1((size_t)n), tk2((size_t)n), tc((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t g = gpos[i];
    tk1[g] = k1_out[i];
    tk2[g] = k2_out[i];
    tc[g] = counts_out[i];
    pos_out[g] = i;
  }
  std::memcpy(k1_out, tk1.data(), sizeof(uint32_t) * (size_t)n);
  std::memcpy(k2_out, tk2.data(), sizeof(uint32_t) * (size_t)n);
  std::memcpy(counts_out, tc.data(), sizeof(uint32_t) * (size_t)n);
  // Permute the concatenated word bytes into shard-grouped order and
  // rebuild the (still global, still exclusive) end offsets.
  int64_t words_len = ends_out[n - 1];
  std::vector<int64_t> gends((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t b = i ? ends_out[i - 1] : 0;
    gends[gpos[i]] = ends_out[i] - b;  // lengths first, grouped
  }
  int64_t acc = 0;
  for (int64_t g = 0; g < n; ++g) {
    acc += gends[g];
    gends[g] = acc;
  }
  std::vector<uint8_t> wtmp((size_t)words_len);
  for (int64_t i = 0; i < n; ++i) {
    int64_t b = i ? ends_out[i - 1] : 0;
    int64_t g = gpos[i];
    int64_t gb = g ? gends[g - 1] : 0;
    std::memcpy(wtmp.data() + gb, words_out + b, (size_t)(ends_out[i] - b));
  }
  std::memcpy(words_out, wtmp.data(), (size_t)words_len);
  std::memcpy(ends_out, gends.data(), sizeof(int64_t) * (size_t)n);
  return n;
}

// Cross-window update coalescing: merge two SORTED unique-key
// (packed-uint64 key, int64 count) columns into one sorted unique-key
// column, SUMMING counts where a key appears in both — the staging-combine
// kernel of the device-merge dispatch plane. Window n's grouped scan
// result folds into the staging buffer here instead of shipping straight
// to the device: under a Zipf vocabulary most of a window's keys already
// sit in staging, so the merge dispatch that finally goes out carries one
// record per distinct key across the coalesced windows, not one per
// (window, key). Pre-summing is exact for the "sum" combine op and only
// that op — the Python side gates on it. Inputs must not alias `out_*`
// (the caller ping-pongs two staging buffers). The linear two-pointer walk
// is O(m + n) against inputs a scan already paid O(bytes) for.
// Returns the merged unique-key count (<= m + n).
int64_t mr_coalesce_updates(const uint64_t* a_keys, const int64_t* a_vals,
                            int64_t m,
                            const uint64_t* b_keys, const int64_t* b_vals,
                            int64_t n,
                            uint64_t* out_keys, int64_t* out_vals) {
  int64_t i = 0, j = 0, o = 0;
  while (i < m && j < n) {
    uint64_t ka = a_keys[i], kb = b_keys[j];
    if (ka < kb) {
      out_keys[o] = ka;
      out_vals[o++] = a_vals[i++];
    } else if (kb < ka) {
      out_keys[o] = kb;
      out_vals[o++] = b_vals[j++];
    } else {
      out_keys[o] = ka;
      out_vals[o++] = a_vals[i++] + b_vals[j++];
    }
  }
  while (i < m) {
    out_keys[o] = a_keys[i];
    out_vals[o++] = a_vals[i++];
  }
  while (j < n) {
    out_keys[o] = b_keys[j];
    out_vals[o++] = b_vals[j++];
  }
  return o;
}

// k-way disjoint merge over sorted uint64 key columns: the
// batched loser-tree egress that replaces the per-key Python heap
// interleave of the spill plane. The caller memory-maps each binary run's
// key column and hands the pointers here; one call fills up to `block`
// outputs — merged key, source index, index within source — and advances
// `cursors` (caller-owned, so the merge streams in O(block) memory however
// many keys the runs hold). Sources are key-DISJOINT by construction
// (dictionary tiers + fold shards never share a key), so no dedup exists;
// ties (impossible by that invariant, checked not assumed upstream) would
// break toward the lower source index via the <= comparisons below.
// Returns the number of outputs produced; 0 = every source exhausted.
int64_t mr_merge_runs(const uint64_t** keys, const int64_t* lens, int64_t k,
                      int64_t* cursors, uint64_t* out_keys, int32_t* out_src,
                      int64_t* out_idx, int64_t block) {
  if (k <= 0 || block <= 0) return 0;
  if (k == 1) {  // degenerate merge: a straight copy of the remainder
    int64_t n = 0;
    while (n < block && cursors[0] < lens[0]) {
      out_keys[n] = keys[0][cursors[0]];
      out_src[n] = 0;
      out_idx[n] = cursors[0];
      ++cursors[0];
      ++n;
    }
    return n;
  }
  // Loser tree over m = next-pow2(k) leaves; leaves >= k are permanently
  // exhausted sentinels. `key[s]` caches source s's current head so the
  // replay path never re-reads the (possibly page-faulting) mapped column
  // twice for one comparison. Exhaustion is a FLAG, not a sentinel key:
  // 0xFFFF...F is a legal packed key ((k1,k2) = (max,max)) — astronomically
  // unlikely, but checked, not assumed (the house rule).
  int64_t m = 1;
  while (m < k) m <<= 1;
  std::vector<uint64_t> key((size_t)k);
  std::vector<uint8_t> alive((size_t)k, 0);
  for (int64_t s = 0; s < k; ++s) {
    if (cursors[s] < lens[s]) {
      alive[s] = 1;
      key[s] = keys[s][cursors[s]];
    }
  }
  // does a beat b? (exhausted/virtual leaves lose to everything)
  auto beats = [&](int32_t a, int32_t b) -> bool {
    bool ba = a < k && alive[a], bb = b < k && alive[b];
    if (!bb) return true;
    if (!ba) return false;
    return key[a] <= key[b];
  };
  // Build: play every leaf pair up the tree, storing losers at internal
  // nodes; win[1] is the overall winner.
  std::vector<int32_t> loser((size_t)m, (int32_t)k);  // k = virtual leaf
  std::vector<int32_t> win((size_t)(2 * m));
  for (int64_t i = 0; i < m; ++i) win[m + i] = (int32_t)i;
  for (int64_t i = m - 1; i >= 1; --i) {
    int32_t a = win[2 * i], b = win[2 * i + 1];
    if (beats(a, b)) {
      win[i] = a;
      loser[i] = b;
    } else {
      win[i] = b;
      loser[i] = a;
    }
  }
  int32_t winner = win[1];
  int64_t n = 0;
  while (n < block) {
    int32_t s = winner;
    if (s >= k || !alive[s]) break;  // every source exhausted
    out_keys[n] = key[s];
    out_src[n] = s;
    out_idx[n] = cursors[s];
    ++n;
    ++cursors[s];
    if (cursors[s] < lens[s]) {
      key[s] = keys[s][cursors[s]];
    } else {
      alive[s] = 0;
    }
    // Replay only s's leaf-to-root path: O(log k) per output.
    int32_t w = s;
    for (int64_t node = (m + s) >> 1; node >= 1; node >>= 1) {
      if (!beats(w, loser[node])) {
        int32_t tmp = w;
        w = loser[node];
        loser[node] = tmp;
      }
    }
    winner = w;
  }
  return n;
}

// Normalize raw UTF-8 in one pass (the C replacement for
// core/normalize.normalize_python — byte-exact by contract, held to it by
// tests/test_torch_native.py):
//   - ASCII bytes pass through untouched;
//   - each non-ASCII codepoint is classified by cpclass[cp] (a table the
//     Python side builds ONCE from the same `re` \w / isspace rules):
//     1 = word char (original bytes kept verbatim), 2 = whitespace (one
//     0x20 per codepoint), 0 = delete;
//   - malformed sequences decode like Python errors="replace": each bad
//     byte run becomes U+FFFD, which classifies as delete.
// Output never exceeds the input length. Returns the normalized length.
int64_t mr_normalize(const uint8_t* buf, int64_t len,
                     const uint8_t* cpclass,  // [0x110000]
                     uint8_t* out) {
  int64_t o = 0;
  int64_t p = 0;
  while (p < len) {
    uint8_t c = buf[p];
    if (c < 0x80) {
      out[o++] = c;
      ++p;
      continue;
    }
    // Decode one UTF-8 sequence (the shared strict decoder); invalid →
    // replace (delete) and resync at the next byte, like Python's decoder.
    uint32_t cp = 0;
    int n = 0;
    if (!decode_utf8(buf, len, p, &cp, &n)) {
      ++p;  // consume just the lead byte (Python replaces per bad byte)
      continue;
    }
    uint8_t cls = cpclass[cp];
    if (cls == 1) {
      for (int j = 0; j <= n; ++j) out[o++] = buf[p + j];
    } else if (cls == 2) {
      out[o++] = 0x20;
    }
    p += n + 1;
  }
  return o;
}

}  // extern "C"
