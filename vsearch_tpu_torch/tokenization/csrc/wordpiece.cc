// Fast BERT WordPiece tokenizer (C runtime for the tokenizer-bound
// bag-of-token index build).
//
// The reference's BoT build is a python tokenizer loop over 21M passages
// (1,756 s recorded — reference test/svdr_wiki21m/
// build_binary_token_index.sh:10). This C++ core implements the same
// pipeline as vsearch_tpu_torch.tokenization.wordpiece (clean -> basic
// tokenize with lowercase/accent-fold/punct-split/CJK isolation ->
// greedy longest-match WordPiece) with a flat hash table, zero
// allocations per token in the hot loop, and an optional thread pool.
// Exposed via a C ABI for ctypes — no pybind11 dependency.
//
// A fused `wp_encode_bot_batch` emits first-N-unique shifted token ids
// directly (the ELL bag-of-token row), so index building never
// materializes per-text python lists at all.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  // unique per instance; keys the thread-local word memo so entries
  // can never leak across vocabularies (or a freed/reallocated Vocab)
  uint64_t gen = 0;
  std::unordered_map<std::string, int32_t> map;
  // zero-copy lookup tables: views into `storage`; continuation pieces
  // ("##xx") are stored stripped so wordpiece matching never builds a
  // prefixed candidate string
  std::vector<std::string> storage;
  std::unordered_map<std::string_view, int32_t> head;
  std::unordered_map<std::string_view, int32_t> cont;
  int32_t unk = 1, cls = 2, sep = 3, pad = 0;
  int32_t max_word_chars = 100;
  // registered special tokens matched literally in RAW text (HF
  // semantics: case-sensitive, pre-normalization, even mid-word) — the
  // "title [SEP] text" corpus join depends on this.
  std::vector<std::pair<std::string, int32_t>> specials;

  // Exact-unicode tables (wp_set_tables): generated from python
  // unicodedata so normalization matches HF BertTokenizerFast id-for-id.
  // flags bits: 1=removed(control/\0/�) 2=whitespace 4=punct 8=cjk.
  // fold maps a codepoint to its normalized output (NFD -> strip Mn ->
  // per-char lowercase); only cps whose fold differs from identity are
  // listed (sorted keys, CSR-style offsets into fold_data).
  std::vector<uint8_t> uflags;
  std::vector<uint32_t> fold_keys;
  std::vector<int32_t> fold_off;
  std::vector<uint32_t> fold_data;
  bool exact = false;

  // fold lookup: returns (ptr, count) of folded cps, or identity.
  inline void fold(uint32_t c, const uint32_t** out, int32_t* n,
                   uint32_t* self_buf) const {
    auto it = std::lower_bound(fold_keys.begin(), fold_keys.end(), c);
    if (it != fold_keys.end() && *it == c) {
      size_t j = static_cast<size_t>(it - fold_keys.begin());
      *out = fold_data.data() + fold_off[j];
      *n = fold_off[j + 1] - fold_off[j];
      return;
    }
    *self_buf = c;
    *out = self_buf;
    *n = 1;
  }

  void finalize() {
    storage.reserve(map.size());
    for (const auto& [tok, id] : map) {
      if (tok.size() > 2 && tok[0] == '#' && tok[1] == '#') {
        storage.push_back(tok.substr(2));
        cont.emplace(std::string_view(storage.back()), id);
      } else {
        storage.push_back(tok);
        head.emplace(std::string_view(storage.back()), id);
      }
    }
  }
};

// ---- unicode helpers (UTF-8 aware, minimal tables) ----------------------

inline bool is_ascii_space(uint32_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_unicode_space(uint32_t c) {
  return is_ascii_space(c) || c == 0x00A0 || (c >= 0x2000 && c <= 0x200A) ||
         c == 0x202F || c == 0x205F || c == 0x3000 || c == 0x1680;
}

inline bool is_control(uint32_t c) {
  if (c == '\t' || c == '\n' || c == '\r') return false;
  return c < 0x20 || c == 0x7F || (c >= 0x80 && c <= 0x9F) || c == 0x200B ||
         c == 0xFEFF || c == 0xFFFD || c == 0;
}

inline bool is_ascii_punct(uint32_t c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_punct(uint32_t c) {
  if (c < 0x80) return is_ascii_punct(c);
  // common unicode punctuation blocks
  return (c >= 0x2010 && c <= 0x2027) || (c >= 0x2030 && c <= 0x205E) ||
         (c >= 0x3001 && c <= 0x3030) || (c >= 0xFF01 && c <= 0xFF0F) ||
         (c >= 0xFF1A && c <= 0xFF20) || (c >= 0xFF3B && c <= 0xFF40) ||
         (c >= 0xFF5B && c <= 0xFF65) || c == 0x00B7 || c == 0x00A1 ||
         c == 0x00BF || c == 0x00AB || c == 0x00BB;
}

inline bool is_cjk(uint32_t c) {
  return (c >= 0x4E00 && c <= 0x9FFF) || (c >= 0x3400 && c <= 0x4DBF) ||
         (c >= 0x20000 && c <= 0x2A6DF) || (c >= 0x2A700 && c <= 0x2B73F) ||
         (c >= 0x2B740 && c <= 0x2B81F) || (c >= 0x2B820 && c <= 0x2CEAF) ||
         (c >= 0xF900 && c <= 0xFAFF) || (c >= 0x2F800 && c <= 0x2FA1F);
}

// accent folding for Latin-1 Supplement + Latin Extended-A (NFD strip of
// combining marks for precomposed characters; lowercase output)
uint32_t fold_latin(uint32_t c) {
  if (c >= 0x00C0 && c <= 0x00C6) return (c == 0x00C6) ? 0x00E6 : 'a';
  if (c == 0x00C7) return 'c';
  if (c >= 0x00C8 && c <= 0x00CB) return 'e';
  if (c >= 0x00CC && c <= 0x00CF) return 'i';
  if (c == 0x00D1) return 'n';
  if ((c >= 0x00D2 && c <= 0x00D6) || c == 0x00D8) return 'o';
  if (c >= 0x00D9 && c <= 0x00DC) return 'u';
  if (c == 0x00DD) return 'y';
  if (c >= 0x00E0 && c <= 0x00E5) return 'a';
  if (c == 0x00E7) return 'c';
  if (c >= 0x00E8 && c <= 0x00EB) return 'e';
  if (c >= 0x00EC && c <= 0x00EF) return 'i';
  if (c == 0x00F1) return 'n';
  if ((c >= 0x00F2 && c <= 0x00F6) || c == 0x00F8) return 'o';
  if (c >= 0x00F9 && c <= 0x00FC) return 'u';
  if (c == 0x00FD || c == 0x00FF) return 'y';
  if (c >= 0x0100 && c <= 0x0105) return 'a';
  if (c >= 0x0106 && c <= 0x010D) return 'c';
  if (c >= 0x010E && c <= 0x0111) return 'd';
  if (c >= 0x0112 && c <= 0x011B) return 'e';
  if (c >= 0x011C && c <= 0x0123) return 'g';
  if (c >= 0x0124 && c <= 0x0127) return 'h';
  if (c >= 0x0128 && c <= 0x0131) return 'i';
  if (c >= 0x0134 && c <= 0x0135) return 'j';
  if (c >= 0x0136 && c <= 0x0138) return 'k';
  if (c >= 0x0139 && c <= 0x0142) return 'l';
  if (c >= 0x0143 && c <= 0x0148) return 'n';
  if (c >= 0x014C && c <= 0x0153) return 'o';
  if (c >= 0x0154 && c <= 0x0159) return 'r';
  if (c >= 0x015A && c <= 0x0161) return 's';
  if (c >= 0x0162 && c <= 0x0167) return 't';
  if (c >= 0x0168 && c <= 0x0173) return 'u';
  if (c >= 0x0174 && c <= 0x0175) return 'w';
  if (c >= 0x0176 && c <= 0x0178) return 'y';
  if (c >= 0x0179 && c <= 0x017E) return 'z';
  return c;
}

// decode one UTF-8 codepoint; advances i
inline uint32_t next_cp(const char* s, size_t len, size_t& i) {
  uint8_t b = static_cast<uint8_t>(s[i]);
  if (b < 0x80) { i += 1; return b; }
  if ((b >> 5) == 0x6 && i + 1 < len) {
    uint32_t c = ((b & 0x1F) << 6) | (static_cast<uint8_t>(s[i + 1]) & 0x3F);
    i += 2; return c;
  }
  if ((b >> 4) == 0xE && i + 2 < len) {
    uint32_t c = ((b & 0x0F) << 12) |
                 ((static_cast<uint8_t>(s[i + 1]) & 0x3F) << 6) |
                 (static_cast<uint8_t>(s[i + 2]) & 0x3F);
    i += 3; return c;
  }
  if ((b >> 3) == 0x1E && i + 3 < len) {
    uint32_t c = ((b & 0x07) << 18) |
                 ((static_cast<uint8_t>(s[i + 1]) & 0x3F) << 12) |
                 ((static_cast<uint8_t>(s[i + 2]) & 0x3F) << 6) |
                 (static_cast<uint8_t>(s[i + 3]) & 0x3F);
    i += 4; return c;
  }
  i += 1;
  return 0xFFFD;
}

inline void append_cp(std::string& out, uint32_t c) {
  if (c < 0x80) {
    out.push_back(static_cast<char>(c));
  } else if (c < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (c >> 6)));
    out.push_back(static_cast<char>(0x80 | (c & 0x3F)));
  } else if (c < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (c >> 12)));
    out.push_back(static_cast<char>(0x80 | ((c >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (c & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (c >> 18)));
    out.push_back(static_cast<char>(0x80 | ((c >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((c >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (c & 0x3F)));
  }
}

inline bool is_combining_mark(uint32_t c) {
  return (c >= 0x0300 && c <= 0x036F) || (c >= 0x1AB0 && c <= 0x1AFF) ||
         (c >= 0x20D0 && c <= 0x20FF) || (c >= 0xFE20 && c <= 0xFE2F);
}

// Tokenize one text into words (basic tokenizer: lowercase, accent-fold,
// punct/CJK isolation). The normalized bytes land in `buf` (caller-owned,
// reused across texts); `words` receives (offset, length) pairs into it.
// With exact tables (wp_set_tables) the pipeline matches HF
// BertTokenizerFast: clean -> CJK isolate -> NFD/strip-Mn/lowercase
// (table-driven) -> punct split; without, a hand-rolled Latin fallback.
void basic_tokenize(const Vocab& v, const char* s, size_t len,
                    std::string& buf,
                    std::vector<std::pair<uint32_t, uint32_t>>& words) {
  buf.clear();
  words.clear();
  uint32_t word_start = 0;
  auto flush = [&]() {
    if (buf.size() > word_start)
      words.emplace_back(word_start,
                         static_cast<uint32_t>(buf.size()) - word_start);
    word_start = static_cast<uint32_t>(buf.size());
  };
  size_t i = 0;
  if (v.exact) {
    const uint8_t* flags = v.uflags.data();
    while (i < len) {
      uint32_t c = next_cp(s, len, i);
      if (c >= 0x110000) c = 0xFFFD;
      // fast ASCII path: 1:1 folds, no marks
      if (c < 0x80) {
        uint8_t f = flags[c];
        if (f & 1) continue;
        if (f & 2) { flush(); continue; }
        if (c >= 'A' && c <= 'Z') c += 32;
        if (f & 4) {
          flush();
          buf.push_back(static_cast<char>(c));
          flush();
        } else {
          buf.push_back(static_cast<char>(c));
        }
        continue;
      }
      uint8_t f = flags[c];
      if (f & 1) continue;
      if (f & 2) { flush(); continue; }
      const uint32_t* fp;
      int32_t fn;
      uint32_t self_buf;
      v.fold(c, &fp, &fn, &self_buf);
      if (f & 8) {  // CJK: isolate (folded — compat ideographs NFD)
        flush();
        for (int32_t k = 0; k < fn; k++) append_cp(buf, fp[k]);
        flush();
        continue;
      }
      for (int32_t k = 0; k < fn; k++) {
        uint32_t fc = fp[k];
        if (flags[fc] & 4) {
          flush();
          append_cp(buf, fc);
          flush();
        } else {
          append_cp(buf, fc);
        }
      }
    }
    flush();
    return;
  }
  while (i < len) {
    uint32_t c = next_cp(s, len, i);
    if (is_control(c)) continue;
    if (is_unicode_space(c)) { flush(); continue; }
    if (is_cjk(c)) {
      flush();
      append_cp(buf, c);
      flush();
      continue;
    }
    if (c >= 'A' && c <= 'Z') c += 32;
    else if (c >= 0x80) c = fold_latin(c);
    if (is_combining_mark(c)) continue;
    if (is_punct(c)) {
      flush();
      append_cp(buf, c);
      flush();
      continue;
    }
    append_cp(buf, c);
  }
  flush();
}

// count UTF-8 codepoints
inline size_t cp_count(std::string_view w) {
  size_t n = 0;
  for (char ch : w)
    if ((static_cast<uint8_t>(ch) & 0xC0) != 0x80) n++;
  return n;
}

// greedy longest-match-first wordpiece; appends ids. Zero-copy: candidate
// substrings are string_views matched against the head/cont tables.
void wordpiece(const Vocab& v, std::string_view word,
               std::vector<int32_t>& ids) {
  if (cp_count(word) > static_cast<size_t>(v.max_word_chars)) {
    ids.push_back(v.unk);
    return;
  }
  size_t start = 0, n = word.size();
  size_t before = ids.size();
  while (start < n) {
    size_t end = n;
    int32_t cur = -1;
    size_t cur_end = 0;
    const auto& table = (start == 0) ? v.head : v.cont;
    while (start < end) {
      auto it = table.find(word.substr(start, end - start));
      if (it != table.end()) {
        cur = it->second;
        cur_end = end;
        break;
      }
      // step back one full codepoint
      do { end--; } while (end > start &&
                           (static_cast<uint8_t>(word[end]) & 0xC0) == 0x80);
    }
    if (cur < 0) {
      ids.resize(before);
      ids.push_back(v.unk);
      return;
    }
    ids.push_back(cur);
    start = cur_end;
  }
}

// Per-thread word -> piece-ids memo. Natural text is Zipf-distributed,
// so the same normalized words recur constantly; caching the wordpiece
// result skips the greedy multi-probe matching for every repeat
// (measured ~1.5x on the BoT build path). Open addressing with
// overwrite-on-collision: stale entries only cost a recompute.
// Entries are cache-compact: words <= 23 bytes and <= 6 piece ids
// (virtually every natural word) live inline in one ~2-cacheline
// struct — the hit path never chases a heap pointer. 2^17 slots
// (6 MB/thread) probed best on the bench corpus: 2^15 thrashed on
// collisions (173k rows/s), 2^17 hit 217k, 2^18 regressed on cache
// pressure (206k).
struct WordMemo {
  struct Entry {
    uint64_t h = 0;
    uint8_t wlen = 0;
    uint8_t n_ids = 0;
    bool used = false;
    char word[23];
    int32_t idbuf[6];

    inline bool matches(uint64_t hh, std::string_view w) const {
      return used && h == hh && wlen == w.size() &&
             std::memcmp(word, w.data(), w.size()) == 0;
    }
  };
  static constexpr size_t kSlots = 1 << 17;
  std::vector<Entry> slots{kSlots};

  static inline uint64_t hash(std::string_view w) {
    uint64_t h = 1469598103934665603ULL;
    for (char c : w) {
      h ^= static_cast<uint8_t>(c);
      h *= 1099511628211ULL;
    }
    return h;
  }
};

struct Scratch {
  std::string norm;
  std::string lower;
  std::vector<std::pair<uint32_t, uint32_t>> words;
  std::vector<int32_t> ids;
  std::vector<int32_t> row;
  std::vector<uint64_t> seen_bits;
  std::vector<int32_t> memo_ids;
};

// Thread-local memo: HTTP/serve threads persist across calls, so their
// memo warms once and is REUSED (the per-Scratch version re-zeroed
// ~8 MB per encode call — hundreds of microseconds to tokenize a
// single query). run_parallel's batch threads are fresh per call and
// amortize construction over their whole chunk.
inline WordMemo& memo_for(const Vocab& v) {
  static thread_local WordMemo memo;
  static thread_local uint64_t owner_gen = ~0ULL;
  if (owner_gen != v.gen) {
    for (auto& e : memo.slots) e.used = false;
    owner_gen = v.gen;
  }
  return memo;
}

// Tokenize raw text into ids, honoring literal special tokens; appends
// to `ids` and stops adding once `cap` total ids are reached (trimming
// any wordpiece overshoot).
void tokenize_ids(const Vocab& v, const char* s, size_t len, int32_t cap,
                  std::vector<int32_t>& ids, Scratch& sc) {
  // memo-and-append: key is the (raw or normalized) word; when the key
  // may carry uppercase ASCII (raw fast path) the pieces are computed
  // from a lowercased copy, matching what normalization would emit
  auto compute = [&](std::string_view w, bool needs_lower,
                     std::vector<int32_t>& out) {
    if (needs_lower) {
      sc.lower.assign(w.data(), w.size());
      for (char& ch : sc.lower)
        if (ch >= 'A' && ch <= 'Z') ch += 32;
      wordpiece(v, std::string_view(sc.lower), out);
    } else {
      wordpiece(v, w, out);
    }
  };
  auto append_memo = [&](std::string_view w, bool needs_lower) {
    if (w.size() > sizeof(WordMemo::Entry::word)) {
      // rare long word: compute directly, no memo entry
      size_t before = ids.size();
      compute(w, needs_lower, ids);
      if (static_cast<int32_t>(ids.size()) > cap) ids.resize(cap);
      (void)before;
      return;
    }
    uint64_t h = WordMemo::hash(w);
    auto& e = memo_for(v).slots[h & (WordMemo::kSlots - 1)];
    if (!e.matches(h, w)) {
      auto& tmp = sc.memo_ids;
      tmp.clear();
      compute(w, needs_lower, tmp);
      if (tmp.size() <= sizeof(e.idbuf) / sizeof(int32_t)) {
        e.h = h;
        e.wlen = static_cast<uint8_t>(w.size());
        std::memcpy(e.word, w.data(), w.size());
        e.n_ids = static_cast<uint8_t>(tmp.size());
        std::memcpy(e.idbuf, tmp.data(), tmp.size() * sizeof(int32_t));
        e.used = true;
      } else {
        e.used = false;  // >6 pieces: don't cache, just emit
      }
      for (int32_t id : tmp) {
        if (static_cast<int32_t>(ids.size()) >= cap) return;
        ids.push_back(id);
      }
      return;
    }
    for (int32_t k = 0; k < e.n_ids; k++) {
      if (static_cast<int32_t>(ids.size()) >= cap) return;
      ids.push_back(e.idbuf[k]);
    }
  };

  auto emit_words = [&](size_t lo, size_t hi) {
    basic_tokenize(v, s + lo, hi - lo, sc.norm, sc.words);
    for (const auto& [off, wlen] : sc.words) {
      if (static_cast<int32_t>(ids.size()) >= cap) return;
      append_memo(std::string_view(sc.norm).substr(off, wlen), false);
    }
  };

  auto emit_segment = [&](size_t lo, size_t hi) {
    if (lo >= hi) return;
    // raw fast path: chunks split at ASCII whitespace that contain
    // only [A-Za-z0-9] normalize to lowercase(chunk) with no further
    // splitting/removal — memo them directly, skipping the per-char
    // normalization walk entirely (most words of natural text)
    size_t cs = lo;
    bool simple = true;
    auto flush = [&](size_t ce) {
      if (cs < ce) {
        if (simple)
          append_memo(std::string_view(s + cs, ce - cs), true);
        else
          emit_words(cs, ce);
      }
      simple = true;
    };
    for (size_t i = lo; i < hi; i++) {
      if (static_cast<int32_t>(ids.size()) >= cap) return;
      uint8_t b = static_cast<uint8_t>(s[i]);
      if (b == ' ' || b == '\t' || b == '\n' || b == '\r') {
        flush(i);
        cs = i + 1;
      } else if (!((b >= 'a' && b <= 'z') || (b >= 'A' && b <= 'Z') ||
                   (b >= '0' && b <= '9'))) {
        simple = false;
      }
    }
    flush(hi);
  };
  size_t seg = 0;
  if (!v.specials.empty()) {
    // every registered special starts with '[' — find candidates with
    // SIMD memchr instead of walking every byte (texts rarely contain
    // '[' at all, so this scan is ~free)
    size_t i = 0;
    while (i < len && static_cast<int32_t>(ids.size()) < cap) {
      const void* hit = std::memchr(s + i, '[', len - i);
      if (hit == nullptr) break;
      i = static_cast<size_t>(static_cast<const char*>(hit) - s);
      bool matched = false;
      for (const auto& [tok, id] : v.specials) {
        if (i + tok.size() <= len &&
            std::memcmp(s + i, tok.data(), tok.size()) == 0) {
          emit_segment(seg, i);
          if (static_cast<int32_t>(ids.size()) < cap)
            ids.push_back(id);
          i += tok.size();
          seg = i;
          matched = true;
          break;
        }
      }
      if (!matched) i++;
    }
  }
  if (static_cast<int32_t>(ids.size()) < cap) emit_segment(seg, len);
  if (static_cast<int32_t>(ids.size()) > cap) ids.resize(cap);
}

void encode_one(const Vocab& v, const char* text, size_t len,
                int32_t max_len, bool add_special, int32_t* out,
                int32_t* out_len, Scratch& sc) {
  auto& ids = sc.ids;
  ids.clear();
  if (add_special) ids.push_back(v.cls);
  tokenize_ids(v, text, len, add_special ? max_len - 1 : max_len, ids,
               sc);
  if (add_special) ids.push_back(v.sep);
  int32_t m = static_cast<int32_t>(ids.size());
  std::memcpy(out, ids.data(), m * sizeof(int32_t));
  for (int32_t k = m; k < max_len; k++) out[k] = v.pad;
  *out_len = m;
}

void run_parallel(int64_t n, int nthreads,
                  const std::function<void(int64_t, int64_t)>& fn) {
  if (nthreads <= 1 || n < 256) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// vocab_blob: newline-joined tokens in id order
void* wp_create(const char* vocab_blob, int64_t blob_len) {
  static std::atomic<uint64_t> next_gen{1};
  auto* v = new Vocab();
  v->gen = next_gen.fetch_add(1);
  int32_t id = 0;
  const char* p = vocab_blob;
  const char* endp = vocab_blob + blob_len;
  while (p < endp) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', endp - p));
    size_t len = nl ? static_cast<size_t>(nl - p)
                    : static_cast<size_t>(endp - p);
    if (len > 0) {
      std::string tok(p, len);
      v->map.emplace(std::move(tok), id);
    }
    id++;
    p = nl ? nl + 1 : endp;
  }
  auto find = [&](const char* t, int32_t dflt) {
    auto it = v->map.find(t);
    return it == v->map.end() ? dflt : it->second;
  };
  v->pad = find("[PAD]", 0);
  v->unk = find("[UNK]", 1);
  v->cls = find("[CLS]", 2);
  v->sep = find("[SEP]", 3);
  for (const char* t : {"[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"}) {
    auto it = v->map.find(t);
    if (it != v->map.end()) v->specials.emplace_back(t, it->second);
  }
  v->finalize();
  return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Install exact-unicode tables (see Vocab docs). Copies all inputs.
// flags: [n_flags] uint8 (n_flags = 0x110000); fold CSR: keys [n_keys]
// sorted uint32, off [n_keys+1] int32, data [off[n_keys]] uint32.
void wp_set_tables(void* handle, const uint8_t* flags, int64_t n_flags,
                   const uint32_t* fold_keys, const int32_t* fold_off,
                   const uint32_t* fold_data, int64_t n_keys) {
  Vocab& v = *static_cast<Vocab*>(handle);
  v.uflags.assign(flags, flags + n_flags);
  v.fold_keys.assign(fold_keys, fold_keys + n_keys);
  v.fold_off.assign(fold_off, fold_off + n_keys + 1);
  v.fold_data.assign(fold_data, fold_data + fold_off[n_keys]);
  v.exact = true;
}

int32_t wp_vocab_size(void* handle) {
  return static_cast<int32_t>(static_cast<Vocab*>(handle)->map.size());
}

// texts: concatenated bytes; offsets: [n+1] byte offsets into texts.
// out_ids: [n, max_len] int32 (caller-allocated); out_lens: [n] int32.
void wp_encode_batch(void* handle, const char* texts,
                     const int64_t* offsets, int64_t n, int32_t max_len,
                     int32_t add_special, int32_t* out_ids,
                     int32_t* out_lens, int32_t nthreads) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  run_parallel(n, nthreads, [&](int64_t lo, int64_t hi) {
    Scratch sc;
    for (int64_t i = lo; i < hi; i++) {
      encode_one(v, texts + offsets[i],
                 static_cast<size_t>(offsets[i + 1] - offsets[i]), max_len,
                 add_special != 0, out_ids + i * max_len, out_lens + i,
                 sc);
    }
  });
}

// Fused bag-of-token row build: first-`cap` unique ids >= shift, emitted
// shifted (id - shift) into out_cols [n, nnz_pad]; counts into out_nnz.
void wp_encode_bot_batch(void* handle, const char* texts,
                         const int64_t* offsets, int64_t n,
                         int32_t max_len, int32_t shift, int32_t cap,
                         int32_t nnz_pad, int32_t pad_value,
                         int32_t* out_cols, int32_t* out_nnz,
                         int32_t nthreads) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  run_parallel(n, nthreads, [&](int64_t lo, int64_t hi) {
    Scratch sc;
    auto& ids = sc.ids;
    auto& row = sc.row;
    auto& seen_bits = sc.seen_bits;
    for (int64_t i = lo; i < hi; i++) {
      ids.clear();
      row.clear();
      // tokenize (with CLS/SEP like the reference tokenizer call,
      // reference retriever.py:238 — specials fall below shift anyway)
      ids.push_back(v.cls);
      tokenize_ids(v, texts + offsets[i],
                   static_cast<size_t>(offsets[i + 1] - offsets[i]),
                   max_len - 1, ids, sc);
      ids.push_back(v.sep);
      // first-N-unique >= shift (small bitset over the vocab; the map
      // holds one entry per blob line, so ids always index in range)
      size_t vs = v.map.size();
      if (seen_bits.size() < (vs + 63) / 64)
        seen_bits.assign((vs + 63) / 64, 0);
      for (int32_t t : ids) {
        if (t < shift) continue;
        uint64_t& w64 = seen_bits[static_cast<size_t>(t) >> 6];
        uint64_t bit = 1ULL << (t & 63);
        if (w64 & bit) continue;
        w64 |= bit;
        row.push_back(t - shift);
        if (static_cast<int32_t>(row.size()) >= cap) break;
      }
      int32_t m = static_cast<int32_t>(row.size());
      int32_t* dst = out_cols + i * nnz_pad;
      std::memcpy(dst, row.data(), m * sizeof(int32_t));
      for (int32_t k = m; k < nnz_pad; k++) dst[k] = pad_value;
      out_nnz[i] = m;
      // targeted bitmap clear: every set bit belongs to a row entry
      // (bits are only set when pushed), so clearing those words
      // beats re-zeroing the full ~vocab/64-word bitset per row
      // (~470 words for bert vocab vs <= nnz words)
      for (int32_t c : row)
        seen_bits[static_cast<size_t>(c + shift) >> 6] = 0;
    }
  });
}

}  // extern "C"
