// Native batch hashing for the text featurization host path.
//
// A copy of keystone_tpu/native/hashing.cpp for the PyTorch port.
// Bit-exact counterparts of keystone_tpu_torch/nodes/nlp/hashing.py (which is
// itself bit-exact with the reference's Scala `.##` / MurmurHash3.seqHash
// — HashingTF.scala:15-32, NGramsHashingTF.scala:25-146). The Python
// loops hash per character / per n-gram position in the interpreter; the
// corpus-level batch forms here do the same arithmetic over flat arrays.
// Strings arrive as UTF-32 codepoint arrays (matching the Python
// implementation's ord()-based loop).
//
// Built by keystone_tpu_torch/native/__init__.py with g++ at first use and
// loaded via ctypes; everything stays available in pure Python when no
// compiler is present.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t rotl32(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

inline uint32_t mix(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

inline int32_t finalize(uint32_t h, uint32_t length) {
  h ^= length;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (int32_t)h;
}

inline int32_t non_negative_mod(int32_t x, int32_t mod) {
  int32_t r = x % mod;
  return r < 0 ? r + mod : r;
}

}  // namespace

extern "C" {

// java.lang.String.hashCode over n strings packed as UTF-32 codepoints.
// offsets has n+1 entries delimiting each string in cps.
void ks_java_string_hash_batch(const uint32_t* cps, const int64_t* offsets,
                               int64_t n, int32_t* out) {
  for (int64_t s = 0; s < n; ++s) {
    uint32_t h = 0;
    for (int64_t i = offsets[s]; i < offsets[s + 1]; ++i) {
      h = h * 31u + cps[i];
    }
    out[s] = (int32_t)h;
  }
}

// The rolling n-gram feature stream of NGramsHashingTF.apply: for every
// start position, hash the min_order-gram, then extend one token at a
// time up to max_order, emitting non_negative_mod(finalize(h, order), F)
// at each order. doc_offsets (n_docs+1) delimits token_hashes per doc;
// out_offsets (n_docs+1) delimits the (precomputed) per-doc output
// counts. Returns total features written.
int64_t ks_ngram_hash_features_batch(
    const int32_t* token_hashes, const int64_t* doc_offsets, int64_t n_docs,
    int32_t min_order, int32_t max_order, int32_t num_features,
    uint32_t seq_seed, const int64_t* out_offsets, int32_t* out) {
  int64_t written = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    const int32_t* th = token_hashes + doc_offsets[d];
    const int64_t n = doc_offsets[d + 1] - doc_offsets[d];
    int32_t* w = out + out_offsets[d];
    for (int64_t i = 0; i + min_order <= n; ++i) {
      uint32_t h = seq_seed;
      for (int64_t j = i; j < i + min_order; ++j) {
        h = mix(h, (uint32_t)th[j]);
      }
      *w++ = non_negative_mod(finalize(h, (uint32_t)min_order),
                              num_features);
      for (int32_t order = min_order + 1;
           order <= max_order && i + order <= n; ++order) {
        h = mix(h, (uint32_t)th[i + order - 1]);
        *w++ = non_negative_mod(finalize(h, (uint32_t)order), num_features);
      }
    }
    written += w - (out + out_offsets[d]);
  }
  return written;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused text frontend: trim -> lowercase -> tokenize -> first-seen vocab ids,
// one pass over the concatenated ASCII corpus. Semantics are pinned to the
// Python chain Trim -> LowerCase -> Tokenizer(r"[^\w]+") -> _token_ids
// (nodes/nlp/text.py + packed_features.py), which remains the spec and the
// fallback; the Python caller guarantees pure-ASCII input (non-ASCII corpora
// take the Python path, where re's unicode \w applies).
//
// Tokenizer parity details reproduced exactly:
//   * split on runs of non-[A-Za-z0-9_];
//   * a doc starting with a separator contributes one leading EMPTY token
//     (Java String.split keeps it; trailing empties are dropped);
//   * an empty (or all-whitespace, post-trim) doc contributes no tokens;
//   * ids are assigned in first-seen order over the concatenated stream
//     (grow=1), or looked up with -1 for unknowns (grow=0).

namespace {

inline bool is_word_ascii(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

inline bool is_space_ascii(unsigned char c) {
  // str.strip() whitespace, ASCII subset: \t-\r, the \x1c-\x1f
  // file/group/record/unit separators, and space
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
}

inline uint64_t fnv1a(const char* p, int64_t n) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < n; ++i) {
    h ^= (unsigned char)p[i];
    h *= 1099511628211ull;
  }
  return h;
}

// open-addressing token table: slot -> entry index + 1 (0 = empty)
struct TokenMap {
  struct Entry {
    const char* ptr;
    int64_t len;
    int64_t id;
    uint64_t hash;
  };
  std::vector<int64_t> slots;
  std::vector<Entry> entries;
  uint64_t mask;

  explicit TokenMap(int64_t expected) {
    int64_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    slots.assign(cap, 0);
    mask = (uint64_t)cap - 1;
  }

  void rehash() {
    int64_t cap = (int64_t)slots.size() * 2;
    slots.assign(cap, 0);
    mask = (uint64_t)cap - 1;
    for (int64_t i = 0; i < (int64_t)entries.size(); ++i) {
      uint64_t s = entries[i].hash & mask;
      while (slots[s]) s = (s + 1) & mask;
      slots[s] = i + 1;
    }
  }

  // returns id, or -1 when absent and insert_id < 0
  int64_t lookup_or_insert(const char* p, int64_t n, int64_t insert_id,
                           bool* inserted) {
    uint64_t h = fnv1a(p, n);
    uint64_t s = h & mask;
    while (slots[s]) {
      const Entry& e = entries[slots[s] - 1];
      if (e.hash == h && e.len == n && std::memcmp(e.ptr, p, n) == 0) {
        *inserted = false;
        return e.id;
      }
      s = (s + 1) & mask;
    }
    if (insert_id < 0) {
      *inserted = false;
      return -1;
    }
    entries.push_back({p, n, insert_id, h});
    slots[s] = (int64_t)entries.size();
    *inserted = true;
    if ((uint64_t)entries.size() * 3 > slots.size() * 2) rehash();
    return insert_id;
  }
};

}  // namespace

extern "C" {

// Returns the total token count (<= 0 on error). Buffers sized by caller:
// ids_out: text_len + n_docs entries; tok_doc_off_out: n_docs + 1;
// new_bytes_out: text_len bytes; new_off_out: text_len + n_docs + 1
// (offsets, first entry 0); new_count_out: 1.
int64_t ks_text_frontend(
    const char* text, const int64_t* doc_off, int64_t n_docs,
    int32_t do_trim, int32_t do_lower,
    const char* vocab_bytes, const int64_t* vocab_off, int64_t vocab_n,
    int32_t grow,
    int64_t* ids_out, int64_t* tok_doc_off_out,
    char* new_bytes_out, int64_t* new_off_out, int64_t* new_count_out) {
  const int64_t text_len = doc_off[n_docs];
  // lowercased working copy (token entries point into it, so it must
  // outlive the map — new-token bytes are copied to new_bytes_out before
  // return, making the map/table disposable)
  std::vector<char> buf(text, text + text_len);
  if (do_lower) {
    for (int64_t i = 0; i < text_len; ++i) {
      unsigned char c = (unsigned char)buf[i];
      if (c >= 'A' && c <= 'Z') buf[i] = (char)(c + 32);
    }
  }
  TokenMap map(vocab_n + 1024);
  for (int64_t v = 0; v < vocab_n; ++v) {
    bool ins;
    map.lookup_or_insert(vocab_bytes + vocab_off[v],
                         vocab_off[v + 1] - vocab_off[v], v, &ins);
  }
  int64_t next_id = vocab_n;
  int64_t ntok = 0;
  int64_t new_count = 0;
  int64_t new_bytes = 0;
  new_off_out[0] = 0;
  tok_doc_off_out[0] = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    const char* s = buf.data() + doc_off[d];
    const char* e = buf.data() + doc_off[d + 1];
    if (do_trim) {
      while (s < e && is_space_ascii((unsigned char)*s)) ++s;
      while (e > s && is_space_ascii((unsigned char)e[-1])) --e;
    }
    const char* p = s;
    // a leading separator run yields one empty token, but ONLY if a word
    // token follows (otherwise Python's trailing-empty pop removes it too:
    // "++--++" tokenizes to nothing) — emit it lazily before the first word
    bool pending_empty = (p < e && !is_word_ascii((unsigned char)*p));
    while (true) {
      while (p < e && !is_word_ascii((unsigned char)*p)) ++p;
      if (p >= e) break;
      const char* t0 = p;
      while (p < e && is_word_ascii((unsigned char)*p)) ++p;
      for (int emit_empty = pending_empty ? 1 : 0; emit_empty >= 0;
           --emit_empty) {
        const char* tp = emit_empty ? s : t0;
        const int64_t tlen = emit_empty ? 0 : p - t0;
        bool inserted;
        int64_t id =
            map.lookup_or_insert(tp, tlen, grow ? next_id : -1, &inserted);
        if (inserted) {
          std::memcpy(new_bytes_out + new_bytes, tp, tlen);
          new_bytes += tlen;
          new_off_out[++new_count] = new_bytes;
          ++next_id;
        }
        ids_out[ntok++] = id;
      }
      pending_empty = false;
    }
    tok_doc_off_out[d + 1] = ntok;
  }
  *new_count_out = new_count;
  return ntok;
}

// Packed n-gram emission + per-doc uniquing, fused — the native form of
// packed_features._corpus_grams + _per_doc_unique. The numpy form pays a
// corpus-wide lexsort over every (doc, gram) pair; grams never cross doc
// boundaries, so doc-local sorts of ~tens of entries do the same work in
// cache. Bit-packing replicates NaiveBitPackIndexer.pack_batch exactly
// (20-bit ids, control bits 1<<60 / 1<<61); grams containing a -1 OOV id
// are dropped; output pairs are doc-major, within-doc ordered by FIRST
// EMISSION (position-major, then order ascending) — the uid order the
// selection tie-break depends on. Returns the unique-pair count.
int64_t ks_packed_grams_unique(
    const int64_t* ids, const int64_t* tok_off, int64_t n_docs,
    const int32_t* orders, int32_t n_orders,
    int64_t* d_u, int64_t* g_u, int64_t* counts_out) {
  struct Gram {
    int64_t packed;
    int64_t emit;
  };
  for (int32_t oi = 0; oi < n_orders; ++oi) {
    if (orders[oi] < 1 || orders[oi] > 3) return -1;  // wrapper falls back
  }
  std::vector<Gram> grams;
  std::vector<Gram> uniq;
  int64_t written = 0;
  for (int64_t d = 0; d < n_docs; ++d) {
    const int64_t* t = ids + tok_off[d];
    const int64_t n = tok_off[d + 1] - tok_off[d];
    grams.clear();
    for (int32_t oi = 0; oi < n_orders; ++oi) {
      const int32_t order = orders[oi];
      for (int64_t i = 0; i + order <= n; ++i) {
        int64_t packed;
        if (order == 1) {
          if (t[i] < 0) continue;
          packed = t[i] << 40;
        } else if (order == 2) {
          if (t[i] < 0 || t[i + 1] < 0) continue;
          packed = (t[i + 1] << 20) | (t[i] << 40) | (int64_t(1) << 60);
        } else {
          if (t[i] < 0 || t[i + 1] < 0 || t[i + 2] < 0) continue;
          packed = t[i + 2] | (t[i + 1] << 20) | (t[i] << 40) |
                   (int64_t(1) << 61);
        }
        grams.push_back({packed, i * n_orders + oi});
      }
    }
    std::sort(grams.begin(), grams.end(), [](const Gram& a, const Gram& b) {
      return a.packed != b.packed ? a.packed < b.packed : a.emit < b.emit;
    });
    uniq.clear();
    int64_t i = 0;
    while (i < (int64_t)grams.size()) {
      int64_t j = i + 1;
      while (j < (int64_t)grams.size() &&
             grams[j].packed == grams[i].packed) {
        ++j;
      }
      // grams[i].emit is the min emit key of the run (sorted tie-break)
      uniq.push_back({grams[i].packed, grams[i].emit});
      counts_out[written + (int64_t)uniq.size() - 1] = j - i;
      i = j;
    }
    // counts were written in gram order; reorder all three outputs by
    // first-emission via an index sort over the doc's unique entries
    std::vector<int64_t> order_idx(uniq.size());
    for (size_t x = 0; x < uniq.size(); ++x) order_idx[x] = (int64_t)x;
    std::sort(order_idx.begin(), order_idx.end(),
              [&](int64_t a, int64_t b) { return uniq[a].emit < uniq[b].emit; });
    std::vector<int64_t> counts_tmp(uniq.size());
    for (size_t x = 0; x < uniq.size(); ++x) {
      counts_tmp[x] = counts_out[written + order_idx[x]];
    }
    for (size_t x = 0; x < uniq.size(); ++x) {
      d_u[written + (int64_t)x] = d;
      g_u[written + (int64_t)x] = uniq[order_idx[x]].packed;
      counts_out[written + (int64_t)x] = counts_tmp[x];
    }
    written += (int64_t)uniq.size();
  }
  return written;
}

}  // extern "C"
