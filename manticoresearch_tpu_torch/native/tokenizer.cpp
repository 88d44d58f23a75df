// Native host tokenizer: UTF-8 decode + charset folding + word-run split.
//
// Behavioral model: CSphTokenizer_UTF8 (Manticore src/sphinx.cpp:2671+)
// — the host-side hot loop of index builds. The reference implements this in
// C++ for throughput; so do we. Exposed via a C ABI for ctypes (no pybind11
// in this environment).
//
// Input: raw UTF-8 bytes + a dense fold table (codepoint -> folded codepoint,
// 0 = separator), built once per charset_table by the Python side.
// Output: flat folded-codepoint buffer + per-token (offset, length, position,
// char_start, char_end) arrays. Python slices token strings out in bulk.
//
// Build: g++ -O3 -shared -fPIC tokenizer.cpp -o libmttok.so  (see build.py)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxWordLen = 42;  // SPH_MAX_WORD_LEN, sphinx.h:106

// Stateful dictionary builder for bulk index builds: folded-codepoint
// token -> dense term id via an open-addressing hash map with full-key
// verification (exact — the hash only routes probing). This is the
// C++-side replacement for the Python `vocab.setdefault` per-token loop
// (the reference's CSphDict hash lives on this side of the wall too,
// sphinx.cpp:19224).
struct MtDict {
    std::vector<int32_t> pool;        // concatenated folded codes
    std::vector<int64_t> term_off;    // per-term offset into pool (+end)
    std::vector<int32_t> slots;       // open addressing: term id + 1, 0 = empty
    uint64_t mask = 0;

    MtDict() {
        slots.assign(1 << 16, 0);
        mask = slots.size() - 1;
        term_off.push_back(0);
    }

    static uint64_t hash(const int32_t* codes, int len) {
        uint64_t h = 1469598103934665603ULL;          // FNV-1a 64
        for (int i = 0; i < len; i++) {
            h ^= (uint32_t)codes[i];
            h *= 1099511628211ULL;
        }
        return h;
    }

    bool equal(int tid, const int32_t* codes, int len) const {
        int64_t a = term_off[tid], b = term_off[tid + 1];
        if (b - a != len) return false;
        return std::memcmp(&pool[a], codes, len * sizeof(int32_t)) == 0;
    }

    void grow() {
        std::vector<int32_t> old;
        old.swap(slots);
        slots.assign(old.size() * 2, 0);
        mask = slots.size() - 1;
        int n = (int)term_off.size() - 1;
        for (int t = 0; t < n; t++) {
            int64_t a = term_off[t];
            uint64_t h = hash(&pool[a], (int)(term_off[t + 1] - a));
            uint64_t i = h & mask;
            while (slots[i]) i = (i + 1) & mask;
            slots[i] = t + 1;
        }
    }

    int get(const int32_t* codes, int len) {
        uint64_t i = hash(codes, len) & mask;
        while (slots[i]) {
            int tid = slots[i] - 1;
            if (equal(tid, codes, len)) return tid;
            i = (i + 1) & mask;
        }
        int tid = (int)term_off.size() - 1;
        pool.insert(pool.end(), codes, codes + len);
        term_off.push_back((int64_t)pool.size());
        slots[i] = tid + 1;
        if ((uint64_t)(tid + 1) * 2 > mask) grow();
        return tid;
    }
};

// Decode one UTF-8 codepoint; returns bytes consumed (0 on error).
inline int utf8_decode(const uint8_t* p, const uint8_t* end, uint32_t* cp) {
    uint8_t c = p[0];
    if (c < 0x80) { *cp = c; return 1; }
    if ((c >> 5) == 0x6) {
        if (end - p < 2) return 0;
        *cp = ((c & 0x1F) << 6) | (p[1] & 0x3F);
        return 2;
    }
    if ((c >> 4) == 0xE) {
        if (end - p < 3) return 0;
        *cp = ((c & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
        return 3;
    }
    if ((c >> 3) == 0x1E) {
        if (end - p < 4) return 0;
        *cp = ((c & 0x07) << 18) | ((p[1] & 0x3F) << 12) |
              ((p[2] & 0x3F) << 6) | (p[3] & 0x3F);
        return 4;
    }
    return 0;
}

}  // namespace

extern "C" {

// Tokenize UTF-8 text.
//   text, text_len:      input bytes
//   fold, fold_len:      dense codepoint fold table (index = codepoint)
//   min_word_len:        tokens shorter than this are skipped
//   overshort_step:      position bump for skipped overshort tokens
//   out_codes:           [cap_codes] folded codepoints of kept tokens, packed
//   out_tok_off/len:     [cap_tokens] per-token slice into out_codes
//   out_pos:             [cap_tokens] 1-based in-field positions
//   out_char_start/end:  [cap_tokens] char (codepoint) offsets in the source
// Returns the number of tokens written (clipped at cap_tokens).
int mt_tokenize(const uint8_t* text, int text_len,
                const int32_t* fold, int fold_len,
                int min_word_len, int overshort_step,
                int32_t* out_codes, int cap_codes,
                int32_t* out_tok_off, int32_t* out_len, int32_t* out_pos,
                int32_t* out_char_start, int32_t* out_char_end,
                int cap_tokens) {
    const uint8_t* p = text;
    const uint8_t* end = text + text_len;

    int n_tokens = 0;
    int code_cursor = 0;
    int pos = 0;
    int char_idx = 0;

    int run_len = 0;          // codepoints in the current word run
    int run_kept = 0;         // codepoints actually stored (<= kMaxWordLen)
    int run_start_char = 0;
    int run_start_code = 0;

    while (p < end) {
        uint32_t cp;
        int nb = utf8_decode(p, end, &cp);
        if (nb == 0) { p += 1; continue; }  // skip invalid byte
        p += nb;

        int32_t folded = (cp < (uint32_t)fold_len) ? fold[cp] : 0;
        if (folded > 0) {
            if (run_len == 0) {
                run_start_char = char_idx;
                run_start_code = code_cursor;
                run_kept = 0;
            }
            if (run_kept < kMaxWordLen && code_cursor < cap_codes) {
                out_codes[code_cursor++] = folded;
                run_kept++;
            }
            run_len++;
        } else if (run_len > 0) {
            // close the run
            if (run_len < min_word_len) {
                pos += overshort_step;
                code_cursor = run_start_code;  // discard stored codes
            } else {
                pos += 1;
                if (n_tokens < cap_tokens) {
                    out_tok_off[n_tokens] = run_start_code;
                    out_len[n_tokens] = run_kept;
                    out_pos[n_tokens] = pos;
                    out_char_start[n_tokens] = run_start_char;
                    out_char_end[n_tokens] = char_idx;
                    n_tokens++;
                } else {
                    return n_tokens;
                }
            }
            run_len = 0;
        }
        char_idx++;
    }
    if (run_len > 0) {
        if (run_len < min_word_len) {
            // trailing overshort token: dropped
        } else {
            pos += 1;
            if (n_tokens < cap_tokens) {
                out_tok_off[n_tokens] = run_start_code;
                out_len[n_tokens] = run_kept;
                out_pos[n_tokens] = pos;
                out_char_start[n_tokens] = run_start_char;
                out_char_end[n_tokens] = char_idx;
                n_tokens++;
            }
        }
    }
    return n_tokens;
}

// ---- bulk-build dictionary API (ctypes) ----------------------------------

void* mt_dict_new() { return new MtDict(); }
void mt_dict_free(void* d) { delete (MtDict*)d; }
int mt_dict_n_terms(void* d) {
    return (int)((MtDict*)d)->term_off.size() - 1;
}
int64_t mt_dict_pool_len(void* d) {
    return (int64_t)((MtDict*)d)->pool.size();
}
// Export the dictionary: folded codes pool + per-term offsets.
void mt_dict_export(void* dv, int32_t* out_codes, int64_t* out_off) {
    MtDict* d = (MtDict*)dv;
    std::memcpy(out_codes, d->pool.data(),
                d->pool.size() * sizeof(int32_t));
    std::memcpy(out_off, d->term_off.data(),
                d->term_off.size() * sizeof(int64_t));
}

// Tokenize one field and emit (term_id, Hitman-packed key) pairs — the
// whole per-token path (decode, fold, split, dict lookup, hit packing
// incl. the field-end flag pass) in one native call. Returns the token
// count (clipped at cap; caller grows and retries when == cap).
int mt_dict_tokenize(void* dv, const uint8_t* text, int text_len,
                     const int32_t* fold, int fold_len,
                     int min_word_len, int overshort_step, int field_id,
                     int32_t* out_tid, int32_t* out_pk, int cap) {
    MtDict* d = (MtDict*)dv;
    const uint8_t* p = text;
    const uint8_t* end = text + text_len;
    int32_t run[kMaxWordLen];
    int run_len = 0, run_kept = 0, pos = 0, n = 0;
    const int32_t fbits = field_id << 24;

    auto flush = [&]() {
        if (run_len >= min_word_len) {
            pos += 1;
            if (n < cap) {
                out_tid[n] = d->get(run, run_kept);
                out_pk[n] = fbits | pos;
                n++;
            }
        } else if (run_len > 0) {
            pos += overshort_step;
        }
        run_len = run_kept = 0;
    };

    while (p < end) {
        uint32_t cp;
        int nb = utf8_decode(p, end, &cp);
        if (nb == 0) { p += 1; continue; }
        p += nb;
        int32_t folded = (cp < (uint32_t)fold_len) ? fold[cp] : 0;
        if (folded > 0) {
            if (run_kept < kMaxWordLen) run[run_kept++] = folded;
            run_len++;
        } else if (run_len > 0) {
            flush();
        }
    }
    if (run_len > 0) flush();
    // Hitman end flag: every hit at the field's last position
    if (n > 0 && n < cap) {
        int32_t last = out_pk[n - 1];
        for (int i = n - 1; i >= 0 && out_pk[i] == last; i--)
            out_pk[i] |= 1 << 23;
    }
    return n;
}

// CRC64 (Jones polynomial) of folded token bytes — available for dict=crc
// style wordid hashing if ever needed.
uint64_t mt_crc64(const uint8_t* data, int len) {
    static uint64_t table[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; i++) {
            uint64_t crc = i;
            for (int j = 0; j < 8; j++)
                crc = (crc >> 1) ^ ((crc & 1) ? 0xad93d23594c935a9ULL : 0);
            table[i] = crc;
        }
        init = true;
    }
    uint64_t crc = ~0ULL;
    for (int i = 0; i < len; i++)
        crc = (crc >> 8) ^ table[(crc ^ data[i]) & 0xFF];
    return ~crc;
}

}  // extern "C"
