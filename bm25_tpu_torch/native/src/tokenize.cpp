// Native corpus tokenizer: lowercase -> \w\w+ split -> stopwords -> stem.
//
// C-ABI replacement for the pure-Python pipeline in
// bm25_tpu_torch/text/tokenizer.py (which remains the semantics oracle);
// built at first use into libbm25text-<hash>.so (native/_build.py) and
// loaded via ctypes.  The reference's native layer was Mojo kernels; here
// the host-side hot loop of index building (tokenization,
// reference/bm25_test.py:16) is the part that belongs in C++ — device
// scoring lives in the CUDA kernels instead.
//
// Unicode handling: UTF-8 bytes >= 0x80 are treated as word characters and
// token length is counted in code points, matching Python's \w\w+ for the
// common cases; ASCII-only text is byte-exact with the Python path
// (enforced by tests/test_torch_native.py), and the Python tokenizer sends
// only ASCII documents here.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace bm25 {
template <class S>
S stem_english(const S& input);
}

namespace {

inline bool is_word_byte(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_' ||
           c >= 0x80;
}

inline bool is_ascii_alpha_token(const std::string& t) {
    for (unsigned char c : t)
        if (c >= 0x80) return false;
    return true;
}

}  // namespace

struct TokResult {
    std::vector<int32_t> ids;        // flat token ids
    std::vector<int64_t> offsets;    // n_docs + 1
    std::vector<std::string> vocab;  // id -> term
};

extern "C" {

TokResult* bm25_tokenize_corpus(const char* const* docs, const int64_t* lens,
                                int64_t n_docs, const char* const* stopwords,
                                int64_t n_stop, int use_stemmer) {
    // an exception (std::bad_alloc from the unbounded vectors/maps) must
    // never unwind through the ctypes frames — that aborts the whole
    // Python process; return null so the wrapper raises MemoryError
    TokResult* res = nullptr;
    try {
    res = new TokResult();
    res->offsets.reserve(n_docs + 1);
    res->offsets.push_back(0);

    std::unordered_set<std::string> stop;
    for (int64_t i = 0; i < n_stop; i++) stop.insert(stopwords[i]);

    std::unordered_map<std::string, int32_t> vocab_map;
    std::unordered_map<std::string, std::string> stem_cache;

    std::string tok;
    for (int64_t d = 0; d < n_docs; d++) {
        const char* p = docs[d];
        const char* end = p + lens[d];
        while (p < end) {
            // scan to next word byte (lowercasing ASCII on the fly)
            unsigned char c = (unsigned char)*p;
            if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
            if (!is_word_byte(c)) { p++; continue; }
            tok.clear();
            int chars = 0;
            while (p < end) {
                c = (unsigned char)*p;
                if (c >= 'A' && c <= 'Z') c = c - 'A' + 'a';
                if (!is_word_byte(c)) break;
                if ((c & 0xC0) != 0x80) chars++;  // count code points
                tok.push_back((char)c);
                p++;
            }
            if (chars < 2) continue;                 // \w\w+ needs >= 2 chars
            if (stop.count(tok)) continue;           // stopword
            const std::string* final_tok = &tok;
            std::string stemmed;
            if (use_stemmer) {
                auto it = stem_cache.find(tok);
                if (it == stem_cache.end()) {
                    stemmed = is_ascii_alpha_token(tok) ? bm25::stem_english<std::string>(tok)
                                                        : tok;
                    it = stem_cache.emplace(tok, stemmed).first;
                }
                final_tok = &it->second;
            }
            auto vit = vocab_map.find(*final_tok);
            int32_t id;
            if (vit == vocab_map.end()) {
                id = (int32_t)res->vocab.size();
                vocab_map.emplace(*final_tok, id);
                res->vocab.push_back(*final_tok);
            } else {
                id = vit->second;
            }
            res->ids.push_back(id);
        }
        res->offsets.push_back((int64_t)res->ids.size());
    }
    return res;
    } catch (...) {
        delete res;
        return nullptr;
    }
}

int64_t tok_total_tokens(TokResult* r) { return (int64_t)r->ids.size(); }
int64_t tok_vocab_size(TokResult* r) { return (int64_t)r->vocab.size(); }

void tok_copy_ids(TokResult* r, int32_t* out) {
    std::memcpy(out, r->ids.data(), r->ids.size() * sizeof(int32_t));
}

void tok_copy_offsets(TokResult* r, int64_t* out) {
    std::memcpy(out, r->offsets.data(), r->offsets.size() * sizeof(int64_t));
}

int64_t tok_vocab_bytes(TokResult* r) {
    int64_t total = 0;
    for (auto& t : r->vocab) total += (int64_t)t.size() + 1;
    return total;
}

void tok_copy_vocab(TokResult* r, char* out) {
    for (auto& t : r->vocab) {
        std::memcpy(out, t.data(), t.size());
        out += t.size();
        *out++ = '\n';
    }
}

void tok_free(TokResult* r) { delete r; }

// Single-word stem entry point (for tests / query-time use).  The input
// is lowercased first — the parity target (NLTK SnowballStemmer.stem)
// lowercases, and the stemmer's internal 'Y' consonant marker mangles
// uppercase input otherwise.  Returns -1 on overflow, -2 on exception.
int64_t bm25_stem(const char* word, int64_t len, char* out, int64_t out_cap) {
    try {
        std::string w(word, (size_t)len);
        for (auto& c : w)
            if (c >= 'A' && c <= 'Z') c = (char)(c - 'A' + 'a');
        std::string s = bm25::stem_english<std::string>(w);
        int64_t n = (int64_t)s.size();
        if (n > out_cap) return -1;
        std::memcpy(out, s.data(), (size_t)n);
        return n;
    } catch (...) {
        return -2;
    }
}

// The same for a word of any script, as UTF-32 code points (``len`` of
// them, read from ``word`` as raw bytes: no alignment is assumed).  The
// caller lowercases first (NLTK's stem() runs Python's str.lower()); only
// the stem itself, in code points, is written to ``out``.  Returns its
// length, -1 on overflow, -2 on exception.
int64_t bm25_stem_u32(const char* word, int64_t len, char* out,
                      int64_t out_cap) {
    try {
        std::u32string w(static_cast<size_t>(len), U'\0');
        if (len) std::memcpy(&w[0], word, static_cast<size_t>(len) * 4);
        std::u32string s = bm25::stem_english<std::u32string>(w);
        int64_t n = static_cast<int64_t>(s.size());
        if (n > out_cap) return -1;
        if (n) std::memcpy(out, s.data(), static_cast<size_t>(n) * 4);
        return n;
    } catch (...) {
        return -2;
    }
}

}  // extern "C"
