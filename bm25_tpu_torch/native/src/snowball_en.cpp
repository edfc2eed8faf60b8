// Snowball English ("Porter2") stemmer, C++ implementation.
//
// Parity target: NLTK's SnowballStemmer("english"), on every word, ASCII
// or not (fuzz-tested in tests/test_torch_native.py).  NLTK tracks the
// R1/R2 regions as *strings* that are surgically updated alongside the
// word and can go out of sync with it (e.g. an 'e' appended to the word is
// only conditionally appended to R2); exact compatibility therefore
// requires mirroring that bookkeeping rather than the position-based
// scheme of the published algorithm.
//
// The algorithm is a template over the string type: std::string (bytes)
// serves ASCII words, std::u32string (code points) every other word, so
// that lengths and positions count code points as NLTK's do.  Case folding
// beyond ASCII is the caller's: NLTK's stem() starts with Python's
// str.lower(), which the Python wrapper runs before a non-ASCII word
// reaches this code.  The three quote characters NLTK maps to an
// apostrophe (U+2019, U+2018, U+201B) are mapped here.
//
// Role: native replacement for the reference pipeline's PyStemmer call
// (reference/bm25_test.py:13-16); used by the fast tokenizer in
// tokenize.cpp for index builds, and by the Python tokenizer for queries
// and non-ASCII documents.

#include <cstring>
#include <string>
#include <unordered_map>

namespace bm25 {

namespace {

template <class C>
inline bool is_vowel(C c) {
    return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' || c == 'y';
}

// c is one of the ASCII characters of set (never matches NUL)
template <class C>
inline bool in_set(C c, const char* set) {
    for (const char* p = set; *p; ++p)
        if (c == static_cast<C>(static_cast<unsigned char>(*p))) return true;
    return false;
}

template <class S>
bool ends_with(const S& w, const char* suf) {
    using C = typename S::value_type;
    size_t n = std::strlen(suf);
    if (w.size() < n) return false;
    size_t off = w.size() - n;
    for (size_t i = 0; i < n; i++)
        if (w[off + i] != static_cast<C>(static_cast<unsigned char>(suf[i])))
            return false;
    return true;
}

template <class S>
bool starts_with(const S& w, const char* pre) {
    using C = typename S::value_type;
    size_t n = std::strlen(pre);
    if (w.size() < n) return false;
    for (size_t i = 0; i < n; i++)
        if (w[i] != static_cast<C>(static_cast<unsigned char>(pre[i])))
            return false;
    return true;
}

template <class S>
void append(S& s, const char* tail) {
    using C = typename S::value_type;
    for (const char* p = tail; *p; ++p)
        s.push_back(static_cast<C>(static_cast<unsigned char>(*p)));
}

// python s[:-n] (empty when n >= len)
template <class S>
void drop(S& s, size_t n) {
    s.resize(n >= s.size() ? 0 : s.size() - n);
}

// python suffix_replace semantics used by NLTK:
//   word: always replace; regions: replace when len >= suffix len, else
//   caller-specified fallback content.
template <class S>
void replace_word(S& w, size_t suf_len, const char* rep) {
    w.resize(w.size() - suf_len);
    append(w, rep);
}

template <class S>
void replace_region(S& r, size_t suf_len, const char* rep,
                    const char* fallback = "") {
    if (r.size() >= suf_len) {
        r.resize(r.size() - suf_len);
        append(r, rep);
    } else {
        r.clear();
        append(r, fallback);
    }
}

const std::unordered_map<std::string, std::string>& special_words() {
    static const std::unordered_map<std::string, std::string> m = {
        {"skis", "ski"},       {"skies", "sky"},     {"dying", "die"},
        {"lying", "lie"},      {"tying", "tie"},     {"idly", "idl"},
        {"gently", "gentl"},   {"ugly", "ugli"},     {"early", "earli"},
        {"only", "onli"},      {"singly", "singl"},  {"sky", "sky"},
        {"news", "news"},      {"howe", "howe"},     {"atlas", "atlas"},
        {"cosmos", "cosmos"},  {"bias", "bias"},     {"andes", "andes"},
        {"inning", "inning"},  {"innings", "inning"},
        {"outing", "outing"},  {"outings", "outing"},
        {"canning", "canning"}, {"cannings", "canning"},
        {"herring", "herring"}, {"herrings", "herring"},
        {"earring", "earring"}, {"earrings", "earring"},
        {"proceed", "proceed"}, {"proceeds", "proceed"},
        {"proceeded", "proceed"}, {"proceeding", "proceed"},
        {"exceed", "exceed"},  {"exceeds", "exceed"},
        {"exceeded", "exceed"}, {"exceeding", "exceed"},
        {"succeed", "succeed"}, {"succeeds", "succeed"},
        {"succeeded", "succeed"}, {"succeeding", "succeed"},
    };
    return m;
}

// the special word's stem, or null; the words are all ASCII
template <class S>
const std::string* special_stem(const S& w) {
    std::string key;
    key.reserve(w.size());
    for (auto c : w) {
        if (static_cast<unsigned long>(c) >= 0x80) return nullptr;
        key.push_back(static_cast<char>(c));
    }
    auto it = special_words().find(key);
    return it == special_words().end() ? nullptr : &it->second;
}

template <class S>
S from_ascii(const std::string& a) {
    S s;
    append(s, a.c_str());
    return s;
}

template <class S>
bool is_double(const S& w) {
    static const char* d[] = {"bb", "dd", "ff", "gg", "mm", "nn",
                              "pp", "rr", "tt"};
    for (auto s : d)
        if (ends_with(w, s)) return true;
    return false;
}

}  // namespace

// Stem an already-lowercased word (apostrophes allowed).
template <class S>
S stem_english(const S& input) {
    using C = typename S::value_type;
    S word = input;
    if (word.size() <= 2) return word;

    if (const std::string* special = special_stem(word))
        return from_ascii<S>(*special);

    if constexpr (sizeof(C) > 1) {
        for (auto& c : word)
            if (c == 0x2019 || c == 0x2018 || c == 0x201B) c = '\'';
    }
    if (!word.empty() && word[0] == '\'') word.erase(0, 1);
    if (!word.empty() && word[0] == 'y') word[0] = 'Y';
    for (size_t i = 1; i < word.size(); i++)
        if (word[i] == 'y' && is_vowel(word[i - 1])) word[i] = 'Y';

    // R1/R2 as region strings (NLTK _r1r2_standard + gener/commun/arsen)
    S r1, r2;
    if (starts_with(word, "gener") || starts_with(word, "commun") ||
        starts_with(word, "arsen")) {
        r1 = word.substr(starts_with(word, "commun") ? 6 : 5);
        for (size_t i = 1; i < r1.size(); i++)
            if (!is_vowel(r1[i]) && is_vowel(r1[i - 1])) {
                r2 = r1.substr(i + 1);
                break;
            }
    } else {
        for (size_t i = 1; i < word.size(); i++)
            if (!is_vowel(word[i]) && is_vowel(word[i - 1])) {
                r1 = word.substr(i + 1);
                break;
            }
        for (size_t i = 1; i < r1.size(); i++)
            if (!is_vowel(r1[i]) && is_vowel(r1[i - 1])) {
                r2 = r1.substr(i + 1);
                break;
            }
    }

    // STEP 0
    for (const char* suf : {"'s'", "'s", "'"}) {
        if (ends_with(word, suf)) {
            size_t n = std::strlen(suf);
            drop(word, n);
            drop(r1, n);
            drop(r2, n);
            break;
        }
    }

    // STEP 1a
    for (const char* suf : {"sses", "ied", "ies", "us", "ss", "s"}) {
        if (!ends_with(word, suf)) continue;
        if (0 == std::strcmp(suf, "sses")) {
            drop(word, 2); drop(r1, 2); drop(r2, 2);
        } else if (0 == std::strcmp(suf, "ied") || 0 == std::strcmp(suf, "ies")) {
            size_t n = (word.size() - 3 > 1) ? 2 : 1;
            drop(word, n); drop(r1, n); drop(r2, n);
        } else if (0 == std::strcmp(suf, "s")) {
            bool vowel_found = false;
            for (size_t i = 0; i + 2 < word.size(); i++)
                if (is_vowel(word[i])) { vowel_found = true; break; }
            if (vowel_found) {
                drop(word, 1); drop(r1, 1); drop(r2, 1);
            }
        }
        break;  // "us"/"ss": leave unchanged
    }

    // STEP 1b
    for (const char* suf : {"eedly", "ingly", "edly", "eed", "ing", "ed"}) {
        if (!ends_with(word, suf)) continue;
        size_t n = std::strlen(suf);
        if (0 == std::strcmp(suf, "eed") || 0 == std::strcmp(suf, "eedly")) {
            if (ends_with(r1, suf)) {
                replace_word(word, n, "ee");
                replace_region(r1, n, "ee");
                replace_region(r2, n, "ee");
            }
        } else {
            bool vowel_found = false;
            for (size_t i = 0; i + n < word.size(); i++)
                if (is_vowel(word[i])) { vowel_found = true; break; }
            if (vowel_found) {
                drop(word, n); drop(r1, n); drop(r2, n);
                if (ends_with(word, "at") || ends_with(word, "bl") ||
                    ends_with(word, "iz")) {
                    word.push_back('e');
                    r1.push_back('e');
                    if (word.size() > 5 || r1.size() >= 3) r2.push_back('e');
                } else if (is_double(word)) {
                    drop(word, 1); drop(r1, 1); drop(r2, 1);
                } else {
                    size_t m = word.size();
                    bool short_a = r1.empty() && m >= 3 &&
                                   !is_vowel(word[m - 1]) &&
                                   !in_set(word[m - 1], "wxY") &&
                                   is_vowel(word[m - 2]) &&
                                   !is_vowel(word[m - 3]);
                    bool short_b = r1.empty() && m == 2 && is_vowel(word[0]) &&
                                   !is_vowel(word[1]);
                    if (short_a || short_b) {
                        word.push_back('e');
                        if (!r1.empty()) r1.push_back('e');
                        if (!r2.empty()) r2.push_back('e');
                    }
                }
            }
        }
        break;
    }

    // STEP 1c
    if (word.size() > 2 && (word.back() == 'y' || word.back() == 'Y') &&
        !is_vowel(word[word.size() - 2])) {
        word.back() = 'i';
        if (!r1.empty()) r1.back() = 'i';
        if (!r2.empty()) r2.back() = 'i';
    }

    // STEP 2
    {
        static const char* sufs[] = {
            "ization", "ational", "fulness", "ousness", "iveness", "tional",
            "biliti", "lessli", "entli", "ation", "alism", "aliti", "ousli",
            "iviti", "fulli", "enci", "anci", "abli", "izer", "ator", "alli",
            "bli", "ogi", "li",
        };
        for (const char* suf : sufs) {
            if (!ends_with(word, suf)) continue;
            if (ends_with(r1, suf)) {
                size_t n = std::strlen(suf);
                std::string s = suf;
                if (s == "tional") {
                    drop(word, 2); drop(r1, 2); drop(r2, 2);
                } else if (s == "enci" || s == "anci" || s == "abli") {
                    word.back() = 'e';
                    if (!r1.empty()) r1.back() = 'e';
                    if (!r2.empty()) r2.back() = 'e';
                } else if (s == "entli") {
                    drop(word, 2); drop(r1, 2); drop(r2, 2);
                } else if (s == "izer" || s == "ization") {
                    replace_word(word, n, "ize");
                    replace_region(r1, n, "ize");
                    replace_region(r2, n, "ize");
                } else if (s == "ational" || s == "ation" || s == "ator") {
                    replace_word(word, n, "ate");
                    replace_region(r1, n, "ate");
                    replace_region(r2, n, "ate", /*fallback=*/"e");  // NLTK quirk
                } else if (s == "alism" || s == "aliti" || s == "alli") {
                    replace_word(word, n, "al");
                    replace_region(r1, n, "al");
                    replace_region(r2, n, "al");
                } else if (s == "fulness") {
                    drop(word, 4); drop(r1, 4); drop(r2, 4);
                } else if (s == "ousli" || s == "ousness") {
                    replace_word(word, n, "ous");
                    replace_region(r1, n, "ous");
                    replace_region(r2, n, "ous");
                } else if (s == "iveness" || s == "iviti") {
                    replace_word(word, n, "ive");
                    replace_region(r1, n, "ive");
                    replace_region(r2, n, "ive", /*fallback=*/"e");  // NLTK quirk
                } else if (s == "biliti" || s == "bli") {
                    replace_word(word, n, "ble");
                    replace_region(r1, n, "ble");
                    replace_region(r2, n, "ble");
                } else if (s == "ogi") {
                    if (word.size() >= 4 && word[word.size() - 4] == 'l') {
                        drop(word, 1); drop(r1, 1); drop(r2, 1);
                    }
                } else if (s == "fulli" || s == "lessli") {
                    drop(word, 2); drop(r1, 2); drop(r2, 2);
                } else if (s == "li") {
                    if (word.size() >= 3 &&
                        in_set(word[word.size() - 3], "cdeghkmnrt")) {
                        drop(word, 2); drop(r1, 2); drop(r2, 2);
                    }
                }
            }
            break;
        }
    }

    // STEP 3
    {
        static const char* sufs[] = {
            "ational", "tional", "alize", "icate", "iciti",
            "ative", "ical", "ness", "ful",
        };
        for (const char* suf : sufs) {
            if (!ends_with(word, suf)) continue;
            if (ends_with(r1, suf)) {
                size_t n = std::strlen(suf);
                std::string s = suf;
                if (s == "tional") {
                    drop(word, 2); drop(r1, 2); drop(r2, 2);
                } else if (s == "ational") {
                    replace_word(word, n, "ate");
                    replace_region(r1, n, "ate");
                    replace_region(r2, n, "ate");
                } else if (s == "alize") {
                    drop(word, 3); drop(r1, 3); drop(r2, 3);
                } else if (s == "icate" || s == "iciti" || s == "ical") {
                    replace_word(word, n, "ic");
                    replace_region(r1, n, "ic");
                    replace_region(r2, n, "ic");
                } else if (s == "ful" || s == "ness") {
                    drop(word, n); drop(r1, n); drop(r2, n);
                } else if (s == "ative") {
                    if (ends_with(r2, suf)) {
                        drop(word, 5); drop(r1, 5); drop(r2, 5);
                    }
                }
            }
            break;
        }
    }

    // STEP 4
    {
        static const char* sufs[] = {
            "ement", "ance", "ence", "able", "ible", "ment", "ant", "ent",
            "ism", "ate", "iti", "ous", "ive", "ize", "ion", "al", "er", "ic",
        };
        for (const char* suf : sufs) {
            if (!ends_with(word, suf)) continue;
            if (ends_with(r2, suf)) {
                size_t n = std::strlen(suf);
                if (0 == std::strcmp(suf, "ion")) {
                    if (word.size() >= 4 && in_set(word[word.size() - 4], "st")) {
                        drop(word, 3); drop(r1, 3); drop(r2, 3);
                    }
                } else {
                    drop(word, n); drop(r1, n); drop(r2, n);
                }
            }
            break;
        }
    }

    // STEP 5
    if (ends_with(r2, "l") && word.size() >= 2 && word[word.size() - 2] == 'l') {
        drop(word, 1);
    } else if (ends_with(r2, "e")) {
        drop(word, 1);
    } else if (ends_with(r1, "e")) {
        size_t m = word.size();
        if (m >= 4 && (is_vowel(word[m - 2]) || in_set(word[m - 2], "wxY") ||
                       !is_vowel(word[m - 3]) || is_vowel(word[m - 4]))) {
            drop(word, 1);
        }
    }

    for (auto& c : word)
        if (c == 'Y') c = 'y';
    return word;
}

template std::string stem_english<std::string>(const std::string&);
template std::u32string stem_english<std::u32string>(const std::u32string&);

}  // namespace bm25
