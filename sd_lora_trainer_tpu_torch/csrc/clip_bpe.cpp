// Native CLIP byte-level BPE tokenizer.
//
// The per-step host work in the training loop is caption tokenization
// (captions are re-tokenized every step because of caption dropout); this
// C++ implementation removes that from the Python hot path. Semantics match
// the Python tokenizer (models/tokenizer.py) exactly for ASCII text (parity
// tested); the Python implementation is the fallback where no C++ compiler
// exists and the reference for full-unicode behavior. A copy of the JAX
// package's clip_bpe.cpp; built by models/tokenizer_native.py.
//
// C API (ctypes):
//   void* clip_bpe_create(const char* vocab_tsv, const char* merges_txt,
//                         int max_length, long pad_token_id /* -1 = eos */);
//   void  clip_bpe_add_special(void* h, const char* token);
//   int   clip_bpe_encode(void* h, const char* text, long* out_ids,
//                         int pad_to_max /* 0: bos..eos only, 1: pad to 77 */);
//   void  clip_bpe_destroy(void* h);
//
// vocab_tsv: lines of "token\tid"; merges_txt: lines of "first second".

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <map>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// GPT-2/CLIP byte -> printable-unicode table (UTF-8 encoded strings).
static std::vector<std::string> byte_to_unicode_table() {
  std::vector<int> bs;
  for (int b = int('!'); b <= int('~'); ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  std::vector<int> cs(bs);
  int n = 0;
  std::vector<bool> present(256, false);
  for (int b : bs) present[b] = true;
  for (int b = 0; b < 256; ++b) {
    if (!present[b]) {
      bs.push_back(b);
      cs.push_back(256 + n);
      ++n;
    }
  }
  std::vector<std::string> table(256);
  auto utf8 = [](int cp) {
    std::string out;
    if (cp < 0x80) {
      out.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
      out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
    return out;
  };
  for (size_t i = 0; i < bs.size(); ++i) table[bs[i]] = utf8(cs[i]);
  return table;
}

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    return std::hash<std::string>()(p.first) * 31 ^ std::hash<std::string>()(p.second);
  }
};

struct Tokenizer {
  std::unordered_map<std::string, long> encoder;
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
  std::unordered_map<std::string, std::vector<std::string>> cache;
  std::vector<std::string> byte_enc = byte_to_unicode_table();
  std::vector<std::pair<std::string, long>> added;  // insertion order
  long bos = 0, eos = 0, pad = 0;
  int max_length = 77;

  std::vector<std::string> bpe(const std::string& token) {
    auto it = cache.find(token);
    if (it != cache.end()) return it->second;

    // split into unicode characters (the token is valid UTF-8 by construction)
    std::vector<std::string> word;
    for (size_t i = 0; i < token.size();) {
      unsigned char c = token[i];
      size_t len = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
      word.push_back(token.substr(i, len));
      i += len;
    }
    if (word.empty()) return {};
    word.back() += "</w>";

    while (word.size() > 1) {
      int best_rank = INT32_MAX;
      size_t best_i = 0;
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        auto r = ranks.find({word[i], word[i + 1]});
        if (r != ranks.end() && r->second < best_rank) {
          best_rank = r->second;
          best_i = i;
        }
      }
      if (best_rank == INT32_MAX) break;
      // merge ALL occurrences of this bigram (left to right), as python does
      const std::string first = word[best_i], second = word[best_i + 1];
      std::vector<std::string> merged;
      for (size_t i = 0; i < word.size();) {
        if (i + 1 < word.size() && word[i] == first && word[i + 1] == second) {
          merged.push_back(first + second);
          i += 2;
        } else {
          merged.push_back(word[i]);
          i += 1;
        }
      }
      word = std::move(merged);
    }
    cache[token] = word;
    return word;
  }

  static bool is_letter(unsigned char c) { return std::isalpha(c) || c >= 0x80; }
  static bool is_digit(unsigned char c) { return std::isdigit(c) != 0; }
  static bool is_space(unsigned char c) { return std::isspace(c) != 0; }

  // CLIP word pattern for ASCII+UTF8 text: contractions | letters+ | digit |
  // punctuation-run (mirrors the python regex in models/tokenizer.py)
  std::vector<std::string> split_words(const std::string& text) {
    std::vector<std::string> out;
    size_t i = 0;
    const size_t n = text.size();
    static const char* contractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
    while (i < n) {
      unsigned char c = text[i];
      if (is_space(c)) {
        ++i;
        continue;
      }
      if (c == '\'') {
        bool matched = false;
        for (const char* con : contractions) {
          size_t len = std::strlen(con);
          if (text.compare(i, len, con) == 0) {
            // python regex is case-insensitive but text is lowercased already
            out.push_back(text.substr(i, len));
            i += len;
            matched = true;
            break;
          }
        }
        if (matched) continue;
      }
      if (is_letter(c) && !is_digit(c)) {
        size_t j = i;
        while (j < n && is_letter(text[j]) && !is_digit(text[j])) ++j;
        out.push_back(text.substr(i, j - i));
        i = j;
        continue;
      }
      if (is_digit(c)) {  // single digit per token, like \d in the python pattern
        out.push_back(text.substr(i, 1));
        ++i;
        continue;
      }
      // punctuation run: not space, not letter, not digit (underscore included)
      size_t j = i;
      while (j < n && !is_space(text[j]) &&
             !(is_letter(text[j]) && !is_digit(text[j])) && !is_digit(text[j]))
        ++j;
      out.push_back(text.substr(i, j - i));
      i = j;
    }
    return out;
  }

  void encode_segment(const std::string& seg, std::vector<long>* ids) {
    for (const std::string& w : split_words(seg)) {
      std::string mapped;
      for (unsigned char ch : w) mapped += byte_enc[ch];
      for (const std::string& piece : bpe(mapped)) {
        auto it = encoder.find(piece);
        ids->push_back(it != encoder.end() ? it->second : eos);
      }
    }
  }

  std::vector<long> encode(const std::string& raw) {
    // whitespace clean + lowercase
    std::string text;
    bool in_space = false;
    for (unsigned char c : raw) {
      if (is_space(c)) {
        in_space = !text.empty();
        continue;
      }
      if (in_space) text.push_back(' ');
      in_space = false;
      text.push_back(std::tolower(c));
    }

    std::vector<long> ids{bos};
    // split on added special tokens first (leftmost-first, insertion order
    // priority like the python re alternation)
    size_t pos = 0;
    while (pos < text.size()) {
      size_t best_at = std::string::npos;
      const std::pair<std::string, long>* best_tok = nullptr;
      for (const auto& tok : added) {
        size_t at = text.find(tok.first, pos);
        if (at != std::string::npos && (best_at == std::string::npos || at < best_at)) {
          best_at = at;
          best_tok = &tok;
        }
      }
      if (best_tok == nullptr) {
        encode_segment(text.substr(pos), &ids);
        break;
      }
      if (best_at > pos) encode_segment(text.substr(pos, best_at - pos), &ids);
      ids.push_back(best_tok->second);
      pos = best_at + best_tok->first.size();
    }

    if (static_cast<int>(ids.size()) > max_length - 1)
      ids.resize(max_length - 1);
    ids.push_back(eos);
    return ids;
  }
};

}  // namespace

extern "C" {

void* clip_bpe_create(const char* vocab_tsv, const char* merges_txt, int max_length,
                      long pad_token_id) {
  auto* t = new Tokenizer();
  t->max_length = max_length;
  std::istringstream vs(vocab_tsv);
  std::string line;
  while (std::getline(vs, line)) {
    if (line.empty()) continue;
    size_t tab = line.rfind('\t');
    if (tab == std::string::npos) continue;
    t->encoder[line.substr(0, tab)] = std::stol(line.substr(tab + 1));
  }
  std::istringstream ms(merges_txt);
  int rank = 0;
  while (std::getline(ms, line)) {
    if (line.empty() || line[0] == '#') continue;
    size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    t->ranks[{line.substr(0, sp), line.substr(sp + 1)}] = rank++;
  }
  t->bos = t->encoder.at("<|startoftext|>");
  t->eos = t->encoder.at("<|endoftext|>");
  t->pad = pad_token_id >= 0 ? pad_token_id : t->eos;
  return t;
}

void clip_bpe_add_special(void* h, const char* token) {
  auto* t = static_cast<Tokenizer*>(h);
  std::string tok(token);
  for (const auto& existing : t->added)
    if (existing.first == tok) return;
  long next_id = static_cast<long>(t->encoder.size()) + static_cast<long>(t->added.size());
  t->added.emplace_back(tok, next_id);
}

int clip_bpe_encode(void* h, const char* text, long* out_ids, int pad_to_max) {
  auto* t = static_cast<Tokenizer*>(h);
  std::vector<long> ids = t->encode(text);
  int n = static_cast<int>(ids.size());
  std::memcpy(out_ids, ids.data(), n * sizeof(long));
  if (pad_to_max) {
    for (int i = n; i < t->max_length; ++i) out_ids[i] = t->pad;
    return t->max_length;
  }
  return n;
}

void clip_bpe_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

}  // extern "C"
