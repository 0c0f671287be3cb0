// CLIP BPE tokenizer: native core of the port's prompts/tokenizer_native.py.
//
// A copy of the JAX package's native/cpd_tokenizer.cpp (the port keeps its
// own, built by the host C++ compiler into the package's build/ directory).
// Every prompt-algebra factor (weighted sub-prompts, AND/NOT factors,
// scheduled prompt variants: one tokenization per boundary step) goes
// through BPE on the host before its CLIP call; this is a from-scratch C++
// implementation exposed through a C ABI and loaded with ctypes.
//
// Vocab is passed pre-parsed from Python as flat buffers (tokens in id
// order, merges as "a b" lines) — no JSON parsing in C++.
//
// Text splitting implements the CLIP pattern
//   <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|\p{L}+|\p{N}|[^\s\p{L}\p{N}]+
// with \p{L}/\p{N} approximated as: ASCII letters/digits exactly; any
// non-ASCII UTF-8 sequence is treated as a letter (correct for the common
// prompt languages; byte-fallback keeps every input encodable).

#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 31 + h(p.second);
  }
};

// byte -> printable-unicode map (GPT-2/CLIP convention), as UTF-8 strings
std::vector<std::string> ByteEncoder() {
  std::vector<int> bs;
  for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
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
  for (size_t i = 0; i < bs.size(); ++i) {
    int cp = cs[i];
    std::string utf8;
    if (cp < 0x80) {
      utf8 += static_cast<char>(cp);
    } else if (cp < 0x800) {
      utf8 += static_cast<char>(0xC0 | (cp >> 6));
      utf8 += static_cast<char>(0x80 | (cp & 0x3F));
    } else {
      utf8 += static_cast<char>(0xE0 | (cp >> 12));
      utf8 += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      utf8 += static_cast<char>(0x80 | (cp & 0x3F));
    }
    table[bs[i]] = utf8;
  }
  return table;
}

struct Tokenizer {
  std::unordered_map<std::string, int> encoder;
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
  std::unordered_map<std::string, std::vector<int>> cache;
  std::vector<std::string> byte_enc = ByteEncoder();
  int bos_id = 0;
  int eos_id = 0;

  std::vector<int> BpeEncodeWord(const std::string& mapped) {
    auto it = cache.find(mapped);
    if (it != cache.end()) return it->second;

    // split mapped string into UTF-8 codepoint units; last gets </w>
    std::vector<std::string> word;
    for (size_t i = 0; i < mapped.size();) {
      unsigned char c = mapped[i];
      size_t len = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
      word.push_back(mapped.substr(i, len));
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
      // merge ALL occurrences of this bigram (left to right)
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
      word.swap(merged);
    }

    std::vector<int> ids;
    for (const auto& piece : word) {
      auto e = encoder.find(piece);
      if (e != encoder.end()) ids.push_back(e->second);
      // unknown pieces are silently dropped (cannot occur with a complete
      // byte-level vocab)
    }
    cache.emplace(mapped, ids);
    return ids;
  }

  std::vector<int> Encode(const std::string& text) {
    std::vector<int> out;
    const std::string lowered = Lower(Clean(text));
    size_t i = 0;
    const size_t n = lowered.size();
    while (i < n) {
      unsigned char c = lowered[i];
      if (std::isspace(c)) {
        ++i;
        continue;
      }
      std::string token;
      // contractions
      if (c == '\'' && i + 1 < n) {
        static const char* kContr[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};
        for (const char* cont : kContr) {
          size_t len = std::strlen(cont);
          if (lowered.compare(i, len, cont) == 0) {
            token = cont;
            break;
          }
        }
      }
      if (token.empty()) {
        if (std::isalpha(c) || c >= 0x80) {
          size_t j = i;
          while (j < n &&
                 (std::isalpha(static_cast<unsigned char>(lowered[j])) ||
                  static_cast<unsigned char>(lowered[j]) >= 0x80)) {
            ++j;
          }
          token = lowered.substr(i, j - i);
        } else if (std::isdigit(c)) {
          token = lowered.substr(i, 1);  // \p{N}: single digit
        } else {
          size_t j = i;
          while (j < n) {
            unsigned char cj = lowered[j];
            if (std::isspace(cj) || std::isalnum(cj) || cj >= 0x80) break;
            ++j;
          }
          token = lowered.substr(i, j - i);
        }
      }
      i += token.size();

      std::string mapped;
      for (unsigned char b : token) mapped += byte_enc[b];
      auto ids = BpeEncodeWord(mapped);
      out.insert(out.end(), ids.begin(), ids.end());
    }
    return out;
  }

  static std::string Clean(const std::string& s) {
    // collapse whitespace runs, trim
    std::string out;
    bool in_space = true;  // trims leading
    for (char ch : s) {
      if (std::isspace(static_cast<unsigned char>(ch))) {
        if (!in_space) out += ' ';
        in_space = true;
      } else {
        out += ch;
        in_space = false;
      }
    }
    while (!out.empty() && out.back() == ' ') out.pop_back();
    return out;
  }

  static std::string Lower(const std::string& s) {
    std::string out = s;
    for (auto& ch : out) ch = std::tolower(static_cast<unsigned char>(ch));
    return out;
  }
};

}  // namespace

extern "C" {

// vocab: '\n'-separated token strings, index = id.
// merges: '\n'-separated "first second" lines in rank order.
void* cpd_tok_create(const char* vocab, const char* merges) {
  auto* tok = new Tokenizer();
  {
    const char* p = vocab;
    int id = 0;
    while (*p) {
      const char* nl = std::strchr(p, '\n');
      size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
      tok->encoder.emplace(std::string(p, len), id++);
      if (!nl) break;
      p = nl + 1;
    }
  }
  {
    const char* p = merges;
    int rank = 0;
    while (*p) {
      const char* nl = std::strchr(p, '\n');
      size_t len = nl ? static_cast<size_t>(nl - p) : std::strlen(p);
      std::string line(p, len);
      size_t sp = line.find(' ');
      if (sp != std::string::npos) {
        tok->ranks.emplace(
            std::make_pair(line.substr(0, sp), line.substr(sp + 1)), rank++);
      }
      if (!nl) break;
      p = nl + 1;
    }
  }
  auto bos = tok->encoder.find("<|startoftext|>");
  auto eos = tok->encoder.find("<|endoftext|>");
  tok->bos_id = bos != tok->encoder.end() ? bos->second : 0;
  tok->eos_id = eos != tok->encoder.end() ? eos->second : 0;
  return tok;
}

// Encode into out_ids (caller-allocated, max_out capacity) WITHOUT
// bos/eos/padding (sequence assembly stays in Python, shared with the
// pure-Python tokenizer). Returns number of ids written.
int cpd_tok_encode(void* handle, const char* text, int* out_ids, int max_out) {
  auto* tok = static_cast<Tokenizer*>(handle);
  auto ids = tok->Encode(text);
  int n = static_cast<int>(ids.size());
  if (n > max_out) n = max_out;
  for (int i = 0; i < n; ++i) out_ids[i] = ids[i];
  return n;
}

int cpd_tok_bos(void* handle) { return static_cast<Tokenizer*>(handle)->bos_id; }
int cpd_tok_eos(void* handle) { return static_cast<Tokenizer*>(handle)->eos_id; }

void cpd_tok_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

}  // extern "C"
