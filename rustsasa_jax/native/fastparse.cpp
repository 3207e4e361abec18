// fastparse: native structure-file ingest for rustsasa_jax.
//
// Parses PDB (fixed-column) and mmCIF (_atom_site loop) coordinate records
// into struct-of-arrays buffers with interned string columns (codes are
// assigned in first-appearance order, matching the Python selection layer's
// factorization).  Exposed through a C ABI consumed via ctypes; calls
// release the GIL on the Python side so a thread pool scales across cores.
//
// This is the counterpart of the reference's reliance on the
// Rust pdbtbx parser (reference: Cargo.toml:19): the parsing work the
// reference spreads across rayon file-worker threads (main.rs:375) runs
// here as native code under Python threads.
//
// Build: g++ -O3 -march=native -shared -fPIC fastparse.cpp -o libfastparse.so -lz
#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <string>
#include <thread>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <zlib.h>

namespace {

constexpr int kStrWidth = 8;  // fixed-width interned strings (U8 on numpy side)

struct Interner {
  // Keys are the first 8 bytes NUL-padded packed into a uint64 - no string
  // allocation on the hot path.  A one-entry inline cache covers the
  // extremely repetitive columns (chain id, alt loc, residue name runs);
  // misses hit a small open-addressed flat table (intern vocabularies are
  // tens of entries, and std::unordered_map hashing was a measured ~25%
  // of whole-file parse time).
  std::vector<uint64_t> slot_keys = std::vector<uint64_t>(64);
  std::vector<int32_t> slot_codes = std::vector<int32_t>(64, -1);
  size_t mask = 63;
  size_t count = 0;
  std::string table;  // kStrWidth bytes per entry, NUL padded
  uint64_t last_key = ~0ull;
  int32_t last_code = -1;

  struct map_size_proxy {  // keeps FPResult wiring (`map.size()`) intact
    const Interner* self;
    size_t size() const { return self->count; }
  };
  map_size_proxy map{this};

  static uint64_t pack(std::string_view s) {
    char buf[kStrWidth] = {0};
    size_t n = s.size() < kStrWidth ? s.size() : kStrWidth;
    memcpy(buf, s.data(), n);
    uint64_t k;
    memcpy(&k, buf, 8);
    return k;
  }

  void grow() {
    size_t nmask = mask * 2 + 1;
    std::vector<uint64_t> nk(nmask + 1);
    std::vector<int32_t> nc(nmask + 1, -1);
    for (size_t i = 0; i <= mask; i++) {
      if (slot_codes[i] < 0) continue;
      size_t h = (slot_keys[i] * 0x9E3779B97F4A7C15ull) >> 32 & nmask;
      while (nc[h] >= 0) h = (h + 1) & nmask;
      nk[h] = slot_keys[i];
      nc[h] = slot_codes[i];
    }
    slot_keys.swap(nk);
    slot_codes.swap(nc);
    mask = nmask;
  }

  // Direct map for single-character fields (chain id, alt loc, icode):
  // one array read instead of hash+probe.  ' ' interns the empty string
  // (the trimmed value), matching intern(trim(field)) exactly.
  int16_t char_code[256];
  Interner() { for (int i = 0; i < 256; i++) char_code[i] = -1; }

  int32_t intern_char(char c) {
    int16_t cc = char_code[static_cast<uint8_t>(c)];
    if (cc >= 0) return cc;
    std::string_view sv(&c, (c == ' ' || c == '\t' || c == '\r') ? 0 : 1);
    int32_t code = intern(sv);
    char_code[static_cast<uint8_t>(c)] = static_cast<int16_t>(code);
    return code;
  }

  int32_t intern(std::string_view s) {
    uint64_t key = pack(s);
    if (key == last_key) return last_code;
    size_t h = (key * 0x9E3779B97F4A7C15ull) >> 32 & mask;
    while (slot_codes[h] >= 0 && slot_keys[h] != key) h = (h + 1) & mask;
    bool inserted = slot_codes[h] < 0;
    if (inserted) {
      if (count * 2 >= mask) {
        grow();
        return intern(s);
      }
      slot_keys[h] = key;
      slot_codes[h] = static_cast<int32_t>(count++);
      size_t off = table.size();
      table.resize(off + kStrWidth, '\0');
      size_t n = s.size() < kStrWidth ? s.size() : kStrWidth;
      memcpy(&table[off], s.data(), n);
    }
    last_key = key;
    last_code = slot_codes[h];
    return last_code;
  }
};

// Direct-mapped cache in front of an Interner keyed by the RAW 4-byte
// column window (before trimming).  Sound because the trimmed value -
// and therefore the interned code - is a pure function of the raw
// window; a hash collision only evicts, never mis-returns.  Interning
// measured 40% of PDB parse time (ablation, scripts history r4): the
// hit path replaces trim + 8-byte pack + table probe with one u32
// compare.
struct RawCache {
  uint32_t raw[128];
  int32_t code[128];
  RawCache() {
    for (int i = 0; i < 128; ++i) {
      raw[i] = 0xFFFFFFFFu;
      code[i] = -1;
    }
  }
};

struct Builder {
  std::vector<float> coords;
  std::vector<int64_t> serial;
  std::vector<int64_t> res_serial;
  std::vector<float> occupancy;
  std::vector<float> bfactor;
  std::vector<uint8_t> hetero;
  std::vector<int32_t> chain_code, resname_code, name_code, alt_code,
      icode_code, element_code;
  Interner chain_tab, resname_tab, name_tab, alt_tab, icode_tab, element_tab;
  RawCache name_raw, resname_raw;
  std::string error;
};

inline std::string_view trim(std::string_view s) {
  size_t b = 0, e = s.size();
  while (b < e && (s[b] == ' ' || s[b] == '\t' || s[b] == '\r')) ++b;
  while (e > b && (s[e - 1] == ' ' || s[e - 1] == '\t' || s[e - 1] == '\r')) --e;
  return s.substr(b, e - b);
}

// Intern the trimmed `width`-char field starting at p, cached by the raw
// 4 bytes at p (width <= 4; bytes beyond the field only widen the cache
// key, which stays consistent for identical windows).
inline int32_t intern_raw4(Interner& tab, RawCache& c, const char* p,
                           int width) {
  uint32_t k;
  memcpy(&k, p, 4);
  uint32_t h = (k * 2654435761u) >> 25;  // top 7 bits -> 128 slots
  if (c.raw[h] == k && c.code[h] >= 0) return c.code[h];
  int32_t code = tab.intern(trim(std::string_view(p, width)));
  c.raw[h] = k;
  c.code[h] = code;
  return code;
}

inline double parse_float(std::string_view s, double dflt) {
  // Fast path for the fixed decimal notation of PDB/mmCIF numeric fields
  // ([-]ddd.ddd); falls back to strtod for exponents/specials.
  s = trim(s);
  if (s.empty()) return dflt;
  const char* p = s.data();
  const char* end = p + s.size();
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') ++p;
  int64_t ip = 0;
  bool any = false, simple = true;
  while (p < end && *p >= '0' && *p <= '9') {
    ip = ip * 10 + (*p - '0');
    ++p;
    any = true;
  }
  double v = static_cast<double>(ip);
  if (p < end && *p == '.') {
    ++p;
    int64_t fp = 0, scale = 1;
    while (p < end && *p >= '0' && *p <= '9') {
      fp = fp * 10 + (*p - '0');
      scale *= 10;
      ++p;
      any = true;
    }
    v += static_cast<double>(fp) / static_cast<double>(scale);
  }
  if (p != end || !any) simple = false;
  if (simple) return neg ? -v : v;
  char buf[32];
  size_t n = s.size() < 31 ? s.size() : 31;
  memcpy(buf, s.data(), n);
  buf[n] = '\0';
  char* e2 = nullptr;
  double sv = strtod(buf, &e2);
  return e2 == buf ? dflt : sv;
}

inline int64_t parse_int(std::string_view s, int64_t dflt) {
  s = trim(s);
  if (s.empty()) return dflt;
  // Fast path: plain [-]digits (every PDB serial/resSeq).
  const char* p = s.data();
  const char* end = p + s.size();
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') ++p;
  int64_t v = 0;
  bool any = false;
  int digits = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
    any = true;
    ++digits;
  }
  // 19+ digits can wrap int64; let strtoll clamp with ERANGE semantics
  // (mmCIF integer fields are free-width, unlike PDB's 4-5 columns).
  if (p == end && any && digits <= 18) return neg ? -v : v;
  char buf[32];
  size_t n = s.size() < 31 ? s.size() : 31;
  memcpy(buf, s.data(), n);
  buf[n] = '\0';
  char* e2 = nullptr;
  long long sv = strtoll(buf, &e2, 10);
  return e2 == buf ? dflt : static_cast<int64_t>(sv);
}

inline std::string_view field(std::string_view line, size_t lo, size_t hi) {
  if (line.size() <= lo) return {};
  size_t end = hi < line.size() ? hi : line.size();
  return line.substr(lo, end - lo);
}

// Single-pass fixed-window numeric parsers for PDB's column format.
// Identical arithmetic to parse_float (integer part + fraction/scale in
// f64, then f32 cast) so results match the generic path bit-for-bit;
// anything unexpected falls back to it.  parse_float measured 52% of
// whole-file parse time (ablation, 50ns/call): the win here is one
// forward scan with no trim / string_view churn.
inline float parse_fixed_float(const char* s, int w, double dflt) {
  const char* p = s;
  const char* end = s + w;
  while (p < end && *p == ' ') ++p;
  if (p == end) return static_cast<float>(dflt);
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') ++p;
  int64_t ip = 0;
  bool any = false;
  while (p < end && static_cast<unsigned>(*p - '0') <= 9u) {
    ip = ip * 10 + (*p - '0');
    ++p;
    any = true;
  }
  double v = static_cast<double>(ip);
  if (p < end && *p == '.') {
    ++p;
    int64_t fp = 0, scale = 1;
    while (p < end && static_cast<unsigned>(*p - '0') <= 9u) {
      fp = fp * 10 + (*p - '0');
      scale *= 10;
      ++p;
      any = true;
    }
    v += static_cast<double>(fp) / static_cast<double>(scale);
  }
  while (p < end && (*p == ' ' || *p == '\r')) ++p;
  if (p == end && any) return static_cast<float>(neg ? -v : v);
  return static_cast<float>(parse_float(std::string_view(s, w), dflt));
}


// Hybrid-36 decode for PDB fixed-width serial/resSeq fields (cctbx
// convention; mirrors io/hybrid36.py + io/pdb.py _field_int: the token
// is stripped but decoded against the FIELD width, and must be pure
// base-36 starting with a letter).  Returns true on success.
inline bool parse_hybrid36(std::string_view s, int field_w, int64_t* out) {
  s = trim(s);
  if (s.empty()) return false;
  const char c0 = s.front();
  const bool upper0 = c0 >= 'A' && c0 <= 'Z';
  const bool lower0 = c0 >= 'a' && c0 <= 'z';
  if (!upper0 && !lower0) return false;
  int64_t v36 = 0;
  for (char c : s) {
    int dv;
    if (c >= '0' && c <= '9') dv = c - '0';
    else if (c >= 'A' && c <= 'Z') dv = c - 'A' + 10;
    else if (c >= 'a' && c <= 'z') dv = c - 'a' + 10;
    else return false;
    v36 = v36 * 36 + dv;
  }
  int64_t p36 = 1;
  for (int k = 1; k < field_w; ++k) p36 *= 36;
  int64_t p10 = 1;
  for (int k = 0; k < field_w; ++k) p10 *= 10;
  *out = v36 - 10 * p36 + p10 + (lower0 ? 26 * p36 : 0);
  return true;
}

// Int parse for PDB serial/resSeq: plain decimal first, hybrid-36 next
// (both paths identical to the Python parser's _field_int).
inline int64_t parse_int_pdb(std::string_view s, int field_w, int64_t dflt) {
  std::string_view t = trim(s);
  if (t.empty()) return dflt;
  const char* p = t.data();
  const char* end = p + t.size();
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') ++p;
  int64_t v = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
    any = true;
  }
  if (p == end && any) return neg ? -v : v;
  int64_t h;
  if (parse_hybrid36(t, field_w, &h)) return h;
  return parse_int(s, dflt);
}

// PDB coordinates are %8.3f: right-justified, ALWAYS 3 decimals, so the
// dot sits at index 4 of the 8-char window.  ip + fp/1000.0 is the exact
// arithmetic of the generic path (scale = 10^3), so results match
// bit-for-bit; any other layout falls back.
inline float parse_coord8(const char* s, double dflt) {
  if (s[4] != '.') return parse_fixed_float(s, 8, dflt);
  const char* p = s;
  const char* ipend = s + 4;
  while (p < ipend && *p == ' ') ++p;
  bool neg = false;
  if (p < ipend && *p == '-') { neg = true; ++p; }
  else if (p < ipend && *p == '+') ++p;
  int64_t ip = 0;
  while (p < ipend) {
    unsigned dg = static_cast<unsigned>(*p - '0');
    if (dg > 9u) return parse_fixed_float(s, 8, dflt);
    ip = ip * 10 + dg;
    ++p;
  }
  unsigned d0 = static_cast<unsigned>(s[5] - '0');
  unsigned d1 = static_cast<unsigned>(s[6] - '0');
  unsigned d2 = static_cast<unsigned>(s[7] - '0');
  if (d0 > 9u || d1 > 9u || d2 > 9u)
    return parse_fixed_float(s, 8, dflt);
  int64_t fp = (int64_t)d0 * 100 + d1 * 10 + d2;
  double v = static_cast<double>(ip) + static_cast<double>(fp) / 1000.0;
  return static_cast<float>(neg ? -v : v);
}

inline int64_t parse_fixed_int(const char* s, int w, int64_t dflt) {
  const char* p = s;
  const char* end = s + w;
  while (p < end && *p == ' ') ++p;
  if (p == end) return dflt;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  else if (*p == '+') ++p;
  int64_t v = 0;
  bool any = false;
  while (p < end && static_cast<unsigned>(*p - '0') <= 9u) {
    v = v * 10 + (*p - '0');
    ++p;
    any = true;
  }
  while (p < end && (*p == ' ' || *p == '\r')) ++p;
  if (p == end && any) return neg ? -v : v;
  return parse_int(std::string_view(s, w), dflt);
}

// Element inference from the raw 4-char PDB atom-name field (mirrors
// rustsasa_jax.io.structure.infer_element).
const char* kTwoLetter[] = {
    "HE", "LI", "BE", "NE", "NA", "MG", "AL", "SI", "CL", "AR", "CA", "SC",
    "TI", "CR", "MN", "FE", "CO", "NI", "CU", "ZN", "GA", "GE", "AS", "SE",
    "BR", "KR", "RB", "SR", "ZR", "NB", "MO", "TC", "RU", "RH", "PD", "AG",
    "CD", "IN", "SN", "SB", "TE", "XE", "CS", "BA", "HG", "PB", "BI"};

std::string infer_element(std::string_view raw4) {
  char f[4] = {' ', ' ', ' ', ' '};
  for (size_t i = 0; i < raw4.size() && i < 4; ++i) f[i] = raw4[i];
  auto upper = [](char c) {
    return (c >= 'a' && c <= 'z') ? static_cast<char>(c - 32) : c;
  };
  if (f[0] == ' ' || (f[0] >= '0' && f[0] <= '9')) {
    for (int i = 0; i < 4; ++i) {
      char c = f[i];
      if (c != ' ' && !(c >= '0' && c <= '9')) return {upper(c)};
    }
    return {};
  }
  char two[3] = {upper(f[0]), upper(f[1]), '\0'};
  for (const char* e : kTwoLetter)
    if (two[0] == e[0] && two[1] == e[1]) return two;
  for (int i = 0; i < 4; ++i)
    if (f[i] != ' ') return {upper(f[i])};
  return {};
}

void parse_pdb_line(Builder& b, std::string_view line, bool hetero,
                    bool lean) {
  const char* d = line.data();
  bool fixed = line.size() >= 54;
  if (fixed) {
    int64_t sv = parse_fixed_int(d + 6, 5, INT64_MIN);
    b.serial.push_back(
        sv != INT64_MIN ? sv : parse_int_pdb(field(line, 6, 11), 5, 0));
  } else {
    b.serial.push_back(parse_int_pdb(field(line, 6, 11), 5, 0));
  }
  std::string_view raw_name = field(line, 12, 16);
  if (fixed) {
    b.name_code.push_back(
        intern_raw4(b.name_tab, b.name_raw, d + 12, 4));
    b.alt_code.push_back(b.alt_tab.intern_char(d[16]));
    b.resname_code.push_back(
        intern_raw4(b.resname_tab, b.resname_raw, d + 17, 3));
    // Column 21 is blank in conforming files; when set AND the spec's
    // chain column 22 is non-blank, it is the first character of a
    // two-char chain id (cctbx convention, matching parse_pdb).  A
    // spill into column 21 with a BLANK chain column (CHARMM-style
    // 4-char resnames, chain-less) must not fabricate a chain.
    if (d[20] == ' ' || d[21] == ' ') {
      b.chain_code.push_back(b.chain_tab.intern_char(d[21]));
    } else {
      b.chain_code.push_back(b.chain_tab.intern(trim(field(line, 20, 22))));
    }
    {
      int64_t rv = parse_fixed_int(d + 22, 4, INT64_MIN);
      b.res_serial.push_back(
          rv != INT64_MIN ? rv : parse_int_pdb(field(line, 22, 26), 4, 0));
    }
    b.icode_code.push_back(b.icode_tab.intern_char(d[26]));
  } else {
    b.name_code.push_back(b.name_tab.intern(trim(raw_name)));
    b.alt_code.push_back(b.alt_tab.intern(trim(field(line, 16, 17))));
    b.resname_code.push_back(b.resname_tab.intern(trim(field(line, 17, 20))));
    {
      std::string_view c22 = trim(field(line, 21, 22));
      b.chain_code.push_back(b.chain_tab.intern(
          c22.empty() ? c22 : trim(field(line, 20, 22))));
    }
    b.res_serial.push_back(parse_int_pdb(field(line, 22, 26), 4, 0));
    b.icode_code.push_back(b.icode_tab.intern(trim(field(line, 26, 27))));
  }
  if (fixed) {
    b.coords.push_back(parse_coord8(d + 30, 0));
    b.coords.push_back(parse_coord8(d + 38, 0));
    b.coords.push_back(parse_coord8(d + 46, 0));
  } else {
    b.coords.push_back(static_cast<float>(parse_float(field(line, 30, 38), 0)));
    b.coords.push_back(static_cast<float>(parse_float(field(line, 38, 46), 0)));
    b.coords.push_back(static_cast<float>(parse_float(field(line, 46, 54), 0)));
  }
  if (lean) {
    // Batch fast path: occupancy/b-factor are never read downstream
    // (json/xml outputs, occupancy-radii off) - skip two float parses.
    b.occupancy.push_back(1.0f);
    b.bfactor.push_back(0.0f);
  } else {
    if (line.size() >= 60) {
      b.occupancy.push_back(parse_fixed_float(d + 54, 6, 1.0));
    } else {
      b.occupancy.push_back(
          static_cast<float>(parse_float(field(line, 54, 60), 1.0)));
    }
    if (line.size() >= 66) {
      b.bfactor.push_back(parse_fixed_float(d + 60, 6, 0));
    } else {
      b.bfactor.push_back(
          static_cast<float>(parse_float(field(line, 60, 66), 0)));
    }
  }
  // Element: stack buffer, no per-line heap allocation.
  char ebuf[4];
  int elen = 0;
  std::string_view etrim = trim(field(line, 76, 78));
  for (size_t i = 0; i < etrim.size() && elen < 4; ++i) {
    char c = etrim[i];
    ebuf[elen++] = (c >= 'a' && c <= 'z') ? static_cast<char>(c - 32) : c;
  }
  if (elen == 0) {
    std::string inf = infer_element(raw_name);
    for (size_t i = 0; i < inf.size() && elen < 4; ++i) ebuf[elen++] = inf[i];
  }
  b.element_code.push_back(
      b.element_tab.intern(std::string_view(ebuf, elen)));
  b.hetero.push_back(hetero ? 1 : 0);
}

void parse_pdb(Builder& b, std::string_view text, bool lean = false) {
  // Reserve by line-count estimate: reallocation churn on 12 parallel
  // vectors was a measurable slice of parse time.
  size_t est = text.size() / 75 + 8;
  b.coords.reserve(3 * est);
  b.serial.reserve(est);
  b.res_serial.reserve(est);
  b.occupancy.reserve(est);
  b.bfactor.reserve(est);
  b.hetero.reserve(est);
  b.chain_code.reserve(est);
  b.resname_code.reserve(est);
  b.name_code.reserve(est);
  b.alt_code.reserve(est);
  b.icode_code.reserve(est);
  b.element_code.reserve(est);
  size_t pos = 0;
  while (pos < text.size()) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string_view::npos) eol = text.size();
    std::string_view line = text.substr(pos, eol - pos);
    pos = eol + 1;
    if (line.size() >= 4 && memcmp(line.data(), "ATOM", 4) == 0) {
      parse_pdb_line(b, line, false, lean);
    } else if (line.size() >= 6 && memcmp(line.data(), "HETATM", 6) == 0) {
      parse_pdb_line(b, line, true, lean);
    } else if (line.size() >= 6 && memcmp(line.data(), "ENDMDL", 6) == 0) {
      break;  // first model only
    }
  }
}

// ---- mmCIF ----

struct CifCols {
  int group = -1, id = -1, type_symbol = -1, label_atom_id = -1,
      auth_atom_id = -1, label_alt_id = -1, label_comp_id = -1,
      auth_comp_id = -1, label_asym_id = -1, auth_asym_id = -1,
      label_seq_id = -1, auth_seq_id = -1, ins_code = -1, x = -1, y = -1,
      z = -1, occ = -1, biso = -1, model = -1;
  int n = 0;
};

inline std::string_view cif_clean(std::string_view s) {
  s = trim(s);
  if (s == "." || s == "?") return {};
  if (s.size() >= 2 && (s.front() == '\'' || s.front() == '"') &&
      s.back() == s.front())
    return s.substr(1, s.size() - 2);
  return s;
}

void parse_cif(Builder& b, std::string_view text) {
  size_t pos = 0;
  CifCols cols;
  bool in_tags = false, in_data = false;
  std::vector<std::string_view> toks;
  std::string first_model;
  while (pos < text.size()) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string_view::npos) eol = text.size();
    std::string_view line = text.substr(pos, eol - pos);
    pos = eol + 1;
    std::string_view t = trim(line);
    if (!in_data) {
      if (!in_tags) {
        if (t.size() > 11 && memcmp(t.data(), "_atom_site.", 11) == 0) {
          in_tags = true;
          cols = CifCols();
        } else {
          continue;
        }
      }
      if (t.size() > 11 && memcmp(t.data(), "_atom_site.", 11) == 0) {
        std::string_view key = t.substr(11);
        size_t sp = key.find_first_of(" \t");
        if (sp != std::string_view::npos) key = key.substr(0, sp);
        int idx = cols.n++;
        if (key == "group_PDB") cols.group = idx;
        else if (key == "id") cols.id = idx;
        else if (key == "type_symbol") cols.type_symbol = idx;
        else if (key == "label_atom_id") cols.label_atom_id = idx;
        else if (key == "auth_atom_id") cols.auth_atom_id = idx;
        else if (key == "label_alt_id") cols.label_alt_id = idx;
        else if (key == "label_comp_id") cols.label_comp_id = idx;
        else if (key == "auth_comp_id") cols.auth_comp_id = idx;
        else if (key == "label_asym_id") cols.label_asym_id = idx;
        else if (key == "auth_asym_id") cols.auth_asym_id = idx;
        else if (key == "label_seq_id") cols.label_seq_id = idx;
        else if (key == "auth_seq_id") cols.auth_seq_id = idx;
        else if (key == "pdbx_PDB_ins_code") cols.ins_code = idx;
        else if (key == "Cartn_x") cols.x = idx;
        else if (key == "Cartn_y") cols.y = idx;
        else if (key == "Cartn_z") cols.z = idx;
        else if (key == "occupancy") cols.occ = idx;
        else if (key == "B_iso_or_equiv") cols.biso = idx;
        else if (key == "pdbx_PDB_model_num") cols.model = idx;
        continue;
      }
      // First non-tag line after tags -> data begins (fall through).
      in_data = true;
    }
    if (t.empty() || t[0] == '#' || t[0] == '_' ||
        (t.size() >= 5 && memcmp(t.data(), "loop_", 5) == 0) ||
        (t.size() >= 5 && memcmp(t.data(), "data_", 5) == 0))
      break;

    // Tokenize (handles simple quoted tokens).
    toks.clear();
    size_t i = 0;
    while (i < t.size()) {
      while (i < t.size() && (t[i] == ' ' || t[i] == '\t')) ++i;
      if (i >= t.size()) break;
      if (t[i] == '\'' || t[i] == '"') {
        char q = t[i];
        size_t j = t.find(q, i + 1);
        if (j == std::string_view::npos) j = t.size();
        toks.push_back(t.substr(i, j + 1 - i));
        i = j + 1;
      } else {
        size_t j = i;
        while (j < t.size() && t[j] != ' ' && t[j] != '\t') ++j;
        toks.push_back(t.substr(i, j - i));
        i = j;
      }
    }
    if (static_cast<int>(toks.size()) != cols.n) continue;  // ragged row

    auto get = [&](int idx) -> std::string_view {
      return idx >= 0 ? cif_clean(toks[idx]) : std::string_view{};
    };
    if (cols.model >= 0) {
      std::string_view m = get(cols.model);
      if (first_model.empty()) first_model = std::string(m);
      else if (m != first_model) break;  // first model only
    }
    std::string_view grp = get(cols.group);
    b.hetero.push_back(grp == "HETATM" ? 1 : 0);
    b.serial.push_back(cols.id >= 0 ? parse_int(get(cols.id), 0)
                                    : static_cast<int64_t>(b.serial.size()));
    std::string_view nm =
        cols.auth_atom_id >= 0 ? get(cols.auth_atom_id) : get(cols.label_atom_id);
    b.name_code.push_back(b.name_tab.intern(nm));
    b.alt_code.push_back(b.alt_tab.intern(get(cols.label_alt_id)));
    std::string_view comp =
        cols.auth_comp_id >= 0 ? get(cols.auth_comp_id) : get(cols.label_comp_id);
    b.resname_code.push_back(b.resname_tab.intern(comp));
    std::string_view asym =
        cols.auth_asym_id >= 0 ? get(cols.auth_asym_id) : get(cols.label_asym_id);
    b.chain_code.push_back(b.chain_tab.intern(asym));
    std::string_view seq =
        cols.auth_seq_id >= 0 ? get(cols.auth_seq_id) : get(cols.label_seq_id);
    b.res_serial.push_back(parse_int(seq, 0));
    b.icode_code.push_back(b.icode_tab.intern(get(cols.ins_code)));
    b.coords.push_back(static_cast<float>(parse_float(get(cols.x), 0)));
    b.coords.push_back(static_cast<float>(parse_float(get(cols.y), 0)));
    b.coords.push_back(static_cast<float>(parse_float(get(cols.z), 0)));
    b.occupancy.push_back(static_cast<float>(parse_float(get(cols.occ), 1.0)));
    b.bfactor.push_back(static_cast<float>(parse_float(get(cols.biso), 0)));
    std::string elem(get(cols.type_symbol));
    for (auto& c : elem) c = (c >= 'a' && c <= 'z') ? c - 32 : c;
    if (elem.empty() && !nm.empty()) {
      std::string padded = nm.size() < 4 ? " " + std::string(nm) : std::string(nm);
      elem = infer_element(padded);
    }
    b.element_code.push_back(b.element_tab.intern(elem));
  }
}

bool read_file(const char* path, std::string& out, std::string& err) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    err = "failed to open file";
    return false;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(size));
  size_t got = size ? fread(&out[0], 1, static_cast<size_t>(size), f) : 0;
  fclose(f);
  if (got != static_cast<size_t>(size)) {
    err = "short read";
    return false;
  }
  // gzip?
  if (out.size() >= 2 && static_cast<uint8_t>(out[0]) == 0x1f &&
      static_cast<uint8_t>(out[1]) == 0x8b) {
    std::string inflated;
    inflated.resize(out.size() * 6 + (1 << 16));
    z_stream zs{};
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) {
      err = "inflateInit failed";
      return false;
    }
    zs.next_in = reinterpret_cast<Bytef*>(&out[0]);
    zs.avail_in = static_cast<uInt>(out.size());
    size_t written = 0;
    int rc = Z_OK;
    while (rc != Z_STREAM_END) {
      if (written == inflated.size()) inflated.resize(inflated.size() * 2);
      zs.next_out = reinterpret_cast<Bytef*>(&inflated[written]);
      zs.avail_out = static_cast<uInt>(inflated.size() - written);
      rc = inflate(&zs, Z_NO_FLUSH);
      written = inflated.size() - zs.avail_out;
      if (rc != Z_OK && rc != Z_STREAM_END) {
        inflateEnd(&zs);
        err = "gzip inflate failed";
        return false;
      }
    }
    inflateEnd(&zs);
    inflated.resize(written);
    out.swap(inflated);
  }
  return true;
}

bool looks_like_cif(const char* path, std::string_view text) {
  std::string_view p(path);
  auto ends_with = [&](std::string_view s, std::string_view suf) {
    return s.size() >= suf.size() &&
           s.compare(s.size() - suf.size(), suf.size(), suf) == 0;
  };
  std::string_view base = p;
  if (ends_with(base, ".gz")) base = base.substr(0, base.size() - 3);
  if (ends_with(base, ".cif") || ends_with(base, ".mmcif")) return true;
  if (ends_with(base, ".pdb") || ends_with(base, ".ent") ||
      ends_with(base, ".pdb1"))
    return false;
  std::string_view head = text.substr(0, text.size() < 4096 ? text.size() : 4096);
  return head.find("data_") != std::string_view::npos ||
         text.substr(0, text.size() < 65536 ? text.size() : 65536)
                 .find("_atom_site.") != std::string_view::npos;
}

}  // namespace

extern "C" {

struct FPResult {
  int64_t n;
  float* coords;
  int64_t* serial;
  int64_t* res_serial;
  float* occupancy;
  float* bfactor;
  uint8_t* hetero;
  int32_t* chain_code;
  int32_t* resname_code;
  int32_t* name_code;
  int32_t* alt_code;
  int32_t* icode_code;
  int32_t* element_code;
  char* chain_tab;
  int32_t n_chain;
  char* resname_tab;
  int32_t n_resname;
  char* name_tab;
  int32_t n_name;
  char* alt_tab;
  int32_t n_alt;
  char* icode_tab;
  int32_t n_icode;
  char* element_tab;
  int32_t n_element;
  int32_t is_cif;
  char error[256];
  Builder* owner;  // opaque, for free
};

static FPResult* fastparse_file_impl(const char* path, bool lean) {
  auto* b = new Builder();
  auto* r = new FPResult();
  memset(r->error, 0, sizeof(r->error));
  r->owner = b;
  std::string text, err;
  if (!read_file(path, text, err)) {
    snprintf(r->error, sizeof(r->error), "%s: %s", err.c_str(), path);
    return r;
  }
  bool is_cif = looks_like_cif(path, text);
  r->is_cif = is_cif ? 1 : 0;
  if (is_cif) parse_cif(*b, text);
  else parse_pdb(*b, text, lean);

  r->n = static_cast<int64_t>(b->serial.size());
  r->coords = b->coords.data();
  r->serial = b->serial.data();
  r->res_serial = b->res_serial.data();
  r->occupancy = b->occupancy.data();
  r->bfactor = b->bfactor.data();
  r->hetero = b->hetero.data();
  r->chain_code = b->chain_code.data();
  r->resname_code = b->resname_code.data();
  r->name_code = b->name_code.data();
  r->alt_code = b->alt_code.data();
  r->icode_code = b->icode_code.data();
  r->element_code = b->element_code.data();
  r->chain_tab = b->chain_tab.table.data();
  r->n_chain = static_cast<int32_t>(b->chain_tab.map.size());
  r->resname_tab = b->resname_tab.table.data();
  r->n_resname = static_cast<int32_t>(b->resname_tab.map.size());
  r->name_tab = b->name_tab.table.data();
  r->n_name = static_cast<int32_t>(b->name_tab.map.size());
  r->alt_tab = b->alt_tab.table.data();
  r->n_alt = static_cast<int32_t>(b->alt_tab.map.size());
  r->icode_tab = b->icode_tab.table.data();
  r->n_icode = static_cast<int32_t>(b->icode_tab.map.size());
  r->element_tab = b->element_tab.table.data();
  r->n_element = static_cast<int32_t>(b->element_tab.map.size());
  return r;
}

FPResult* fastparse_file(const char* path) {
  return fastparse_file_impl(path, false);
}

// Batch fast path: PDB occupancy/b-factor parsing skipped (defaults
// stored).  Only valid when the caller never reads those columns
// (json/xml outputs with occupancy-radii off); mmCIF parses fully.
FPResult* fastparse_file_lean(const char* path) {
  return fastparse_file_impl(path, true);
}

void fastparse_free(FPResult* r) {
  if (!r) return;
  delete r->owner;
  delete r;
}

}  // extern "C"

// ===========================================================================
// fastpipe: native selection + aggregation + serialization.
//
// The accelerator-native counterpart of the reference's per-level atom building and
// result serialization (reference: src/options.rs:139-464, src/utils/io.rs).
// On a host with few cores the Python/numpy versions of these stages become
// the pipeline bottleneck; these run under Python threads with the GIL
// released.  Semantics mirror rustsasa_jax.levels.build_selection /
// io.serialize exactly (the Python implementations remain as the fallback
// and as the executable specification).
// ===========================================================================

namespace {

struct RadiiGlobal {
  std::unordered_map<std::string, float> pair;  // "RES\tATOM" -> radius
  std::unordered_map<std::string, float> vdw;   // "EL" -> radius
  bool loaded = false;
};
RadiiGlobal g_radii;

inline std::string_view tab_entry(const char* tab, int32_t code) {
  const char* p = tab + static_cast<size_t>(code) * kStrWidth;
  size_t len = 0;
  while (len < kStrWidth && p[len] != '\0') ++len;
  return {p, len};
}

constexpr const char* kPolar[] = {"SER", "THR", "CYS", "ASN", "GLN", "TYR"};

inline bool is_polar_res(std::string_view name) {
  for (const char* p : kPolar)
    if (name == p) return true;
  return false;
}

// Letters -> concatenated alphabet positions (reference: utils.rs:24-33).
inline int64_t serialize_chain_id(std::string_view s) {
  int64_t r = 0;
  for (char c : s) {
    if ((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z')) {
      char u = (c >= 'a') ? c - 32 : c;
      r = r * 10 + (u - 64);
    }
  }
  return r;
}

// %.9g with serde-style ".0" suffix for integral values (matches the
// vectorized Python fast path, io/serialize.py::_json_float_col).
inline int append_dot0(char* buf, int n) {
  bool plain = true;
  for (int i = 0; i < n; ++i) {
    char c = buf[i];
    if (!(c >= '0' && c <= '9') && c != '-') { plain = false; break; }
  }
  if (plain) { buf[n++] = '.'; buf[n++] = '0'; buf[n] = '\0'; }
  return n;
}

inline int fmt_f32(char* buf, float v) {
  // std::to_chars(general, 9) is byte-identical to printf "%.9g"
  // (verified over 5M random f32 bit patterns) and ~10x faster than
  // glibc snprintf - emit formatting was a measured ~2us/residue.
  auto r = std::to_chars(buf, buf + 32, static_cast<double>(v),
                         std::chars_format::general, 9);
  int n = static_cast<int>(r.ptr - buf);
  buf[n] = '\0';
  return append_dot0(buf, n);
}

inline int fmt_i64(char* buf, int64_t v) {
  auto r = std::to_chars(buf, buf + 24, v);
  int n = static_cast<int>(r.ptr - buf);
  buf[n] = '\0';
  return n;
}

// Shortest round-trip decimal for an f32 (matches serde_json f32 output /
// io/serialize.py::_f32_repr): the smallest precision whose parse
// round-trips, rendered positionally.
inline int fmt_f32_short(char* buf, float v) {
  int n = 0;
  for (int prec = 1; prec <= 9; ++prec) {
    n = snprintf(buf, 32, "%.*g", prec, static_cast<double>(v));
    if (strtof(buf, nullptr) == v) break;
  }
  if (!memchr(buf, 'e', n) && !memchr(buf, 'E', n)) return n;
  // Exponent form -> positional expansion (rare: |v| >= 1e9 or < 1e-4).
  for (int dec = 0; dec <= 45; ++dec) {
    n = snprintf(buf, 64, "%.*f", dec, static_cast<double>(v));
    if (strtof(buf, nullptr) == v) break;
  }
  // Trim trailing zeros / dot like np.format_float_positional(trim='0').
  if (memchr(buf, '.', n)) {
    while (n > 0 && buf[n - 1] == '0') buf[--n] = '\0';
    if (n > 0 && buf[n - 1] == '.') buf[--n] = '\0';
  }
  if (n == 0) { buf[0] = '0'; buf[1] = '\0'; n = 1; }
  return n;
}

inline int fmt_f32_short_json(char* buf, float v) {
  int n = fmt_f32_short(buf, v);
  return append_dot0(buf, n);
}

inline void json_escape(std::string& out, std::string_view s) {
  out.push_back('"');
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char b[8];
          snprintf(b, sizeof(b), "\\u%04x", c);
          out += b;
        } else {
          out.push_back(c);
        }
    }
  }
  out.push_back('"');
}

inline void xml_escape(std::string& out, std::string_view s) {
  for (char c : s) {
    switch (c) {
      case '&': out += "&amp;"; break;
      case '<': out += "&lt;"; break;
      case '>': out += "&gt;"; break;
      default: out.push_back(c);
    }
  }
}

struct SelOwner {
  std::vector<float> coords;       // [m*3]
  std::vector<float> radii;        // [m]
  std::vector<int32_t> gids;       // [m]
  std::vector<int32_t> res_slot;   // [m]
  std::vector<int64_t> res_serial; // [R]
  std::vector<int32_t> res_icode;  // [R] codes into fp icode_tab
  std::vector<int32_t> res_name;   // [R] codes into fp resname_tab
  std::vector<int32_t> res_chain;  // [R] chain codes
};

}  // namespace

extern "C" {

struct SelResult {
  int64_t m;
  float* coords;
  float* radii;
  int32_t* gids;
  int32_t* residue_slot;
  int64_t n_res;
  int64_t* res_serial;
  int32_t* res_icode_code;
  int32_t* res_name_code;
  int32_t* res_chain_idx;
  int32_t n_chain;
  char error[320];
  SelOwner* owner;
};

// Radii blobs: lines of "RES\tATOM\tradius" / "EL\tradius".  Called once
// from Python before any worker threads start.
void fastpipe_set_radii(const char* pair_blob, const char* vdw_blob) {
  g_radii.pair.clear();
  g_radii.vdw.clear();
  std::string_view pv(pair_blob);
  size_t pos = 0;
  while (pos < pv.size()) {
    size_t eol = pv.find('\n', pos);
    if (eol == std::string_view::npos) eol = pv.size();
    std::string_view line = pv.substr(pos, eol - pos);
    pos = eol + 1;
    size_t t2 = line.rfind('\t');
    if (t2 == std::string_view::npos) continue;
    g_radii.pair[std::string(line.substr(0, t2))] =
        strtof(std::string(line.substr(t2 + 1)).c_str(), nullptr);
  }
  std::string_view vv(vdw_blob);
  pos = 0;
  while (pos < vv.size()) {
    size_t eol = vv.find('\n', pos);
    if (eol == std::string_view::npos) eol = vv.size();
    std::string_view line = vv.substr(pos, eol - pos);
    pos = eol + 1;
    size_t t1 = line.find('\t');
    if (t1 == std::string_view::npos) continue;
    g_radii.vdw[std::string(line.substr(0, t1))] =
        strtof(std::string(line.substr(t1 + 1)).c_str(), nullptr);
  }
  g_radii.loaded = true;
}

// Selection: filtering + radius resolution + occlusion-group ids +
// residue/chain aggregation metadata (reference: options.rs:139-464;
// executable spec: rustsasa_jax.levels.build_selection).
// level: 0=atom 1=residue 2=chain 3=protein.
// Per-thread scratch for fastpipe_select temporaries: reused across
// calls so the ~10 short-lived vectors per file stop paying
// malloc + first-touch every time (worker threads each get their own).
struct SelScratch {
  std::vector<int32_t> res_code, conf_code, conf_res, conf_alt;
  std::vector<int64_t> res_first, conf_first, first_nb, idx;
  std::vector<uint8_t> conf_kept;
  std::vector<int32_t> res_order, slot_of_code;
  std::vector<float> flat;

  // Bound the high-water retention: one multi-million-atom outlier file
  // would otherwise pin its ~30 B/atom of scratch in every worker
  // thread for the rest of the run.  Typical proteome files are well
  // under the threshold, so the fast path never reallocates.
  static constexpr size_t kShrinkAtoms = 1 << 18;  // 256k atoms
  void maybe_shrink(size_t n) {
    if (n > kShrinkAtoms || res_code.capacity() <= kShrinkAtoms) return;
    auto drop = [](auto& v) {
      v.clear();
      v.shrink_to_fit();
    };
    drop(res_code);
    drop(conf_code);
    drop(idx);
    drop(res_first);
    drop(conf_first);
    drop(conf_res);
    drop(conf_alt);
    drop(first_nb);
    drop(conf_kept);
    drop(res_order);
    drop(slot_of_code);
    drop(flat);
  }
};
static thread_local SelScratch g_sel_scratch;

SelResult* fastpipe_select(FPResult* r, int level, int include_h,
                           int include_het, int read_occ, int allow_vdw) {
  auto* owner = new SelOwner();
  auto* s = new SelResult();
  memset(s->error, 0, sizeof(s->error));
  s->owner = owner;
  const int64_t n = r->n;
  s->m = 0;
  s->n_res = 0;
  s->n_chain = r->n_chain;
  if (n == 0) return s;

  // Guard the exact-packing key layouts; bail to the Python fallback on
  // pathological cardinalities (mirrors levels.py's structured-key branch).
  bool in_range = r->n_chain < (1 << 16) && r->n_icode < (1 << 12) &&
                  r->n_alt < (1 << 12) && r->n_resname < (1 << 12) &&
                  r->n_name < (1 << 16);
  if (in_range) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t rs = r->res_serial[i];
      if (rs < -(1ll << 32) || rs >= (1ll << 32)) { in_range = false; break; }
    }
  }
  if (!in_range) {
    snprintf(s->error, sizeof(s->error), "E_FALLBACK");
    return s;
  }

  // Blank / hydrogen codes in this file's interned tables.
  auto find_code = [](const char* tab, int32_t n_tab, std::string_view v) {
    for (int32_t c = 0; c < n_tab; ++c)
      if (tab_entry(tab, c) == v) return c;
    return static_cast<int32_t>(-1);
  };
  const int32_t blank_alt = find_code(r->alt_tab, r->n_alt, "");
  const int32_t blank_elem = find_code(r->element_tab, r->n_element, "");
  const int32_t h_elem = find_code(r->element_tab, r->n_element, "H");

  // Residue codes (chain, res_serial, icode) and conformer codes (res,
  // resname, alt), both in first-appearance order, in ONE fused pass
  // (was two whole-atom loops).  Consecutive-key caches cover the
  // common runs; the hash maps only see boundaries.
  SelScratch& sc = g_sel_scratch;
  sc.maybe_shrink(static_cast<size_t>(n));
  std::unordered_map<uint64_t, int32_t> res_map;
  res_map.reserve(static_cast<size_t>(n / 6));
  auto& res_code = sc.res_code;
  res_code.resize(n);
  auto& res_first = sc.res_first;
  res_first.clear();
  std::unordered_map<uint64_t, int32_t> conf_map;
  conf_map.reserve(static_cast<size_t>(n / 4));
  auto& conf_code = sc.conf_code;
  conf_code.resize(n);
  auto& conf_first = sc.conf_first;
  conf_first.clear();
  auto& conf_res = sc.conf_res;
  conf_res.clear();
  auto& conf_alt = sc.conf_alt;
  conf_alt.clear();
  uint64_t last_rkey = ~0ull; int32_t last_rcode = -1;
  uint64_t last_ckey = ~0ull; int32_t last_ccode = -1;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = (static_cast<uint64_t>(r->chain_code[i]) << 45) |
                   (static_cast<uint64_t>(r->res_serial[i] + (1ll << 32)) << 12) |
                   static_cast<uint64_t>(r->icode_code[i]);
    if (key != last_rkey) {
      auto [it, ins] = res_map.try_emplace(key, static_cast<int32_t>(res_first.size()));
      if (ins) res_first.push_back(i);
      last_rkey = key;
      last_rcode = it->second;
    }
    res_code[i] = last_rcode;
    uint64_t ckey = (static_cast<uint64_t>(last_rcode) << 24) |
                    (static_cast<uint64_t>(r->resname_code[i]) << 12) |
                    static_cast<uint64_t>(r->alt_code[i]);
    if (ckey != last_ckey) {
      auto [it, ins] = conf_map.try_emplace(ckey, static_cast<int32_t>(conf_first.size()));
      if (ins) {
        conf_first.push_back(i);
        conf_res.push_back(last_rcode);
        conf_alt.push_back(r->alt_code[i]);
      }
      last_ckey = ckey;
      last_ccode = it->second;
    }
    conf_code[i] = last_ccode;
  }
  const int64_t n_res = static_cast<int64_t>(res_first.size());
  const int64_t n_conf = static_cast<int64_t>(conf_first.size());

  // Kept conformers: blank alt-loc plus the residue's FIRST alternate
  // (levels.py alt-loc policy; reference first-conformer semantics
  // options.rs:162,255,333,433 resolved against FreeSASA parity).
  auto& first_nb = sc.first_nb;
  first_nb.assign(n_res, INT64_MAX);
  for (int64_t c = 0; c < n_conf; ++c)
    if (conf_alt[c] != blank_alt && conf_first[c] < first_nb[conf_res[c]])
      first_nb[conf_res[c]] = conf_first[c];
  auto& conf_kept = sc.conf_kept;
  conf_kept.resize(n_conf);
  for (int64_t c = 0; c < n_conf; ++c)
    conf_kept[c] = (conf_alt[c] == blank_alt) ||
                   (conf_first[c] == first_nb[conf_res[c]]);

  // Fused filter + traversal-order pass (was four separate loops over
  // all atoms): per atom - kept-conformer gate, required-element check
  // for kept atoms (reference fetches the element before filtering,
  // options.rs:164), H / HETATM filters, sortedness tracking and the
  // kept-index build.
  auto& idx = sc.idx;
  idx.clear();
  idx.reserve(n);
  const bool drop_h = !include_h && h_elem >= 0;
  bool sorted = true;
  uint64_t prev_key = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t key = (static_cast<uint64_t>(r->chain_code[i]) << 48) |
                   (static_cast<uint64_t>(res_code[i]) << 24) |
                   static_cast<uint64_t>(conf_code[i]);
    if (key < prev_key) sorted = false;
    prev_key = key;
    if (!conf_kept[conf_code[i]]) continue;
    if (r->element_code[i] == blank_elem) {
      auto nm = tab_entry(r->name_tab, r->name_code[i]);
      snprintf(s->error, sizeof(s->error), "E_ELEMENT\t%.*s\t%lld",
               static_cast<int>(nm.size()), nm.data(),
               static_cast<long long>(r->serial[i]));
      return s;
    }
    if (drop_h && r->element_code[i] == h_elem) continue;
    if (!include_het && r->hetero[i]) continue;
    idx.push_back(i);
  }
  if (!sorted) {
    std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
      if (r->chain_code[a] != r->chain_code[b])
        return r->chain_code[a] < r->chain_code[b];
      if (res_code[a] != res_code[b]) return res_code[a] < res_code[b];
      return conf_code[a] < conf_code[b];
    });
  }
  const int64_t m = static_cast<int64_t>(idx.size());

  // Radii: memoized per (resname, atom name) pair (reference precedence:
  // occupancy > custom/protor table > vdW-if-allowed > error,
  // options.rs:83-103; custom configs take the Python path).  The memo
  // is a FLAT table indexed by code pair when the code space is small
  // (it practically always is: ~25 resnames x ~300 atom names) - a
  // direct load per atom instead of an unordered_map find, which
  // profiled as one of the two per-atom hash loops dominating select.
  owner->radii.resize(m);
  if (read_occ) {
    for (int64_t k = 0; k < m; ++k) owner->radii[k] = r->occupancy[idx[k]];
  } else {
    auto resolve = [&](int64_t i, float* out_rad) -> bool {
      auto rn = tab_entry(r->resname_tab, r->resname_code[i]);
      auto an = tab_entry(r->name_tab, r->name_code[i]);
      std::string pk;
      pk.reserve(rn.size() + an.size() + 1);
      pk.append(rn);
      pk.push_back('\t');
      pk.append(an);
      auto pit = g_radii.pair.find(pk);
      if (pit != g_radii.pair.end()) {
        *out_rad = pit->second;
        return true;
      }
      auto el = tab_entry(r->element_tab, r->element_code[i]);
      if (!allow_vdw) {
        snprintf(s->error, sizeof(s->error), "E_RADIUS\t%.*s\t%.*s\t%.*s",
                 static_cast<int>(rn.size()), rn.data(),
                 static_cast<int>(an.size()), an.data(),
                 static_cast<int>(el.size()), el.data());
        return false;
      }
      auto vit = g_radii.vdw.find(std::string(el));
      if (vit == g_radii.vdw.end()) {
        snprintf(s->error, sizeof(s->error), "E_VDW\t%.*s",
                 static_cast<int>(el.size()), el.data());
        return false;
      }
      *out_rad = vit->second;
      return true;
    };
    const int64_t flat_size =
        static_cast<int64_t>(r->n_resname) * r->n_name;
    if (flat_size > 0 && flat_size <= (1 << 18)) {
      const float kUnset = -1.0f;
      auto& flat = sc.flat;
      flat.assign(static_cast<size_t>(flat_size), kUnset);
      for (int64_t k = 0; k < m; ++k) {
        int64_t i = idx[k];
        int64_t fk = static_cast<int64_t>(r->resname_code[i]) * r->n_name +
                     r->name_code[i];
        float rad = flat[fk];
        if (rad == kUnset) {
          if (!resolve(i, &rad)) return s;
          flat[fk] = rad;
        }
        owner->radii[k] = rad;
      }
    } else {
      std::unordered_map<uint64_t, float> memo;
      memo.reserve(256);
      for (int64_t k = 0; k < m; ++k) {
        int64_t i = idx[k];
        uint64_t key = (static_cast<uint64_t>(r->resname_code[i]) << 32) |
                       static_cast<uint64_t>(r->name_code[i]);
        auto it = memo.find(key);
        if (it == memo.end()) {
          float rad;
          if (!resolve(i, &rad)) return s;
          it = memo.emplace(key, rad).first;
        }
        owner->radii[k] = it->second;
      }
    }
  }

  // Occlusion-exclusion group ids: (alt_loc, serial), serial-only at
  // protein level (reference: options.rs:183,276,354 vs :453).
  // Fast path: strictly increasing serials (the overwhelmingly common
  // well-formed-file case) make every key unique regardless of alt-loc,
  // so first-appearance ids are just 0..m-1 - no hash map (the map
  // insert per atom was the other profiled select hot loop).
  owner->gids.resize(m);
  {
    bool serial_increasing = true;
    for (int64_t k = 1; k < m; ++k) {
      if (r->serial[idx[k]] <= r->serial[idx[k - 1]]) {
        serial_increasing = false;
        break;
      }
    }
    if (serial_increasing) {
      for (int64_t k = 0; k < m; ++k)
        owner->gids[k] = static_cast<int32_t>(k);
    } else {
      std::unordered_map<uint64_t, int32_t> gmap;
      gmap.reserve(static_cast<size_t>(m));
      for (int64_t k = 0; k < m; ++k) {
        int64_t i = idx[k];
        uint64_t key =
            (level == 3)
                ? static_cast<uint64_t>(r->serial[i])
                : ((static_cast<uint64_t>(r->alt_code[i]) << 48) |
                   (static_cast<uint64_t>(r->serial[i]) & 0xFFFFFFFFFFFFull));
        auto [it, ins] =
            gmap.try_emplace(key, static_cast<int32_t>(gmap.size()));
        owner->gids[k] = it->second;
      }
    }
  }

  owner->coords.resize(m * 3);
  for (int64_t k = 0; k < m; ++k) {
    int64_t i = idx[k];
    owner->coords[k * 3 + 0] = r->coords[i * 3 + 0];
    owner->coords[k * 3 + 1] = r->coords[i * 3 + 1];
    owner->coords[k * 3 + 2] = r->coords[i * 3 + 2];
  }

  // Non-finite coordinates/radii (a textual 'nan' parses as a valid
  // float) must fail as a per-file typed error here: downstream they
  // would silently poison wire quantization and the NaN-asymmetric
  // culling reductions (mirrors levels.build_selection).
  for (int64_t k = 0; k < m; ++k) {
    if (!std::isfinite(owner->radii[k]) ||
        !std::isfinite(owner->coords[k * 3 + 0]) ||
        !std::isfinite(owner->coords[k * 3 + 1]) ||
        !std::isfinite(owner->coords[k * 3 + 2])) {
      snprintf(s->error, sizeof(s->error), "E_NONFINITE");
      return s;
    }
  }

  // Residue slots in traversal order (chain-major, then first appearance).
  auto& res_order = sc.res_order;
  res_order.resize(n_res);
  for (int64_t rc = 0; rc < n_res; ++rc) res_order[rc] = rc;
  std::stable_sort(res_order.begin(), res_order.end(),
                   [&](int32_t a, int32_t b) {
                     return r->chain_code[res_first[a]] <
                            r->chain_code[res_first[b]];
                   });
  auto& slot_of_code = sc.slot_of_code;
  slot_of_code.resize(n_res);
  for (int64_t sl = 0; sl < n_res; ++sl) slot_of_code[res_order[sl]] = sl;

  owner->res_slot.resize(m);
  for (int64_t k = 0; k < m; ++k)
    owner->res_slot[k] = slot_of_code[res_code[idx[k]]];

  owner->res_serial.resize(n_res);
  owner->res_icode.resize(n_res);
  owner->res_name.resize(n_res);
  owner->res_chain.resize(n_res);
  for (int64_t sl = 0; sl < n_res; ++sl) {
    int64_t fi = res_first[res_order[sl]];
    owner->res_serial[sl] = r->res_serial[fi];
    owner->res_icode[sl] = r->icode_code[fi];
    owner->res_name[sl] = r->resname_code[fi];
    owner->res_chain[sl] = r->chain_code[fi];
  }

  s->m = m;
  s->coords = owner->coords.data();
  s->radii = owner->radii.data();
  s->gids = owner->gids.data();
  s->residue_slot = owner->res_slot.data();
  s->n_res = n_res;
  s->res_serial = owner->res_serial.data();
  s->res_icode_code = owner->res_icode.data();
  s->res_name_code = owner->res_name.data();
  s->res_chain_idx = owner->res_chain.data();
  return s;
}

void fastpipe_sel_free(SelResult* s) {
  if (!s) return;
  delete s->owner;
  delete s;
}

// Aggregation + serialization + file write (reference: src/utils/io.rs
// JSON/XML schemas; executable spec: io/serialize.py fast_selection_json/
// fast_selection_xml).  fmt: 0=json 1=xml.  Returns 0 on success.
int fastpipe_emit(FPResult* r, SelResult* s, const float* atom_sasa,
                  int level, int fmt, const char* out_path, char* errbuf) {
  const int64_t m = s->m;
  const int64_t n_res = s->n_res;
  std::string out;
  out.reserve(static_cast<size_t>(n_res) * 120 + 64);
  char fb[40];

  // Residue sums in f64, emitted as f32 (levels.py _residue_sums).
  std::vector<double> sums64(n_res, 0.0);
  for (int64_t k = 0; k < m; ++k)
    sums64[s->residue_slot[k]] += static_cast<double>(atom_sasa[k]);

  if (level == 0) {  // atom
    out += fmt == 0 ? "{\"Atom\":[" : "";
    for (int64_t k = 0; k < m; ++k) {
      fmt_f32(fb, atom_sasa[k]);
      if (fmt == 0) {
        if (k) out.push_back(',');
        out += fb;
      } else {
        out += "<Atom>";
        int nn = fmt_f32(fb, atom_sasa[k]);
        out.append(fb, nn);
        out += "</Atom>";
      }
    }
    if (fmt == 0) out += "]}";
  } else if (level == 1) {  // residue
    if (fmt == 0) out += "{\"Residue\":[";
    for (int64_t sl = 0; sl < n_res; ++sl) {
      auto rn = tab_entry(r->resname_tab, s->res_name_code[sl]);
      auto ic = tab_entry(r->icode_tab, s->res_icode_code[sl]);
      auto cid = tab_entry(r->chain_tab, s->res_chain_idx[sl]);
      float val = static_cast<float>(sums64[sl]);
      if (fmt == 0) {
        if (sl) out.push_back(',');
        out += "{\"serial_number\":";
        char ib[24];
        fmt_i64(ib, s->res_serial[sl]);
        out += ib;
        out += ",\"insertion_code\":";
        json_escape(out, ic);
        out += ",\"value\":";
        fmt_f32(fb, val);
        out += fb;
        out += ",\"name\":";
        json_escape(out, rn);
        out += is_polar_res(rn) ? ",\"is_polar\":true" : ",\"is_polar\":false";
        out += ",\"chain_id\":";
        json_escape(out, cid);
        out.push_back('}');
      } else {
        out += "<Residue><serial_number>";
        char ib[24];
        fmt_i64(ib, s->res_serial[sl]);
        out += ib;
        out += "</serial_number><insertion_code>";
        xml_escape(out, ic);
        out += "</insertion_code><value>";
        fmt_f32(fb, val);
        out += fb;
        out += "</value><name>";
        xml_escape(out, rn);
        out += "</name><is_polar>";
        out += is_polar_res(rn) ? "true" : "false";
        out += "</is_polar><chain_id>";
        xml_escape(out, cid);
        out += "</chain_id></Residue>";
      }
    }
    if (fmt == 0) out += "]}";
  } else if (level == 2) {  // chain
    std::vector<double> csum(s->n_chain, 0.0);
    for (int64_t sl = 0; sl < n_res; ++sl)
      csum[s->res_chain_idx[sl]] += sums64[sl];
    // serialize_chain_id collision semantics: colliding chains all read the
    // LAST chain's value (reference: options.rs:300-308,361).
    std::unordered_map<int64_t, int32_t> last_for_key;
    for (int32_t c = 0; c < s->n_chain; ++c)
      last_for_key[serialize_chain_id(tab_entry(r->chain_tab, c))] = c;
    if (fmt == 0) out += "{\"Chain\":[";
    for (int32_t c = 0; c < s->n_chain; ++c) {
      auto cid = tab_entry(r->chain_tab, c);
      float val = static_cast<float>(
          csum[last_for_key[serialize_chain_id(cid)]]);
      if (fmt == 0) {
        if (c) out.push_back(',');
        out += "{\"name\":";
        json_escape(out, cid);
        out += ",\"value\":";
        fmt_f32_short_json(fb, val);
        out += fb;
        out += "}";
      } else {
        out += "<Chain><name>";
        xml_escape(out, cid);
        out += "</name><value>";
        fmt_f32_short(fb, val);
        out += fb;
        out += "</value></Chain>";
      }
    }
    if (fmt == 0) out += "]}";
  } else {  // protein
    double global = 0.0, polar = 0.0, nonpolar = 0.0;
    for (int64_t k = 0; k < m; ++k) global += static_cast<double>(atom_sasa[k]);
    for (int64_t sl = 0; sl < n_res; ++sl) {
      float v = static_cast<float>(sums64[sl]);
      auto rn = tab_entry(r->resname_tab, s->res_name_code[sl]);
      if (is_polar_res(rn)) polar += static_cast<double>(v);
      else nonpolar += static_cast<double>(v);
    }
    float g = static_cast<float>(global), p = static_cast<float>(polar),
          np_ = static_cast<float>(nonpolar);
    if (fmt == 0) {
      out += "{\"Protein\":{\"global_total\":";
      fmt_f32_short_json(fb, g); out += fb;
      out += ",\"polar_total\":";
      fmt_f32_short_json(fb, p); out += fb;
      out += ",\"non_polar_total\":";
      fmt_f32_short_json(fb, np_); out += fb;
      out += "}}";
    } else {
      out += "<Protein><global_total>";
      fmt_f32_short(fb, g); out += fb;
      out += "</global_total><polar_total>";
      fmt_f32_short(fb, p); out += fb;
      out += "</polar_total><non_polar_total>";
      fmt_f32_short(fb, np_); out += fb;
      out += "</non_polar_total></Protein>";
    }
  }

  // Raw open/write/close: one syscall per stage (fopen+fwrite+fclose
  // measured ~100us slower per file through stdio buffering).
  int fd = open(out_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) {
    snprintf(errbuf, 256, "failed to open output file: %s", out_path);
    return 1;
  }
  const char* p = out.data();
  size_t left = out.size();
  while (left > 0) {
    ssize_t wrote = write(fd, p, left);
    if (wrote < 0) {
      if (errno == EINTR) continue;  // interrupted, not failed: retry
      int err = errno;
      close(fd);
      snprintf(errbuf, 256, "write failed (%s): %s", strerror(err), out_path);
      return 1;
    }
    if (wrote == 0) {  // no progress and no error: avoid spinning forever
      close(fd);
      snprintf(errbuf, 256, "write returned 0: %s", out_path);
      return 1;
    }
    p += wrote;
    left -= static_cast<size_t>(wrote);
  }
  close(fd);
  return 0;
}

// Fused unpack + emit: takes the device's occlusion COUNTS (u8, or u16
// when n_points > 255) still in packed Morton-slot order plus the
// inverse permutation, reconstructs per-atom SASA in one pass
// (bit-identical to engine.collect's numpy arithmetic: f32
// cnt * ((area_const * r_eff) * r_eff)), writes the output file via
// fastpipe_emit, and returns the f64 total area through out_total.
// Replaces ~170us/file of numpy gather/astype/multiply on the Python
// worker threads with ~2us of native code.
int fastpipe_emit_counts(FPResult* r, SelResult* s, const void* counts,
                         int64_t n_slots, int wide, const void* inv,
                         int64_t n_inv, int inv64, float area_const,
                         float probe, int level, int fmt,
                         const char* out_path, double* out_total,
                         char* errbuf) {
  const int64_t m = s->m;
  // A caller mismatch (wrong CountsView/NativeSelection pairing, or a
  // truncated readback) must surface as an error string, not a silent
  // out-of-bounds read in native code.
  if (n_inv != m) {
    snprintf(errbuf, 256,
             "emit_counts: inv length %lld != selection size %lld",
             static_cast<long long>(n_inv), static_cast<long long>(m));
    return 1;
  }
  std::vector<float> sasa(static_cast<size_t>(m));
  const uint8_t* c8 = static_cast<const uint8_t*>(counts);
  const uint16_t* c16 = static_cast<const uint16_t*>(counts);
  const int32_t* p32 = static_cast<const int32_t*>(inv);
  const int64_t* p64 = static_cast<const int64_t*>(inv);
  double total = 0.0;
  for (int64_t k = 0; k < m; ++k) {
    int64_t slot = inv64 ? p64[k] : p32[k];
    if (slot < 0 || slot >= n_slots) {
      snprintf(errbuf, 256,
               "emit_counts: slot %lld out of range [0, %lld)",
               static_cast<long long>(slot),
               static_cast<long long>(n_slots));
      return 1;
    }
    float cnt = wide ? static_cast<float>(c16[slot])
                     : static_cast<float>(c8[slot]);
    float reff = s->radii[k] + probe;
    float t = (area_const * reff) * reff;
    sasa[k] = cnt * t;
    total += static_cast<double>(sasa[k]);
  }
  if (out_total) *out_total = total;
  return fastpipe_emit(r, s, sasa.data(), level, fmt, out_path, errbuf);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// fastpack: host-side packing for the fused occlusion kernel.
//
// Native port of ops/fused_kernel.pack_structures (see its docstring for
// the layout contract): per structure, center coordinates, Morton-sort,
// fill the 5 transfer planes, build per-tile AABBs and the [nt x nt]
// tile-pair culling, and emit nearest-first j-lists.  Semantics are
// bit-compatible with the numpy implementation (tested in
// tests/test_native_pipe.py) so either can pack any chunk.
// ---------------------------------------------------------------------------

static inline uint32_t morton_spread(uint32_t x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

static const int kAtomTile = 128;
static const int kJListRows = 128;
static const int kJListCap = kJListRows - 1;
static const int kJGroup = 8;
static const int kGroupsPerTile = kAtomTile / kJGroup;

// Shared first stage of both packers: center on the f64 mean rounded to
// a 1/256 A grid, Morton-order, invert the permutation.  `c` gets the
// centered coordinates (input order); `order[k]` = input index of slot k.
static void center_morton_sort(const float* coords, int n,
                               std::vector<float>& c,
                               std::vector<int32_t>& order, int32_t* inv) {
  double cx = 0, cy = 0, cz = 0;
  for (int i = 0; i < n; i++) {
    cx += coords[3 * i];
    cy += coords[3 * i + 1];
    cz += coords[3 * i + 2];
  }
  float mx = (float)(std::nearbyint(cx / n * 256.0) / 256.0);
  float my = (float)(std::nearbyint(cy / n * 256.0) / 256.0);
  float mz = (float)(std::nearbyint(cz / n * 256.0) / 256.0);

  c.resize(3 * (size_t)n);
  float qmin[3] = {1e30f, 1e30f, 1e30f};
  for (int i = 0; i < n; i++) {
    c[3 * i] = coords[3 * i] - mx;
    c[3 * i + 1] = coords[3 * i + 1] - my;
    c[3 * i + 2] = coords[3 * i + 2] - mz;
    for (int d = 0; d < 3; d++) qmin[d] = std::min(qmin[d], c[3 * i + d]);
  }
  float qmax = 0.0f;
  for (int i = 0; i < n; i++)
    for (int d = 0; d < 3; d++)
      qmax = std::max(qmax, c[3 * i + d] - qmin[d]);
  // Quantize in float32, matching the numpy packer exactly (NEP 50:
  // f32 array * python float multiplies in f32).
  float scale = (float)(1023.0 / std::max((double)qmax, 1e-6));
  std::vector<uint32_t> code((size_t)n);
  for (int i = 0; i < n; i++) {
    uint32_t q[3];
    for (int d = 0; d < 3; d++) {
      float qf = c[3 * i + d] - qmin[d];
      uint32_t v = (uint32_t)(qf * scale);
      q[d] = v > 1023u ? 1023u : v;
    }
    code[i] = morton_spread(q[0]) | (morton_spread(q[1]) << 1) |
              (morton_spread(q[2]) << 2);
  }
  order.resize((size_t)n);
  for (int i = 0; i < n; i++) order[i] = i;
  // Stable LSD radix sort on the 30-bit codes (three 10-bit counting
  // passes): same ordering as std::stable_sort ascending (stability
  // matches the numpy packer's kind="stable" argsort) at ~1/10th the
  // cost - the comparison sort was ~60% of the whole q16 pack.
  {
    std::vector<int32_t> tmp((size_t)n);
    int32_t* src = order.data();
    int32_t* dst = tmp.data();
    uint32_t cnt[1024];
    for (int pass = 0; pass < 3; ++pass) {
      int shift = pass * 10;
      memset(cnt, 0, sizeof cnt);
      for (int i = 0; i < n; ++i) cnt[(code[src[i]] >> shift) & 1023]++;
      uint32_t sum = 0;
      for (int b = 0; b < 1024; ++b) {
        uint32_t t = cnt[b];
        cnt[b] = sum;
        sum += t;
      }
      for (int i = 0; i < n; ++i)
        dst[cnt[(code[src[i]] >> shift) & 1023]++] = src[i];
      std::swap(src, dst);
    }
    if (src != order.data())
      memcpy(order.data(), src, (size_t)n * sizeof(int32_t));
  }
  for (int k = 0; k < n; k++) inv[order[k]] = k;
}

// Pack one structure into its slot range.  Returns false on j-list
// overflow (caller zeroes the slots and marks the structure failed).
// jlist entries are u32: (group_mask << 16) | j_tile_id; col 0 = count
// (see ops/fused_kernel.py for the full layout contract).
static bool pack_one(const float* coords, const float* radii,
                     const int32_t* gids, int n, float probe,
                     int64_t pos, int tile0, int64_t m_total,
                     float* planes5, uint32_t* jlist, int32_t* inv) {
  int nt = (n + kAtomTile - 1) / kAtomTile;
  std::vector<float> c;
  std::vector<int32_t> order;
  center_morton_sort(coords, n, c, order, inv);

  // Fill transfer planes (row-major [5, M]).
  float* px = planes5 + 0 * m_total + pos;
  float* py = planes5 + 1 * m_total + pos;
  float* pz = planes5 + 2 * m_total + pos;
  float* pr = planes5 + 3 * m_total + pos;
  float* pg = planes5 + 4 * m_total + pos;
  for (int k = 0; k < n; k++) {
    int i = order[k];
    px[k] = c[3 * i];
    py[k] = c[3 * i + 1];
    pz[k] = c[3 * i + 2];
    pr[k] = radii[i] + probe;
    pg[k] = (float)((double)gids[i] + 1.0);
  }

  // Per-8-group AABBs + max reach over real atoms; tile AABBs reduce
  // over their 16 groups.
  int ng = nt * kGroupsPerTile;
  std::vector<float> gmin(3 * (size_t)ng, 3e4f), gmax(3 * (size_t)ng, -3e4f);
  std::vector<float> gmaxr((size_t)ng, 0.0f);
  for (int k = 0; k < n; k++) {
    int g = k / kJGroup;
    float v[3] = {px[k], py[k], pz[k]};
    for (int d = 0; d < 3; d++) {
      gmin[3 * g + d] = std::min(gmin[3 * g + d], v[d]);
      gmax[3 * g + d] = std::max(gmax[3 * g + d], v[d]);
    }
    gmaxr[g] = std::max(gmaxr[g], pr[k]);
  }
  std::vector<float> tmin(3 * (size_t)nt, 3e4f), tmax(3 * (size_t)nt, -3e4f);
  std::vector<float> tmaxr((size_t)nt, 0.0f);
  for (int g = 0; g < ng; g++) {
    int t = g / kGroupsPerTile;
    for (int d = 0; d < 3; d++) {
      tmin[3 * t + d] = std::min(tmin[3 * t + d], gmin[3 * g + d]);
      tmax[3 * t + d] = std::max(tmax[3 * t + d], gmax[3 * g + d]);
    }
    tmaxr[t] = std::max(tmaxr[t], gmaxr[g]);
  }

  // [nt x nt] AABB separation culling with per-pair 16-bit group masks;
  // nearest-first per row.  Pairs whose tile AABBs touch but no 8-atom
  // group does are dropped entirely.
  struct Entry {
    float sep2;
    int tj;
    uint32_t mask;
  };
  std::vector<Entry> row;
  row.reserve((size_t)nt);
  for (int ti = 0; ti < nt; ti++) {
    row.clear();
    for (int tj = 0; tj < nt; tj++) {
      float sep2 = 0.0f;
      for (int d = 0; d < 3; d++) {
        float g1 = tmin[3 * ti + d] - tmax[3 * tj + d];
        float g2 = tmin[3 * tj + d] - tmax[3 * ti + d];
        float g = std::max(std::max(g1, g2), 0.0f);
        sep2 += g * g;
      }
      // 0.08 A slack keeps the cull conservative under u16 coordinate
      // quantization (ops/fused_kernel.quantize_packed / CULL_SLACK).
      float reach = tmaxr[ti] + tmaxr[tj] + 0.08f;
      if (sep2 > reach * reach) continue;
      uint32_t mask = 0;
      for (int g = 0; g < kGroupsPerTile; g++) {
        int jg = tj * kGroupsPerTile + g;
        float gs2 = 0.0f;
        for (int d = 0; d < 3; d++) {
          float g1 = tmin[3 * ti + d] - gmax[3 * jg + d];
          float g2 = gmin[3 * jg + d] - tmax[3 * ti + d];
          float gp = std::max(std::max(g1, g2), 0.0f);
          gs2 += gp * gp;
        }
        float gr = tmaxr[ti] + gmaxr[jg] + 0.08f;
        if (gs2 <= gr * gr) mask |= (1u << g);
      }
      if (mask != 0) row.push_back({sep2, tj, mask});
    }
    if ((int)row.size() > kJListCap) return false;
    std::stable_sort(row.begin(), row.end(),
                     [](const Entry& a, const Entry& b) {
                       return a.sep2 < b.sep2;
                     });
    uint32_t* jrow = jlist + (size_t)(tile0 + ti) * kJListRows;
    jrow[0] = (uint32_t)row.size();
    for (size_t s = 0; s < row.size(); s++)
      jrow[1 + s] =
          (row[s].mask << 16) | (uint32_t)(row[s].tj + tile0);
  }
  return true;
}

extern "C" {

// Returns the number of failed structures (j-list overflow); failed
// structures get pos_out[i] = -1, zeroed planes and zeroed j-lists.
// planes5 (f32[5*M], zeroed), jlist (u16[(M/128)*128], zeroed) and
// inv (i32[sum ns]) are caller-allocated; M = sum(ceil(n/128))*128.
int fastpack(int n_structs, const float** coords, const float** radii,
             const int32_t** gids, const int32_t* ns, float probe,
             int64_t m_total, float* planes5, uint32_t* jlist,
             int32_t* inv, int64_t* pos_out) {
  int n_failed = 0;
  int64_t pos = 0;
  int64_t inv_off = 0;
  int tile0 = 0;
  for (int s = 0; s < n_structs; s++) {
    int n = ns[s];
    int nt = (n + kAtomTile - 1) / kAtomTile;
    bool ok = pack_one(coords[s], radii[s], gids[s], n, probe, pos, tile0,
                       m_total, planes5 + 0, jlist, inv + inv_off);
    if (!ok) {
      // Zero this structure's slots and j-list rows; caller reroutes it.
      for (int p = 0; p < 5; p++)
        memset(planes5 + (size_t)p * m_total + pos, 0,
               sizeof(float) * (size_t)nt * kAtomTile);
      memset(jlist + (size_t)tile0 * kJListRows, 0,
             sizeof(uint32_t) * (size_t)nt * kJListRows);
      pos_out[s] = -1;
      n_failed++;
    } else {
      pos_out[s] = pos;
    }
    pos += (int64_t)nt * kAtomTile;
    tile0 += nt;
    inv_off += n;
  }
  return n_failed;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// fastpack_q16: host packing for the banded DEVICE-cull path.
//
// Native port of ops/fused_kernel._pack_structures_q16_numpy (bit-identical
// layout contract, tested in tests/test_native_pipe.py): per structure,
// center + Morton-sort, then quantize coordinates to u16 against the
// structure's own box and r_eff to u16/8192.  NO neighbor/culling work -
// that runs on the device (ops/fused_kernel.build_jlist_banded).  Threaded
// over structures (disjoint output ranges).
// ---------------------------------------------------------------------------

// Mirrors fused_kernel.MAX_Q_EXTENT / R_QUANT.
static const float kMaxQExtent = 1300.0f;
static const float kRQuant = 8192.0f;

// Returns false when the structure is unquantizable (extent or radius out
// of range) - the whole chunk then falls back to the f32/host-cull path.
static bool pack_one_q16(const float* coords, const float* radii, int n,
                         float probe, int64_t pos, int tile0, int64_t m_total,
                         uint16_t* planes4, float* tparams, int32_t* tmeta,
                         int32_t* inv) {
  int nt = (n + kAtomTile - 1) / kAtomTile;
  std::vector<float> c;
  std::vector<int32_t> order;
  center_morton_sort(coords, n, c, order, inv);

  float cmin[3] = {1e30f, 1e30f, 1e30f};
  float cmax[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < n; i++) {
    for (int d = 0; d < 3; d++) {
      cmin[d] = std::min(cmin[d], c[3 * i + d]);
      cmax[d] = std::max(cmax[d], c[3 * i + d]);
    }
  }
  float extent = 0.0f;
  for (int d = 0; d < 3; d++) extent = std::max(extent, cmax[d] - cmin[d]);
  // NaN-safe negation: non-finite extents must decline, not pass.
  if (!(extent <= kMaxQExtent)) return false;
  // f64 divide then cast, matching np.float32(max(extent, 1e-6) / 65535.0).
  float scale = (float)(std::max((double)extent, 1e-6) / 65535.0);

  uint16_t* px = planes4 + 0 * m_total + pos;
  uint16_t* py = planes4 + 1 * m_total + pos;
  uint16_t* pz = planes4 + 2 * m_total + pos;
  uint16_t* pr = planes4 + 3 * m_total + pos;
  for (int k = 0; k < n; k++) {
    int i = order[k];
    // np.rint == nearbyintf under round-to-nearest-even (the default).
    float qx = nearbyintf((c[3 * i] - cmin[0]) / scale);
    float qy = nearbyintf((c[3 * i + 1] - cmin[1]) / scale);
    float qz = nearbyintf((c[3 * i + 2] - cmin[2]) / scale);
    px[k] = (uint16_t)std::min(std::max(qx, 0.0f), 65535.0f);
    py[k] = (uint16_t)std::min(std::max(qy, 0.0f), 65535.0f);
    pz[k] = (uint16_t)std::min(std::max(qz, 0.0f), 65535.0f);
    float qr = nearbyintf((radii[i] + probe) * kRQuant);
    if (!(qr <= 65535.0f)) return false;  // NaN-safe
    pr[k] = (uint16_t)std::max(qr, 1.0f);
  }
  for (int t = tile0; t < tile0 + nt; t++) {
    tparams[4 * (size_t)t + 0] = cmin[0];
    tparams[4 * (size_t)t + 1] = cmin[1];
    tparams[4 * (size_t)t + 2] = cmin[2];
    tparams[4 * (size_t)t + 3] = scale;
    tmeta[2 * (size_t)t + 0] = tile0;
    tmeta[2 * (size_t)t + 1] = nt;
  }
  return true;
}

extern "C" {

// Returns 0 on success, 1 when any structure is unquantizable (caller
// falls back to fastpack + the f32 path).  planes4 (u16[4*M], zeroed),
// tparams (f32[T*4]), tmeta (i32[T*2]), inv (i32[sum ns]) and
// pos_out (i64[n_structs]) are caller-allocated.
int fastpack_q16(int n_structs, const float** coords, const float** radii,
                 const int32_t* ns, float probe, int64_t m_total,
                 uint16_t* planes4, float* tparams, int32_t* tmeta,
                 int32_t* inv, int64_t* pos_out, int n_threads) {
  // Prefix offsets so every structure packs independently.
  std::vector<int64_t> pos(n_structs), inv_off(n_structs);
  std::vector<int32_t> tile0(n_structs);
  int64_t p = 0, io = 0;
  int t0 = 0;
  for (int s = 0; s < n_structs; s++) {
    pos[s] = p;
    inv_off[s] = io;
    tile0[s] = t0;
    int nt = (ns[s] + kAtomTile - 1) / kAtomTile;
    p += (int64_t)nt * kAtomTile;
    t0 += nt;
    io += ns[s];
    pos_out[s] = pos[s];
  }

  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      int s = next.fetch_add(1);
      if (s >= n_structs || failed.load(std::memory_order_relaxed)) return;
      if (!pack_one_q16(coords[s], radii[s], ns[s], probe, pos[s], tile0[s],
                        m_total, planes4, tparams, tmeta, inv + inv_off[s]))
        failed.store(1, std::memory_order_relaxed);
    }
  };
  int nth = std::max(1, std::min(n_threads, n_structs));
  if (nth == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve((size_t)nth);
    for (int i = 0; i < nth; i++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failed.load() ? 1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// fastpack_q13: 6 B/atom-slot wire (vs q16's 8).  Native port of
// ops/fused_kernel._pack_structures_q12_numpy (same layout contract):
//   wire_a u32[M]: qx(12) | qy(12) | qz_hi(8)
//   wire_b u16[M]: qz_lo(4) | palette_index(8)
// Radii ride as 8-bit indices into a chunk-global palette of exact f32
// r_eff values keyed by the 1/8192 A qr bucket; palette[0] = 0 marks
// padding.  Coordinate step extent/8191 requires extent <= 100 A.
// ---------------------------------------------------------------------------

static const float kMaxQ13Extent = 100.0f;

static bool pack_one_q13(const float* coords, const float* radii, int n,
                         float probe, int64_t pos, int tile0,
                         uint32_t* wire_a, uint16_t* wire_b,
                         const uint16_t* qr_to_idx, float* tparams,
                         int32_t* tmeta, int32_t* inv) {
  int nt = (n + kAtomTile - 1) / kAtomTile;
  std::vector<float> c;
  std::vector<int32_t> order;
  center_morton_sort(coords, n, c, order, inv);

  float cmin[3] = {1e30f, 1e30f, 1e30f};
  float cmax[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < n; i++) {
    for (int d = 0; d < 3; d++) {
      cmin[d] = std::min(cmin[d], c[3 * i + d]);
      cmax[d] = std::max(cmax[d], c[3 * i + d]);
    }
  }
  float extent = 0.0f;
  for (int d = 0; d < 3; d++) extent = std::max(extent, cmax[d] - cmin[d]);
  if (!(extent <= kMaxQ13Extent)) return false;  // NaN-safe
  // f64 divide then cast, matching np.float32(max(extent, 1e-6) / 8191.0).
  float scale = (float)(std::max((double)extent, 1e-6) / 8191.0);

  uint32_t* wa = wire_a + pos;
  uint16_t* wb = wire_b + pos;
  for (int k = 0; k < n; k++) {
    int i = order[k];
    float qxf = nearbyintf((c[3 * i] - cmin[0]) / scale);
    float qyf = nearbyintf((c[3 * i + 1] - cmin[1]) / scale);
    float qzf = nearbyintf((c[3 * i + 2] - cmin[2]) / scale);
    uint32_t qx = (uint32_t)std::min(std::max(qxf, 0.0f), 8191.0f);
    uint32_t qy = (uint32_t)std::min(std::max(qyf, 0.0f), 8191.0f);
    uint32_t qz = (uint32_t)std::min(std::max(qzf, 0.0f), 8191.0f);
    float qrf = nearbyintf((radii[i] + probe) * kRQuant);
    if (!(qrf >= 1.0f && qrf <= 65535.0f)) return false;  // NaN-safe
    uint16_t idx = qr_to_idx[(uint32_t)qrf];
    if (idx == 0) return false;  // palette race guard; prescan covers all
    wa[k] = qx | (qy << 13) | ((qz >> 7) << 26);
    wb[k] = (uint16_t)((qz & 0x7F) | ((uint32_t)idx << 7));
  }
  for (int t = tile0; t < tile0 + nt; t++) {
    tparams[4 * (size_t)t + 0] = cmin[0];
    tparams[4 * (size_t)t + 1] = cmin[1];
    tparams[4 * (size_t)t + 2] = cmin[2];
    tparams[4 * (size_t)t + 3] = scale;
    tmeta[2 * (size_t)t + 0] = tile0;
    tmeta[2 * (size_t)t + 1] = nt;
  }
  return true;
}

extern "C" {

// Returns 0 on success, 1 when the chunk is ineligible (extent/palette/
// radius range) - caller falls back to the q16 wire.  wire_a (u32[M],
// zeroed), wire_b (u16[M], zeroed), palette (f32[256], zeroed), tparams,
// tmeta, inv, pos_out are caller-allocated.
int fastpack_q13(int n_structs, const float** coords, const float** radii,
                 const int32_t* ns, float probe, int64_t m_total,
                 uint32_t* wire_a, uint16_t* wire_b, float* palette,
                 float* tparams, int32_t* tmeta, int32_t* inv,
                 int64_t* pos_out, int n_threads) {
  std::vector<int64_t> pos(n_structs), inv_off(n_structs);
  std::vector<int32_t> tile0(n_structs);
  int64_t p = 0, io = 0;
  int t0 = 0;
  for (int s = 0; s < n_structs; s++) {
    pos[s] = p;
    inv_off[s] = io;
    tile0[s] = t0;
    int nt = (ns[s] + kAtomTile - 1) / kAtomTile;
    p += (int64_t)nt * kAtomTile;
    t0 += nt;
    io += ns[s];
    pos_out[s] = pos[s];
  }

  // Single-threaded palette prescan (measured ~1.5 ns/atom): assign an
  // index per distinct qr bucket in first-seen order so the layout is
  // deterministic and matches the numpy spec.
  std::vector<uint16_t> qr_to_idx(65536, 0);
  int n_pal = 1;
  for (int s = 0; s < n_structs; s++) {
    const float* r = radii[s];
    for (int i = 0; i < ns[s]; i++) {
      float reff = r[i] + probe;
      float qrf = nearbyintf(reff * kRQuant);
      if (!(qrf >= 1.0f && qrf <= 65535.0f)) return 1;  // NaN-safe
      uint32_t qr = (uint32_t)qrf;
      if (qr_to_idx[qr] == 0) {
        if (n_pal >= 256) return 1;
        palette[n_pal] = reff;
        qr_to_idx[qr] = (uint16_t)n_pal;
        n_pal++;
      }
    }
  }

  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      int s = next.fetch_add(1);
      if (s >= n_structs || failed.load(std::memory_order_relaxed)) return;
      if (!pack_one_q13(coords[s], radii[s], ns[s], probe, pos[s], tile0[s],
                        wire_a, wire_b, qr_to_idx.data(), tparams, tmeta,
                        inv + inv_off[s]))
        failed.store(1, std::memory_order_relaxed);
    }
  };
  int nth = std::max(1, std::min(n_threads, n_structs));
  if (nth == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve((size_t)nth);
    for (int i = 0; i < nth; i++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failed.load() ? 1 : 0;
}

}  // extern "C"
