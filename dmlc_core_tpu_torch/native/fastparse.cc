// Native parse core of dmlc_core_tpu_torch: text and RecordIO chunks ->
// CSR arrays or fixed-shape batch rows.
//
// The port's own copy of native/fastparse.cc (the JAX package's parse
// core). Built at first use by dmlc_core_tpu_torch/data/native.py
// with g++ and loaded through ctypes, which releases the GIL for the
// duration of each call, so sub-shard producers parse in parallel.
//
// Semantics contract: the CSR entry points match the plain parsers in
// dmlc_core_tpu_torch/data/{libsvm,csv,libfm}_parser.py, and every entry
// point matches the JAX package's build of the same code bit for bit
// (tests/test_torch_native.py, tests/test_torch_text.py and
// tests/test_torch_fused.py).

#include <algorithm>
#include <array>
#include <atomic>
#include <cerrno>
#include <charconv>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

#if defined(__F16C__)
#include <immintrin.h>
#endif

#define DMLC_API extern "C" __attribute__((visibility("default")))

namespace {

// POD view handed to ctypes; field order mirrors _ParseResult in
// dmlc_core_tpu_torch/data/native.py.
struct ParseResult {
  int64_t n_rows;
  int64_t n_elems;
  int64_t* offset;
  float* label;
  float* weight;
  int64_t* qid;
  int64_t* field;
  uint64_t* index;
  float* value;
  int32_t has_weight;
  int32_t has_qid;
  int32_t has_field;
  int32_t has_value;
  const char* error;
};

// Owns the storage; ParseResult is the first member so the C API can hand
// out &holder->res and free via a cast back.
struct Holder {
  ParseResult res{};
  std::vector<int64_t> offset;
  std::vector<float> label;
  std::vector<float> weight;
  std::vector<int64_t> qid;
  std::vector<int64_t> field;
  std::vector<uint64_t> index;
  std::vector<float> value;
  std::string error_msg;
};

ParseResult* finish(Holder* h) {
  ParseResult& r = h->res;
  r.n_rows = static_cast<int64_t>(h->label.size());
  r.n_elems = static_cast<int64_t>(h->index.size());
  r.offset = h->offset.data();
  r.label = h->label.data();
  r.weight = h->weight.data();
  r.qid = h->qid.data();
  r.field = h->field.data();
  r.index = h->index.data();
  r.value = h->value.data();
  if (!h->error_msg.empty()) r.error = h->error_msg.c_str();
  return &r;
}

// matches Python bytes.split() whitespace (minus \n, which is a line
// terminator here): space, tab, CR, vertical tab, form feed
constexpr auto kBlankLut = [] {
  std::array<bool, 256> t{};
  t[' '] = t['\t'] = t['\r'] = t['\v'] = t['\f'] = true;
  return t;
}();

inline bool is_blank(char c) {
  return kBlankLut[static_cast<unsigned char>(c)];
}

// -- number parsing ----------------------------------------------------------

// std::from_chars rejects a leading '+' that Python float()/int() and C
// strtof/strtoll all accept; strip it (but not a '+' followed by another
// sign, which nothing accepts).
inline const char* skip_plus(const char* b, const char* e) {
  if (b != e && *b == '+' && b + 1 != e && b[1] != '+' && b[1] != '-') ++b;
  return b;
}

// Floating-point from_chars shim: libstdc++ < 11 (gcc 10 toolchains)
// ships the integer overloads only — __cpp_lib_to_chars is defined iff
// the FP overloads exist. The fallback emulates from_chars(general)
// with glibc strtod (also correctly rounded): bounded copy of the
// token, hex-float forms cut at the 'x' (strtod would consume "0x1p3"
// whole; from_chars general stops after the "0"). Callers pre-strip
// the leading blanks/'+' that strtod would otherwise accept.
#if defined(__cpp_lib_to_chars)
inline std::from_chars_result fp_from_chars(const char* b, const char* e,
                                            double& v) {
  return std::from_chars(b, e, v);
}
#else
inline std::from_chars_result fp_from_chars(const char* b, const char* e,
                                            double& v) {
  std::string tmp(b, e);
  const size_t x = tmp.find_first_of("xX");
  if (x != std::string::npos) tmp.resize(x);
  errno = 0;
  char* endp = nullptr;
  const double got = std::strtod(tmp.c_str(), &endp);
  if (endp == tmp.c_str()) {
    return {b, std::errc::invalid_argument};
  }
  v = got;
  return {b + (endp - tmp.c_str()),
          errno == ERANGE ? std::errc::result_out_of_range : std::errc()};
}
#endif

// Exact fast path for plain decimals: [sign] up-to-15 digits with one
// optional dot, no exponent. mantissa < 10^15 < 2^53 and the 10^k divisor
// are both exact doubles, so one division gives the correctly-rounded
// result — bit-identical to from_chars. Everything else returns false.
constexpr double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
    1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
    1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline bool parse_float_simple(const char* b, const char* e, double* out) {
  const char* p = b;
  bool neg = false;
  if (p != e && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  bool seen_dot = false, any = false;
  for (; p != e; ++p) {
    const char c = *p;
    if (c >= '0' && c <= '9') {
      if (++digits > 15) return false;
      mant = mant * 10 + static_cast<uint64_t>(c - '0');
      any = true;
      if (seen_dot) ++frac;
    } else if (c == '.' && !seen_dot) {
      seen_dot = true;
    } else {
      return false;  // exponent / junk: slow path decides
    }
  }
  if (!any) return false;
  const double v = static_cast<double>(mant) / kPow10[frac];
  *out = neg ? -v : v;
  return true;
}

// Fused decimal-value scan shared by the text kernels' fast paths:
// advances *pq past ``[-]digits[.digits]``; succeeds iff the value ends
// at a token boundary and has <= 15 digits (larger magnitudes and
// exponent forms go to the exact slow path, keeping values bit-identical
// across paths). On failure the caller re-parses from the token start.
inline bool scan_decimal_value(const char** pq, const char* le, double* out) {
  const char* q = *pq;
  bool neg = false;
  if (q < le && *q == '-') {
    neg = true;
    ++q;
  }
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  bool dot = false, any = false;
  for (; q < le; ++q) {
    const char c = *q;
    if (c >= '0' && c <= '9') {
      if (++digits > 15) return false;
      mant = mant * 10 + static_cast<uint64_t>(c - '0');
      any = true;
      if (dot) ++frac;
    } else if (c == '.' && !dot) {
      dot = true;
    } else {
      break;  // only a token boundary may follow
    }
  }
  if (!any || (q < le && !is_blank(*q))) return false;
  const double v = static_cast<double>(mant) / kPow10[frac];
  *out = neg ? -v : v;
  *pq = q;
  return true;
}

// Full-token float parse (Python float() semantics: whole token or fail).
// Out-of-range magnitudes resolve via strtod (±inf on overflow, 0 on
// underflow), matching Python float("1e999") == inf.
inline bool parse_float_full(const char* b, const char* e, double* out) {
  while (b != e && is_blank(*b)) ++b;
  while (e != b && is_blank(*(e - 1))) --e;
  if (parse_float_simple(b, e, out)) return true;
  b = skip_plus(b, e);
  if (b == e) return false;
  auto [ptr, ec] = fp_from_chars(b, e, *out);
  if (ec == std::errc::result_out_of_range && ptr == e) {
    std::string tmp(b, e);
    *out = std::strtod(tmp.c_str(), nullptr);
    return true;
  }
  return ec == std::errc() && ptr == e;
}

// Longest-prefix float parse (C strtof semantics: 0.0 when nothing parses).
inline double parse_float_prefix(const char* b, const char* e) {
  while (b != e && is_blank(*b)) ++b;
  b = skip_plus(b, e);
  double v = 0.0;
  auto [ptr, ec] = fp_from_chars(b, e, v);
  (void)ptr;
  if (ec == std::errc::result_out_of_range) {
    std::string tmp(b, e);
    return std::strtod(tmp.c_str(), nullptr);
  }
  return ec == std::errc() ? v : 0.0;
}

// Full-token base-10 integer parse (Python int() semantics).
inline bool parse_i64_full(const char* b, const char* e, int64_t* out) {
  while (b != e && is_blank(*b)) ++b;
  while (e != b && is_blank(*(e - 1))) --e;
  b = skip_plus(b, e);
  if (b == e) return false;
  auto [ptr, ec] = std::from_chars(b, e, *out, 10);
  return ec == std::errc() && ptr == e;
}

// -- tokenizing --------------------------------------------------------------

struct Line {
  const char* b;
  const char* e;
};

// Iterate lines of [b,e) like Python bytes.splitlines (\n, \r, \r\n).
template <typename F>
void for_each_line(const char* b, const char* e, F&& fn) {
  const char* p = b;
  while (p < e) {
    const char* le = p;
    while (le < e && *le != '\n' && *le != '\r') ++le;
    fn(Line{p, le});
    if (le < e) {
      if (*le == '\r' && le + 1 < e && le[1] == '\n') ++le;
      ++le;
    }
    p = le;
  }
}

template <typename F>
void for_each_token(const char* b, const char* e, F&& fn) {
  const char* p = b;
  while (p < e) {
    while (p < e && (is_blank(*p))) ++p;
    if (p >= e) break;
    const char* te = p;
    while (te < e && !is_blank(*te)) ++te;
    if (!fn(p, te)) return;
    p = te;
  }
}

}  // namespace

// -- libsvm ------------------------------------------------------------------

DMLC_API ParseResult* dmlc_parse_libsvm(const char* buf, int64_t len,
                                          int32_t indexing_mode) {
  Holder* h = new Holder();
  // rough sizing: ~12 bytes per feature token, ~48 bytes per row
  h->index.reserve(static_cast<size_t>(len / 12 + 8));
  h->value.reserve(static_cast<size_t>(len / 12 + 8));
  h->label.reserve(static_cast<size_t>(len / 48 + 8));
  h->weight.reserve(static_cast<size_t>(len / 48 + 8));
  h->qid.reserve(static_cast<size_t>(len / 48 + 8));
  h->offset.reserve(static_cast<size_t>(len / 48 + 9));
  h->offset.push_back(0);
  bool any_weight = false, any_qid = false, any_value = false;
  int64_t min_feat = INT64_MAX;
  for_each_line(buf, buf + len, [&](Line ln) {
    const char* lb = ln.b;
    const char* le = ln.e;
    const void* hash = memchr(lb, '#', static_cast<size_t>(le - lb));
    if (hash) le = static_cast<const char*>(hash);

    // ---- label token ----
    const char* p = lb;
    while (p < le && is_blank(*p)) ++p;
    if (p >= le) return;
    const char* te = p;
    while (te < le && !is_blank(*te)) ++te;
    {
      const char* colon =
          static_cast<const char*>(memchr(p, ':', static_cast<size_t>(te - p)));
      double lab, w = 1.0;
      bool has_w = false;
      if (colon) {
        if (!parse_float_full(p, colon, &lab) ||
            !parse_float_full(colon + 1, te, &w))
          return;  // non-numeric label token: skip line
        has_w = true;
      } else if (!parse_float_full(p, te, &lab)) {
        return;
      }
      h->label.push_back(static_cast<float>(lab));
      h->weight.push_back(static_cast<float>(w));
      h->qid.push_back(0);
      if (has_w) any_weight = true;
    }
    p = te;

    // ---- optional qid token (second token only) ----
    while (p < le && is_blank(*p)) ++p;
    {
      const char* qe = p;
      while (qe < le && !is_blank(*qe)) ++qe;
      if (qe - p >= 4 && memcmp(p, "qid:", 4) == 0) {
        int64_t q = 0;
        if (parse_i64_full(p + 4, qe, &q)) {
          h->qid.back() = q;
        }  // garbage qid -> 0, keep parsing (reference atoll)
        any_qid = true;
        p = qe;
      }
    }

    // ---- feature tokens: fused scan+parse; anything unusual (signs,
    // exponents, inf/nan, >15-digit mantissas, malformed) falls back to
    // the exact token-level helpers so semantics stay identical ----
    while (p < le) {
      while (p < le && is_blank(*p)) ++p;
      if (p >= le) break;
      // fused scan+parse: each fast-path char is visited exactly once
      const char* q = p;
      uint64_t feat = 0;
      int fd = 0;
      while (q < le && *q >= '0' && *q <= '9' && fd <= 18) {
        feat = feat * 10 + static_cast<uint64_t>(*q - '0');
        ++q;
        ++fd;
      }
      if (fd > 0 && fd <= 18) {
        if (q >= le || is_blank(*q)) {
          // bare integer feature (binary, value 1)
          h->index.push_back(feat);
          h->value.push_back(1.0f);
          if (static_cast<int64_t>(feat) < min_feat)
            min_feat = static_cast<int64_t>(feat);
          p = q;
          continue;
        }
        if (*q == ':') {
          ++q;
          double v;
          if (scan_decimal_value(&q, le, &v)) {
            h->index.push_back(feat);
            h->value.push_back(static_cast<float>(v));
            any_value = true;
            if (static_cast<int64_t>(feat) < min_feat)
              min_feat = static_cast<int64_t>(feat);
            p = q;
            continue;
          }
        }
      }
      // slow path: exact token-level parse over the full token
      te = p;
      while (te < le && !is_blank(*te)) ++te;
      const char* colon =
          static_cast<const char*>(memchr(p, ':', static_cast<size_t>(te - p)));
      int64_t sfeat;
      if (colon) {
        double v;
        if (parse_i64_full(p, colon, &sfeat) &&
            parse_float_full(colon + 1, te, &v)) {
          h->index.push_back(static_cast<uint64_t>(sfeat));
          h->value.push_back(static_cast<float>(v));
          any_value = true;
          if (sfeat < min_feat) min_feat = sfeat;
        }
      } else if (parse_i64_full(p, te, &sfeat)) {
        h->index.push_back(static_cast<uint64_t>(sfeat));
        h->value.push_back(1.0f);
        if (sfeat < min_feat) min_feat = sfeat;
      }
      p = te;
    }
    h->offset.push_back(static_cast<int64_t>(h->index.size()));
  });
  if (indexing_mode > 0 ||
      (indexing_mode < 0 && !h->index.empty() && min_feat > 0)) {
    for (auto& i : h->index) --i;
  }
  h->res.has_weight = any_weight ? 1 : 0;
  h->res.has_qid = any_qid ? 1 : 0;
  h->res.has_value = any_value ? 1 : 0;
  h->res.has_field = 0;
  return finish(h);
}

// -- csv ---------------------------------------------------------------------

DMLC_API ParseResult* dmlc_parse_csv(const char* buf, int64_t len,
                                       int32_t delimiter, int32_t label_column,
                                       int32_t weight_column) {
  Holder* h = new Holder();
  h->offset.push_back(0);
  bool any_weight = false;
  const char delim = static_cast<char>(delimiter);
  bool failed = false;
  for_each_line(buf, buf + len, [&](Line ln) {
    if (failed || ln.b == ln.e) return;
    const char* p = ln.b;
    int col = 0;
    int64_t k = 0;
    float lab = 0.0f;
    float w = 1.0f;
    bool saw_weight = false;
    while (p <= ln.e) {
      const char* ce = static_cast<const char*>(
          memchr(p, delim, static_cast<size_t>(ln.e - p)));
      if (!ce) ce = ln.e;
      double v = parse_float_prefix(p, ce);
      if (col == label_column) {
        lab = static_cast<float>(v);
      } else if (col == weight_column) {
        w = static_cast<float>(v);
        saw_weight = true;
      } else {
        h->value.push_back(static_cast<float>(v));
        h->index.push_back(static_cast<uint64_t>(k++));
      }
      ++col;
      if (ce == ln.e) break;
      p = ce + 1;
    }
    if (k == 0) {
      h->error_msg = "Delimiter not found in the line. Expected it to separate fields.";
      failed = true;
      return;
    }
    h->label.push_back(lab);
    h->weight.push_back(w);
    if (saw_weight) any_weight = true;
    h->offset.push_back(static_cast<int64_t>(h->index.size()));
  });
  h->res.has_weight = any_weight ? 1 : 0;
  h->res.has_value = 1;
  h->res.has_qid = 0;
  h->res.has_field = 0;
  return finish(h);
}

// -- libfm -------------------------------------------------------------------

DMLC_API ParseResult* dmlc_parse_libfm(const char* buf, int64_t len,
                                         int32_t indexing_mode) {
  Holder* h = new Holder();
  h->offset.push_back(0);
  bool any_weight = false, any_value = false;
  int64_t min_feat = INT64_MAX, min_field = INT64_MAX;
  for_each_line(buf, buf + len, [&](Line ln) {
    bool first = true;
    bool row_open = false;
    for_each_token(ln.b, ln.e, [&](const char* tb, const char* te) {
      if (first) {
        first = false;
        const char* colon =
            static_cast<const char*>(memchr(tb, ':', static_cast<size_t>(te - tb)));
        double lab, w = 1.0;
        bool has_w = false;
        if (colon) {
          if (!parse_float_full(tb, colon, &lab) ||
              !parse_float_full(colon + 1, te, &w))
            return false;
          has_w = true;
        } else if (!parse_float_full(tb, te, &lab)) {
          return false;
        }
        h->label.push_back(static_cast<float>(lab));
        h->weight.push_back(static_cast<float>(w));
        if (has_w) any_weight = true;
        row_open = true;
        return true;
      }
      const char* c1 =
          static_cast<const char*>(memchr(tb, ':', static_cast<size_t>(te - tb)));
      if (!c1) return true;  // fewer than two numbers: skip token
      const char* c2 = static_cast<const char*>(
          memchr(c1 + 1, ':', static_cast<size_t>(te - c1 - 1)));
      int64_t fid, feat;
      if (!parse_i64_full(tb, c1, &fid)) return true;
      if (c2) {
        double v;
        if (!parse_i64_full(c1 + 1, c2, &feat) ||
            !parse_float_full(c2 + 1, te, &v))
          return true;
        h->value.push_back(static_cast<float>(v));
        any_value = true;
      } else {
        if (!parse_i64_full(c1 + 1, te, &feat)) return true;
        h->value.push_back(1.0f);
      }
      h->field.push_back(fid);
      h->index.push_back(static_cast<uint64_t>(feat));
      if (feat < min_feat) min_feat = feat;
      if (fid < min_field) min_field = fid;
      return true;
    });
    if (row_open) h->offset.push_back(static_cast<int64_t>(h->index.size()));
  });
  if (indexing_mode > 0 || (indexing_mode < 0 && !h->index.empty() &&
                            min_feat > 0 && min_field > 0)) {
    for (auto& i : h->index) --i;
    for (auto& f : h->field) --f;
  }
  h->res.has_weight = any_weight ? 1 : 0;
  h->res.has_value = any_value ? 1 : 0;
  h->res.has_field = 1;
  h->res.has_qid = 0;
  return finish(h);
}

DMLC_API void dmlc_free_result(ParseResult* r) {
  delete reinterpret_cast<Holder*>(r);
}



// -- fused libsvm -> fixed-shape dense batch ---------------------------------
//
// The TPU-specific hot path (SURVEY §7 step 4/5): parses libsvm text straight
// into a caller-provided dense [capacity, D] batch buffer (float32 or
// float16), labels and weights included — no CSR materialization, no
// intermediate copies, no per-row Python. The caller owns a ring of reusable
// batch buffers (reference recycle-cell discipline, threadediter.h:155-172)
// and calls this repeatedly with (row_start, remaining chunk bytes); the
// kernel stops at buffer-full or chunk-end and reports bytes consumed so the
// next call resumes mid-chunk.
//
// Semantics match dmlc_parse_libsvm + FixedShapeBatcher(dense) composed
// (parity enforced by tests/test_torch_fused.py): line skipped iff its label token
// fails to parse; '#' starts a comment; first token may be label:weight; a
// second token 'qid:N' is consumed and discarded (dense batches carry no
// qid); features with (index - base) outside [0, D) are counted in
// `truncated` and dropped; duplicate in-range indices accumulate.

namespace {

// float32 -> float16 bits (IEEE 754 half, round-to-nearest-even)
inline uint16_t f32_to_f16(float f) {
#if defined(__F16C__)
  return static_cast<uint16_t>(
      _cvtss_sh(f, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC));
#else
  uint32_t x;
  std::memcpy(&x, &f, 4);
  const uint32_t sign = (x >> 16) & 0x8000u;
  x &= 0x7fffffffu;
  if (x > 0x7f800000u) return static_cast<uint16_t>(sign | 0x7e00u);  // nan
  if (x >= 0x47800000u) return static_cast<uint16_t>(sign | 0x7c00u);
  if (x < 0x38800000u) {  // subnormal half (or zero)
    // half = RNE(mant24 * 2^(e-126)); values <= 2^-25 round to 0
    if (x <= 0x33000000u) return static_cast<uint16_t>(sign);
    const int e = static_cast<int>(x >> 23);
    const int shift = 126 - e;  // in [14, 24]
    const uint32_t mant = (x & 0x7fffffu) | 0x800000u;
    uint32_t q = mant >> shift;
    const uint32_t rem = mant & ((1u << shift) - 1u);
    const uint32_t halfbit = 1u << (shift - 1);
    if (rem > halfbit || (rem == halfbit && (q & 1u))) ++q;
    return static_cast<uint16_t>(sign | q);
  }
  // normal: rebias exponent, round the 13 dropped mantissa bits (RNE);
  // a mantissa carry correctly bumps the exponent, incl. 65520 -> inf
  uint32_t half = (x - 0x38000000u) >> 13;
  const uint32_t drop = x & 0x1fffu;
  if (drop > 0x1000u || (drop == 0x1000u && (half & 1u))) ++half;
  return static_cast<uint16_t>(sign | half);
#endif
}

struct DenseState {
  void* x;         // [capacity, D] f32 or f16
  float* labels;   // [capacity]
  float* weights;  // [capacity]
  float* scratch;  // [D] f32 accumulation row (L1-resident)
  int64_t D;
  bool f16;
  int64_t base;  // subtract from parsed feature index (0 or 1)
  int64_t truncated;
};

// Features accumulate into the f32 scratch row; the completed row is then
// converted/copied into the output in one vectorized pass. (For f16 output
// this means duplicate feature ids accumulate at f32 precision with a
// single final round — at least as accurate as numpy's per-step f16
// add.at, identical whenever a row has no duplicate ids.)
inline void row_flush(DenseState& st, int64_t row) {
  if (st.f16) {
    uint16_t* dst = static_cast<uint16_t*>(st.x) + row * st.D;
    int64_t i = 0;
#if defined(__F16C__) && defined(__AVX__)
    for (; i + 8 <= st.D; i += 8) {
      const __m256 v = _mm256_loadu_ps(st.scratch + i);
      _mm_storeu_si128(
          reinterpret_cast<__m128i*>(dst + i),
          _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC));
    }
#endif
    for (; i < st.D; ++i) dst[i] = f32_to_f16(st.scratch[i]);
  } else {
    std::memcpy(static_cast<float*>(st.x) + row * st.D, st.scratch,
                static_cast<size_t>(st.D) * 4);
  }
}

// Parse one libsvm line into dense row `row`. Returns true iff the line
// produced a row (valid label). Zeroes the row before writing.
inline bool parse_dense_line(const char* lb, const char* le, DenseState& st,
                             int64_t row) {
  const void* hash = memchr(lb, '#', static_cast<size_t>(le - lb));
  if (hash) le = static_cast<const char*>(hash);

  // ---- label token ----
  const char* p = lb;
  while (p < le && is_blank(*p)) ++p;
  if (p >= le) return false;
  const char* te = p;
  while (te < le && !is_blank(*te)) ++te;
  {
    const char* colon =
        static_cast<const char*>(memchr(p, ':', static_cast<size_t>(te - p)));
    double lab, w = 1.0;
    if (colon) {
      if (!parse_float_full(p, colon, &lab) ||
          !parse_float_full(colon + 1, te, &w))
        return false;
    } else if (!parse_float_full(p, te, &lab)) {
      return false;
    }
    st.labels[row] = static_cast<float>(lab);
    st.weights[row] = static_cast<float>(w);
  }
  p = te;

  // row accepted: features accumulate in the zeroed scratch row, flushed
  // to the (possibly dirty, ring-reused) output row at the end
  std::memset(st.scratch, 0, static_cast<size_t>(st.D) * 4);

  // ---- optional qid token (second token only; consumed, not stored) ----
  while (p < le && is_blank(*p)) ++p;
  {
    const char* qe = p;
    while (qe < le && !is_blank(*qe)) ++qe;
    if (qe - p >= 4 && memcmp(p, "qid:", 4) == 0) p = qe;
  }

  // ---- feature tokens: same fused fast path as dmlc_parse_libsvm ----
  const uint64_t ubase = static_cast<uint64_t>(st.base);
  const uint64_t uD = static_cast<uint64_t>(st.D);
  while (p < le) {
    while (p < le && is_blank(*p)) ++p;
    if (p >= le) break;
    const char* q = p;
    uint64_t feat = 0;
    int fd = 0;
    while (q < le && *q >= '0' && *q <= '9' && fd <= 18) {
      feat = feat * 10 + static_cast<uint64_t>(*q - '0');
      ++q;
      ++fd;
    }
    if (fd > 0 && fd <= 18) {
      if (q >= le || is_blank(*q)) {
        // bare integer feature (binary, value 1)
        const uint64_t col = feat - ubase;  // wraps huge if feat < base
        if (col < uD) {
          st.scratch[col] += 1.0f;
        } else {
          ++st.truncated;
        }
        p = q;
        continue;
      }
      if (*q == ':') {
        ++q;
        double v;
        if (scan_decimal_value(&q, le, &v)) {
          const uint64_t col = feat - ubase;
          if (col < uD) {
            st.scratch[col] += static_cast<float>(v);
          } else {
            ++st.truncated;
          }
          p = q;
          continue;
        }
      }
    }
    // slow path: exact token-level parse over the full token
    te = p;
    while (te < le && !is_blank(*te)) ++te;
    const char* colon =
        static_cast<const char*>(memchr(p, ':', static_cast<size_t>(te - p)));
    int64_t sfeat;
    if (colon) {
      double v;
      if (parse_i64_full(p, colon, &sfeat) &&
          parse_float_full(colon + 1, te, &v)) {
        const uint64_t col = static_cast<uint64_t>(sfeat) - ubase;
        if (col < uD) {
          st.scratch[col] += static_cast<float>(v);
        } else {
          ++st.truncated;
        }
      }
    } else if (parse_i64_full(p, te, &sfeat)) {
      const uint64_t col = static_cast<uint64_t>(sfeat) - ubase;
      if (col < uD) {
        st.scratch[col] += 1.0f;
      } else {
        ++st.truncated;
      }
    }
    p = te;
  }
  row_flush(st, row);
  return true;
}

// Out-params mirror _DenseResult in dmlc_core_tpu_torch/data/native.py.
struct DenseResult {
  int64_t rows_written;
  int64_t bytes_consumed;
  int64_t truncated;
  int64_t has_cr;  // echo of the '\r' probe so callers can cache it
};

// Resumable line walk shared by the fused text->dense kernels: calls
// fn(line_begin, line_end, row) per line (Python splitlines semantics:
// '\n', '\r', "\r\n"), stopping at buffer-full or chunk-end. Returns the
// cached/probed has_cr and fills rows_written/bytes_consumed.
template <typename LineFn>
bool walk_dense_lines(const char* buf, int64_t len, int64_t row_start,
                      int64_t row_capacity, int32_t cr_hint,
                      DenseResult* out, LineFn&& fn) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = row_start;
  // one SIMD scan (per chunk, cached by the caller via the hint) decides
  // whether per-line '\r' handling is needed at all
  const bool has_cr =
      cr_hint < 0 ? memchr(buf, '\r', static_cast<size_t>(len)) != nullptr
                  : cr_hint != 0;
  while (p < end && row < row_capacity) {
    // memchr keeps the scan SIMD-fast on the common '\n'-only data
    const char* nl =
        static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* seg_end = nl ? nl : end;
    const char* cr =
        has_cr ? static_cast<const char*>(
                     memchr(p, '\r', static_cast<size_t>(seg_end - p)))
               : nullptr;
    const char* line_end;
    const char* next;
    if (cr) {
      line_end = cr;
      next = (cr + 1 == nl) ? nl + 1 : cr + 1;
    } else {
      line_end = seg_end;
      next = nl ? nl + 1 : end;
    }
    if (fn(p, line_end, row)) ++row;
    p = next;
  }
  out->rows_written = row - row_start;
  out->bytes_consumed = p - buf;
  return has_cr;
}

}  // namespace

// cr_hint: -1 = unknown (probe the remaining buffer once — callers cache
// the echoed result across resumed calls on the same chunk), 0 = no '\r'
// anywhere in the chunk, 1 = may contain '\r'.
DMLC_API void dmlc_parse_libsvm_dense(
    const char* buf, int64_t len, int32_t base, int64_t num_features,
    int32_t out_f16, void* x, float* labels, float* weights,
    int64_t row_start, int64_t row_capacity, int32_t cr_hint,
    DenseResult* out) {
  std::vector<float> scratch(static_cast<size_t>(num_features));
  DenseState st{x,
                labels,
                weights,
                scratch.data(),
                num_features,
                out_f16 != 0,
                static_cast<int64_t>(base),
                0};
  const bool has_cr = walk_dense_lines(
      buf, len, row_start, row_capacity, cr_hint, out,
      [&](const char* lb, const char* le, int64_t row) {
        return parse_dense_line(lb, le, st, row);
      });
  out->truncated = st.truncated;
  out->has_cr = has_cr ? 1 : 0;
}

// -- csv -> fixed-shape dense batch -------------------------------------------
//
// Same resumable chunk contract as dmlc_parse_libsvm_dense; semantics match
// CSVParser + FixedShapeBatcher('dense') composed (reference
// src/data/csv_parser.h:98-111): longest-prefix float parsing per cell
// (strtof semantics, 0.0 on junk), label/weight columns lifted out, the
// k-th remaining column scatters to feature k (truncated + counted when
// k >= D). A non-empty line with no delimiter is a malformed-file error
// (counted in bad_lines; the Python wrapper raises, like the generic
// parser's "Delimiter not found" error).

struct CsvDenseResult {
  int64_t rows_written;
  int64_t bytes_consumed;
  int64_t truncated;
  int64_t has_cr;
  int64_t bad_lines;
};

namespace {

// One csv line into dense row `row` (the rules above); false for a line
// that gives no row: an empty one, or one whose cells all went to the
// label or weight column (counted in `bad`).
struct CsvDenseLine {
  DenseState st;
  char delim;
  int32_t label_column;
  int32_t weight_column;
  int64_t bad;

  bool operator()(const char* lb, const char* le, int64_t row) {
    if (lb == le) return false;  // empty line: skipped, no row
    std::memset(st.scratch, 0, static_cast<size_t>(st.D) * 4);
    const char* p = lb;
    int col = 0;
    int64_t k = 0;
    float lab = 0.0f, w = 1.0f;
    while (p <= le) {
      const char* ce = static_cast<const char*>(
          memchr(p, delim, static_cast<size_t>(le - p)));
      if (!ce) ce = le;
      const double v = parse_float_prefix(p, ce);
      if (col == label_column) {
        lab = static_cast<float>(v);
      } else if (col == weight_column) {
        w = static_cast<float>(v);
      } else {
        if (k < st.D) {
          st.scratch[k] = static_cast<float>(v);
        } else {
          ++st.truncated;
        }
        ++k;
      }
      ++col;
      if (ce == le) break;
      p = ce + 1;
    }
    if (k == 0) {
      ++bad;
      return false;
    }
    st.labels[row] = lab;
    st.weights[row] = w;
    row_flush(st, row);
    return true;
  }
};

}  // namespace

DMLC_API void dmlc_parse_csv_dense(
    const char* buf, int64_t len, int32_t delimiter, int32_t label_column,
    int32_t weight_column, int64_t num_features, int32_t out_f16, void* x,
    float* labels, float* weights, int64_t row_start, int64_t row_capacity,
    int32_t cr_hint, CsvDenseResult* out) {
  std::vector<float> scratch(static_cast<size_t>(num_features));
  CsvDenseLine line{{x, labels, weights, scratch.data(), num_features,
                     out_f16 != 0, 0, 0},
                    static_cast<char>(delimiter), label_column, weight_column,
                    0};
  DenseResult inner{};
  const bool has_cr = walk_dense_lines(buf, len, row_start, row_capacity,
                                       cr_hint, &inner, line);
  out->rows_written = inner.rows_written;
  out->bytes_consumed = inner.bytes_consumed;
  out->truncated = line.st.truncated;
  out->has_cr = has_cr ? 1 : 0;
  out->bad_lines = line.bad;
}

namespace {

// Runs fn(w) for every w in [0, n): on n - 1 new threads and the calling
// thread, then joins them. A thread that cannot be made leaves its w to
// the calling thread.
template <typename Fn>
void fork_join(int64_t n, Fn&& fn) {
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(std::max<int64_t>(0, n - 1)));
  int64_t w = 1;
  for (; w < n; ++w) {
    try {
      threads.emplace_back(fn, w);
    } catch (const std::system_error&) {
      break;
    }
  }
  for (; w < n; ++w) fn(w);
  fn(0);
  for (auto& t : threads) t.join();
}

}  // namespace

// The same call with its rows split over up to `workers` threads, each
// row written where the one-thread walk puts it, so every count and every
// byte of rows [row_start, row_capacity) equals dmlc_parse_csv_dense's.
// The '\r' probe, when the caller has no hint, runs over `workers` pieces
// of the buffer at once; one pass of walk_dense_lines then finds the
// lines that can become rows, and `n` threads parse them in blocks of
// rows taken in turn, each thread with its own scratch row.
// A call with room for fewer than 2 * min_rows rows goes to the one-thread
// walk; one that finds fewer lines parses them on the calling thread.
// min_rows is SPLIT_MIN_ROWS in data/native.py; tests lower it to split
// small inputs. A line that gives no row shifts every later one, so a
// call that meets one is parsed again by the one-thread walk: then the
// counts and rows [row_start, row_start + rows_written) equal the
// one-thread call's, and the slots after them may hold rows the split
// wrote one place late.
struct CsvSplitResult {
  CsvDenseResult csv;
  int64_t workers;  // threads that parsed the rows (1: not split)
};

DMLC_API void dmlc_parse_csv_dense_split(
    const char* buf, int64_t len, int32_t delimiter, int32_t label_column,
    int32_t weight_column, int64_t num_features, int32_t out_f16, void* x,
    float* labels, float* weights, int64_t row_start, int64_t row_capacity,
    int32_t cr_hint, int32_t workers, int64_t min_rows, CsvSplitResult* out) {
  out->workers = 1;
  const int64_t floor_rows = std::max<int64_t>(1, min_rows);
  if (workers <= 1 || row_capacity - row_start < 2 * floor_rows) {
    dmlc_parse_csv_dense(buf, len, delimiter, label_column, weight_column,
                         num_features, out_f16, x, labels, weights, row_start,
                         row_capacity, cr_hint, &out->csv);
    return;
  }
  if (cr_hint < 0) {
    std::vector<char> found(static_cast<size_t>(workers));
    fork_join(workers, [&](int64_t w) {
      const int64_t lo = len * w / workers, hi = len * (w + 1) / workers;
      found[w] = memchr(buf + lo, '\r', static_cast<size_t>(hi - lo)) != nullptr;
    });
    cr_hint = std::find(found.begin(), found.end(), 1) != found.end() ? 1 : 0;
  }
  std::vector<Line> lines;
  lines.reserve(static_cast<size_t>(
      std::min<int64_t>(row_capacity - row_start, len / 2 + 1)));
  DenseResult inner{};
  const bool has_cr = walk_dense_lines(
      buf, len, row_start, row_capacity, cr_hint, &inner,
      [&](const char* lb, const char* le, int64_t) {
        if (lb == le) return false;  // the empty lines CsvDenseLine skips
        lines.push_back(Line{lb, le});
        return true;
      });
  const int64_t n_lines = static_cast<int64_t>(lines.size());
  const int64_t n = std::max<int64_t>(
      1, std::min<int64_t>(workers, n_lines / floor_rows));
  // blocks of rows taken in turn: a thread slowed by the others on the
  // host takes fewer of them
  const int64_t block = std::max<int64_t>(1, n_lines / (8 * n));
  std::atomic<int64_t> next{0};
  std::vector<int64_t> truncated(static_cast<size_t>(n));
  std::vector<int64_t> bad(static_cast<size_t>(n));
  fork_join(n, [&](int64_t w) {
    std::vector<float> scratch(static_cast<size_t>(num_features));
    CsvDenseLine line{{x, labels, weights, scratch.data(), num_features,
                       out_f16 != 0, 0, 0},
                      static_cast<char>(delimiter), label_column,
                      weight_column, 0};
    for (int64_t lo; (lo = next.fetch_add(block)) < n_lines;) {
      const int64_t hi = std::min(n_lines, lo + block);
      for (int64_t i = lo; i < hi; ++i)
        line(lines[i].b, lines[i].e, row_start + i);
    }
    truncated[w] = line.st.truncated;
    bad[w] = line.bad;
  });
  int64_t trunc_sum = 0, bad_sum = 0;
  for (int64_t i = 0; i < n; ++i) {
    trunc_sum += truncated[i];
    bad_sum += bad[i];
  }
  if (bad_sum) {
    dmlc_parse_csv_dense(buf, len, delimiter, label_column, weight_column,
                         num_features, out_f16, x, labels, weights, row_start,
                         row_capacity, has_cr ? 1 : 0, &out->csv);
    return;
  }
  out->csv.rows_written = inner.rows_written;
  out->csv.bytes_consumed = inner.bytes_consumed;
  out->csv.truncated = trunc_sum;
  out->csv.has_cr = has_cr ? 1 : 0;
  out->csv.bad_lines = 0;
  out->workers = n;
}

// -- RecordIO frame scan + fused rowrec -> ELL batch --------------------------
//
// RecordIO frame (bit-compatible with reference include/dmlc/recordio.h:16-45):
//   [kMagic u32][lrec u32][payload][pad to 4B]   lrec = cflag<<29 | len
// cflag: 0 complete, 1 start, 2 middle, 3 end of a multi-part chain (the
// writer splits a record at aligned in-payload magic words; the elided magic
// is re-inserted between parts on read, reference src/recordio.cc:53-82).
//
// Payload ("rowrec" sparse-row wire format, data/rowrec.py):
//   label f32 | weight f32 | nnz u32 | indices u32[nnz] | values f32[nnz]
//
// The kernel consumes complete records from an arbitrary byte window and
// stops at buffer-full or at a trailing partial record/chain (reporting
// bytes consumed up to the chain start), so callers can hand it raw
// byte-ranges without any boundary pre-scan.

namespace {

constexpr uint32_t kRecMagic = 0xced7230au;  // reference recordio.h:43

inline uint32_t load_u32(const char* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // host is little-endian (x86/ARM TPU hosts); format is LE
}

inline float load_f32(const char* p) {
  float v;
  std::memcpy(&v, p, 4);
  return v;
}

struct EllState {
  int32_t* indices;  // [capacity, K]
  void* values;      // [capacity, K] f32 or f16
  int32_t* nnz;      // [capacity]
  float* labels;     // [capacity]
  float* weights;    // [capacity]
  int64_t K;
  bool f16;
  int64_t truncated;
};

// Per-row ELL writer shared by the text->ELL kernels (libsvm/libfm): the
// store/truncate/finish rules must stay bit-identical across kernels —
// they mirror FixedShapeBatcher._to_ell (staging/batcher.py) — so they
// live here once instead of drifting per kernel.
struct EllRowWriter {
  EllState& st;
  int32_t* irow;
  uint16_t* vrow16;
  float* vrow32;
  uint64_t ubase;
  int64_t k = 0;     // parsed-feature position within the row
  int64_t kept = 0;  // features stored with a valid id

  EllRowWriter(EllState& s, int64_t row, uint64_t base)
      : st(s),
        irow(s.indices + row * s.K),
        vrow16(s.f16 ? static_cast<uint16_t*>(s.values) + row * s.K
                     : nullptr),
        vrow32(s.f16 ? nullptr
                     : static_cast<float*>(s.values) + row * s.K),
        ubase(base) {}

  // first K parsed features keep token positions; ids outside int32
  // after base subtraction (incl. 1-based wraparound of id 0) are
  // zeroed in place + counted truncated; features beyond K dropped
  // + counted
  inline void store(int64_t feat, double v) {
    if (k < st.K) {
      const uint64_t col = static_cast<uint64_t>(feat) - ubase;
      if (col > 0x7fffffffu) {
        irow[k] = 0;
        if (st.f16) vrow16[k] = 0; else vrow32[k] = 0.0f;
        ++st.truncated;
      } else {
        irow[k] = static_cast<int32_t>(col);
        if (st.f16) vrow16[k] = f32_to_f16(static_cast<float>(v));
        else vrow32[k] = static_cast<float>(v);
        ++kept;
      }
    } else {
      ++st.truncated;
    }
    ++k;
  }

  // zero the unparsed tail and commit nnz = kept (holes stay positional)
  inline void finish(int64_t row) {
    const int64_t filled = k < st.K ? k : st.K;
    std::memset(irow + filled, 0, static_cast<size_t>(st.K - filled) * 4);
    if (st.f16) {
      std::memset(vrow16 + filled, 0,
                  static_cast<size_t>(st.K - filled) * 2);
    } else {
      std::memset(vrow32 + filled, 0,
                  static_cast<size_t>(st.K - filled) * 4);
    }
    st.nnz[row] = static_cast<int32_t>(kept);
  }
};

// Shared first-token scan: label or label:weight. Returns false (line
// skipped) when the label token fails to parse; advances *pp past it.
inline bool parse_label_token(const char** pp, const char* le, EllState& st,
                              int64_t row) {
  const char* p = *pp;
  while (p < le && is_blank(*p)) ++p;
  if (p >= le) return false;
  const char* te = p;
  while (te < le && !is_blank(*te)) ++te;
  const char* colon =
      static_cast<const char*>(memchr(p, ':', static_cast<size_t>(te - p)));
  double lab, w = 1.0;
  if (colon) {
    if (!parse_float_full(p, colon, &lab) ||
        !parse_float_full(colon + 1, te, &w))
      return false;
  } else if (!parse_float_full(p, te, &lab)) {
    return false;
  }
  st.labels[row] = static_cast<float>(lab);
  st.weights[row] = static_cast<float>(w);
  *pp = te;
  return true;
}

// f32 row -> f16 row (RNE), 8-wide where F16C is available.
inline void f32row_to_f16(const char* src, uint16_t* dst, int64_t n) {
  int64_t i = 0;
#if defined(__F16C__) && defined(__AVX__)
  for (; i + 8 <= n; i += 8) {
    const __m256 v =
        _mm256_loadu_ps(reinterpret_cast<const float*>(src) + i);
    _mm_storeu_si128(
        reinterpret_cast<__m128i*>(dst + i),
        _mm256_cvtps_ph(v, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC));
  }
#endif
  for (; i < n; ++i) dst[i] = f32_to_f16(load_f32(src + i * 4));
}

// Decode one rowrec payload into ELL row `row`. Returns false on a
// malformed payload (declared sizes exceed the payload).
inline bool rowrec_to_ell(const char* p, int64_t len, EllState& st,
                          int64_t row) {
  if (len < 12) return false;
  const uint32_t n = load_u32(p + 8);
  if (len < 12 + static_cast<int64_t>(n) * 8) return false;
  st.labels[row] = load_f32(p);
  st.weights[row] = load_f32(p + 4);
  const char* idx = p + 12;
  const char* val = idx + static_cast<int64_t>(n) * 4;
  // semantics match FixedShapeBatcher._to_ell (staging/batcher.py): the
  // first K positions are kept; within them, ids that don't fit the
  // device index dtype (int32) are zeroed in place and counted truncated
  // (never cast-aliased to negative); beyond-K features are dropped.
  const int64_t keep = std::min<int64_t>(n, st.K);
  st.truncated += static_cast<int64_t>(n) - keep;
  int32_t* irow = st.indices + row * st.K;
  // bulk copy then scan for unfit ids (sign bit set after the uint32
  // reinterpret) — the no-bad-id case, i.e. every real dataset, stays a
  // memcpy plus one vectorizable scan instead of a branch per feature
  std::memcpy(irow, idx, static_cast<size_t>(keep) * 4);
  std::memset(irow + keep, 0, static_cast<size_t>(st.K - keep) * 4);
  bool any_bad = false;
  for (int64_t i = 0; i < keep; ++i) {
    if (irow[i] < 0) {
      any_bad = true;
      break;
    }
  }
  int64_t kept = keep;
  if (any_bad) {
    kept = 0;
    for (int64_t i = 0; i < keep; ++i) {
      if (irow[i] < 0) {
        irow[i] = 0;
        ++st.truncated;
      } else {
        ++kept;
      }
    }
  }
  if (st.f16) {
    uint16_t* vrow = static_cast<uint16_t*>(st.values) + row * st.K;
    f32row_to_f16(val, vrow, keep);
    std::memset(vrow + keep, 0, static_cast<size_t>(st.K - keep) * 2);
    if (any_bad) {
      for (int64_t i = 0; i < keep; ++i) {
        if (load_u32(idx + i * 4) > 0x7fffffffu) vrow[i] = 0;
      }
    }
  } else {
    float* vrow = static_cast<float*>(st.values) + row * st.K;
    std::memcpy(vrow, val, static_cast<size_t>(keep) * 4);
    if (any_bad) {
      for (int64_t i = 0; i < keep; ++i) {
        if (load_u32(idx + i * 4) > 0x7fffffffu) vrow[i] = 0.0f;
      }
    }
    std::memset(vrow + keep, 0, static_cast<size_t>(st.K - keep) * 4);
  }
  st.nnz[row] = static_cast<int32_t>(kept);
  return true;
}

// Walk ONE logical record (a standalone frame or a multi-part chain)
// starting at *pp within [*pp, end). On success advances *pp past it and
// sets payload/plen (chains reassembled into `chain` with the elided
// magic re-inserted, reference recordio.cc:63-77). Returns 1 complete,
// 0 incomplete (partial header/payload hits `end` — trailing partial,
// not an error), -1 corrupt (a full header is in view but carries no
// magic: the stream is broken HERE, callers fail fast). Kept apart
// from the chunk kernel so a gather kernel can share the frame
// semantics.
inline int walk_one_record(const char** pp, const char* end,
                           std::vector<char>& chain, const char** payload,
                           int64_t* plen) {
  const char* p = *pp;
  chain.clear();
  bool in_chain = false;
  while (true) {
    if (end - p < 8) return 0;  // partial header
    if (load_u32(p) != kRecMagic) return -1;
    const uint32_t lrec = load_u32(p + 4);
    const uint32_t cflag = (lrec >> 29) & 7u;
    const int64_t pl = static_cast<int64_t>(lrec & ((1u << 29) - 1u));
    const int64_t upper = (pl + 3) & ~int64_t{3};
    if (end - p < 8 + upper) return 0;  // partial payload
    const char* data = p + 8;
    p += 8 + upper;
    if (cflag == 0) {
      // complete standalone record; if a chain was pending this abandons
      // it, matching RecordIOChunkReader.next_record (io/recordio.py)
      *payload = data;
      *plen = pl;
      *pp = p;
      return 1;
    }
    // multi-part chain: parts are joined with the elided magic word
    // re-inserted between them
    if (in_chain) {
      const char m[4] = {'\x0a', '\x23', '\xd7', '\xce'};  // LE kRecMagic
      chain.insert(chain.end(), m, m + 4);
    }
    chain.insert(chain.end(), data, data + pl);
    in_chain = true;
    if (cflag == 3) {
      *payload = chain.data();
      *plen = static_cast<int64_t>(chain.size());
      *pp = p;
      return 1;
    }
    // cflag 1 or 2: chain continues with the next frame
  }
}

}  // namespace

struct EllResult {
  int64_t rows_written;
  int64_t bytes_consumed;
  int64_t truncated;
  int64_t bad_records;  // malformed payloads skipped
  int64_t corrupt;      // bad magic with a full header available: the
                        // stream is broken HERE, not merely truncated —
                        // callers fail fast instead of carrying the rest
                        // of the shard hoping a later window completes it
};

DMLC_API void dmlc_parse_rowrec_ell(
    const char* buf, int64_t len, int64_t max_nnz, int32_t out_f16,
    int32_t* indices, void* values, int32_t* nnz, float* labels,
    float* weights, int64_t row_start, int64_t row_capacity,
    EllResult* out) {
  EllState st{indices, values, nnz, labels, weights, max_nnz, out_f16 != 0, 0};
  int64_t row = row_start;
  int64_t bad = 0;
  bool corrupt = false;
  const char* p = buf;
  const char* end = buf + len;
  std::vector<char> chain;  // reassembly buffer for multi-part records
  const char* consumed_to = buf;
  while (row < row_capacity) {
    const char* rec_start = p;
    const char* payload = nullptr;
    int64_t payload_len = 0;
    const int got = walk_one_record(&p, end, chain, &payload, &payload_len);
    if (got <= 0) {
      if (got < 0) corrupt = true;  // bad magic with a full header: fail fast
      p = rec_start;  // leave the partial chain for the caller's next window
      break;
    }
    if (rowrec_to_ell(payload, payload_len, st, row)) {
      ++row;
    } else {
      ++bad;
    }
    consumed_to = p;
  }
  out->rows_written = row - row_start;
  out->bytes_consumed = consumed_to - buf;
  out->truncated = st.truncated;
  out->bad_records = bad;
  out->corrupt = corrupt ? 1 : 0;
}

// -- shuffled-read gather: (buf, starts, sizes) -> ELL batch ------------------
//
// The shuffled read path: IndexedRecordIOSplitter (io/split.py) hands
// `next_gather_batch` views — one span buffer plus per-record byte
// offsets/lengths IN PERMUTATION ORDER — and this kernel parses every
// record straight out of that buffer into the caller's ring-slot ELL
// batch. One native call per batch, with no per-record Python and no
// re-framing copy, so the shuffled epoch rides the same single-copy
// staging path as sequential reads.
//
// Each (starts[i], sizes[i]) slice must contain one whole logical record
// (a frame or a multi-part chain — the index points at chain starts). A
// slice that doesn't (bad magic OR a record extending past the slice)
// means the index and the data disagree: reported as `corrupt`, and the
// caller fails fast. Malformed rowrec payloads are skipped and counted in
// `bad_records`, exactly like the sequential kernel. Stops at
// buffer-full; `bytes_consumed` carries the number of RECORDS consumed
// (slices, not bytes — the caller resumes at starts[consumed]).

DMLC_API void dmlc_parse_rowrec_gather_ell(
    const char* buf, const int64_t* starts, const int64_t* sizes,
    int64_t n_recs, int64_t max_nnz, int32_t out_f16, int32_t* indices,
    void* values, int32_t* nnz, float* labels, float* weights,
    int64_t row_start, int64_t row_capacity, EllResult* out) {
  EllState st{indices, values, nnz, labels, weights, max_nnz, out_f16 != 0, 0};
  int64_t row = row_start;
  int64_t bad = 0;
  int64_t i = 0;
  bool corrupt = false;
  std::vector<char> chain;
  for (; i < n_recs && row < row_capacity; ++i) {
    const char* p = buf + starts[i];
    const char* end = p + sizes[i];
    const char* payload = nullptr;
    int64_t payload_len = 0;
    if (walk_one_record(&p, end, chain, &payload, &payload_len) <= 0) {
      corrupt = true;  // slice holds no complete record: index mismatch
      break;
    }
    if (rowrec_to_ell(payload, payload_len, st, row)) {
      ++row;
    } else {
      ++bad;
    }
  }
  out->rows_written = row - row_start;
  out->bytes_consumed = i;  // gather contract: records consumed, not bytes
  out->truncated = st.truncated;
  out->bad_records = bad;
  out->corrupt = corrupt ? 1 : 0;
}

// -- batched point-read frame walk: payload spans -----------------------------
//
// The point-read walk: given per-record byte slices of a span buffer — each (starts[i], sizes[i]) must
// begin at a frame head — emit the PAYLOAD span of every single-frame
// record in one native call, no per-record Python. Multi-part chains
// (payloads containing the aligned magic word — rare by construction)
// cannot be expressed as a slice of the input buffer, so they are
// marked out_off = -2 and the caller reassembles those few in Python;
// a slice that does not start at a valid head (index/data mismatch) is
// marked out_off = -1 and counted corrupt — callers fail fast.
DMLC_API void dmlc_walk_record_spans(
    const char* buf, const int64_t* starts, const int64_t* sizes,
    int64_t n, int64_t* out_off, int64_t* out_len,
    int64_t* n_multipart, int64_t* n_corrupt) {
  int64_t nm = 0, nc = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* p = buf + starts[i];
    const int64_t avail = sizes[i];
    out_len[i] = 0;
    if (avail < 8 || load_u32(p) != kRecMagic) {
      out_off[i] = -1;
      ++nc;
      continue;
    }
    const uint32_t lrec = load_u32(p + 4);
    const uint32_t cflag = (lrec >> 29) & 7u;
    const int64_t pl = static_cast<int64_t>(lrec & ((1u << 29) - 1u));
    if (cflag == 0) {  // complete single-frame record: payload in place
      if (avail < 8 + ((pl + 3) & ~int64_t{3})) {
        out_off[i] = -1;  // frame runs past the slice: index mismatch
        ++nc;
        continue;
      }
      out_off[i] = starts[i] + 8;
      out_len[i] = pl;
    } else if (cflag == 1) {  // chain start: Python reassembles
      out_off[i] = -2;
      ++nm;
    } else {  // mid-chain / compressed head at a record start: corrupt
      out_off[i] = -1;
      ++nc;
    }
  }
  *n_multipart = nm;
  *n_corrupt = nc;
}

// -- fused libfm -> fixed-shape ELL batch -------------------------------------
//
// Same resumable text-chunk contract as dmlc_parse_libsvm_dense (line walk,
// cr_hint caching, stop at buffer-full/chunk-end) but ELL output; semantics
// match dmlc_parse_libfm + FixedShapeBatcher('ell') composed (parity
// enforced by tests/test_torch_fused.py):
//   - a line is skipped iff its label token fails to parse
//     (label or label:weight first token);
//   - feature tokens are field:index[:value]; tokens without a ':' or with
//     malformed numbers are skipped (reference libfm_parser.h:67-144
//     tolerant tokenization);
//   - the first max_nnz parsed features keep their token positions; ids
//     that fall outside int32 after base subtraction (incl. 1-based
//     wraparound of id 0) are zeroed in place and counted truncated;
//     features beyond max_nnz are dropped and counted;
//   - fields are parsed (a malformed field skips the token) and then
//     DROPPED: the ELL device layout carries no field axis, exactly like
//     the generic batcher path (staging/batcher.py _to_ell).
// `base` is the resolved indexing base (callers resolve libfm auto mode
// against the file head, as the fused libsvm path does).

DMLC_API void dmlc_parse_libfm_ell(
    const char* buf, int64_t len, int32_t base, int64_t max_nnz,
    int32_t out_f16, int32_t* indices, void* values, int32_t* nnz,
    float* labels, float* weights, int64_t row_start, int64_t row_capacity,
    int32_t cr_hint, DenseResult* out) {
  EllState st{indices, values, nnz, labels, weights, max_nnz, out_f16 != 0, 0};
  const uint64_t ubase = static_cast<uint64_t>(base);
  const bool has_cr = walk_dense_lines(
      buf, len, row_start, row_capacity, cr_hint, out,
      [&](const char* lb, const char* le, int64_t row) {
        const char* p = lb;
        if (!parse_label_token(&p, le, st, row)) return false;

        EllRowWriter w(st, row, ubase);
        const auto store = [&](int64_t feat, double v) { w.store(feat, v); };
        const char* te;
        while (p < le) {
          while (p < le && is_blank(*p)) ++p;
          if (p >= le) break;
          // ---- fast path: fid ':' feat [':' value] in ONE forward pass
          // (the same fused scan style as the libsvm dense kernel) ----
          const char* q = p;
          int fd = 0;
          if (q < le && *q == '-') ++q;
          while (q < le && *q >= '0' && *q <= '9' && fd <= 18) {
            ++q;
            ++fd;  // fid digits: validity only, the value is dropped
          }
          if (fd > 0 && fd <= 18 && q < le && *q == ':') {
            ++q;
            bool gneg = false;
            if (q < le && *q == '-') {
              gneg = true;
              ++q;
            }
            uint64_t feat = 0;
            int gd = 0;
            while (q < le && *q >= '0' && *q <= '9' && gd <= 18) {
              feat = feat * 10 + static_cast<uint64_t>(*q - '0');
              ++q;
              ++gd;
            }
            if (gd > 0 && gd <= 18) {
              const int64_t sfeat =
                  gneg ? -static_cast<int64_t>(feat)
                       : static_cast<int64_t>(feat);
              if (q >= le || is_blank(*q)) {
                store(sfeat, 1.0);  // bare pair fid:feat
                p = q;
                continue;
              }
              if (*q == ':') {
                ++q;
                double v;
                if (scan_decimal_value(&q, le, &v)) {
                  store(sfeat, v);
                  p = q;
                  continue;
                }
              }
            }
          }
          // ---- exact slow path over the full token (rare: exponents,
          // '+' signs, >15-digit values, junk) ----
          te = p;
          while (te < le && !is_blank(*te)) ++te;
          const char* c1 = static_cast<const char*>(
              memchr(p, ':', static_cast<size_t>(te - p)));
          if (c1) {
            const char* c2 = static_cast<const char*>(
                memchr(c1 + 1, ':', static_cast<size_t>(te - c1 - 1)));
            int64_t fid, feat;
            double v = 1.0;
            bool ok = parse_i64_full(p, c1, &fid);
            if (ok) {
              ok = c2 ? (parse_i64_full(c1 + 1, c2, &feat) &&
                         parse_float_full(c2 + 1, te, &v))
                      : parse_i64_full(c1 + 1, te, &feat);
            }
            if (ok) store(feat, v);
          }
          p = te;
        }
        w.finish(row);
        return true;
      });
  out->truncated = st.truncated;
  out->has_cr = has_cr ? 1 : 0;
}

// -- fused libsvm -> fixed-shape ELL batch ------------------------------------
//
// Same resumable text-chunk contract as dmlc_parse_libsvm_dense (line walk,
// cr_hint caching, stop at buffer-full/chunk-end) but ELL output; semantics
// match LibSVMParser + FixedShapeBatcher('ell') composed (parity enforced
// by tests/test_torch_fused.py) — the sparse layout the reference treats as
// the premier text hot path (reference src/data/libsvm_parser.h:86-169):
//   - '#' starts a comment (rest of line ignored);
//   - a line is skipped iff its label token fails to parse
//     (label or label:weight first token);
//   - a second token 'qid:N' is consumed and discarded (the ELL device
//     layout carries no qid, like the dense kernel);
//   - feature tokens are index[:value]; a bare index is value 1.0;
//     malformed tokens are skipped (strtonum tolerant rule);
//   - the first max_nnz parsed features keep their token positions; ids
//     that fall outside int32 after base subtraction (incl. 1-based
//     wraparound of id 0) are zeroed in place and counted truncated;
//     features beyond max_nnz are dropped and counted. Unlike the dense
//     kernel there is no D bound and duplicates stay positional — ELL
//     rows are gathered on device, not accumulated.
// `base` is the resolved indexing base (callers resolve libsvm auto mode
// against the file head, as the fused dense path does).

DMLC_API void dmlc_parse_libsvm_ell(
    const char* buf, int64_t len, int32_t base, int64_t max_nnz,
    int32_t out_f16, int32_t* indices, void* values, int32_t* nnz,
    float* labels, float* weights, int64_t row_start, int64_t row_capacity,
    int32_t cr_hint, DenseResult* out) {
  EllState st{indices, values, nnz, labels, weights, max_nnz, out_f16 != 0, 0};
  const uint64_t ubase = static_cast<uint64_t>(base);
  const bool has_cr = walk_dense_lines(
      buf, len, row_start, row_capacity, cr_hint, out,
      [&](const char* lb, const char* le, int64_t row) {
        const void* hash = memchr(lb, '#', static_cast<size_t>(le - lb));
        if (hash) le = static_cast<const char*>(hash);

        const char* p = lb;
        if (!parse_label_token(&p, le, st, row)) return false;

        // ---- optional qid token (second token only; discarded) ----
        while (p < le && is_blank(*p)) ++p;
        {
          const char* qe = p;
          while (qe < le && !is_blank(*qe)) ++qe;
          if (qe - p >= 4 && memcmp(p, "qid:", 4) == 0) p = qe;
        }

        EllRowWriter w(st, row, ubase);
        const auto store = [&](int64_t feat, double v) { w.store(feat, v); };
        const char* te;
        while (p < le) {
          while (p < le && is_blank(*p)) ++p;
          if (p >= le) break;
          // ---- fast path: digits [':' value] in ONE forward pass ----
          const char* q = p;
          uint64_t feat = 0;
          int fd = 0;
          while (q < le && *q >= '0' && *q <= '9' && fd <= 18) {
            feat = feat * 10 + static_cast<uint64_t>(*q - '0');
            ++q;
            ++fd;
          }
          if (fd > 0 && fd <= 18) {
            if (q >= le || is_blank(*q)) {
              store(static_cast<int64_t>(feat), 1.0);  // bare index
              p = q;
              continue;
            }
            if (*q == ':') {
              ++q;
              double v;
              if (scan_decimal_value(&q, le, &v)) {
                store(static_cast<int64_t>(feat), v);
                p = q;
                continue;
              }
            }
          }
          // ---- exact slow path over the full token (rare: exponents,
          // signs, >18-digit ids, junk) ----
          te = p;
          while (te < le && !is_blank(*te)) ++te;
          const char* colon = static_cast<const char*>(
              memchr(p, ':', static_cast<size_t>(te - p)));
          int64_t sfeat;
          if (colon) {
            double v;
            if (parse_i64_full(p, colon, &sfeat) &&
                parse_float_full(colon + 1, te, &v)) {
              store(sfeat, v);
            }
          } else if (parse_i64_full(p, te, &sfeat)) {
            store(sfeat, 1.0);
          }
          p = te;
        }
        w.finish(row);
        return true;
      });
  out->truncated = st.truncated;
  out->has_cr = has_cr ? 1 : 0;
}

// -- CPython-compatible shuffle ----------------------------------------------
//
// Fisher-Yates over an int64 array, reproducing random.Random.shuffle
// BIT-IDENTICALLY from a CPython Mersenne-Twister state snapshot
// (random.Random.getstate()): same genrand_uint32 stream, same tempering,
// same getrandbits(k)=top-k-bits rule, same rejection loop, same swap
// order. The shuffled-read permutation contract pins epoch order to
// random.Random(seed', epoch'); this native twin keeps the ORDER while
// removing the Python loop from the epoch's critical path (parity with
// random.shuffle enforced by tests/test_torch_native.py).

namespace {

struct Mt19937 {
  uint32_t mt[624];
  int mti;

  inline uint32_t next() {
    if (mti >= 624) {
      // one-pass in-place regeneration; the modular indices resolve to
      // the reference implementation's three loops (already-updated
      // words are read exactly where CPython reads them)
      for (int kk = 0; kk < 624; ++kk) {
        const uint32_t y =
            (mt[kk] & 0x80000000u) | (mt[(kk + 1) % 624] & 0x7fffffffu);
        mt[kk] =
            mt[(kk + 397) % 624] ^ (y >> 1) ^ ((y & 1u) ? 0x9908b0dfu : 0u);
      }
      mti = 0;
    }
    uint32_t y = mt[mti++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }
};

}  // namespace

// `state` is the 624-word key and `mti` the position from
// random.Random.getstate() (state[1][:624], state[1][624]). `n` must be
// < 2^31: beyond that getrandbits(k>32) consumes multiple words per call,
// which this kernel does not mirror, and the Python wrapper declines so
// the caller runs random.Random.shuffle itself.
DMLC_API void dmlc_shuffle_mt19937(const uint32_t* state, int32_t mti,
                                   int64_t n, int64_t* x) {
  Mt19937 rng;
  std::memcpy(rng.mt, state, sizeof(rng.mt));
  rng.mti = mti;
  for (int64_t i = n - 1; i >= 1; --i) {
    const uint32_t bound = static_cast<uint32_t>(i + 1);
    int k = 0;
    while ((bound >> k) != 0u) ++k;  // k = bit_length(i + 1) <= 31
    uint32_t r;
    do {
      r = rng.next() >> (32 - k);  // getrandbits(k): top k bits
    } while (r >= bound);
    const int64_t j = static_cast<int64_t>(r);
    const int64_t tmp = x[i];
    x[i] = x[j];
    x[j] = tmp;
  }
}

// Build stamp: data/native.py passes -DDMLC_SRC_HASH="sha256 of fastparse.cc"
// so a loaded library can be held to the source in the checkout.
DMLC_API const char* dmlc_source_hash() {
#ifdef DMLC_SRC_HASH
  return DMLC_SRC_HASH;
#else
  return "";
#endif
}
