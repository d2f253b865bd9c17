// gatk_hc_tpu native host runtime.
//
// C++17, no external dependencies.  Exposes a flat C ABI consumed via
// ctypes (see __init__.py).  Components:
//   * numeric context tables (ph2pr / jacobian / matchToMatch), same
//     formulas as the reference's Context.h so the Python tables match
//     bit-for-bit (verified by tests/test_pairhmm.py::test_tables_bit_equal
//     and the differential suites in tests/test_pairhmm.py,
//     tests/test_sw.py, tests/test_assembler.py, tests/test_columnar.py);
//   * PairHMM forward engine, float32-with-FTZ and float64, replicating the
//     reference main path's semantics (raw-ASCII quality indexing, Intel
//     recurrence order, final sumM+sumX over the last row);
//   * Smith-Waterman with backtrack replicating the reference's AVX2
//     engine's scoring, tie-breaking and CIGAR emission semantics;
//   * read-threading De Bruijn assembler (dup-kmer fresh vertices,
//     last-base chain threading, backward count propagation, pruned cycle
//     check, exhaustive pruned path enumeration, log10 edge scores).
//
// This is a clean-room implementation against documented behavior
// (SURVEY.md §2/§3); no reference code is copied.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <thread>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define HC_HAVE_SSE 1
#endif

namespace {

// ---------------------------------------------------------------------------
// Host-stage profiling: nanosecond accumulators per assembly phase, read by
// hc_prof_read (the reference has only compile-time rdtsc hooks,
// PairWiseSW.h:111-119; here the profile is always on — ~12 clock reads per
// region, ~0.04% of a 1 ms region).  Atomic: pool workers accumulate
// concurrently.  Slots: 0 segments+dup-scan, 1 graph build, 2 guards
// (unique/cycle), 3 path DFS, 4 score+reconstruct+sort, 5 SW, 6 window
// prep, 7 regions assembled.  Count slots (not nanoseconds): 8 kmer-ladder
// retry iterations, 9 SW full-DP calls, 10 SW all-M fast-path hits,
// 11 SW full-DP cells (n*m summed).
constexpr int PROF_SLOTS = 12;
std::atomic<int64_t> g_prof[PROF_SLOTS] = {};

inline int64_t prof_now() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Numeric context

constexpr int kMaxQual = 254;
constexpr double kMaxJacobianTolerance = 8.0;
constexpr double kJacobianStep = 1e-4;
constexpr double kJacobianInvStep = 1.0 / kJacobianStep;
constexpr int kJacobianSize = static_cast<int>(kMaxJacobianTolerance / kJacobianStep) + 1;
constexpr int kMatchToMatchSize = ((kMaxQual + 1) * (kMaxQual + 2)) >> 1;

struct Tables {
  double ph2pr64[128];
  float ph2pr32[128];
  double jacobian64[kJacobianSize];
  float jacobian32[kJacobianSize];
  double m2m64[kMatchToMatchSize];
  float m2m32[kMatchToMatchSize];

  static double approx_log10_sum_log10(double small, double big) {
    if (small > big) std::swap(small, big);
    if (std::isinf(small) || std::isinf(big)) return big;
    double diff = big - small;
    if (diff >= kMaxJacobianTolerance) return big;
    double d = diff * kJacobianInvStep;
    int ind = d > 0.0 ? static_cast<int>(d + 0.5) : static_cast<int>(d - 0.5);
    static const Tables& t = instance();
    return big + t.jacobian64[ind];
  }

  Tables() {
    for (int x = 0; x < 128; ++x) {
      ph2pr64[x] = std::pow(10.0, -x / 10.0);
      ph2pr32[x] = static_cast<float>(ph2pr64[x]);
    }
    for (int k = 0; k < kJacobianSize; ++k) {
      jacobian64[k] = std::log10(1.0 + std::pow(10.0, -k * kJacobianStep));
      jacobian32[k] = static_cast<float>(jacobian64[k]);
    }
    const double inv_ln10 = 1.0 / std::log(10.0);
    int offset = 0;
    for (int i = 0; i <= kMaxQual; ++i) {
      for (int j = 0; j <= i; ++j) {
        // Inline the jacobian lookup to avoid instance() recursion during
        // construction.
        double small = -0.1 * i, big = -0.1 * j;
        if (small > big) std::swap(small, big);
        double diff = big - small;
        double log10_sum = big;
        if (diff < kMaxJacobianTolerance) {
          double d = diff * kJacobianInvStep;
          int ind = d > 0.0 ? static_cast<int>(d + 0.5) : static_cast<int>(d - 0.5);
          log10_sum = big + jacobian64[ind];
        }
        double m2m_log10 = std::log1p(-std::min(1.0, std::pow(10.0, log10_sum))) * inv_ln10;
        m2m64[offset + j] = std::pow(10.0, m2m_log10);
        m2m32[offset + j] = static_cast<float>(m2m64[offset + j]);
      }
      offset += i + 1;
    }
  }

  static Tables& mutable_instance() {
    static Tables tables;
    return tables;
  }

  static const Tables& instance() { return mutable_instance(); }
};

inline uint8_t base_code(uint8_t b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'T': return 2;
    case 'G': return 3;
    case 'N': return 4;
    default: return 0;  // matches the reference's zero-initialized table
  }
}

struct FtzScope {
#ifdef HC_HAVE_SSE
  unsigned int saved;
  FtzScope() : saved(_MM_GET_FLUSH_ZERO_MODE()) {
    _MM_SET_FLUSH_ZERO_MODE(_MM_FLUSH_ZERO_ON);
  }
  ~FtzScope() { _MM_SET_FLUSH_ZERO_MODE(saved); }
#endif
};

// ---------------------------------------------------------------------------
// PairHMM forward (one pair), templated on float/double.

template <typename T>
double pairhmm_one(const uint8_t* rs, const uint8_t* rq, int rlen,
                   const uint8_t* hap, int hlen, int gop, int gcp) {
  const Tables& tab = Tables::instance();
  const bool is_f32 = sizeof(T) == 4;
  const T* ph2pr;
  T p_mm;
  if constexpr (sizeof(T) == 4) {
    ph2pr = reinterpret_cast<const T*>(tab.ph2pr32);
    p_mm = static_cast<T>(tab.m2m32[(((gop & 127) * ((gop & 127) + 1)) >> 1) + (gop & 127)]);
  } else {
    ph2pr = reinterpret_cast<const T*>(tab.ph2pr64);
    p_mm = static_cast<T>(tab.m2m64[(((gop & 127) * ((gop & 127) + 1)) >> 1) + (gop & 127)]);
  }
  (void)is_f32;
  const T p_gapm = T(1.0) - ph2pr[gcp & 127];
  const T p_mx = ph2pr[gop & 127];
  const T p_xx = ph2pr[gcp & 127];
  const T p_my = ph2pr[gop & 127];
  const T p_yy = ph2pr[gcp & 127];

  T initial;
  if constexpr (sizeof(T) == 4) {
    initial = std::ldexp(1.0f, 120);
  } else {
    initial = std::ldexp(1.0, 1020);
  }
  const T init_y = initial / static_cast<T>(hlen);

  const int C = hlen;
  std::vector<T> M_prev(C + 1), X_prev(C + 1), Y_prev(C + 1);
  std::vector<T> M_cur(C + 1), X_cur(C + 1), Y_cur(C + 1);
  for (int c = 0; c <= C; ++c) {
    M_prev[c] = T(0);
    X_prev[c] = T(0);
    Y_prev[c] = init_y;
  }
  std::vector<uint8_t> hap_codes(C);
  for (int c = 0; c < C; ++c) hap_codes[c] = base_code(hap[c]);

  T sum_m = T(0), sum_x = T(0);
  for (int r = 1; r <= rlen; ++r) {
    const uint8_t rcode = base_code(rs[r - 1]);
    const T q = ph2pr[rq[r - 1] & 127];
    const T one_minus_q = T(1.0) - q;
    const T q_div3 = q / T(3.0);
    M_cur[0] = T(0);
    X_cur[0] = T(0);
    Y_cur[0] = T(0);
    for (int c = 1; c <= C; ++c) {
      const uint8_t hcode = hap_codes[c - 1];
      const bool match = rcode == hcode || rcode == 4 || hcode == 4;
      const T distm = match ? one_minus_q : q_div3;
      const T t1 = M_prev[c - 1] * p_mm;
      const T t2 = X_prev[c - 1] * p_gapm;
      const T t3 = Y_prev[c - 1] * p_gapm;
      M_cur[c] = ((t1 + t2) + t3) * distm;
      X_cur[c] = M_prev[c] * p_mx + X_prev[c] * p_xx;
      Y_cur[c] = M_cur[c - 1] * p_my + Y_cur[c - 1] * p_yy;
    }
    if (r == rlen) {
      for (int c = 1; c <= C; ++c) sum_m = sum_m + M_cur[c];
      for (int c = 1; c <= C; ++c) sum_x = sum_x + X_cur[c];
    }
    std::swap(M_prev, M_cur);
    std::swap(X_prev, X_cur);
    std::swap(Y_prev, Y_cur);
  }
  return static_cast<double>(sum_m + sum_x);
}

// ---------------------------------------------------------------------------
// PairHMM forward, 8 pairs per AVX f32 vector (pairs-per-lane).
//
// Each of the 8 lanes executes EXACTLY the scalar pairhmm_one<float> op
// sequence — same mul/add/div order, same FTZ mode, no FMA contraction
// (-ffp-contract=off + explicit mul/add intrinsics) — so every pair's
// result is BITWISE identical to the scalar engine (tests assert this on
// varied-length batches).  This vectorizes the reference's OpenMP axis
// (inter-pair, intel_pairhmm.hpp:128-131) instead of its intra-pair
// anti-diagonal (avx-pairhmm-template.h): no cross-lane shifts, no
// wavefront ramp, and short/long pairs just mask their tails.  It is the
// same parallel shape as the TPU ppe Pallas kernel, on CPU lanes.

#ifdef HC_HAVE_SSE

struct PairHMMV8Scratch {
  std::vector<int32_t> hplane;  // (max_h x 8) transposed hap codes
  std::vector<float> rows;      // 6 x (max_h + 1) x 8: M/X/Y prev+cur
  void ensure(int max_h) {
    if (static_cast<int>(hplane.size()) < max_h * 8)
      hplane.resize(static_cast<size_t>(max_h) * 8);
    const size_t need = static_cast<size_t>(6) * (max_h + 1) * 8;
    if (rows.size() < need) rows.resize(need);
  }
};

static void pairhmm_f32_x8(const uint8_t* reads, const uint8_t* quals,
                           const int32_t* read_lens, int32_t read_stride,
                           const uint8_t* haps, const int32_t* hap_lens,
                           int32_t hap_stride, const int32_t* pair_read,
                           const int32_t* pair_hap, int32_t gop, int32_t gcp,
                           float* out) {
  const Tables& tab = Tables::instance();
  const uint8_t* rs[8];
  const uint8_t* rq[8];
  const uint8_t* hp[8];
  int rlen[8], hlen[8];
  int max_r = 0, max_h = 0;
  for (int l = 0; l < 8; ++l) {
    const int32_t r = pair_read[l], h = pair_hap[l];
    rs[l] = reads + static_cast<int64_t>(r) * read_stride;
    rq[l] = quals + static_cast<int64_t>(r) * read_stride;
    hp[l] = haps + static_cast<int64_t>(h) * hap_stride;
    rlen[l] = read_lens[r];
    hlen[l] = hap_lens[h];
    max_r = std::max(max_r, rlen[l]);
    max_h = std::max(max_h, hlen[l]);
  }
  thread_local PairHMMV8Scratch s;
  s.ensure(max_h);
  int32_t* hplane = s.hplane.data();
  for (int c = 0; c < max_h; ++c)
    for (int l = 0; l < 8; ++l)
      hplane[static_cast<size_t>(c) * 8 + l] =
          c < hlen[l] ? base_code(hp[l][c]) : 0;

  const int q7 = gop & 127, g7 = gcp & 127;
  const __m256 p_mm = _mm256_set1_ps(tab.m2m32[((q7 * (q7 + 1)) >> 1) + q7]);
  const __m256 p_gapm = _mm256_set1_ps(1.0f - tab.ph2pr32[g7]);
  const __m256 p_mx = _mm256_set1_ps(tab.ph2pr32[q7]);
  const __m256 p_xx = _mm256_set1_ps(tab.ph2pr32[g7]);
  const __m256 p_my = p_mx;
  const __m256 p_yy = p_xx;

  // per-lane init_y = 2^120 / hlen, the same float division as scalar
  alignas(32) float init_buf[8];
  const float initial = std::ldexp(1.0f, 120);
  for (int l = 0; l < 8; ++l)
    init_buf[l] = initial / static_cast<float>(hlen[l]);
  const __m256 init_y = _mm256_load_ps(init_buf);

  const size_t rw = static_cast<size_t>(max_h + 1) * 8;
  float* Mp = s.rows.data();
  float* Xp = Mp + rw;
  float* Yp = Xp + rw;
  float* Mc = Yp + rw;
  float* Xc = Mc + rw;
  float* Yc = Xc + rw;
  const __m256 zero = _mm256_setzero_ps();
  for (int c = 0; c <= max_h; ++c) {
    _mm256_storeu_ps(Mp + c * 8, zero);
    _mm256_storeu_ps(Xp + c * 8, zero);
    _mm256_storeu_ps(Yp + c * 8, init_y);
  }

  const __m256i rlen_v = _mm256_loadu_si256(
      reinterpret_cast<const __m256i*>(rlen));
  const __m256i hlen_v = _mm256_loadu_si256(
      reinterpret_cast<const __m256i*>(hlen));
  const __m256i four = _mm256_set1_epi32(4);
  const __m256 one = _mm256_set1_ps(1.0f);
  const __m256 three = _mm256_set1_ps(3.0f);
  __m256 sum_m = zero, sum_x = zero;

  alignas(32) float qbuf[8];
  alignas(32) int32_t rcode_buf[8];
  for (int r = 1; r <= max_r; ++r) {
    for (int l = 0; l < 8; ++l) {
      const bool live = r <= rlen[l];
      qbuf[l] = tab.ph2pr32[live ? (rq[l][r - 1] & 127) : 0];
      rcode_buf[l] = live ? base_code(rs[l][r - 1]) : 0;
    }
    const __m256 q = _mm256_load_ps(qbuf);
    const __m256 one_minus_q = _mm256_sub_ps(one, q);
    const __m256 q_div3 = _mm256_div_ps(q, three);
    const __m256i rcode = _mm256_load_si256(
        reinterpret_cast<const __m256i*>(rcode_buf));
    const __m256i rcode_is_n = _mm256_cmpeq_epi32(rcode, four);

    __m256 m_left = zero;  // M_cur[c-1]
    __m256 y_left = zero;  // Y_cur[c-1]
    __m256 row_m = zero, row_x = zero;
    _mm256_storeu_ps(Mc, zero);
    _mm256_storeu_ps(Xc, zero);
    _mm256_storeu_ps(Yc, zero);
    for (int c = 1; c <= max_h; ++c) {
      const __m256i hcode = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(hplane + (c - 1) * 8));
      const __m256i match_i = _mm256_or_si256(
          _mm256_or_si256(_mm256_cmpeq_epi32(rcode, hcode), rcode_is_n),
          _mm256_cmpeq_epi32(hcode, four));
      const __m256 distm = _mm256_blendv_ps(
          q_div3, one_minus_q, _mm256_castsi256_ps(match_i));
      const __m256 mp = _mm256_loadu_ps(Mp + (c - 1) * 8);
      const __m256 xp = _mm256_loadu_ps(Xp + (c - 1) * 8);
      const __m256 yp = _mm256_loadu_ps(Yp + (c - 1) * 8);
      const __m256 t1 = _mm256_mul_ps(mp, p_mm);
      const __m256 t2 = _mm256_mul_ps(xp, p_gapm);
      const __m256 t3 = _mm256_mul_ps(yp, p_gapm);
      const __m256 m = _mm256_mul_ps(
          _mm256_add_ps(_mm256_add_ps(t1, t2), t3), distm);
      const __m256 x = _mm256_add_ps(
          _mm256_mul_ps(_mm256_loadu_ps(Mp + c * 8), p_mx),
          _mm256_mul_ps(_mm256_loadu_ps(Xp + c * 8), p_xx));
      const __m256 y = _mm256_add_ps(_mm256_mul_ps(m_left, p_my),
                                     _mm256_mul_ps(y_left, p_yy));
      _mm256_storeu_ps(Mc + c * 8, m);
      _mm256_storeu_ps(Xc + c * 8, x);
      _mm256_storeu_ps(Yc + c * 8, y);
      // masked row sums: +0.0f adds for lanes with c > hlen keep the
      // accumulation bit-identical to the scalar c<=hlen loop (all
      // summands are non-negative, so no -0.0 hazards)
      const __m256 len_ok = _mm256_castsi256_ps(
          _mm256_cmpgt_epi32(hlen_v, _mm256_set1_epi32(c - 1)));
      row_m = _mm256_add_ps(row_m, _mm256_and_ps(m, len_ok));
      row_x = _mm256_add_ps(row_x, _mm256_and_ps(x, len_ok));
      m_left = m;
      y_left = y;
    }
    // lanes whose final row this is take their totals (assign, not add)
    const __m256 final_row = _mm256_castsi256_ps(
        _mm256_cmpeq_epi32(_mm256_set1_epi32(r), rlen_v));
    sum_m = _mm256_blendv_ps(sum_m, row_m, final_row);
    sum_x = _mm256_blendv_ps(sum_x, row_x, final_row);
    std::swap(Mp, Mc);
    std::swap(Xp, Xc);
    std::swap(Yp, Yc);
  }
  _mm256_storeu_ps(out, _mm256_add_ps(sum_m, sum_x));
}

// 16-lane AVX-512 variant of the same construction (runtime-dispatched:
// the .so is built for x86-64-v3 so it stays portable across a multihost
// run's machines; this function alone carries avx512 target attributes
// and is only called when __builtin_cpu_supports confirms the ISA).
// AVX-512 mask registers replace the and/blend games: masked adds skip
// dead lanes outright, which is bit-identical to the scalar c<=hlen loop.
#if defined(__GNUC__) && defined(__x86_64__)
#define HC_HAVE_AVX512_FN 1

__attribute__((target("avx512f,avx512bw,avx512dq")))
static void pairhmm_f32_x16(const uint8_t* reads, const uint8_t* quals,
                            const int32_t* read_lens, int32_t read_stride,
                            const uint8_t* haps, const int32_t* hap_lens,
                            int32_t hap_stride, const int32_t* pair_read,
                            const int32_t* pair_hap, int32_t gop,
                            int32_t gcp, float* out) {
  const Tables& tab = Tables::instance();
  const uint8_t* rs[16];
  const uint8_t* rq[16];
  const uint8_t* hp[16];
  alignas(64) int32_t rlen[16], hlen[16];
  int max_r = 0, max_h = 0;
  for (int l = 0; l < 16; ++l) {
    const int32_t r = pair_read[l], h = pair_hap[l];
    rs[l] = reads + static_cast<int64_t>(r) * read_stride;
    rq[l] = quals + static_cast<int64_t>(r) * read_stride;
    hp[l] = haps + static_cast<int64_t>(h) * hap_stride;
    rlen[l] = read_lens[r];
    hlen[l] = hap_lens[h];
    max_r = std::max(max_r, rlen[l]);
    max_h = std::max(max_h, hlen[l]);
  }
  struct V16Scratch {
    std::vector<int32_t> hplane;  // (max_h x 16) transposed hap codes
    std::vector<float> rows;      // 6 x (max_h + 1) x 16
    void ensure(int mh) {
      if (static_cast<int>(hplane.size()) < mh * 16)
        hplane.resize(static_cast<size_t>(mh) * 16);
      const size_t need = static_cast<size_t>(6) * (mh + 1) * 16;
      if (rows.size() < need) rows.resize(need);
    }
  };
  thread_local V16Scratch s;
  s.ensure(max_h);
  int32_t* hplane = s.hplane.data();
  for (int c = 0; c < max_h; ++c)
    for (int l = 0; l < 16; ++l)
      hplane[static_cast<size_t>(c) * 16 + l] =
          c < hlen[l] ? base_code(hp[l][c]) : 0;

  const int q7 = gop & 127, g7 = gcp & 127;
  const __m512 p_mm = _mm512_set1_ps(tab.m2m32[((q7 * (q7 + 1)) >> 1) + q7]);
  const __m512 p_gapm = _mm512_set1_ps(1.0f - tab.ph2pr32[g7]);
  const __m512 p_mx = _mm512_set1_ps(tab.ph2pr32[q7]);
  const __m512 p_xx = _mm512_set1_ps(tab.ph2pr32[g7]);
  const __m512 p_my = p_mx;
  const __m512 p_yy = p_xx;

  alignas(64) float init_buf[16];
  const float initial = std::ldexp(1.0f, 120);
  for (int l = 0; l < 16; ++l)
    init_buf[l] = initial / static_cast<float>(hlen[l]);
  const __m512 init_y = _mm512_load_ps(init_buf);

  const size_t rw = static_cast<size_t>(max_h + 1) * 16;
  float* Mp = s.rows.data();
  float* Xp = Mp + rw;
  float* Yp = Xp + rw;
  float* Mc = Yp + rw;
  float* Xc = Mc + rw;
  float* Yc = Xc + rw;
  const __m512 zero = _mm512_setzero_ps();
  for (int c = 0; c <= max_h; ++c) {
    _mm512_storeu_ps(Mp + c * 16, zero);
    _mm512_storeu_ps(Xp + c * 16, zero);
    _mm512_storeu_ps(Yp + c * 16, init_y);
  }

  const __m512i rlen_v = _mm512_load_si512(rlen);
  const __m512i hlen_v = _mm512_load_si512(hlen);
  const __m512i four = _mm512_set1_epi32(4);
  const __m512 one = _mm512_set1_ps(1.0f);
  const __m512 three = _mm512_set1_ps(3.0f);
  __m512 sum_m = zero, sum_x = zero;

  alignas(64) float qbuf[16];
  alignas(64) int32_t rcode_buf[16];
  for (int r = 1; r <= max_r; ++r) {
    for (int l = 0; l < 16; ++l) {
      const bool live = r <= rlen[l];
      qbuf[l] = tab.ph2pr32[live ? (rq[l][r - 1] & 127) : 0];
      rcode_buf[l] = live ? base_code(rs[l][r - 1]) : 0;
    }
    const __m512 q = _mm512_load_ps(qbuf);
    const __m512 one_minus_q = _mm512_sub_ps(one, q);
    const __m512 q_div3 = _mm512_div_ps(q, three);
    const __m512i rcode = _mm512_load_si512(rcode_buf);
    const __mmask16 rcode_is_n = _mm512_cmpeq_epi32_mask(rcode, four);

    __m512 m_left = zero, y_left = zero;
    __m512 row_m = zero, row_x = zero;
    _mm512_storeu_ps(Mc, zero);
    _mm512_storeu_ps(Xc, zero);
    _mm512_storeu_ps(Yc, zero);
    for (int c = 1; c <= max_h; ++c) {
      const __m512i hcode = _mm512_loadu_si512(hplane + (c - 1) * 16);
      const __mmask16 match =
          _mm512_cmpeq_epi32_mask(rcode, hcode) | rcode_is_n |
          _mm512_cmpeq_epi32_mask(hcode, four);
      const __m512 distm = _mm512_mask_blend_ps(match, q_div3, one_minus_q);
      const __m512 mp = _mm512_loadu_ps(Mp + (c - 1) * 16);
      const __m512 xp = _mm512_loadu_ps(Xp + (c - 1) * 16);
      const __m512 yp = _mm512_loadu_ps(Yp + (c - 1) * 16);
      const __m512 t1 = _mm512_mul_ps(mp, p_mm);
      const __m512 t2 = _mm512_mul_ps(xp, p_gapm);
      const __m512 t3 = _mm512_mul_ps(yp, p_gapm);
      const __m512 m = _mm512_mul_ps(
          _mm512_add_ps(_mm512_add_ps(t1, t2), t3), distm);
      const __m512 x = _mm512_add_ps(
          _mm512_mul_ps(_mm512_loadu_ps(Mp + c * 16), p_mx),
          _mm512_mul_ps(_mm512_loadu_ps(Xp + c * 16), p_xx));
      const __m512 y = _mm512_add_ps(_mm512_mul_ps(m_left, p_my),
                                     _mm512_mul_ps(y_left, p_yy));
      _mm512_storeu_ps(Mc + c * 16, m);
      _mm512_storeu_ps(Xc + c * 16, x);
      _mm512_storeu_ps(Yc + c * 16, y);
      const __mmask16 len_ok =
          _mm512_cmpgt_epi32_mask(hlen_v, _mm512_set1_epi32(c - 1));
      row_m = _mm512_mask_add_ps(row_m, len_ok, row_m, m);
      row_x = _mm512_mask_add_ps(row_x, len_ok, row_x, x);
      m_left = m;
      y_left = y;
    }
    const __mmask16 final_row =
        _mm512_cmpeq_epi32_mask(_mm512_set1_epi32(r), rlen_v);
    sum_m = _mm512_mask_blend_ps(final_row, sum_m, row_m);
    sum_x = _mm512_mask_blend_ps(final_row, sum_x, row_x);
    std::swap(Mp, Mc);
    std::swap(Xp, Xc);
    std::swap(Yp, Yc);
  }
  _mm512_storeu_ps(out, _mm512_add_ps(sum_m, sum_x));
}
#endif  // HC_HAVE_AVX512_FN

// Same pairs-per-lane construction in f64 (4 pairs per __m256d) — the
// rescue path recomputes the ~7-8% of pairs whose f32 result underflows,
// and a scalar rescue loop was the engine bottleneck once f32 went 8-wide.
// Bitwise identical per lane to pairhmm_one<double>.
struct PairHMMV4Scratch {
  std::vector<int32_t> hplane;  // (max_h x 4) transposed hap codes
  std::vector<double> rows;     // 6 x (max_h + 1) x 4
  void ensure(int max_h) {
    if (static_cast<int>(hplane.size()) < max_h * 4)
      hplane.resize(static_cast<size_t>(max_h) * 4);
    const size_t need = static_cast<size_t>(6) * (max_h + 1) * 4;
    if (rows.size() < need) rows.resize(need);
  }
};

static void pairhmm_f64_x4(const uint8_t* reads, const uint8_t* quals,
                           const int32_t* read_lens, int32_t read_stride,
                           const uint8_t* haps, const int32_t* hap_lens,
                           int32_t hap_stride, const int32_t* pair_read,
                           const int32_t* pair_hap, int32_t gop, int32_t gcp,
                           double* out) {
  const Tables& tab = Tables::instance();
  const uint8_t* rs[4];
  const uint8_t* rq[4];
  const uint8_t* hp[4];
  alignas(16) int32_t rlen[4], hlen[4];
  int max_r = 0, max_h = 0;
  for (int l = 0; l < 4; ++l) {
    const int32_t r = pair_read[l], h = pair_hap[l];
    rs[l] = reads + static_cast<int64_t>(r) * read_stride;
    rq[l] = quals + static_cast<int64_t>(r) * read_stride;
    hp[l] = haps + static_cast<int64_t>(h) * hap_stride;
    rlen[l] = read_lens[r];
    hlen[l] = hap_lens[h];
    max_r = std::max(max_r, rlen[l]);
    max_h = std::max(max_h, hlen[l]);
  }
  thread_local PairHMMV4Scratch s;
  s.ensure(max_h);
  int32_t* hplane = s.hplane.data();
  for (int c = 0; c < max_h; ++c)
    for (int l = 0; l < 4; ++l)
      hplane[static_cast<size_t>(c) * 4 + l] =
          c < hlen[l] ? base_code(hp[l][c]) : 0;

  const int q7 = gop & 127, g7 = gcp & 127;
  const __m256d p_mm = _mm256_set1_pd(tab.m2m64[((q7 * (q7 + 1)) >> 1) + q7]);
  const __m256d p_gapm = _mm256_set1_pd(1.0 - tab.ph2pr64[g7]);
  const __m256d p_mx = _mm256_set1_pd(tab.ph2pr64[q7]);
  const __m256d p_xx = _mm256_set1_pd(tab.ph2pr64[g7]);
  const __m256d p_my = p_mx;
  const __m256d p_yy = p_xx;

  alignas(32) double init_buf[4];
  const double initial = std::ldexp(1.0, 1020);
  for (int l = 0; l < 4; ++l)
    init_buf[l] = initial / static_cast<double>(hlen[l]);
  const __m256d init_y = _mm256_load_pd(init_buf);

  const size_t rw = static_cast<size_t>(max_h + 1) * 4;
  double* Mp = s.rows.data();
  double* Xp = Mp + rw;
  double* Yp = Xp + rw;
  double* Mc = Yp + rw;
  double* Xc = Mc + rw;
  double* Yc = Xc + rw;
  const __m256d zero = _mm256_setzero_pd();
  for (int c = 0; c <= max_h; ++c) {
    _mm256_storeu_pd(Mp + c * 4, zero);
    _mm256_storeu_pd(Xp + c * 4, zero);
    _mm256_storeu_pd(Yp + c * 4, init_y);
  }

  const __m128i rlen_v = _mm_load_si128(reinterpret_cast<const __m128i*>(rlen));
  const __m128i hlen_v = _mm_load_si128(reinterpret_cast<const __m128i*>(hlen));
  const __m128i four4 = _mm_set1_epi32(4);
  const __m256d one = _mm256_set1_pd(1.0);
  const __m256d three = _mm256_set1_pd(3.0);
  __m256d sum_m = zero, sum_x = zero;
  const auto mask_pd = [](__m128i m32) {
    return _mm256_castsi256_pd(_mm256_cvtepi32_epi64(m32));
  };

  alignas(32) double qbuf[4];
  alignas(16) int32_t rcode_buf[4];
  for (int r = 1; r <= max_r; ++r) {
    for (int l = 0; l < 4; ++l) {
      const bool live = r <= rlen[l];
      qbuf[l] = tab.ph2pr64[live ? (rq[l][r - 1] & 127) : 0];
      rcode_buf[l] = live ? base_code(rs[l][r - 1]) : 0;
    }
    const __m256d q = _mm256_load_pd(qbuf);
    const __m256d one_minus_q = _mm256_sub_pd(one, q);
    const __m256d q_div3 = _mm256_div_pd(q, three);
    const __m128i rcode = _mm_load_si128(
        reinterpret_cast<const __m128i*>(rcode_buf));
    const __m128i rcode_is_n = _mm_cmpeq_epi32(rcode, four4);

    __m256d m_left = zero, y_left = zero;
    __m256d row_m = zero, row_x = zero;
    _mm256_storeu_pd(Mc, zero);
    _mm256_storeu_pd(Xc, zero);
    _mm256_storeu_pd(Yc, zero);
    for (int c = 1; c <= max_h; ++c) {
      const __m128i hcode = _mm_loadu_si128(
          reinterpret_cast<const __m128i*>(hplane + (c - 1) * 4));
      const __m128i match_i = _mm_or_si128(
          _mm_or_si128(_mm_cmpeq_epi32(rcode, hcode), rcode_is_n),
          _mm_cmpeq_epi32(hcode, four4));
      const __m256d distm =
          _mm256_blendv_pd(q_div3, one_minus_q, mask_pd(match_i));
      const __m256d mp = _mm256_loadu_pd(Mp + (c - 1) * 4);
      const __m256d xp = _mm256_loadu_pd(Xp + (c - 1) * 4);
      const __m256d yp = _mm256_loadu_pd(Yp + (c - 1) * 4);
      const __m256d t1 = _mm256_mul_pd(mp, p_mm);
      const __m256d t2 = _mm256_mul_pd(xp, p_gapm);
      const __m256d t3 = _mm256_mul_pd(yp, p_gapm);
      const __m256d m = _mm256_mul_pd(
          _mm256_add_pd(_mm256_add_pd(t1, t2), t3), distm);
      const __m256d x = _mm256_add_pd(
          _mm256_mul_pd(_mm256_loadu_pd(Mp + c * 4), p_mx),
          _mm256_mul_pd(_mm256_loadu_pd(Xp + c * 4), p_xx));
      const __m256d y = _mm256_add_pd(_mm256_mul_pd(m_left, p_my),
                                      _mm256_mul_pd(y_left, p_yy));
      _mm256_storeu_pd(Mc + c * 4, m);
      _mm256_storeu_pd(Xc + c * 4, x);
      _mm256_storeu_pd(Yc + c * 4, y);
      const __m256d len_ok =
          mask_pd(_mm_cmpgt_epi32(hlen_v, _mm_set1_epi32(c - 1)));
      row_m = _mm256_add_pd(row_m, _mm256_and_pd(m, len_ok));
      row_x = _mm256_add_pd(row_x, _mm256_and_pd(x, len_ok));
      m_left = m;
      y_left = y;
    }
    const __m256d final_row =
        mask_pd(_mm_cmpeq_epi32(_mm_set1_epi32(r), rlen_v));
    sum_m = _mm256_blendv_pd(sum_m, row_m, final_row);
    sum_x = _mm256_blendv_pd(sum_x, row_x, final_row);
    std::swap(Mp, Mc);
    std::swap(Xp, Xc);
    std::swap(Yp, Yc);
  }
  _mm256_storeu_pd(out, _mm256_add_pd(sum_m, sum_x));
}

#endif  // HC_HAVE_SSE

// ---------------------------------------------------------------------------
// Smith-Waterman (reference AVX2-engine semantics, SOFTCLIP overhang)

constexpr int SW_MATCH = 0;
constexpr int SW_INSERT = 1;
constexpr int SW_DELETE = 2;
constexpr int SW_INSERT_EXT = 4;
constexpr int SW_DELETE_EXT = 8;
constexpr int64_t SW_MIN_CUTOFF = -100000000;
constexpr int64_t SW_LOW_INIT = INT64_MIN / 4;

struct SWResult {
  int offset = 0;
  std::string cigar;
  // (op char, length) in emit order — same content as `cigar`, kept as
  // elements so batch callers (hc_assemble_sw) skip the string round trip
  std::vector<std::pair<char, int>> elements;
};

int sw_align_impl(const uint8_t* ref, int n, const uint8_t* alt, int m,
                  int w_match, int w_mismatch, int w_open, int w_extend,
                  int max_mismatches, SWResult* out) {
  // all-match fast path (intel_smithwaterman.hpp:47-58)
  if (n == m) {
    int mismatches = 0;
    for (int i = 0; i < n && mismatches <= max_mismatches; ++i)
      if (ref[i] != alt[i]) ++mismatches;
    if (mismatches <= max_mismatches) {
      out->offset = 0;
      out->cigar = std::to_string(n) + "M";
      out->elements.assign(1, {'M', n});
      g_prof[10].fetch_add(1, std::memory_order_relaxed);
      return 0;
    }
  }
  g_prof[9].fetch_add(1, std::memory_order_relaxed);
  g_prof[11].fetch_add(static_cast<int64_t>(n) * m,
                       std::memory_order_relaxed);
  // Two-row rolling int32 DP (identical arithmetic path to the full-matrix
  // int64 version: scores are bounded by ~max(n,m)*|w| << 2^31/4, and the
  // low-init sentinel only ever has w_extend added once before a max).
  // Bottom-row and last-column scores are captured for start-cell selection
  // so the O(n*m) H matrix never materializes (it was ~1.4MB per call and
  // thrashed L2; the backtrack matrix bt is bytes and stays).
  // Scratch is thread_local: per-call allocation + zero-fill of the ~170KB
  // backtrack matrix was ~15% of SW time, and only cells (i>=1, j>=1) are
  // ever written-then-read, so bt needs no clearing between calls.
  constexpr int32_t kLowInit32 = INT32_MIN / 4;
  constexpr int32_t kMinCutoff32 = -100000000;
  struct Scratch {
    std::vector<uint8_t> bt;
    std::vector<int32_t> h_prev, h_cur, F_prev, last_col, bottom_row;
    std::vector<int32_t> m11p, hnoe, del_ext, etmp, e_a, e_b;
  };
  thread_local Scratch s;
  const size_t bt_size = static_cast<size_t>(n + 1) * (m + 1);
  if (s.bt.size() < bt_size) s.bt.resize(bt_size);
  auto& bt = s.bt;
  s.h_prev.assign(m + 1, 0);
  s.h_cur.assign(m + 1, 0);
  s.F_prev.assign(m + 1, kLowInit32);
  s.last_col.assign(n + 1, 0);
  s.bottom_row.assign(m + 1, 0);
  s.m11p.resize(m + 1);
  s.hnoe.resize(m + 1);
  s.del_ext.resize(m + 1);
  s.etmp.resize(m + 1);
  s.e_a.resize(m + 1);
  s.e_b.resize(m + 1);
  auto& h_prev = s.h_prev;
  auto& h_cur = s.h_cur;
  auto& F_prev = s.F_prev;
  auto& last_col = s.last_col;
  auto& bottom_row = s.bottom_row;

  // Two-pass rows when w_open <= w_extend (all presets): pass A has no
  // loop-carried dependence and autovectorizes; pass B keeps only the
  // E-recurrence.  The lazy-E substitution (opening a gap from an
  // E-won cell is dominated by extending, since open <= extend) leaves
  // every score, tie-break, and backtrack flag bit-identical to the
  // single-pass reference loop, which is kept as the fallback.
  const bool lazy_e_ok = w_open <= w_extend;
  for (int i = 1; i <= n; ++i) {
    h_cur[0] = 0;
    uint8_t* bt_row = bt.data() + static_cast<size_t>(i) * (m + 1);
    const uint8_t ri = ref[i - 1];
    if (lazy_e_ok) {
      int32_t* __restrict__ m11p = s.m11p.data();
      int32_t* __restrict__ hnoe = s.hnoe.data();
      int32_t* __restrict__ dele = s.del_ext.data();
      const int32_t* __restrict__ hp = h_prev.data();
      int32_t* __restrict__ fp = F_prev.data();
      const uint8_t* __restrict__ altp = alt;
      // all six arrays are distinct allocations (thread_local scratch);
      // ivdep suppresses gcc's >10 runtime alias checks that otherwise
      // block vectorization
#pragma GCC ivdep
      for (int j = 1; j <= m; ++j) {  // pass A (vectorizable)
        const int32_t m11 =
            hp[j - 1] + (ri == altp[j - 1] ? w_match : w_mismatch);
        const int32_t mp = m11 > kMinCutoff32 ? m11 : kMinCutoff32;
        const int32_t f_open = hp[j] + w_open;
        const int32_t f_ext = fp[j] + w_extend;
        const int32_t f11 = f_open > f_ext ? f_open : f_ext;
        m11p[j] = mp;
        dele[j] = f_open > f_ext ? 0 : SW_DELETE_EXT;
        fp[j] = f11;
        hnoe[j] = mp > f11 ? mp : f11;
      }
      // pass B: the E recurrence e[j] = max(hnoe[j-1] + open, e[j-1] + ext)
      // is a max-plus inclusive scan — computed with log2(m) vectorized
      // Hillis-Steele passes (integer max-plus is associative: exact).
      // (Two variants tried and reverted, r5: an exact convergence
      // early-exit — scan elements keep changing even where E never wins
      // a cell, so it rarely fired and its change-reduction cost ~5% — and
      // fusing the etmp/ea init into one two-store loop, which gcc
      // vectorizes worse than the two single-store passes, −12%.)
      int32_t* __restrict__ etmp = s.etmp.data();
      int32_t* __restrict__ ea = s.e_a.data();
      hnoe[0] = 0;  // h(i, 0) = 0; E never wins at column 0
#pragma GCC ivdep
      for (int j = 1; j <= m; ++j) etmp[j] = hnoe[j - 1] + w_open;
      ea[0] = kLowInit32;
#pragma GCC ivdep
      for (int j = 1; j <= m; ++j) ea[j] = etmp[j];
      {
        int32_t* __restrict__ src = ea;
        int32_t* __restrict__ dst = s.e_b.data();
        for (int step = 1; step <= m; step <<= 1) {
          const int32_t add = static_cast<int32_t>(step) * w_extend;
#pragma GCC ivdep
          for (int j = step; j <= m; ++j) {
            const int32_t via = src[j - step] + add;
            dst[j] = src[j] > via ? src[j] : via;
          }
          for (int j = 0; j < step && j <= m; ++j) dst[j] = src[j];
          std::swap(src, dst);
        }
        ea = src;
      }
      uint8_t* __restrict__ btp = bt_row;
      int32_t* __restrict__ hc = h_cur.data();
#pragma GCC ivdep
      for (int j = 1; j <= m; ++j) {  // codes + H (vectorizable)
        const int32_t e_ext = ea[j - 1] + w_extend;
        const int32_t e11 = ea[j];
        const int32_t mp = m11p[j];
        const int32_t f11 = fp[j];
        int32_t h11 = mp;
        int32_t code = SW_MATCH;
        if (e11 > h11) {
          code = SW_INSERT;
          h11 = e11;
        }
        if (f11 > h11) {
          code = SW_DELETE;
          h11 = f11;
        }
        if (!(etmp[j] > e_ext)) code |= SW_INSERT_EXT;
        code |= dele[j];
        hc[j] = h11;
        btp[j] = static_cast<uint8_t>(code);
      }
    } else {  // reference single-pass loop (exotic parameters)
      int32_t E = kLowInit32;  // E[i][0]
      for (int j = 1; j <= m; ++j) {
        const int32_t h_left = h_cur[j - 1];
        const int32_t e_open = h_left + w_open;
        const int32_t e_ext = E + w_extend;
        const bool ins_ext = !(e_open > e_ext);
        const int32_t e11 = std::max(e_open, e_ext);

        const int32_t h_top = h_prev[j];
        const int32_t f_open = h_top + w_open;
        const int32_t f_ext = F_prev[j] + w_extend;
        const bool del_ext = !(f_open > f_ext);
        const int32_t f11 = std::max(f_open, f_ext);

        const int32_t m11 =
            h_prev[j - 1] + (ri == alt[j - 1] ? w_match : w_mismatch);
        int32_t h11 = std::max(kMinCutoff32, m11);
        uint8_t code = SW_MATCH;
        if (e11 > h11) {
          code = SW_INSERT;
          h11 = e11;
        }
        if (f11 > h11) {
          code = SW_DELETE;
          h11 = f11;
        }
        if (ins_ext) code |= SW_INSERT_EXT;
        if (del_ext) code |= SW_DELETE_EXT;
        h_cur[j] = h11;
        bt_row[j] = code;
        E = e11;
        F_prev[j] = f11;
      }
    }
    last_col[i] = h_cur[m];
    if (i == n) bottom_row = h_cur;
    std::swap(h_prev, h_cur);
  }

  // start-cell selection, anti-diagonal scan order (PairWiseSW.h:200-227)
  int64_t max_score = INT64_MIN;
  int max_i = 0, max_j = 0;
  for (int anti = 1; anti <= n + m; ++anti) {
    if (anti >= n + 1) {  // bottom row cell (n, anti-n)
      const int j = anti - n;
      const int64_t score = bottom_row[j];
      if (score > max_score ||
          (score == max_score && std::abs(n - j) < std::abs(max_i - max_j))) {
        max_score = score;
        max_i = n;
        max_j = j;
      }
    }
    if (anti >= m + 1) {  // last column cell (anti-m, m)
      const int i = anti - m;
      const int64_t score = last_col[i];
      if (score > max_score ||
          (score == max_score &&
           (max_j == m || std::abs(i - m) <= std::abs(max_i - max_j)))) {
        max_score = score;
        max_i = i;
        max_j = m;
      }
    }
  }

  // backtrack walk (getCIGAR, PairWiseSW.h:240-415)
  std::vector<std::pair<int, int>> raw;  // (op, len), newest last
  int i = max_i, j = max_j;
  if (j < m) raw.emplace_back(9, m - j);  // soft clip
  int state = 0;
  while (i > 0 && j > 0) {
    const int btr = bt[i * (m + 1) + j];
    if (state == SW_INSERT_EXT) {
      --j;
      raw.back().second++;
      state = btr & SW_INSERT_EXT;
    } else if (state == SW_DELETE_EXT) {
      --i;
      raw.back().second++;
      state = btr & SW_DELETE_EXT;
    } else {
      switch (btr & 3) {
        case SW_MATCH:
          --i; --j;
          raw.emplace_back(SW_MATCH, 1);
          state = 0;
          break;
        case SW_INSERT:
          --j;
          raw.emplace_back(SW_INSERT, 1);
          state = btr & SW_INSERT_EXT;
          break;
        default:
          --i;
          raw.emplace_back(SW_DELETE, 1);
          state = btr & SW_DELETE_EXT;
          break;
      }
    }
  }
  if (j > 0) raw.emplace_back(9, j);
  out->offset = i;

  // run-length merge then reverse
  std::vector<std::pair<int, int>> merged;
  for (auto [op, len] : raw) {
    if (!merged.empty() && merged.back().first == op)
      merged.back().second += len;
    else
      merged.emplace_back(op, len);
  }
  std::string cigar;
  out->elements.clear();
  for (auto it = merged.rbegin(); it != merged.rend(); ++it) {
    cigar += std::to_string(it->second);
    char op;
    switch (it->first) {
      case SW_MATCH: op = 'M'; break;
      case SW_INSERT: op = 'I'; break;
      case SW_DELETE: op = 'D'; break;
      default: op = 'S'; break;
    }
    cigar += op;
    out->elements.emplace_back(op, it->second);
  }
  out->cigar = std::move(cigar);
  return 0;
}

// ---------------------------------------------------------------------------
// Read-threading De Bruijn assembler

// Open-addressed uint64 hash set/map (linear probing, power-of-2 capacity).
// The packed kmer path is the hot path of graph construction; libstdc++'s
// node-based unordered containers spent ~35% of assembly in hashing and
// node allocation.  ~0ull is reserved as the empty slot; the one real key
// that can equal it (k == 32, all-T kmer) is tracked out-of-band.
struct FlatSet64 {
  static constexpr uint64_t EMPTY = ~0ull;
  std::vector<uint64_t> slots;
  size_t mask = 0, count = 0;
  bool has_special = false;

  void init(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    slots.assign(cap, EMPTY);
    mask = cap - 1;
    count = 0;
    has_special = false;
  }
  static inline size_t hash64(uint64_t key) {
    return static_cast<size_t>((key * 0x9E3779B97F4A7C15ull) >> 29);
  }
  bool insert(uint64_t key) {  // true if newly inserted
    if (key == EMPTY) {
      const bool fresh = !has_special;
      has_special = true;
      return fresh;
    }
    size_t i = hash64(key) & mask;
    while (slots[i] != EMPTY) {
      if (slots[i] == key) return false;
      i = (i + 1) & mask;
    }
    slots[i] = key;
    if (++count * 10 >= (mask + 1) * 7) grow();
    return true;
  }
  // Tracked variant for sets that are reset per short sequence: records
  // which slots were written so reset_tracked() wipes only those instead
  // of memsetting the whole table (the per-segment dup-scan seen set paid
  // a 4KB assign per ~150bp segment).  REQUIRES the table to be pre-sized
  // for the largest sequence (init once): count stays <= cap/2, so grow()
  // can never fire and invalidate the recorded indices.
  std::vector<uint32_t> used;
  bool insert_tracked(uint64_t key) {
    if (key == EMPTY) {
      const bool fresh = !has_special;
      has_special = true;
      return fresh;
    }
    size_t i = hash64(key) & mask;
    while (slots[i] != EMPTY) {
      if (slots[i] == key) return false;
      i = (i + 1) & mask;
    }
    slots[i] = key;
    ++count;
    used.push_back(static_cast<uint32_t>(i));
    return true;
  }
  void reset_tracked() {
    for (uint32_t i : used) slots[i] = EMPTY;
    used.clear();
    count = 0;
    has_special = false;
  }
  bool contains(uint64_t key) const {
    if (key == EMPTY) return has_special;
    size_t i = hash64(key) & mask;
    while (slots[i] != EMPTY) {
      if (slots[i] == key) return true;
      i = (i + 1) & mask;
    }
    return false;
  }
  void grow() {
    std::vector<uint64_t> old = std::move(slots);
    slots.assign((mask + 1) * 2, EMPTY);
    mask = slots.size() - 1;
    for (uint64_t key : old) {
      if (key == EMPTY) continue;
      size_t i = hash64(key) & mask;
      while (slots[i] != EMPTY) i = (i + 1) & mask;
      slots[i] = key;
    }
  }
};

struct FlatMap64 {  // uint64 -> int
  static constexpr uint64_t EMPTY = ~0ull;
  std::vector<uint64_t> keys;
  std::vector<int> vals;
  size_t mask = 0, count = 0;
  bool has_special = false;
  int special_val = -1;

  void init(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    keys.assign(cap, EMPTY);
    vals.resize(cap);
    mask = cap - 1;
    count = 0;
    has_special = false;
  }
  size_t size() const { return count + (has_special ? 1 : 0); }
  // returns the value or -1 (vertex ids are non-negative)
  int find(uint64_t key) const {
    if (key == EMPTY) return has_special ? special_val : -1;
    size_t i = FlatSet64::hash64(key) & mask;
    while (keys[i] != EMPTY) {
      if (keys[i] == key) return vals[i];
      i = (i + 1) & mask;
    }
    return -1;
  }
  void emplace(uint64_t key, int val) {  // first insert wins (like map)
    if (key == EMPTY) {
      if (!has_special) {
        has_special = true;
        special_val = val;
      }
      return;
    }
    size_t i = FlatSet64::hash64(key) & mask;
    while (keys[i] != EMPTY) {
      if (keys[i] == key) return;
      i = (i + 1) & mask;
    }
    keys[i] = key;
    vals[i] = val;
    if (++count * 10 >= (mask + 1) * 7) grow();
  }
  void grow() {
    std::vector<uint64_t> okeys = std::move(keys);
    std::vector<int> ovals = std::move(vals);
    keys.assign((mask + 1) * 2, EMPTY);
    vals.resize(keys.size());
    mask = keys.size() - 1;
    for (size_t j = 0; j < okeys.size(); ++j) {
      if (okeys[j] == EMPTY) continue;
      size_t i = FlatSet64::hash64(okeys[j]) & mask;
      while (keys[i] != EMPTY) i = (i + 1) & mask;
      keys[i] = okeys[j];
      vals[i] = ovals[j];
    }
  }
};

struct Assembly {
  int k;
  int prune_factor;
  std::vector<std::string_view> kmers;        // vertex -> kmer
  // adjacency as intrusive singly-linked edge lists with TAIL insertion:
  // iteration order == insertion order (path enumeration order and the
  // fp edge-score fan-out sums depend on it), and vertex creation stops
  // allocating a vector per vertex (~1.1k allocations per region before)
  std::vector<int> out_head, out_tail, out_deg;  // per vertex
  std::vector<int> out_next;                     // per edge
  std::vector<int> in_head, in_deg;              // per vertex (head = first
                                                 // inserted; only deg==1
                                                 // paths ever read it)
  std::vector<int> e_src, e_dst, e_count;
  std::vector<uint8_t> e_is_ref;
  std::vector<char> v_last;  // kmers[v].back() without the string_view
                             // indirection: extend_chain reads it once per
                             // position on the hot chained path
  std::unordered_map<std::string_view, int> unique_kmers;
  std::unordered_set<std::string_view> dup_kmers;  // membership-only
  // packed mode (k <= 32, pure-ACGT window): kmers map EXACTLY to 2-bit
  // uint64 keys — collision-free, O(1) rolling construction, ~2x cheaper
  // hashing than byte-wise string_view keys
  bool packed = false;
  FlatMap64 unique_p;
  FlatSet64 dup_p;

  static inline uint64_t pack_code(char ch) {
    switch (ch) {
      case 'C': return 1;
      case 'G': return 2;
      case 'T': return 3;
      default: return 0;  // 'A' (packed mode requires pure ACGT)
    }
  }

  uint64_t pack(std::string_view kmer) const {
    uint64_t v = 0;
    for (char ch : kmer) v = (v << 2) | pack_code(ch);
    return v;
  }

  size_t unique_count() const {
    return packed ? unique_p.size() : unique_kmers.size();
  }

  int source = 0, sink = 0;

  // key: the 2-bit packed kmer in packed mode (callers roll it in O(1)
  // per position), ignored otherwise
  int create_vertex(std::string_view kmer, uint64_t key) {
    int vid = static_cast<int>(kmers.size());
    kmers.push_back(kmer);
    v_last.push_back(kmer.back());
    out_head.push_back(-1);
    out_tail.push_back(-1);
    out_deg.push_back(0);
    in_head.push_back(-1);
    in_deg.push_back(0);
    if (packed) {
      if (!dup_p.contains(key)) unique_p.emplace(key, vid);
    } else {
      if (dup_kmers.find(kmer) == dup_kmers.end())
        unique_kmers.emplace(kmer, vid);
    }
    return vid;
  }

  int get_vertex(std::string_view kmer, uint64_t key) {
    if (packed) {
      const int vid = unique_p.find(key);
      if (vid >= 0) return vid;
    } else {
      auto it = unique_kmers.find(kmer);
      if (it != unique_kmers.end()) return it->second;
    }
    return create_vertex(kmer, key);
  }

  void create_edge(int u, int v, bool is_ref) {
    int eid = static_cast<int>(e_src.size());
    e_src.push_back(u);
    e_dst.push_back(v);
    e_count.push_back(1);
    e_is_ref.push_back(is_ref);
    out_next.push_back(-1);
    if (out_tail[u] < 0)
      out_head[u] = eid;
    else
      out_next[out_tail[u]] = eid;
    out_tail[u] = eid;
    ++out_deg[u];
    if (in_head[v] < 0) in_head[v] = eid;
    ++in_deg[v];
  }

  void increase_counts_backwards(int v, std::string_view kmer) {
    while (!kmer.empty()) {
      if (in_deg[v] != 1) return;
      const int eid = in_head[v];
      const int u = e_src[eid];
      if (v_last[u] != kmer.back()) return;
      ++e_count[eid];
      v = u;
      kmer.remove_suffix(1);
    }
  }

  int extend_chain(int u, std::string_view kmer, uint64_t key, bool is_ref) {
    const char last = kmer.back();
    for (int eid = out_head[u]; eid >= 0; eid = out_next[eid]) {
      const int v = e_dst[eid];
      if (v_last[v] == last) {
        ++e_count[eid];
        return v;
      }
    }
    const int v = get_vertex(kmer, key);
    create_edge(u, v, is_ref);
    return v;
  }

  void add_seq(std::string_view seq, bool is_ref) {
    // mask only defined in packed mode (k <= 32; shifting by 2k > 63 is UB)
    const uint64_t mask =
        !packed ? 0 : (k == 32 ? ~0ull : ((1ull << (2 * k)) - 1));
    uint64_t key = packed ? (pack(seq.substr(0, k)) & mask) : 0;
    int v = get_vertex(seq.substr(0, k), key);
    increase_counts_backwards(v, seq.substr(0, k - 1));
    if (is_ref) source = v;
    for (size_t i = 1; i + k <= seq.size(); ++i) {
      if (packed)
        key = ((key << 2) | pack_code(seq[i + k - 1])) & mask;
      v = extend_chain(v, seq.substr(i, k), key, is_ref);
    }
    if (is_ref) sink = v;
  }

  bool edge_passes(int eid) const {
    return e_is_ref[eid] || e_count[eid] >= prune_factor ||
           out_deg[e_src[eid]] == 1;
  }

  bool has_cycles() const {
    enum { WHITE, GRAY, BLACK };
    std::vector<uint8_t> color(kmers.size(), WHITE);
    std::vector<std::pair<int, int>> stack;  // (vertex, next edge cursor)
    for (size_t root = 0; root < kmers.size(); ++root) {
      if (color[root] != WHITE) continue;
      color[root] = GRAY;
      stack.clear();
      stack.emplace_back(static_cast<int>(root), out_head[root]);
      while (!stack.empty()) {
        auto& [v, cursor] = stack.back();
        int next = -1;
        while (cursor >= 0) {
          const int eid = cursor;
          cursor = out_next[eid];
          if (!edge_passes(eid)) continue;
          const int w = e_dst[eid];
          if (color[w] == GRAY) return true;
          if (color[w] == WHITE) {
            next = w;
            break;
          }
        }
        if (next < 0) {
          color[v] = BLACK;
          stack.pop_back();
        } else {
          color[next] = GRAY;
          stack.emplace_back(next, out_head[next]);
        }
      }
    }
    return false;
  }

  // exhaustive pruned DFS source->sink
  bool find_paths(std::vector<std::vector<int>>* paths, size_t max_paths) const {
    std::vector<int> path;
    std::vector<uint8_t> on_path(kmers.size(), 0);
    // explicit stack of (vertex, next edge cursor)
    std::vector<std::pair<int, int>> stack;
    stack.emplace_back(source, out_head[source]);
    path.push_back(source);
    on_path[source] = 1;
    if (source == sink) paths->push_back(path);
    while (!stack.empty()) {
      auto& [v, cursor] = stack.back();
      int next = -1;
      while (cursor >= 0) {
        const int eid = cursor;
        cursor = out_next[eid];
        if (!edge_passes(eid)) continue;
        const int w = e_dst[eid];
        if (!on_path[w]) {
          next = w;
          break;
        }
      }
      if (next < 0) {
        on_path[v] = 0;
        path.pop_back();
        stack.pop_back();
      } else {
        path.push_back(next);
        on_path[next] = 1;
        stack.emplace_back(next, out_head[next]);
        if (next == sink) {
          if (paths->size() >= max_paths) return false;
          paths->push_back(path);
        }
      }
    }
    return true;
  }

  int edge_between(int u, int v) const {
    for (int eid = out_head[u]; eid >= 0; eid = out_next[eid])
      if (e_dst[eid] == v) return eid;
    return -1;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI

extern "C" {

// Overwrite the native tables with caller-provided values so Python/numpy
// remains the single numeric source of truth (last-ulp libm differences in
// the f64 tables otherwise break bit-equality between engines).
void hc_load_tables(const float* ph32, const double* ph64, const float* mm32,
                    const double* mm64, const float* jac32,
                    const double* jac64) {
  Tables& t = Tables::mutable_instance();
  std::memcpy(t.ph2pr32, ph32, sizeof(t.ph2pr32));
  std::memcpy(t.ph2pr64, ph64, sizeof(t.ph2pr64));
  std::memcpy(t.m2m32, mm32, sizeof(t.m2m32));
  std::memcpy(t.m2m64, mm64, sizeof(t.m2m64));
  std::memcpy(t.jacobian32, jac32, sizeof(t.jacobian32));
  std::memcpy(t.jacobian64, jac64, sizeof(t.jacobian64));
}

void hc_table_probe(float* ph32, double* ph64, float* mm32, double* mm64,
                    float* jac32, double* jac64) {
  const Tables& t = Tables::instance();
  std::memcpy(ph32, t.ph2pr32, sizeof(t.ph2pr32));
  std::memcpy(ph64, t.ph2pr64, sizeof(t.ph2pr64));
  std::memcpy(mm32, t.m2m32, sizeof(t.m2m32));
  std::memcpy(mm64, t.m2m64, sizeof(t.m2m64));
  std::memcpy(jac32, t.jacobian32, sizeof(t.jacobian32));
  std::memcpy(jac64, t.jacobian64, sizeof(t.jacobian64));
}

int32_t hc_sw_align(const uint8_t* ref, int32_t ref_len, const uint8_t* alt,
                    int32_t alt_len, int32_t w_match, int32_t w_mismatch,
                    int32_t w_open, int32_t w_extend, int32_t max_mismatches,
                    char* cigar_out, int32_t cigar_cap, int32_t* offset_out) {
  if (ref_len <= 0 || alt_len <= 0) return -1;
  SWResult result;
  const int rc = sw_align_impl(ref, ref_len, alt, alt_len, w_match, w_mismatch,
                               w_open, w_extend, max_mismatches, &result);
  if (rc != 0) return rc;
  if (static_cast<int32_t>(result.cigar.size()) + 1 > cigar_cap) return -2;
  std::memcpy(cigar_out, result.cigar.c_str(), result.cigar.size() + 1);
  *offset_out = result.offset;
  return 0;
}

void hc_pairhmm_f32(const uint8_t* reads, const uint8_t* quals,
                    const int32_t* read_lens, int32_t read_stride,
                    const uint8_t* haps, const int32_t* hap_lens,
                    int32_t hap_stride, const int32_t* pair_read,
                    const int32_t* pair_hap, int64_t n_pairs, int32_t gop,
                    int32_t gcp, float* out) {
  FtzScope ftz;
  int64_t p = 0;
#ifdef HC_HAVE_SSE
  // pairs-per-lane AVX main path (bitwise-identical per pair to the
  // scalar loop below); HC_PAIRHMM_SCALAR=1 forces the scalar path for
  // A/B and debugging
  static const bool force_scalar = [] {
    const char* env = std::getenv("HC_PAIRHMM_SCALAR");
    return env != nullptr && env[0] != '\0' && env[0] != '0';
  }();
  if (!force_scalar) {
    // Vector blocks pad every lane to the block max (rlen, hlen): sort the
    // pair indices by descending (hlen, rlen) so blocks are near-uniform,
    // then scatter results back.  Per-pair results are order-independent,
    // so this costs nothing in exactness (~15% fewer padded cells on
    // mixed-length jobs).
    thread_local std::vector<int64_t> order;
    thread_local std::vector<int32_t> sp_read, sp_hap;
    thread_local std::vector<float> sp_out;
    order.resize(n_pairs);
    for (int64_t i = 0; i < n_pairs; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      const int32_t ha = hap_lens[pair_hap[a]], hb = hap_lens[pair_hap[b]];
      if (ha != hb) return ha > hb;
      const int32_t ra = read_lens[pair_read[a]], rb = read_lens[pair_read[b]];
      if (ra != rb) return ra > rb;
      return a < b;
    });
    sp_read.resize(n_pairs);
    sp_hap.resize(n_pairs);
    sp_out.resize(n_pairs);
    for (int64_t i = 0; i < n_pairs; ++i) {
      sp_read[i] = pair_read[order[i]];
      sp_hap[i] = pair_hap[order[i]];
    }
#ifdef HC_HAVE_AVX512_FN
    static const bool use_avx512 = [] {
      const char* env = std::getenv("HC_PAIRHMM_NO_AVX512");
      const bool disabled = env != nullptr && env[0] != '\0' && env[0] != '0';
      return !disabled && __builtin_cpu_supports("avx512f") &&
             __builtin_cpu_supports("avx512bw") &&
             __builtin_cpu_supports("avx512dq");
    }();
    if (use_avx512) {
      for (; p + 16 <= n_pairs; p += 16) {
        pairhmm_f32_x16(reads, quals, read_lens, read_stride, haps,
                        hap_lens, hap_stride, sp_read.data() + p,
                        sp_hap.data() + p, gop, gcp, sp_out.data() + p);
      }
    }
#endif
    for (; p + 8 <= n_pairs; p += 8) {
      pairhmm_f32_x8(reads, quals, read_lens, read_stride, haps, hap_lens,
                     hap_stride, sp_read.data() + p, sp_hap.data() + p, gop,
                     gcp, sp_out.data() + p);
    }
    for (int64_t i = 0; i < p; ++i) out[order[i]] = sp_out[i];
    for (; p < n_pairs; ++p) {
      const int32_t r = sp_read[p];
      const int32_t h = sp_hap[p];
      out[order[p]] = static_cast<float>(pairhmm_one<float>(
          reads + static_cast<int64_t>(r) * read_stride,
          quals + static_cast<int64_t>(r) * read_stride, read_lens[r],
          haps + static_cast<int64_t>(h) * hap_stride, hap_lens[h], gop,
          gcp));
    }
    return;
  }
#endif
  for (; p < n_pairs; ++p) {
    const int32_t r = pair_read[p];
    const int32_t h = pair_hap[p];
    out[p] = static_cast<float>(pairhmm_one<float>(
        reads + static_cast<int64_t>(r) * read_stride,
        quals + static_cast<int64_t>(r) * read_stride, read_lens[r],
        haps + static_cast<int64_t>(h) * hap_stride, hap_lens[h], gop, gcp));
  }
}

void hc_pairhmm_f64(const uint8_t* reads, const uint8_t* quals,
                    const int32_t* read_lens, int32_t read_stride,
                    const uint8_t* haps, const int32_t* hap_lens,
                    int32_t hap_stride, const int32_t* pair_read,
                    const int32_t* pair_hap, int64_t n_pairs, int32_t gop,
                    int32_t gcp, double* out) {
  FtzScope ftz;
  int64_t p = 0;
#ifdef HC_HAVE_SSE
  static const bool force_scalar = [] {
    const char* env = std::getenv("HC_PAIRHMM_SCALAR");
    return env != nullptr && env[0] != '\0' && env[0] != '0';
  }();
  if (!force_scalar) {
    // same length-sorted blocking as the f32 entry (order-independent)
    thread_local std::vector<int64_t> order;
    thread_local std::vector<int32_t> sp_read, sp_hap;
    thread_local std::vector<double> sp_out;
    order.resize(n_pairs);
    for (int64_t i = 0; i < n_pairs; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      const int32_t ha = hap_lens[pair_hap[a]], hb = hap_lens[pair_hap[b]];
      if (ha != hb) return ha > hb;
      const int32_t ra = read_lens[pair_read[a]], rb = read_lens[pair_read[b]];
      if (ra != rb) return ra > rb;
      return a < b;
    });
    sp_read.resize(n_pairs);
    sp_hap.resize(n_pairs);
    sp_out.resize(n_pairs);
    for (int64_t i = 0; i < n_pairs; ++i) {
      sp_read[i] = pair_read[order[i]];
      sp_hap[i] = pair_hap[order[i]];
    }
    for (; p + 4 <= n_pairs; p += 4) {
      pairhmm_f64_x4(reads, quals, read_lens, read_stride, haps, hap_lens,
                     hap_stride, sp_read.data() + p, sp_hap.data() + p, gop,
                     gcp, sp_out.data() + p);
    }
    for (int64_t i = 0; i < p; ++i) out[order[i]] = sp_out[i];
    for (; p < n_pairs; ++p) {
      const int32_t r = sp_read[p];
      const int32_t h = sp_hap[p];
      out[order[p]] = pairhmm_one<double>(
          reads + static_cast<int64_t>(r) * read_stride,
          quals + static_cast<int64_t>(r) * read_stride, read_lens[r],
          haps + static_cast<int64_t>(h) * hap_stride, hap_lens[h], gop,
          gcp);
    }
    return;
  }
#endif
  for (; p < n_pairs; ++p) {
    const int32_t r = pair_read[p];
    const int32_t h = pair_hap[p];
    out[p] = pairhmm_one<double>(
        reads + static_cast<int64_t>(r) * read_stride,
        quals + static_cast<int64_t>(r) * read_stride, read_lens[r],
        haps + static_cast<int64_t>(h) * hap_stride, hap_lens[h], gop, gcp);
  }
}

// cfg ints: [initial_kmer, kmer_increase, max_iterations, max_unique_kmers,
//            prune_factor, min_base_quality, max_haplotypes]
int32_t hc_assemble(const uint8_t* ref, int64_t ref_len, const uint8_t* seqs,
                    const uint8_t* quals, const int64_t* offsets,
                    int32_t n_reads, const int32_t* cfg, uint8_t* out_bases,
                    int64_t out_cap, int64_t* out_offsets, double* out_scores,
                    int32_t max_out) {
  const int initial_kmer = cfg[0];
  const int kmer_increase = cfg[1];
  const int max_iterations = cfg[2];
  const size_t max_unique = cfg[3];
  const int prune_factor = cfg[4];
  const int min_qual = cfg[5];
  const size_t max_haplotypes = cfg[6];

  const std::string_view ref_view(reinterpret_cast<const char*>(ref), ref_len);

  struct Hap {
    std::string bases;
    double score;
  };
  std::vector<Hap> haplotypes;

  g_prof[7].fetch_add(1, std::memory_order_relaxed);
  int64_t t_last = prof_now();
  auto mark = [&t_last](int slot) {
    const int64_t now = prof_now();
    g_prof[slot].fetch_add(now - t_last, std::memory_order_relaxed);
    t_last = now;
  };

  bool attempted_before = false;
  for (int iteration = 0; iteration < max_iterations; ++iteration) {
    const int kmer_size = initial_kmer + iteration * kmer_increase;
    if (ref_len < kmer_size) continue;
    // a retry = an assembly ATTEMPT after an earlier attempt failed (not
    // merely iteration > 0: skipped short-ref rungs are not attempts)
    if (attempted_before)
      g_prof[8].fetch_add(1, std::memory_order_relaxed);
    attempted_before = true;

    // usable read segments (graph_wrapper.hpp:266-286), with the
    // packed-mode ACGT-purity check fused into the same byte scan (the
    // separate all_acgt pass re-read every segment byte per region)
    std::vector<std::string_view> segments;
    bool segs_acgt = true;
    for (int rr = 0; rr < n_reads; ++rr) {
      const char* seq = reinterpret_cast<const char*>(seqs) + offsets[rr];
      const char* qual = reinterpret_cast<const char*>(quals) + offsets[rr];
      const int64_t len = offsets[rr + 1] - offsets[rr];
      int64_t start = -1;
      bool run_acgt = true;
      for (int64_t i = 0; i <= len; ++i) {
        const char ch = i < len ? seq[i] : 'N';
        const bool usable =
            i < len && ch != 'N' && static_cast<uint8_t>(qual[i]) >= min_qual;
        if (!usable) {
          if (start >= 0 && i - start >= kmer_size) {
            segments.emplace_back(seq + start, i - start);
            segs_acgt &= run_acgt;
          }
          start = -1;
          run_acgt = true;
        } else {
          if (start < 0) start = i;
          run_acgt &= (ch == 'A') | (ch == 'C') | (ch == 'G') | (ch == 'T');
        }
      }
    }

    Assembly graph;
    graph.k = kmer_size;
    graph.prune_factor = prune_factor;

    auto all_acgt = [](std::string_view sv) {
      for (char ch : sv)
        if (ch != 'A' && ch != 'C' && ch != 'G' && ch != 'T') return false;
      return true;
    };
    graph.packed = kmer_size <= 32 && segs_acgt && all_acgt(ref_view);

    size_t total_positions = ref_view.size();
    for (auto seg : segments) total_positions += seg.size();
    if (graph.packed) {
      graph.dup_p.init(total_positions / 8 + 16);
      graph.unique_p.init(total_positions / 2 + 16);
    }

    // hashed set (membership-only): the former std::set red-black tree cost
    // O(k log n) string compares per kmer and dominated region assembly
    std::unordered_set<std::string_view> seen;
    FlatSet64 seen_p;
    if (graph.packed) {
      // one table sized for the LONGEST sequence, wiped per sequence via
      // tracked-slot resets (grow() provably never fires: per-seq count
      // <= cap/2 < the 0.7 load-factor trigger)
      size_t max_len = ref_view.size();
      for (auto seg : segments) max_len = std::max(max_len, seg.size());
      seen_p.init(max_len - kmer_size + 1);
    }
    auto collect_dups = [&](std::string_view seq) {
      if (graph.packed) {
        seen_p.reset_tracked();
        const uint64_t mask =
            kmer_size == 32 ? ~0ull : ((1ull << (2 * kmer_size)) - 1);
        uint64_t v = 0;
        for (size_t i = 0; i < seq.size(); ++i) {
          v = ((v << 2) | Assembly::pack_code(seq[i])) & mask;
          if (i + 1 >= static_cast<size_t>(kmer_size) &&
              !seen_p.insert_tracked(v))
            graph.dup_p.insert(v);
        }
        return;
      }
      seen.clear();
      if (seq.size() >= kmer_size) seen.reserve(seq.size() - kmer_size + 1);
      for (size_t i = 0; i + kmer_size <= seq.size(); ++i) {
        auto kmer = seq.substr(i, kmer_size);
        if (!seen.insert(kmer).second) graph.dup_kmers.insert(kmer);
      }
    };
    collect_dups(ref_view);
    for (auto seg : segments) collect_dups(seg);
    mark(0);

    graph.add_seq(ref_view, true);
    for (auto seg : segments) graph.add_seq(seg, false);
    mark(1);

    if (graph.unique_count() > max_unique) {
      mark(2);
      continue;
    }
    if (graph.has_cycles()) {
      mark(2);
      continue;
    }
    mark(2);

    std::vector<std::vector<int>> paths;
    if (!graph.find_paths(&paths, 200000)) return -3;  // path explosion
    mark(3);

    // scores
    // dense flags/score arrays over the contiguous vertex/edge id spaces;
    // per-vertex fan-out sums follow each vertex's own edge insertion order so
    // results are identical to the former hash-set iteration
    std::vector<uint8_t> vertex_on_path(graph.kmers.size(), 0);
    std::vector<uint8_t> edge_on_path(graph.e_src.size(), 0);
    for (const auto& path : paths) {
      for (int v : path) vertex_on_path[v] = 1;
      for (size_t i = 1; i < path.size(); ++i)
        edge_on_path[graph.edge_between(path[i - 1], path[i])] = 1;
    }
    std::vector<double> edge_score(graph.e_src.size(), 0.0);
    for (size_t v = 0; v < vertex_on_path.size(); ++v) {
      if (!vertex_on_path[v]) continue;
      double sum = 0;
      for (int eid = graph.out_head[v]; eid >= 0; eid = graph.out_next[eid])
        if (edge_on_path[eid]) sum += graph.e_count[eid];
      for (int eid = graph.out_head[v]; eid >= 0; eid = graph.out_next[eid])
        if (edge_on_path[eid])
          edge_score[eid] = std::log10(graph.e_count[eid] / sum);
    }

    haplotypes.clear();
    for (const auto& path : paths) {
      std::string seq(graph.kmers[path[0]]);
      double score = 0;
      for (size_t i = 1; i < path.size(); ++i) {
        seq += graph.kmers[path[i]].back();
        score += edge_score[graph.edge_between(path[i - 1], path[i])];
      }
      haplotypes.push_back({std::move(seq), score});
    }
    std::stable_sort(haplotypes.begin(), haplotypes.end(),
                     [](const Hap& a, const Hap& b) { return a.score > b.score; });
    if (haplotypes.size() > max_haplotypes) haplotypes.resize(max_haplotypes);
    mark(4);

    if (!haplotypes.empty()) break;  // accepted this kmer size
  }

  const int32_t n = static_cast<int32_t>(std::min<size_t>(haplotypes.size(), max_out));
  int64_t cursor = 0;
  out_offsets[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    const auto& h = haplotypes[i];
    if (cursor + static_cast<int64_t>(h.bases.size()) > out_cap) return -2;
    std::memcpy(out_bases + cursor, h.bases.data(), h.bases.size());
    cursor += h.bases.size();
    out_offsets[i + 1] = cursor;
    out_scores[i] = h.score;
  }
  return n;
}

// Assembly + per-haplotype SW alignment in one call: removes one ctypes
// round trip per haplotype (the per-call overhead dominated host assembly
// time at WGS scale).  sw_cfg: [w_match, w_mismatch, w_open, w_extend,
// max_mismatches_all_match].  CIGARs come back as (op char, length) element
// arrays in CSR layout — no string parse on the Python side.
int32_t hc_assemble_sw(const uint8_t* ref, int64_t ref_len,
                       const uint8_t* seqs, const uint8_t* quals,
                       const int64_t* offsets, int32_t n_reads,
                       const int32_t* cfg, const int32_t* sw_cfg,
                       uint8_t* out_bases, int64_t out_cap,
                       int64_t* out_offsets, double* out_scores,
                       int32_t max_out, int32_t* out_align_offset,
                       uint8_t* out_cigar_ops, int32_t* out_cigar_lens,
                       int64_t* out_cigar_offsets, int64_t cigar_cap) {
  const int32_t n = hc_assemble(ref, ref_len, seqs, quals, offsets, n_reads,
                                cfg, out_bases, out_cap, out_offsets,
                                out_scores, max_out);
  if (n <= 0) return n;
  const int64_t t_sw = prof_now();
  int64_t cursor = 0;
  out_cigar_offsets[0] = 0;
  SWResult result;
  for (int32_t i = 0; i < n; ++i) {
    const uint8_t* alt = out_bases + out_offsets[i];
    const int alt_len = static_cast<int>(out_offsets[i + 1] - out_offsets[i]);
    const int rc = sw_align_impl(ref, static_cast<int>(ref_len), alt, alt_len,
                                 sw_cfg[0], sw_cfg[1], sw_cfg[2], sw_cfg[3],
                                 sw_cfg[4], &result);
    if (rc != 0) return -4;
    out_align_offset[i] = result.offset;
    if (cursor + static_cast<int64_t>(result.elements.size()) > cigar_cap)
      return -5;
    for (const auto& [op, len] : result.elements) {
      out_cigar_ops[cursor] = static_cast<uint8_t>(op);
      out_cigar_lens[cursor] = len;
      ++cursor;
    }
    out_cigar_offsets[i + 1] = cursor;
  }
  g_prof[5].fetch_add(prof_now() - t_sw, std::memory_order_relaxed);
  return n;
}

// ---------------------------------------------------------------------------
// Columnar SAM data path (production fast path for io/sam.py +
// models/downsampler.py + models/read_filters.py + models/read_clipper.py;
// semantics differential-tested against the Python pipeline, which remains
// the oracle).  Mirrors the reference's C++ data layer (sam.hpp:100-114,
// read_filter.hpp:8-38, read_clipper.hpp:32-91) at columnar granularity.

// SIMD whitespace finder: the scan+parse passes walk the whole SAM text
// twice and the long SEQ/QUAL fields are ~60% of its bytes — stepping 16
// bytes per iteration instead of 1 makes both passes memory-bound.
static inline const uint8_t* find_ws(const uint8_t* p, const uint8_t* end) {
#ifdef HC_HAVE_SSE
  const __m128i sp = _mm_set1_epi8(' ');
  const __m128i tb = _mm_set1_epi8('\t');
  while (p + 16 <= end) {
    const __m128i v = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
    const int m = _mm_movemask_epi8(
        _mm_or_si128(_mm_cmpeq_epi8(v, sp), _mm_cmpeq_epi8(v, tb)));
    if (m) return p + __builtin_ctz(m);
    p += 16;
  }
#endif
  while (p < end && *p != ' ' && *p != '\t') ++p;
  return p;
}

static inline const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
  const void* hit = std::memchr(p, '\n', static_cast<size_t>(end - p));
  return hit ? static_cast<const uint8_t*>(hit) : end;
}

// Split one SAM line into up to 11 (ptr, len) fields; returns the count.
static inline int split_line_fields(const uint8_t* line, const uint8_t* eol,
                                    const uint8_t** f_ptr, int64_t* f_len) {
  int field = 0;
  const uint8_t* p = line;
  while (p < eol && field < 11) {
    while (p < eol && (*p == ' ' || *p == '\t')) ++p;
    const uint8_t* start = p;
    p = find_ws(p, eol);
    if (p > start) {
      f_ptr[field] = start;
      f_len[field] = p - start;
      ++field;
    }
  }
  return field;
}

// Pass 1: count records / cigar ops / sequence bytes so Python can allocate.
void hc_sam_scan(const uint8_t* buf, int64_t n, int64_t* out_reads,
                 int64_t* out_cigar_ops, int64_t* out_seq_bytes) {
  int64_t reads = 0, ops = 0, bytes = 0;
  const uint8_t* p = buf;
  const uint8_t* end = buf + n;
  while (p < end) {
    const uint8_t* eol = find_nl(p, end);
    if (eol > p && *p != '@') {
      const uint8_t* f_ptr[11];
      int64_t f_len[11];
      const int field = split_line_fields(p, eol, f_ptr, f_len);
      if (field >= 11) {
        ++reads;
        // field 5 (cigar) op count = count of non-digit chars
        for (int64_t k = 0; k < f_len[5]; ++k)
          if (!(f_ptr[5][k] >= '0' && f_ptr[5][k] <= '9')) ++ops;
        bytes += f_len[9];
      } else {
        // keep the pre-SIMD contract: partial lines still tally their
        // cigar/seq sizes (allocation upper bounds, never undercounted)
        if (field > 5)
          for (int64_t k = 0; k < f_len[5]; ++k)
            if (!(f_ptr[5][k] >= '0' && f_ptr[5][k] <= '9')) ++ops;
        if (field > 9) bytes += f_len[9];
      }
    }
    p = eol + 1;
  }
  *out_reads = reads;
  *out_cigar_ops = ops;
  *out_seq_bytes = bytes;
}

// Digit-validated int like Python's int(): a non-numeric FLAG/POS/MAPQ
// field is a malformed line, same error contract as the <11-fields path.
static inline int64_t sam_field_int(const uint8_t* p, int64_t len, bool* ok) {
  int64_t v = 0;
  bool neg = false;
  int64_t k = 0;
  if (len > 0 && (p[0] == '-' || p[0] == '+')) {
    neg = p[0] == '-';
    k = 1;
  }
  if (k >= len) *ok = false;
  for (; k < len; ++k) {
    if (p[k] < '0' || p[k] > '9') {
      *ok = false;
      return 0;
    }
    v = v * 10 + (p[k] - '0');
  }
  return neg ? -v : v;
}

static inline int32_t match_contig(const uint8_t* p, int64_t len,
                                   const uint8_t* blob, const int64_t* offs,
                                   int32_t n_contigs) {
  for (int32_t c = 0; c < n_contigs; ++c) {
    const int64_t clen = offs[c + 1] - offs[c];
    if (clen == len && std::memcmp(blob + offs[c], p, clen) == 0) return c;
  }
  return -1;
}

// Pass 2: fill columnar arrays.  contig_blob/contig_offs name the FASTA
// contigs; rname_id is the matching index or -1.  Returns records parsed,
// or -(line_number) on a malformed line (fewer than 11 fields).
//
// When keep_lo/keep_hi are non-null they give a per-contig 0-based
// start-position range and only records with keep_lo[c] <= POS-1 <
// keep_hi[c] are materialized; records matching no contig are dropped
// (the shard-restricted store only exists to hold usable reads).  The
// unfiltered entry point keeps unmatched records with rname_id = -1.
// r0/ops0/seq0/line0 seed the output cursors so byte-block workers of the
// multi-threaded parse write disjoint absolute ranges of the shared arrays
// (the single-thread entry points pass zeros).  The caller initializes
// cig_off[0]/seq_off[0].  Returns the absolute record count after this
// slice, or -(absolute line number) on a malformed line.
static int64_t sam_parse_impl(const uint8_t* buf, int64_t n,
                              const uint8_t* contig_blob,
                              const int64_t* contig_offs, int32_t n_contigs,
                              const int64_t* keep_lo, const int64_t* keep_hi,
                              int64_t r0, int64_t ops0, int64_t seq0,
                              int64_t line0,
                              int32_t* pos, int32_t* flag, int32_t* mapq,
                              uint8_t* rnext_eq, int32_t* rname_id,
                              int64_t* cig_off, uint8_t* cig_op,
                              int32_t* cig_len, int64_t* seq_off, uint8_t* seq,
                              uint8_t* qual) {
  int64_t r = r0, line_no = line0;
  int64_t ops_cursor = ops0, seq_cursor = seq0;
  int64_t i = 0;
  while (i < n) {
    ++line_no;
    const int64_t eol = find_nl(buf + i, buf + n) - buf;
    if (eol == i || buf[i] == '@') {
      i = eol + 1;
      continue;
    }
    const uint8_t* f_ptr[11];
    int64_t f_len[11];
    const int field = split_line_fields(buf + i, buf + eol, f_ptr, f_len);
    if (field < 11) {
      // blank-ish line (only whitespace) is skipped like Python's rstrip
      if (field == 0) {
        i = eol + 1;
        continue;
      }
      return -line_no;
    }
    bool num_ok = true;
    const int64_t f_flag = sam_field_int(f_ptr[1], f_len[1], &num_ok);
    const int64_t f_pos = sam_field_int(f_ptr[3], f_len[3], &num_ok);
    const int64_t f_mapq = sam_field_int(f_ptr[4], f_len[4], &num_ok);
    if (!num_ok) return -line_no;
    const int32_t cid = match_contig(f_ptr[2], f_len[2], contig_blob,
                                     contig_offs, n_contigs);
    if (keep_lo != nullptr) {
      if (cid < 0 || f_pos - 1 < keep_lo[cid] || f_pos - 1 >= keep_hi[cid]) {
        i = eol + 1;
        continue;
      }
    }
    flag[r] = static_cast<int32_t>(f_flag);
    pos[r] = static_cast<int32_t>(f_pos);
    mapq[r] = static_cast<int32_t>(f_mapq);
    rnext_eq[r] = (f_len[6] == 1 && f_ptr[6][0] == '=') ? 1 : 0;
    rname_id[r] = cid;
    // cigar: "*" -> no ops
    if (!(f_len[5] == 1 && f_ptr[5][0] == '*')) {
      int64_t count = 0;
      for (int64_t k = 0; k < f_len[5]; ++k) {
        const uint8_t ch = f_ptr[5][k];
        if (ch >= '0' && ch <= '9') {
          count = count * 10 + (ch - '0');
        } else {
          cig_op[ops_cursor] = ch;
          cig_len[ops_cursor] = static_cast<int32_t>(count);
          ++ops_cursor;
          count = 0;
        }
      }
    }
    cig_off[r + 1] = ops_cursor;
    std::memcpy(seq + seq_cursor, f_ptr[9], f_len[9]);
    // SAM guarantees |QUAL| == |SEQ|; guard against malformed lines anyway
    const int64_t qlen = std::min(f_len[10], f_len[9]);
    std::memcpy(qual + seq_cursor, f_ptr[10], qlen);
    if (qlen < f_len[9]) std::memset(qual + seq_cursor + qlen, '!', f_len[9] - qlen);
    seq_cursor += f_len[9];
    seq_off[r + 1] = seq_cursor;
    ++r;
    i = eol + 1;
  }
  return r;
}

int64_t hc_sam_parse(const uint8_t* buf, int64_t n, const uint8_t* contig_blob,
                     const int64_t* contig_offs, int32_t n_contigs,
                     int32_t* pos, int32_t* flag, int32_t* mapq,
                     uint8_t* rnext_eq, int32_t* rname_id, int64_t* cig_off,
                     uint8_t* cig_op, int32_t* cig_len, int64_t* seq_off,
                     uint8_t* seq, uint8_t* qual) {
  cig_off[0] = 0;
  seq_off[0] = 0;
  return sam_parse_impl(buf, n, contig_blob, contig_offs, n_contigs, nullptr,
                        nullptr, 0, 0, 0, 0, pos, flag, mapq, rnext_eq,
                        rname_id, cig_off, cig_op, cig_len, seq_off, seq,
                        qual);
}

// Shard-restricted parse: only records inside the per-contig start ranges
// are materialized (multi-host SAM sharding + contig-streaming memory
// bounding, SURVEY.md §5/§7 step 7).  Same malformed-line error contract as
// hc_sam_parse; line numbers are relative to `buf`, so callers handing a
// byte slice must translate.
int64_t hc_sam_parse_ranges(const uint8_t* buf, int64_t n,
                            const uint8_t* contig_blob,
                            const int64_t* contig_offs, int32_t n_contigs,
                            const int64_t* keep_lo, const int64_t* keep_hi,
                            int32_t* pos, int32_t* flag, int32_t* mapq,
                            uint8_t* rnext_eq, int32_t* rname_id,
                            int64_t* cig_off, uint8_t* cig_op,
                            int32_t* cig_len, int64_t* seq_off, uint8_t* seq,
                            uint8_t* qual) {
  cig_off[0] = 0;
  seq_off[0] = 0;
  return sam_parse_impl(buf, n, contig_blob, contig_offs, n_contigs, keep_lo,
                        keep_hi, 0, 0, 0, 0, pos, flag, mapq, rnext_eq,
                        rname_id, cig_off, cig_op, cig_len, seq_off, seq,
                        qual);
}

// Exact per-block sizing for the multi-threaded parse: unlike hc_sam_scan's
// allocation upper bounds, these counts must equal what sam_parse_impl
// writes for a VALID block ("*" cigars contribute zero ops; only >=11-field
// lines are records; with keep ranges, only contig-matched records whose
// POS-1 is in range).  The parallel fill consumes these counts BEFORE the
// malformed-line error check, so the predicate must never count a line the
// allocation scan skipped (see the ranged branch below) — overcounting
// would write past the allocated arrays.
static void sam_count_block(const uint8_t* buf, int64_t lo, int64_t hi,
                            const uint8_t* contig_blob,
                            const int64_t* contig_offs, int32_t n_contigs,
                            const int64_t* keep_lo, const int64_t* keep_hi,
                            int64_t* out_recs, int64_t* out_ops,
                            int64_t* out_bytes, int64_t* out_lines) {
  int64_t recs = 0, ops = 0, bytes = 0, lines = 0;
  int64_t i = lo;
  while (i < hi) {
    ++lines;
    const int64_t eol = find_nl(buf + i, buf + hi) - buf;
    if (eol > i && buf[i] != '@') {
      const uint8_t* f_ptr[11];
      int64_t f_len[11];
      const int field = split_line_fields(buf + i, buf + eol, f_ptr, f_len);
      if (field >= 11) {
        bool kept = true;
        if (keep_lo != nullptr) {
          bool ok = true;
          const int64_t f_pos = sam_field_int(f_ptr[3], f_len[3], &ok);
          const int32_t cid = match_contig(f_ptr[2], f_len[2], contig_blob,
                                           contig_offs, n_contigs);
          // a non-numeric-POS line must NOT count as kept: the allocation
          // scan (sam_scan_ranges_block) skips it, so counting it here
          // would push every later block's prefix-summed cursor past the
          // allocated arrays before pass 2 reports the error.  Pass 2
          // aborts at the line either way, so skipping keeps the cursors
          // consistent with both the allocation and the records parse
          // actually writes.
          kept = ok && cid >= 0 && f_pos - 1 >= keep_lo[cid] &&
                 f_pos - 1 < keep_hi[cid];
        }
        if (kept) {
          ++recs;
          if (!(f_len[5] == 1 && f_ptr[5][0] == '*'))
            for (int64_t k = 0; k < f_len[5]; ++k)
              if (!(f_ptr[5][k] >= '0' && f_ptr[5][k] <= '9')) ++ops;
          bytes += f_len[9];
        }
      }
    }
    i = eol + 1;
  }
  *out_recs = recs;
  *out_ops = ops;
  *out_bytes = bytes;
  *out_lines = lines;
}

// Multi-threaded parse: newline-aligned byte blocks, an exact counting
// pass, prefix-summed output cursors, then a parallel fill of the shared
// columnar arrays (disjoint ranges per block).  Outputs are
// byte-identical to hc_sam_parse / hc_sam_parse_ranges for any thread
// count; a malformed line reports the same (earliest) absolute line
// number.  The reference's data layer is a serial stream
// (sam.hpp:100-114) — this is the multi-core replacement for the
// serial-parse Amdahl term when host assembly already pools across cores.
// keep_lo/keep_hi non-null = shard-restricted counting + fill (the same
// predicate as sam_parse_impl: contig matched AND POS-1 in range).
static int64_t sam_parse_mt_impl(
    const uint8_t* buf, int64_t n, const uint8_t* contig_blob,
    const int64_t* contig_offs, int32_t n_contigs, const int64_t* keep_lo,
    const int64_t* keep_hi, int32_t n_threads, int32_t* pos, int32_t* flag,
    int32_t* mapq, uint8_t* rnext_eq, int32_t* rname_id, int64_t* cig_off,
    uint8_t* cig_op, int32_t* cig_len, int64_t* seq_off, uint8_t* seq,
    uint8_t* qual) {
  int T = std::max(1, std::min(n_threads, 64));
  if (static_cast<int64_t>(T) > n / (1 << 20)) {  // >=1 MB of text per block
    T = std::max<int>(1, static_cast<int>(n / (1 << 20)));
  }
  if (T == 1) {
    cig_off[0] = 0;
    seq_off[0] = 0;
    return sam_parse_impl(buf, n, contig_blob, contig_offs, n_contigs,
                          keep_lo, keep_hi, 0, 0, 0, 0, pos, flag, mapq,
                          rnext_eq, rname_id, cig_off, cig_op, cig_len,
                          seq_off, seq, qual);
  }
  std::vector<int64_t> starts(T + 1);
  starts[0] = 0;
  starts[T] = n;
  for (int b = 1; b < T; ++b) {
    int64_t s = std::max(starts[b - 1], b * (n / T));
    const void* nl =
        s < n ? std::memchr(buf + s, '\n', static_cast<size_t>(n - s))
              : nullptr;
    starts[b] =
        nl ? (static_cast<const uint8_t*>(nl) - buf) + 1 : n;
  }
  std::vector<int64_t> recs(T), ops(T), bytes(T), lines(T);
  {
    std::vector<std::thread> th;
    th.reserve(T);
    for (int b = 0; b < T; ++b)
      th.emplace_back([&, b] {
        sam_count_block(buf, starts[b], starts[b + 1], contig_blob,
                        contig_offs, n_contigs, keep_lo, keep_hi, &recs[b],
                        &ops[b], &bytes[b], &lines[b]);
      });
    for (auto& t : th) t.join();
  }
  std::vector<int64_t> r0(T + 1, 0), o0(T + 1, 0), s0(T + 1, 0), l0(T + 1, 0);
  for (int b = 0; b < T; ++b) {
    r0[b + 1] = r0[b] + recs[b];
    o0[b + 1] = o0[b] + ops[b];
    s0[b + 1] = s0[b] + bytes[b];
    l0[b + 1] = l0[b] + lines[b];
  }
  cig_off[0] = 0;
  seq_off[0] = 0;
  std::vector<int64_t> ret(T);
  {
    std::vector<std::thread> th;
    th.reserve(T);
    for (int b = 0; b < T; ++b)
      th.emplace_back([&, b] {
        ret[b] = sam_parse_impl(
            buf + starts[b], starts[b + 1] - starts[b], contig_blob,
            contig_offs, n_contigs, keep_lo, keep_hi, r0[b], o0[b], s0[b],
            l0[b], pos, flag, mapq, rnext_eq, rname_id, cig_off, cig_op,
            cig_len, seq_off, seq, qual);
      });
    for (auto& t : th) t.join();
  }
  for (int b = 0; b < T; ++b)  // earliest malformed line wins, like serial
    if (ret[b] < 0) return ret[b];
  return r0[T];
}

int64_t hc_sam_parse_mt(const uint8_t* buf, int64_t n,
                        const uint8_t* contig_blob, const int64_t* contig_offs,
                        int32_t n_contigs, int32_t n_threads,
                        int32_t* pos, int32_t* flag, int32_t* mapq,
                        uint8_t* rnext_eq, int32_t* rname_id,
                        int64_t* cig_off, uint8_t* cig_op, int32_t* cig_len,
                        int64_t* seq_off, uint8_t* seq, uint8_t* qual) {
  return sam_parse_mt_impl(buf, n, contig_blob, contig_offs, n_contigs,
                           nullptr, nullptr, n_threads, pos, flag, mapq,
                           rnext_eq, rname_id, cig_off, cig_op, cig_len,
                           seq_off, seq, qual);
}

// Shard-restricted multi-threaded parse (streaming contig slices and
// multihost shard parses are ~1 GB each at WGS scale).
int64_t hc_sam_parse_ranges_mt(
    const uint8_t* buf, int64_t n, const uint8_t* contig_blob,
    const int64_t* contig_offs, int32_t n_contigs, const int64_t* keep_lo,
    const int64_t* keep_hi, int32_t n_threads, int32_t* pos, int32_t* flag,
    int32_t* mapq, uint8_t* rnext_eq, int32_t* rname_id, int64_t* cig_off,
    uint8_t* cig_op, int32_t* cig_len, int64_t* seq_off, uint8_t* seq,
    uint8_t* qual) {
  return sam_parse_mt_impl(buf, n, contig_blob, contig_offs, n_contigs,
                           keep_lo, keep_hi, n_threads, pos, flag, mapq,
                           rnext_eq, rname_id, cig_off, cig_op, cig_len,
                           seq_off, seq, qual);
}

// Pass 1 (shard-restricted): per-contig allocation counts AND the byte range
// of the file that covers each contig's kept records, so pass 2 (and any
// later per-contig streaming parse) touches only that slice.  `out` is
// (n_contigs x 5) int64 rows: kept reads, cigar-op upper bound, seq bytes,
// byte_lo, byte_hi (byte_lo/byte_hi are -1 when nothing matched).  Records
// whose RNAME matches no contig are not counted (unlike hc_sam_scan, which
// sizes the keep-everything store).  Lines that fail numeric POS validation
// are skipped here; pass 2 reports them if they fall inside a parsed slice.
static void sam_scan_ranges_block(const uint8_t* buf, int64_t lo, int64_t hi,
                                  const uint8_t* contig_blob,
                                  const int64_t* contig_offs,
                                  int32_t n_contigs, const int64_t* keep_lo,
                                  const int64_t* keep_hi, int64_t* out) {
  for (int32_t c = 0; c < n_contigs; ++c) {
    int64_t* row = out + c * 5;
    row[0] = row[1] = row[2] = 0;
    row[3] = row[4] = -1;
  }
  int64_t i = lo;
  const int64_t n = hi;
  while (i < n) {
    const int64_t eol = find_nl(buf + i, buf + n) - buf;
    if (eol > i && buf[i] != '@') {
      const uint8_t* f_ptr[11];
      int64_t f_len[11];
      const int field = split_line_fields(buf + i, buf + eol, f_ptr, f_len);
      if (field >= 11) {
        const int32_t cid = match_contig(f_ptr[2], f_len[2], contig_blob,
                                         contig_offs, n_contigs);
        if (cid >= 0) {
          bool ok = true;
          const int64_t begin = sam_field_int(f_ptr[3], f_len[3], &ok) - 1;
          if (ok && begin >= keep_lo[cid] && begin < keep_hi[cid]) {
            int64_t* row = out + cid * 5;
            row[0] += 1;
            for (int64_t k = 0; k < f_len[5]; ++k)
              if (!(f_ptr[5][k] >= '0' && f_ptr[5][k] <= '9')) row[1] += 1;
            row[2] += f_len[9];
            if (row[3] < 0) row[3] = i;
            row[4] = std::min<int64_t>(eol + 1, n);
          }
        }
      }
    }
    i = eol + 1;
  }
}

void hc_sam_scan_ranges(const uint8_t* buf, int64_t n,
                        const uint8_t* contig_blob, const int64_t* contig_offs,
                        int32_t n_contigs, const int64_t* keep_lo,
                        const int64_t* keep_hi, int64_t* out) {
  sam_scan_ranges_block(buf, 0, n, contig_blob, contig_offs, n_contigs,
                        keep_lo, keep_hi, out);
}

// Multi-threaded ranged scan: newline-aligned byte blocks scanned in
// parallel, per-block (n_contigs x 5) rows merged (counts add; byte_lo is
// the min, byte_hi the max — block offsets are absolute, so the merge is
// order-free).  Identical output to hc_sam_scan_ranges for any thread
// count.  This is the one whole-file pass left on the streaming startup
// path once parse-ahead hides the per-contig parses.
void hc_sam_scan_ranges_mt(const uint8_t* buf, int64_t n,
                           const uint8_t* contig_blob,
                           const int64_t* contig_offs, int32_t n_contigs,
                           const int64_t* keep_lo, const int64_t* keep_hi,
                           int32_t n_threads, int64_t* out) {
  int T = std::max(1, std::min(n_threads, 64));
  if (static_cast<int64_t>(T) > n / (1 << 20)) {
    T = std::max<int>(1, static_cast<int>(n / (1 << 20)));
  }
  if (T == 1) {
    hc_sam_scan_ranges(buf, n, contig_blob, contig_offs, n_contigs, keep_lo,
                       keep_hi, out);
    return;
  }
  std::vector<int64_t> starts(T + 1);
  starts[0] = 0;
  starts[T] = n;
  for (int b = 1; b < T; ++b) {
    int64_t s = std::max(starts[b - 1], b * (n / T));
    const void* nl =
        s < n ? std::memchr(buf + s, '\n', static_cast<size_t>(n - s))
              : nullptr;
    starts[b] = nl ? (static_cast<const uint8_t*>(nl) - buf) + 1 : n;
  }
  std::vector<int64_t> rows(static_cast<size_t>(T) * n_contigs * 5);
  std::vector<std::thread> th;
  th.reserve(T);
  for (int b = 0; b < T; ++b)
    th.emplace_back([&, b] {
      sam_scan_ranges_block(buf, starts[b], starts[b + 1], contig_blob,
                            contig_offs, n_contigs, keep_lo, keep_hi,
                            rows.data() + static_cast<size_t>(b) * n_contigs * 5);
    });
  for (auto& t : th) t.join();
  for (int32_t c = 0; c < n_contigs; ++c) {
    int64_t* row = out + c * 5;
    row[0] = row[1] = row[2] = 0;
    row[3] = row[4] = -1;
    for (int b = 0; b < T; ++b) {
      const int64_t* br = rows.data() + (static_cast<size_t>(b) * n_contigs + c) * 5;
      row[0] += br[0];
      row[1] += br[1];
      row[2] += br[2];
      if (br[3] >= 0 && (row[3] < 0 || br[3] < row[3])) row[3] = br[3];
      if (br[4] >= 0 && br[4] > row[4]) row[4] = br[4];
    }
    if (row[3] < 0) row[4] = -1;  // nothing matched: keep the (-1, -1) pair
  }
}

static inline bool ref_consuming(uint8_t op) {
  return op == 'M' || op == 'D' || op == 'N' || op == '=' || op == 'X';
}

// Per-window pipeline: MAPQ/dup/secondary/mate filters (caller order,
// haplotypecaller.hpp:52-66), strand-dependent soft-clip reversion
// (read_clipper.hpp:32-66), hard clip to the padded window WITHOUT touching
// the cigar (read_clipper.hpp:68-91 — alignment_end stays stale), minimum
// length.  `sel` lists store rows in window position order.  Returns kept
// count; fills CSR seq/qual blobs and the post-revert alignment spans.
int32_t hc_prepare_window(const int32_t* pos, const int32_t* flag,
                          const int32_t* mapq, const uint8_t* rnext_eq,
                          const int64_t* cig_off, const uint8_t* cig_op,
                          const int32_t* cig_len, const int64_t* seq_off,
                          const uint8_t* seq, const uint8_t* qual,
                          const int64_t* sel, int32_t n_sel, int32_t min_mapq,
                          int32_t min_len, int64_t win_begin, int64_t win_end,
                          uint8_t* out_seq, uint8_t* out_qual,
                          int64_t* out_off, int64_t* out_abegin,
                          int64_t* out_aend) {
  int32_t kept = 0;
  int64_t cursor = 0;
  out_off[0] = 0;
  for (int32_t s = 0; s < n_sel; ++s) {
    const int64_t i = sel[s];
    if (mapq[i] < min_mapq) continue;
    if (flag[i] & 0x400) continue;  // duplicate
    if (flag[i] & 0x100) continue;  // secondary
    if (!rnext_eq[i]) continue;     // mate on a different contig
    const int64_t c0 = cig_off[i], c1 = cig_off[i + 1];
    int64_t sb = seq_off[i], se = seq_off[i + 1];
    int64_t p = pos[i];  // 1-based, may move on forward-strand reversion
    int64_t ref_len = 0;
    for (int64_t k = c0; k < c1; ++k)
      if (ref_consuming(cig_op[k])) ref_len += cig_len[k];
    if (c1 > c0) {
      const uint8_t fo = cig_op[c0];
      const int32_t fl = cig_len[c0];
      uint8_t bo = cig_op[c1 - 1];
      const int32_t bl = cig_len[c1 - 1];
      if (flag[i] & 0x10) {  // reverse strand
        if (fo == 'S') sb += fl;     // trim leading soft-clipped bases
        if (bo == 'S') ref_len += bl;  // trailing S -> M
      } else {
        const int64_t ab = p - 1;
        bool front_converted = false;
        if (fo == 'S' && ab >= fl) {  // leading S -> M, POS moves back
          ref_len += fl;
          p = ab - fl + 1;
          front_converted = true;
        }
        // single-element cigars see the already-converted front op, exactly
        // like the Python/ reference sequential mutation
        if (c1 - c0 == 1 && front_converted) bo = 'M';
        if (bo == 'S') se -= bl;  // trim trailing soft-clipped bases
      }
    }
    const int64_t abegin = p - 1;
    const int64_t aend = abegin + ref_len;
    if (abegin < win_begin) {
      const int64_t clip = std::min(win_begin - abegin, se - sb);
      sb += clip;
    }
    if (aend > win_end) {
      const int64_t clip = aend - win_end;
      se = sb + std::max<int64_t>((se - sb) - clip, 0);
    }
    const int64_t len = se - sb;
    if (len < min_len) continue;
    std::memcpy(out_seq + cursor, seq + sb, len);
    std::memcpy(out_qual + cursor, qual + sb, len);
    cursor += len;
    out_off[kept + 1] = cursor;
    out_abegin[kept] = abegin;
    out_aend[kept] = aend;
    ++kept;
  }
  return kept;
}

// Whole-window fusion: downsample/filter/clip (hc_prepare_window) +
// assembly + per-haplotype SW in ONE native call.  The per-region Python
// caller previously made two ctypes calls and re-flattened the prepared
// reads into fresh blobs for the assembler; here the assembler consumes
// the prepared CSR blobs directly.  Returns n_haplotypes (>= 0) or a
// negative hc_assemble error; *out_kept reports the prepared read count.
int32_t hc_prepare_assemble_sw(
    const int32_t* pos, const int32_t* flag, const int32_t* mapq,
    const uint8_t* rnext_eq, const int64_t* cig_off, const uint8_t* cig_op,
    const int32_t* cig_len, const int64_t* seq_off, const uint8_t* seq,
    const uint8_t* qual, const int64_t* sel, int32_t n_sel, int32_t min_mapq,
    int32_t min_len, int64_t win_begin, int64_t win_end, uint8_t* out_seq,
    uint8_t* out_qual, int64_t* out_off, int64_t* out_abegin,
    int64_t* out_aend, int32_t* out_kept, const uint8_t* ref, int64_t ref_len,
    const int32_t* cfg, const int32_t* sw_cfg, uint8_t* out_bases,
    int64_t out_cap, int64_t* out_offsets, double* out_scores,
    int32_t max_out, int32_t* out_align_offset, uint8_t* out_cigar_ops,
    int32_t* out_cigar_lens, int64_t* out_cigar_offsets, int64_t cigar_cap) {
  const int64_t t_prep = prof_now();
  const int32_t kept = hc_prepare_window(
      pos, flag, mapq, rnext_eq, cig_off, cig_op, cig_len, seq_off, seq,
      qual, sel, n_sel, min_mapq, min_len, win_begin, win_end, out_seq,
      out_qual, out_off, out_abegin, out_aend);
  g_prof[6].fetch_add(prof_now() - t_prep, std::memory_order_relaxed);
  *out_kept = kept;
  if (kept == 0) return 0;
  return hc_assemble_sw(ref, ref_len, out_seq, out_qual, out_off, kept, cfg,
                        sw_cfg, out_bases, out_cap, out_offsets, out_scores,
                        max_out, out_align_offset, out_cigar_ops,
                        out_cigar_lens, out_cigar_offsets, cigar_cap);
}

// Single-pointer fused-window entry: the 30-argument ctypes call to
// hc_prepare_assemble_sw cost ~50us of marshalling per region (~13s over a
// 60Mb WGS walk) and the numpy downsample-select another ~17us.  This
// variant reads every argument from one caller-owned int64 control block
// (pointers stored as integers; all slots except begin/end are bound once
// per contig) and runs the downsample selection natively — the per-region
// Python cost drops to two scalar stores + a one-argument call.
//
// Control-block layout (int64 slots; pointers as addresses):
//   0..9   store columns: pos,flag,mapq,rnext_eq,cig_off,cig_op,cig_len,
//          seq_off,seq,qual                      (same as hc_prepare_window)
//   10..13 positional index: rows*, starts*, counts*, contig size
//   14..15 downsample: mode (0=first,1=seeded), seeded base
//          ((seed*0x10001) mod 2^64 — matches models/downsampler.py)
//   16..17 min_mapq, min_len
//   18..19 window begin, end                     (REWRITTEN per region)
//   20..26 out seq*, qual*, cap, off*, abegin*, aend*, kept*(i32)
//   27     sel scratch* (int64, >= max window width entries)
//   28     sel scratch capacity (entries); a window wider than it
//          returns -11 before anything is written
//   29     contig reference bytes* (window ref = base + begin)
//   30..31 assembler cfg ints*, SW cfg ints*
//   32..41 hap outputs: arena*, cap, offsets*, scores*, max_h,
//          align_offsets*, cigar ops*, lens*, offsets*, cigar cap
//   42     out n_downsampled*(i32)
//   43     out needed-capacity*(i64) — written with the required out_seq
//          capacity when the call returns -10 (caller grows and retries)
static inline uint64_t splitmix64_mix(uint64_t z) {
  // identical to models/downsampler.py::_splitmix64 / the vectorized
  // io/columnar.py::_splitmix64_np (bit-for-bit)
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

int32_t hc_fused_run(const int64_t* ctrl) {
  const auto P = [&](int i) { return ctrl[i]; };
  const int64_t* seq_off = reinterpret_cast<const int64_t*>(P(7));
  const int64_t* idx_rows = reinterpret_cast<const int64_t*>(P(10));
  const int64_t* idx_starts = reinterpret_cast<const int64_t*>(P(11));
  const int64_t* idx_counts = reinterpret_cast<const int64_t*>(P(12));
  const int64_t idx_size = P(13);
  const int64_t ds_mode = P(14);
  const uint64_t ds_base = static_cast<uint64_t>(P(15));
  const int64_t begin = P(18), end = P(19);
  int64_t* sel = reinterpret_cast<int64_t*>(P(27));
  int32_t* out_kept = reinterpret_cast<int32_t*>(P(26));
  int32_t* out_nds = reinterpret_cast<int32_t*>(P(42));

  // downsample-select (io/columnar.py::_ContigIndex.select semantics: one
  // read per non-empty start position in [begin, end), position order)
  const int64_t lo = begin > 0 ? begin : 0;
  const int64_t hi = end < idx_size ? end : idx_size;
  // at most one read per position: hi - lo entries bound the selection
  if (hi - lo > P(28)) return -11;
  int32_t n_sel = 0;
  for (int64_t p = lo; p < hi; ++p) {
    const int64_t cnt = idx_counts[p];
    if (cnt <= 0) continue;
    int64_t off = 0;
    if (ds_mode == 1) {
      const uint64_t h =
          splitmix64_mix(ds_base + static_cast<uint64_t>(p));
      off = static_cast<int64_t>(h % static_cast<uint64_t>(cnt));
    }
    sel[n_sel++] = idx_rows[idx_starts[p] + off];
  }
  *out_nds = n_sel;
  if (n_sel == 0) {
    *out_kept = 0;
    return 0;
  }
  // out_seq/out_qual capacity check (the caller's scratch grows on -10)
  int64_t need = 0;
  for (int32_t s = 0; s < n_sel; ++s)
    need += seq_off[sel[s] + 1] - seq_off[sel[s]];
  if (need > P(22)) {
    *reinterpret_cast<int64_t*>(P(43)) = need;
    return -10;
  }
  return hc_prepare_assemble_sw(
      reinterpret_cast<const int32_t*>(P(0)),
      reinterpret_cast<const int32_t*>(P(1)),
      reinterpret_cast<const int32_t*>(P(2)),
      reinterpret_cast<const uint8_t*>(P(3)),
      reinterpret_cast<const int64_t*>(P(4)),
      reinterpret_cast<const uint8_t*>(P(5)),
      reinterpret_cast<const int32_t*>(P(6)), seq_off,
      reinterpret_cast<const uint8_t*>(P(8)),
      reinterpret_cast<const uint8_t*>(P(9)), sel, n_sel,
      static_cast<int32_t>(P(16)), static_cast<int32_t>(P(17)), begin, end,
      reinterpret_cast<uint8_t*>(P(20)), reinterpret_cast<uint8_t*>(P(21)),
      reinterpret_cast<int64_t*>(P(23)), reinterpret_cast<int64_t*>(P(24)),
      reinterpret_cast<int64_t*>(P(25)), out_kept,
      reinterpret_cast<const uint8_t*>(P(29)) + begin, end - begin,
      reinterpret_cast<const int32_t*>(P(30)),
      reinterpret_cast<const int32_t*>(P(31)),
      reinterpret_cast<uint8_t*>(P(32)), P(33),
      reinterpret_cast<int64_t*>(P(34)), reinterpret_cast<double*>(P(35)),
      static_cast<int32_t>(P(36)), reinterpret_cast<int32_t*>(P(37)),
      reinterpret_cast<uint8_t*>(P(38)), reinterpret_cast<int32_t*>(P(39)),
      reinterpret_cast<int64_t*>(P(40)), P(41));
}

// Drain the host-stage profile accumulators (nanoseconds; see g_prof slot
// map).  reset != 0 zeroes them after reading.
void hc_prof_read(int64_t* out, int32_t reset) {
  for (int i = 0; i < PROF_SLOTS; ++i) {
    out[i] = g_prof[i].load(std::memory_order_relaxed);
    if (reset) g_prof[i].store(0, std::memory_order_relaxed);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The dispatch worker's pack (ops/torch_runner.py): one pass writes a
// group's unique read and haplotype rows straight into the host buffer it
// ships, in the group's encoding, with the same bytes as the runner's numpy
// pack.  A job is four int64s: the addresses of its read bases and of its
// qualities (its reads end to end, in order) and its read and haplotype
// counts; read_lens holds every read's length, jobs in group order.

namespace {

// row(index, bases, quals, length) for each read of the group, in order.
template <class Row>
void pack_for_each_read(const int64_t* jobs, int32_t n_jobs,
                        const int64_t* read_lens, Row&& row) {
  int64_t k = 0;
  for (int32_t j = 0; j < n_jobs; ++j) {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(jobs[4 * j]);
    const uint8_t* q = reinterpret_cast<const uint8_t*>(jobs[4 * j + 1]);
    for (int64_t r = 0; r < jobs[4 * j + 2]; ++r, ++k) {
      const int64_t n = read_lens[k];
      row(k, s, q, n);
      s += n;
      q += n;
    }
  }
}

// One table lookup per byte of a row, the row's tail filled with what
// byte 0 looks up to.
template <class T>
inline void pack_lookup_row(T* out, const T* tab, const uint8_t* src,
                            int64_t n, int64_t width) {
  for (int64_t i = 0; i < n; ++i) out[i] = tab[src[i]];
  std::fill(out + n, out + width, tab[0]);
}

inline void pack_copy_row(uint8_t* out, const uint8_t* src, int64_t n,
                          int64_t width) {
  std::memcpy(out, src, static_cast<size_t>(n));
  std::memset(out + n, 0, static_cast<size_t>(width - n));
}

}  // namespace

extern "C" {

// The nib dictionaries of a group: every distinct read base and quality
// byte, byte 0 (the padding) forced in at index 0, ascending.  dict gets
// [n_seq, n_qual, seq bytes (8), qual bytes (32)] and luts the byte ->
// index tables, seq then qual (2 x 256).  Returns 1 when there are more
// than 8 seq or 32 qual bytes (the group ships raw bytes), writing
// nothing; else 0.
int32_t hc_pack_dict(const int64_t* jobs, int32_t n_jobs,
                     const int64_t* read_lens, int32_t* dict,
                     uint8_t* luts) {
  uint8_t seen_s[256] = {0}, seen_q[256] = {0};
  seen_s[0] = seen_q[0] = 1;
  pack_for_each_read(jobs, n_jobs, read_lens,
                     [&](int64_t, const uint8_t* s, const uint8_t* q,
                         int64_t n) {
                       for (int64_t i = 0; i < n; ++i) seen_s[s[i]] = 1;
                       for (int64_t i = 0; i < n; ++i) seen_q[q[i]] = 1;
                     });
  int32_t n_seq = 0, n_qual = 0;
  for (int b = 0; b < 256; ++b) {
    n_seq += seen_s[b];
    n_qual += seen_q[b];
  }
  if (n_seq > 8 || n_qual > 32) return 1;
  std::memset(luts, 0, 512);
  std::memset(dict, 0, sizeof(int32_t) * 42);
  dict[0] = n_seq;
  dict[1] = n_qual;
  int32_t is = 0, iq = 0;
  for (int b = 0; b < 256; ++b) {
    if (seen_s[b]) {
      luts[b] = static_cast<uint8_t>(is);
      dict[2 + is++] = b;
    }
    if (seen_q[b]) {
      luts[256 + b] = static_cast<uint8_t>(iq);
      dict[10 + iq++] = b;
    }
  }
  return 0;
}

// A group's rows in one encoding, each padded to its width with what
// byte 0 encodes to, rows past the group's padded the same:
//   encoding 0, raw bytes: u8 bases then u8 quals (nr_pad x r_pad each)
//     at out_reads, u8 haps at out_haps;
//   encoding 1, nib: u8 (lut_s[base] << 5) | lut_q[qual] at out_reads
//     (tab: hc_pack_dict's luts), u8 haps at out_haps;
//   encoding 2, planes: i32 mask[base], omq[qual], q3[qual] planes end to
//     end at out_reads (tab: the 768 i32 mask | omq | q3 tables), i32
//     mask[base] haps at out_haps.
// Haps come end to end in hap_flat, hap_lens long each, clipped to c_pad.
// With pairs, the (2, total) i32 pair indices too: read-major per job,
// jobs in order.  Returns 0; -1 when a read is longer than r_pad or the
// rows do not fit nr_pad / nh_pad / total (nothing written).
int32_t hc_pack_rows(const int64_t* jobs, int32_t n_jobs,
                     const int64_t* read_lens, int32_t nr_pad, int32_t r_pad,
                     const uint8_t* hap_flat, const int64_t* hap_lens,
                     int32_t nh_pad, int32_t c_pad, int32_t encoding,
                     const void* tab, void* out_reads, void* out_haps,
                     int32_t* pairs, int64_t total) {
  int64_t n_reads = 0, n_haps = 0, n_pairs = 0;
  for (int32_t j = 0; j < n_jobs; ++j) {
    n_reads += jobs[4 * j + 2];
    n_haps += jobs[4 * j + 3];
    n_pairs += jobs[4 * j + 2] * jobs[4 * j + 3];
  }
  if (n_reads > nr_pad || n_haps > nh_pad || (pairs && n_pairs != total))
    return -1;
  for (int64_t k = 0; k < n_reads; ++k)
    if (read_lens[k] > r_pad) return -1;
  const int64_t width = r_pad, nrr = int64_t(nr_pad) * r_pad;
  const int64_t tail = nrr - n_reads * width;  // padding rows' elements

  if (encoding == 2) {
    const int32_t* mask = static_cast<const int32_t*>(tab);
    const int32_t* omq = mask + 256;
    const int32_t* q3 = mask + 512;
    int32_t* m = static_cast<int32_t*>(out_reads);
    pack_for_each_read(jobs, n_jobs, read_lens,
                       [&](int64_t k, const uint8_t* s, const uint8_t* q,
                           int64_t n) {
                         pack_lookup_row(m + k * width, mask, s, n, width);
                         pack_lookup_row(m + nrr + k * width, omq, q, n,
                                         width);
                         pack_lookup_row(m + 2 * nrr + k * width, q3, q, n,
                                         width);
                       });
    std::fill(m + nrr - tail, m + nrr, mask[0]);
    std::fill(m + 2 * nrr - tail, m + 2 * nrr, omq[0]);
    std::fill(m + 3 * nrr - tail, m + 3 * nrr, q3[0]);
    int32_t* h = static_cast<int32_t*>(out_haps);
    const uint8_t* src = hap_flat;
    for (int64_t k = 0; k < n_haps; ++k) {
      pack_lookup_row(h + k * c_pad, mask, src,
                      std::min<int64_t>(hap_lens[k], c_pad), c_pad);
      src += hap_lens[k];
    }
    std::fill(h + n_haps * c_pad, h + int64_t(nh_pad) * c_pad, mask[0]);
  } else {
    uint8_t* out = static_cast<uint8_t*>(out_reads);
    if (encoding == 1) {
      const uint8_t* lut_s = static_cast<const uint8_t*>(tab);
      const uint8_t* lut_q = lut_s + 256;
      pack_for_each_read(jobs, n_jobs, read_lens,
                         [&](int64_t k, const uint8_t* s, const uint8_t* q,
                             int64_t n) {
                           uint8_t* row = out + k * width;
                           for (int64_t i = 0; i < n; ++i)
                             row[i] = static_cast<uint8_t>(
                                 (lut_s[s[i]] << 5) | lut_q[q[i]]);
                           std::memset(row + n, 0,
                                       static_cast<size_t>(width - n));
                         });
      std::memset(out + nrr - tail, 0, static_cast<size_t>(tail));
    } else {
      pack_for_each_read(jobs, n_jobs, read_lens,
                         [&](int64_t k, const uint8_t* s, const uint8_t* q,
                             int64_t n) {
                           pack_copy_row(out + k * width, s, n, width);
                           pack_copy_row(out + nrr + k * width, q, n, width);
                         });
      std::memset(out + nrr - tail, 0, static_cast<size_t>(tail));
      std::memset(out + 2 * nrr - tail, 0, static_cast<size_t>(tail));
    }
    uint8_t* h = static_cast<uint8_t*>(out_haps);
    const uint8_t* src = hap_flat;
    for (int64_t k = 0; k < n_haps; ++k) {
      pack_copy_row(h + k * c_pad, src,
                    std::min<int64_t>(hap_lens[k], c_pad), c_pad);
      src += hap_lens[k];
    }
    std::memset(h + n_haps * c_pad, 0,
                static_cast<size_t>((nh_pad - n_haps) * c_pad));
  }

  if (pairs) {
    int64_t at = 0;
    int32_t rb = 0, hb = 0;
    for (int32_t j = 0; j < n_jobs; ++j) {
      const int32_t nr = static_cast<int32_t>(jobs[4 * j + 2]);
      const int32_t nh = static_cast<int32_t>(jobs[4 * j + 3]);
      for (int32_t r = 0; r < nr; ++r)
        for (int32_t h = 0; h < nh; ++h, ++at) {
          pairs[at] = rb + r;
          pairs[total + at] = hb + h;
        }
      rb += nr;
      hb += nh;
    }
  }
  return 0;
}

}  // extern "C"
