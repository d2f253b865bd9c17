// Device genotyper reductions for Hopper (sm_90a).
//
// Replaces gatk_hc_tpu/ops/genotyper_jax.py::genotype_sites (jnp, not a
// Pallas kernel), the device genotyper's batched reductions over one padded
// (S, R, H) site tile.  Per site s:
//   allele_lik[r][a] = max over valid haps h with hap_to_allele[h] == a of
//                      lik[r][h] (LOWEST when there is none);
//   for every genotype slot g = (a1 <= a2) of MAX_ALLELES = 8 alleles
//   (np.triu_indices order, 36 slots), per read r:
//     hom (a1 == a2): l1 + log10(2);
//     het: big = max(l1, l2), diff = big - min(l1, l2);
//          diff < 8 ? big + jacobian[floor(diff * 1e4 + 0.5)] : big;
//     0 for a read with read_keep false;
//   totals[g] = (sum over r in read order) - n_kept * log10(2);
//   genotype_lik[g] = totals[g] where a1, a2 < allele_count, else LOWEST;
//   best = the LAST index of the maximum (the reference's >= scan,
//   genotyper.hpp:330-362); second = the max of every other slot (masked
//   ones included); gq = floor(-10 * (second - best) + 0.5), capped at
//   max_gq.  A NaN total (f32 only: a compensated sum over a -inf value)
//   ranks as the maximum and gives GQ 0, as jnp.argmax / jnp.max and the
//   saturating int cast do in the reference.
//
// One template over the type:
//   <double>  the port's default (the H100 has native f64): the plain
//             left-to-right read sum, bit-equal to the host genotyper's
//             np.cumsum (models/genotyper.py::_genotype_sites_numpy);
//             LOWEST = -DBL_MAX, as the host's numeric_limits::lowest.
//   <float>   the guarded f32 path: Neumaier-compensated read sums
//             (genotyper_jax.py:104-121); LOWEST = -inf, the f32 cast of
//             -DBL_MAX, so a slot of two unsupported alleles has diff
//             -inf - -inf = NaN, fails `diff < 8` and takes het = big.
// Every multiply and add is its own rounded operation (__d*_rn / __f*_rn;
// the library builds with -fmad=false) and, as every source of the
// package, with -ftz=true (ops/_kernels.py): the <float> instance reads a
// subnormal operand as zero and flushes a subnormal result to a zero of
// its sign; the plain PyTorch version
// (ops/genotyper_cuda.py::genotype_sites_plain) flushes its f32
// likelihoods and every f32 result the same way, so the two are bit-equal
// on the CPU and the card.  f64 is never flushed.
//
// Design (simple first; making it fast is later work).  One block per
// site, THREADS threads.  The site's hap -> allele map (valid haps only)
// is staged in shared memory.  Reads are taken in chunks of READ_CHUNK:
// thread t computes read (base + t)'s eight allele maxima into shared
// memory; then threads 0..35 each own one genotype slot and add the
// chunk's reads to a register sum IN READ ORDER, carried across chunks, so
// any R (2,048 at the largest bucket) fits in 8.6 KB of static shared
// memory.  Thread 0 then scans the 36 totals for best / second and GQ.
// What bounds it on the card: the tile's bytes (lik is S*R*H values, read
// once) against ~7 f64 operations per (kept read, genotype) — far under
// the f64 rate, so bytes; the design is latency-bound (36 of 128 threads
// in the ordered sum, one block per site), which a later PR can cut.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int MAX_ALLELES = 8;
constexpr int MAX_GENOTYPES = MAX_ALLELES * (MAX_ALLELES + 1) / 2;
constexpr int THREADS = 128;
constexpr int READ_CHUNK = THREADS;  // one read of a chunk per thread
// utils/quality.py: MAX_JACOBIAN_TOLERANCE, 1 / JACOBIAN_LOG_TABLE_STEP
constexpr double JACOBIAN_TOLERANCE = 8.0;
constexpr double JACOBIAN_INV_STEP = 10000.0;
// the largest hap count of a tile (dynamic shared memory, one byte a hap)
constexpr int MAX_HAPS = 32768;

// (a1, a2) of each genotype slot: np.triu_indices(MAX_ALLELES)
__constant__ signed char kA1[MAX_GENOTYPES] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
    2, 2, 2, 3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 6, 6, 7};
__constant__ signed char kA2[MAX_GENOTYPES] = {
    0, 1, 2, 3, 4, 5, 6, 7, 1, 2, 3, 4, 5, 6, 7, 2, 3, 4,
    5, 6, 7, 3, 4, 5, 6, 7, 4, 5, 6, 7, 5, 6, 7, 6, 7, 7};

template <typename T>
struct Arith;

template <>
struct Arith<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double lowest() { return -DBL_MAX; }
};

template <>
struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float lowest() { return -INFINITY; }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    genotype_kernel(const T* __restrict__ lik,
                    const int32_t* __restrict__ hap_to_allele,
                    const uint8_t* __restrict__ read_keep,
                    const uint8_t* __restrict__ hap_valid,
                    const int32_t* __restrict__ allele_count,
                    const T* __restrict__ jacobian, T* __restrict__ gl,
                    int32_t* __restrict__ best_out,
                    int32_t* __restrict__ gq_out, int R, int H, int max_gq,
                    T log10_2) {
  using A = Arith<T>;
  constexpr bool kCompensated = std::is_same<T, float>::value;
  extern __shared__ signed char allele_of[];  // H: allele of hap h, or -1
  __shared__ T al[READ_CHUNK][MAX_ALLELES];
  __shared__ uint8_t kept[READ_CHUNK];
  __shared__ T tot[MAX_GENOTYPES];

  const long long s = blockIdx.x;
  const int t = threadIdx.x;
  for (int h = t; h < H; h += THREADS) {
    const int a = hap_to_allele[s * H + h];
    allele_of[h] = (hap_valid[s * H + h] && a >= 0 && a < MAX_ALLELES)
                       ? static_cast<signed char>(a)
                       : static_cast<signed char>(-1);
  }
  const int g = t < MAX_GENOTYPES ? t : 0;
  const int a1 = kA1[g], a2 = kA2[g];
  T sum = T(0), comp = T(0);
  int n_kept = 0;
  __syncthreads();

  for (int base = 0; base < R; base += READ_CHUNK) {
    const int r = base + t;
    if (r < R) {
      T m[MAX_ALLELES];
#pragma unroll
      for (int k = 0; k < MAX_ALLELES; ++k) m[k] = A::lowest();
      const T* row = lik + (s * R + r) * static_cast<long long>(H);
#pragma unroll 1
      for (int h = 0; h < H; ++h) {
        const int a = allele_of[h];
        if (a >= 0) {
          const T v = row[h];
#pragma unroll
          for (int k = 0; k < MAX_ALLELES; ++k)
            if (a == k) m[k] = v > m[k] ? v : m[k];
        }
      }
#pragma unroll
      for (int k = 0; k < MAX_ALLELES; ++k) al[t][k] = m[k];
      kept[t] = read_keep[s * R + r];
    }
    __syncthreads();
    if (t < MAX_GENOTYPES) {
      const int n = R - base < READ_CHUNK ? R - base : READ_CHUNK;
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        T v = T(0);
        if (kept[i]) {
          ++n_kept;
          const T l1 = al[i][a1];
          if (a1 == a2) {
            v = A::add(l1, log10_2);
          } else {
            const T l2 = al[i][a2];
            const T big = l1 > l2 ? l1 : l2;
            const T small = l1 > l2 ? l2 : l1;
            const T diff = A::sub(big, small);
            if (diff < T(JACOBIAN_TOLERANCE)) {  // false for NaN
              const int ind = static_cast<int>(floor(
                  A::add(A::mul(diff, T(JACOBIAN_INV_STEP)), T(0.5))));
              v = A::add(big, jacobian[ind]);
            } else {
              v = big;
            }
          }
        }
        if constexpr (kCompensated) {
          const T next = A::add(sum, v);
          const T lost = fabs(sum) >= fabs(v) ? A::add(A::sub(sum, next), v)
                                              : A::add(A::sub(v, next), sum);
          comp = A::add(comp, lost);
          sum = next;
        } else {
          sum = A::add(sum, v);
        }
      }
    }
    __syncthreads();
  }

  if (t < MAX_GENOTYPES) {
    T total = kCompensated ? A::add(sum, comp) : sum;
    total = A::sub(total, A::mul(static_cast<T>(n_kept), log10_2));
    const int count = allele_count[s];
    const T masked = (a1 < count && a2 < count) ? total : A::lowest();
    gl[s * MAX_GENOTYPES + g] = masked;
    tot[g] = masked;
  }
  __syncthreads();
  if (t == 0) {
    // NaN ranks above every number, as in the reference's argmax / max
    int best = 0;
    T best_v = tot[0];
    for (int i = 1; i < MAX_GENOTYPES; ++i)
      if (tot[i] >= best_v || isnan(tot[i])) {  // later ties win
        best = i;
        best_v = tot[i];
      }
    T second = A::lowest();
    for (int i = 0; i < MAX_GENOTYPES; ++i)
      if (i != best && (tot[i] > second || isnan(tot[i]))) second = tot[i];
    const T q = floor(A::add(A::mul(T(-10), A::sub(second, best_v)), T(0.5)));
    best_out[s] = best;
    gq_out[s] = isnan(q) ? 0
                : q < static_cast<T>(max_gq) ? static_cast<int>(q)
                                              : max_gq;
  }
}

template <typename T>
cudaError_t launch(const void* lik, const void* h2a, const void* keep,
                   const void* hv, const void* ac, const void* jac, void* gl,
                   void* best, void* gq, int S, int R, int H, int max_gq,
                   double log10_2, cudaStream_t stream) {
  genotype_kernel<T><<<S, THREADS, H, stream>>>(
      static_cast<const T*>(lik), static_cast<const int32_t*>(h2a),
      static_cast<const uint8_t*>(keep), static_cast<const uint8_t*>(hv),
      static_cast<const int32_t*>(ac), static_cast<const T*>(jac),
      static_cast<T*>(gl), static_cast<int32_t*>(best),
      static_cast<int32_t*>(gq), R, H, max_gq, static_cast<T>(log10_2));
  return cudaGetLastError();
}

}  // namespace

// Genotype reductions of one tile: f64 != 0 runs the <double> instance,
// else <float>.  lik (S, R, H) of that type, hap_to_allele (S, H) i32,
// read_keep (S, R) u8, hap_valid (S, H) u8, allele_count (S,) i32,
// jacobian (80,001,) of that type (utils/quality.py JACOBIAN_F64, cast);
// out: gl (S, 36) of that type, best (S,) i32, gq (S,) i32.  log10_2 is
// log10(2) as a double (cast to the type here).  Launches on ``stream``
// and does not synchronise.  Returns a CUDA error code
// (cudaErrorInvalidValue for a bad shape), 0 on success.
extern "C" int genotype_sites(int f64, const void* lik, const void* h2a,
                              const void* keep, const void* hv,
                              const void* ac, const void* jac, void* gl,
                              void* best, void* gq, int S, int R, int H,
                              int max_gq, double log10_2, void* stream) {
  if (S < 0 || R < 1 || H < 1 || H > MAX_HAPS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? launch<double>(lik, h2a, keep, hv, ac, jac, gl, best, gq, S, R, H,
                           max_gq, log10_2, st)
          : launch<float>(lik, h2a, keep, hv, ac, jac, gl, best, gq, S, R, H,
                          max_gq, log10_2, st));
}
