// PairHMM forward, warp-per-pair ("ppe") kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel family gatk_hc_tpu/ops/pairhmm_pallas.py::
// _kernel_ppe (NR=1), _kernel_ppe2 (NR=2) and _make_kernel_ppe_multi(NR)
// (_kernel_ppe4, _kernel_ppe8) behind _pallas_call_ppe.  One template over
// K, the read rows each lane holds, covers all four: the launcher takes
// K = min(8, max(NR, ceil(r_pad / 32))) (ops/pairhmm_torch.py::
// rows_per_lane), so NR is a floor on K.  It also replaces the XLA glue in
// front of _pallas_call_ppe on every shipping path (none of it is Pallas):
// _unpack_planes (:935) and the gathers of pairhmm_pallas_planes (:958) /
// _fused (:1005); _unpack_u8_ppe (:1034) and dispatch_pairs_ppe (:1082),
// as pairhmm_pallas_packed (:1118) / _packed_fused (:1154) run them; and
// _unpack_nib_ppe (:1254) with _expand_pairs_from_spans (:1226), as
// pairhmm_pallas_packed_nib (:1289) / _packed_nib_fused (:1193) run them.
//
// What it computes, per (read, hap) pair b: the raw f32 forward probability
// (scaled by INITIAL_CONSTANT) of the reference's main-path PairHMM,
//     sum_{c=1..clen} M[rlen][c]  +  sum_{c=1..clen} X[rlen][c],
// with every DP cell evaluated as
//     M = ((M_diag*p_mm + X_diag*p_gapm) + Y_diag*p_gapm) * dist
//     X = M_up*p_mx + X_up*p_xx
//     Y = M_left*p_my + Y_left*p_yy
// and dist = (read_mask & hap_mask) ? (1-q) : q/3 (N = 15 matches all).
//
// Where a pair's inputs come from (Front::src, one per launch, so the
// choice is uniform across every warp and decided before the step loop;
// the step loop is compiled once per (K, CARRY) for all of them):
//   PAIR_MINOR  pairhmm_ppe_forward: rows (r_pad, 3, B) i32 [base mask |
//               1-q bits | q/3 bits], hap (c_pad, B) i32 masks, rlen /
//               clen / init_y (B,), as forward_batch builds them;
//   PLANES, PACKED, NIB  pairhmm_ppe_forward_unique: a launch unit's
//               unique rows as the runner ships them (ops/runner.py,
//               ops/pairhmm_front.py), cut into segments, one per group (k
//               of them in a fused launch; a chunk of a large group is one
//               segment starting at its first pair).  The segments sit in
//               the kernel's parameters.  A warp finds its segment (at
//               most 16, a scan of constant memory), then its (read, hap)
//               pair: planes and packed from the shipped (2, n) pair
//               indices; nib by binary search of the pair's span over the
//               exclusive starts the host ships beside the span table
//               (searchsorted side "right" minus one: zero-count padding
//               rows are skipped; nh is taken as at least 1; a pair at or
//               past the total is pair (0, 0)).  Lengths and INITIAL /
//               haplen come from the group's i32 [read lens | hap lens |
//               init_y bits].  Lane j reads the K bytes or words of its
//               rows straight from the unique read row, so a warp reads 32
//               K consecutive elements: planes three i32 planes (3, nr_pad,
//               r_pad); packed the base and qual byte through the 768-entry
//               ppe_element_table ([mask | 1-q | q/3] at 0 / 256 / 512);
//               nib one byte (seq_idx << 5 | qual_idx) through the group's
//               72-entry mini-table ([mask 8 | 1-q 32 | q/3 32]).  The hap
//               is staged from the unique hap row: i32 masks (planes), or
//               bytes through the table's mask segment.  The tables are
//               read through the read-only data cache (3 KB and 288 B, hot
//               in L1), not staged, so warps of one block may serve
//               different segments without a block-wide barrier.  Only bit
//               patterns move: no float is computed before the step loop.
//               No pair-minor copy of the inputs exists in device memory.
//
// Design.  One warp owns one pair; the DP state never leaves the chip.  The
// read is cut into stripes of 32 K rows (one stripe when r_pad <= 32 K,
// which covers every read of the main path: K = 3..8 at r_pad 96..256).
// Lane j holds rows j K + 1 .. j K + K of the stripe in registers (their
// read mask, 1-q and q/3, and the previous column's M, X, Y of each row)
// and, at wavefront step t, computes column c = t - j for its K rows top
// to bottom: rows 2..K take "up" from the row just computed.  The lane's
// top row takes "up" from lane j-1's bottom row, computed at step t-1, by
// __shfl_up_sync (3 shuffles per K cells); its "diagonal" is that value of
// the step before.  Lane 0 takes row 0 (M = X = 0, Y = init_y) in stripe 0
// and the previous stripe's last row, which lane 31 left in shared memory
// by column, in later stripes (read at step c, rewritten in place 31 steps
// later; a __syncwarp() orders the stripes).  Before column 1 every lane
// computes exact zeros from zero state, which are the column-0 boundary.
// The pair's hap masks are staged once per pair into a per-warp shared
// copy, 32 slots of padding on each side, so each step reads its column
// with one conflict-free LDS.  The step loop runs clen + (the lane holding
// row rlen) steps in the last stripe, clen + 31 in the others; the lanes
// below row rlen compute cells nothing reads.  Row rlen's place in its
// lane is warp-uniform (one pair per warp), so the step loop is
// instantiated per place and adds exactly that row's M and X, in column
// order, into two accumulators (zeros before column 1 add nothing); the
// lane holding row rlen writes their sum.  No atomics, no reduction of
// values across lanes.  A block's warps take consecutive pairs.
//
// What bounds it.  Per step a lane issues 8 FMUL and 4 FADD per row, kept
// unfused for exactness, and the mask AND and select per row; per step, 3
// shuffles, one LDS, the lane-0 selects, 2 capture adds and the loop (the
// step loop is unrolled twice at K <= 5, which drops the register moves
// between steps).  So it is bound by instruction issue, not by device
// memory: each pair's inputs are read once and only its result is
// written; from the unique rows a 65,536-pair group reads ~6 MB, which
// stays in L2.  Lanes wait up to 31 steps at the start of a stripe, and
// rows past rlen are computed up to the next multiple of 32 K.  On an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has every shape):
// K = 5 (NR 4, r_pad 160, c_pad 448, B = 65,536 pairs) takes 2.33 ms per
// launch, 22.5% of the 0.524 ms operations bound; the pair-per-thread
// kernel this one replaced, with its row above in device memory (~1.2
// TB/s of scratch traffic), took 16.77 ms.  K = 4 uses 56 registers, K = 5
// 64, K = 8 72 (89 with the carry), with no local memory or stack.
//
// Exactness.  Built with -fmad=false (no mul+add contraction) and
// -ftz=true (the reference is flush-to-zero; every input to a cell is a
// flushed result or a table value far above the denormal range, so the
// input flush changes nothing).  The multiplies and adds are also written
// with __fmul_rn/__fadd_rn, which are never contracted.  No division: q/3
// and INITIAL/haplen come from the host, and the omq/q3 planes hold f32
// bits in i32 (reinterpreted with __int_as_float, never converted).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;
constexpr int MAX_K = 8;
constexpr int MAX_WARPS = 4;  // pairs per block
constexpr int HAP_PAD = 32;   // zero slots before column 1 and after c_pad
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int MAX_SEGMENTS = 16;  // groups of one launch (config.FUSE_GROUPS)
constexpr int SEG_FIELDS = 14;    // int64 values per segment row (the C entry)

struct Trans {
  float p_mm, p_gapm, p_mx, p_xx, p_my, p_yy;
};

// Where a launch's pairs come from (the header's list); the values of the
// unique sources are the C entry's ``src`` argument.
enum Src : int { PAIR_MINOR = 0, PLANES = 1, PACKED = 2, NIB = 3 };

// One group's share of a unique-rows launch: launch pairs first .. first +
// n - 1 are the group's pairs src .. src + n - 1, read from its shipped
// arrays (device pointers).
struct Seg {
  long long first, n, src;
  const int32_t* lens;    // [read lens | hap lens | init_y bits]
  const void* rows;       // planes: (3, nr_pad, r_pad) i32; packed: u8
                          // [reads | quals]; nib: u8 nib reads
  const void* haps;       // (nh_pad, c_pad): i32 masks (planes) or bytes
  const int32_t* pairs;   // planes, packed: (2, stride) read / hap indices
  long long stride;
  const int32_t* mini;    // nib: the 72-entry mini-table
  const int32_t* spans;   // nib: (n_spans, 4) [read_base, hap_base, nr, nh]
  const int32_t* starts;  // nib: n_spans exclusive starts, then the total
  int nr_pad, nh_pad, n_spans;
};

// Everything a launch reads besides its output, passed by value in the
// kernel's parameters (__grid_constant__: read in place, never copied).
struct Front {
  int src, n_seg;
  const int32_t* table;  // ppe_element_table (768): packed, nib
  const int32_t* rows;   // PAIR_MINOR: (r_pad, 3, B)
  const int32_t* hap;    // PAIR_MINOR: (c_pad, B)
  const int32_t* rlen;
  const int32_t* clen;
  const float* init_y;
  Seg seg[MAX_SEGMENTS];
};

// One pair's inputs, resolved before the step loop.  i32 rows (pair-minor
// or planes): element (row r, plane p) at w[r * rstep + p * pstep]; byte
// rows (packed, nib): read byte of row r at bytes[r], packed's qual byte
// at bytes[pstep + r], looked up in tab.  Hap column c: hw[c * cstep]
// (i32) or mask[hb[c]] (bytes).
struct Pair {
  int src;
  const int32_t* w;
  const uint8_t* bytes;
  const int32_t* tab;
  long long rstep, pstep;
  const int32_t* hw;
  const uint8_t* hb;
  const int32_t* mask;
  long long cstep;
};

// Pair b's sources, lengths and init_y.
__device__ __forceinline__ Pair resolve(const Front& f, long long b, int B,
                                        int r_pad, int c_pad, int& rl,
                                        int& cl, float& iy) {
  Pair p{};
  p.src = f.src;
  if (f.src == PAIR_MINOR) {
    p.w = f.rows + b;
    p.rstep = 3LL * B;
    p.pstep = B;
    p.hw = f.hap + b;
    p.cstep = B;
    rl = f.rlen[b];
    cl = f.clen[b];
    iy = f.init_y[b];
    return p;
  }
  int s = 0;  // segments are contiguous and in launch order
  while (s + 1 < f.n_seg && b >= f.seg[s + 1].first) ++s;
  const Seg& g = f.seg[s];
  const int i = static_cast<int>(g.src + (b - g.first));
  int pr = 0, ph = 0;
  if (f.src == NIB) {
    // searchsorted(starts, i, side="right") - 1, clipped to the table
    const int n = g.n_spans;
    int a = 0, hi = n;
    while (a < hi) {
      const int mid = (a + hi) >> 1;
      if (g.starts[mid] <= i)
        a = mid + 1;
      else
        hi = mid;
    }
    const int j = max(0, min(n - 1, a - 1));
    if (i < g.starts[n]) {
      const int nh = max(g.spans[4 * j + 3], 1);
      const int local = i - g.starts[j];
      pr = g.spans[4 * j] + local / nh;
      ph = g.spans[4 * j + 1] + local % nh;
    }
  } else {
    pr = g.pairs[i];
    ph = g.pairs[g.stride + i];
  }
  rl = g.lens[pr];
  cl = g.lens[g.nr_pad + ph];
  iy = __int_as_float(g.lens[g.nr_pad + g.nh_pad + ph]);
  const long long nrr = static_cast<long long>(g.nr_pad) * r_pad;
  const long long row = static_cast<long long>(pr) * r_pad;
  const long long hrow = static_cast<long long>(ph) * c_pad;
  p.pstep = nrr;
  p.cstep = 1;
  if (f.src == PLANES) {
    p.w = static_cast<const int32_t*>(g.rows) + row;
    p.rstep = 1;
    p.hw = static_cast<const int32_t*>(g.haps) + hrow;
  } else {
    p.bytes = static_cast<const uint8_t*>(g.rows) + row;
    p.tab = f.src == NIB ? g.mini : f.table;
    p.hb = static_cast<const uint8_t*>(g.haps) + hrow;
    p.mask = f.table;
  }
  return p;
}

// Read row r of the pair: its base mask, 1-q and q/3.
__device__ __forceinline__ void row_at(const Pair& p, int r, int& rs,
                                       float& omq, float& q3) {
  if (p.src == PACKED) {
    const int b = p.bytes[r];
    const int q = p.bytes[p.pstep + r];
    rs = __ldg(p.tab + b);
    omq = __int_as_float(__ldg(p.tab + 256 + q));
    q3 = __int_as_float(__ldg(p.tab + 512 + q));
  } else if (p.src == NIB) {
    const int b = p.bytes[r];
    rs = __ldg(p.tab + (b >> 5));
    omq = __int_as_float(__ldg(p.tab + 8 + (b & 31)));
    q3 = __int_as_float(__ldg(p.tab + 40 + (b & 31)));
  } else {
    const int32_t* e = p.w + r * p.rstep;
    rs = e[0];
    omq = __int_as_float(e[p.pstep]);
    q3 = __int_as_float(e[2 * p.pstep]);
  }
}

// Hap mask of column col (0-based) of the pair.
__device__ __forceinline__ int32_t hap_at(const Pair& p, int col) {
  if (p.src == PACKED || p.src == NIB) return __ldg(p.mask + p.hb[col]);
  return p.hw[col * p.cstep];
}

// Shared memory per warp, in 4-byte words: the hap masks with their
// padding, and (multi-stripe launches only) the carried row's M, X, Y by
// column 0..c_pad.
inline __host__ __device__ int hap_words(int c_pad) {
  return c_pad + 2 * HAP_PAD;
}
inline __host__ __device__ int carry_words(int c_pad) {
  return 3 * (c_pad + 1);
}

// One stripe of one pair: `steps` wavefront steps over the lane's K rows.
// QC is the place of row rlen in its lane (warp-uniform); every lane sums
// its row QC, and only the lane holding row rlen in the last stripe
// reports it.  With CARRY, lane 0 of a later stripe (carry_in) reads the
// previous stripe's last row and lane 31 of a stripe that has a successor
// (carry_out) writes its bottom row, both by column.
template <int K, int QC, bool CARRY>
__device__ __forceinline__ void sweep(
    const int32_t* __restrict__ hs, const int (&rs)[K],
    const float (&omq)[K], const float (&q3)[K], float* cm, float* cx,
    float* cy, bool carry_in, bool carry_out, int steps, int cl, int lane,
    float iy, Trans tr, float& acc_m, float& acc_x) {
  float md[K], xd[K], yd[K], ml[K], yl[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    md[q] = xd[q] = yd[q] = ml[q] = yl[q] = 0.0f;
  }
  // Y(0, 0) = init_y is row 1's only nonzero diagonal input at column 1
  if (lane == 0 && !carry_in) yd[0] = iy;
  float mo = 0.0f, xo = 0.0f, yo = 0.0f;  // bottom row, previous step
  acc_m = 0.0f;
  acc_x = 0.0f;
  // Unrolled twice at K <= 5, which saves the moves that rename the
  // carried registers between steps (2-9% faster on an H100); at K = 6
  // and 8 it measured slower and at K = 7 no faster, so those keep one
  // step per iteration (gatk_hc_tpu_torch/tools/ppe_variants.py).
#pragma unroll(K <= 5 ? 2 : 1)
  for (int step = 1; step <= steps; ++step) {
    const int hw = hs[step];  // this lane's column step - lane
    float MA = __shfl_up_sync(FULL, mo, 1);
    float XA = __shfl_up_sync(FULL, xo, 1);
    float YA = __shfl_up_sync(FULL, yo, 1);
    if (lane == 0) {
      if (CARRY && carry_in) {
        const bool in = step <= cl;  // lane 0's column is step
        MA = in ? cm[step] : 0.0f;
        XA = in ? cx[step] : 0.0f;
        YA = in ? cy[step] : 0.0f;
      } else {  // row 0
        MA = 0.0f;
        XA = 0.0f;
        YA = iy;
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const float dist = (rs[q] & hw) != 0 ? omq[q] : q3[q];
      const float t1 = __fmul_rn(md[q], tr.p_mm);
      const float t2 = __fmul_rn(xd[q], tr.p_gapm);
      const float t3 = __fmul_rn(yd[q], tr.p_gapm);
      const float M = __fmul_rn(__fadd_rn(__fadd_rn(t1, t2), t3), dist);
      const float X =
          __fadd_rn(__fmul_rn(MA, tr.p_mx), __fmul_rn(XA, tr.p_xx));
      const float Y =
          __fadd_rn(__fmul_rn(ml[q], tr.p_my), __fmul_rn(yl[q], tr.p_yy));
      if (q == QC) {
        acc_m = __fadd_rn(acc_m, M);
        acc_x = __fadd_rn(acc_x, X);
      }
      // this row's "up" cell is the next column's diagonal
      md[q] = MA;
      xd[q] = XA;
      yd[q] = YA;
      ml[q] = M;
      yl[q] = Y;
      MA = M;
      XA = X;
      YA = Y;
    }
    mo = MA;
    xo = XA;
    yo = YA;
    if (CARRY && carry_out && lane == LANES - 1 && step >= LANES) {
      const int c = step - (LANES - 1);  // 1..cl: lane 31 runs to clen
      cm[c] = mo;
      cx[c] = xo;
      cy[c] = yo;
    }
  }
}

// sweep<K, qc, CARRY> for a runtime, warp-uniform qc in 0..K-1.
template <int K, bool CARRY, int QC = 0>
__device__ __forceinline__ void sweep_at(
    int qc, const int32_t* __restrict__ hs, const int (&rs)[K],
    const float (&omq)[K], const float (&q3)[K], float* cm, float* cx,
    float* cy, bool carry_in, bool carry_out, int steps, int cl, int lane,
    float iy, Trans tr, float& acc_m, float& acc_x) {
  if constexpr (QC + 1 < K) {
    if (qc != QC) {
      sweep_at<K, CARRY, QC + 1>(qc, hs, rs, omq, q3, cm, cx, cy, carry_in,
                                 carry_out, steps, cl, lane, iy, tr, acc_m,
                                 acc_x);
      return;
    }
  }
  sweep<K, QC, CARRY>(hs, rs, omq, q3, cm, cx, cy, carry_in, carry_out,
                      steps, cl, lane, iy, tr, acc_m, acc_x);
}

template <int K, bool CARRY>
__global__ void __launch_bounds__(LANES * MAX_WARPS)
ppe_forward_kernel(const __grid_constant__ Front f,
                   float* __restrict__ out,  // (B,)
                   int B, int r_pad, int c_pad, Trans tr) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x % LANES;
  const int warp = threadIdx.x / LANES;
  const int warps = blockDim.x / LANES;
  const int64_t b = (int64_t)blockIdx.x * warps + warp;
  if (b >= B) return;  // the whole warp: one pair per warp
  int rl = 0, cl = 0;
  float iy = 0.0f;
  const Pair p = resolve(f, b, B, r_pad, c_pad, rl, cl, iy);
  cl = max(0, min(cl, c_pad));
  // a read length outside 1..r_pad captures no row: the TPU kernel's row
  // mask never fires and it returns 0
  if (rl < 1 || rl > r_pad) {
    if (lane == 0) out[b] = 0.0f;
    return;
  }

  // hap mask of column c (1-based) at slot HAP_PAD - 1 + c; zeros around
  int32_t* hap_s = smem + warp * hap_words(c_pad);
  for (int i = lane; i < hap_words(c_pad); i += LANES) {
    const int col = i - HAP_PAD;
    hap_s[i] = col >= 0 && col < cl ? hap_at(p, col) : 0;
  }
  float* cm = nullptr;
  float* cx = nullptr;
  float* cy = nullptr;
  if (CARRY) {
    cm = reinterpret_cast<float*>(smem + warps * hap_words(c_pad)) +
         warp * carry_words(c_pad);
    cx = cm + (c_pad + 1);
    cy = cx + (c_pad + 1);
  }
  __syncwarp();
  const int32_t* hs = hap_s + HAP_PAD - 1 - lane;  // hs[t]: column t - lane

  constexpr int S = LANES * K;  // rows per stripe
  const int n_stripes = CARRY ? (rl + S - 1) / S : 1;
  const int last = rl - 1 - (n_stripes - 1) * S;  // row rlen in its stripe
  const int jr = last / K;  // the lane holding it
  const int qc = last % K;  // its place in that lane
  float acc_m = 0.0f, acc_x = 0.0f;
  for (int s = 0; s < n_stripes; ++s) {
    int rs[K];
    float omq[K], q3[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int r = s * S + lane * K + q;  // 0-based read row
      rs[q] = 0;
      omq[q] = q3[q] = 0.0f;
      if (r < rl) row_at(p, r, rs[q], omq[q], q3[q]);
    }
    const bool more = s + 1 < n_stripes;
    const int steps = cl + (more ? LANES - 1 : jr);
    sweep_at<K, CARRY>(qc, hs, rs, omq, q3, cm, cx, cy, s > 0, more, steps,
                       cl, lane, iy, tr, acc_m, acc_x);
    if (CARRY) __syncwarp();
  }
  if (lane == jr) out[b] = __fadd_rn(acc_m, acc_x);
}

// Blocks of up to MAX_WARPS warps (pairs), fewer when their shared memory
// would exceed the default 48 KB; a single warp that needs more raises the
// kernel's limit, up to the card's opt-in maximum.
template <int K, bool CARRY>
cudaError_t configure(int c_pad, int* warps_out, size_t* smem_out) {
  const size_t per_warp =
      sizeof(int32_t) *
      (size_t)(hap_words(c_pad) + (CARRY ? carry_words(c_pad) : 0));
  int warps = MAX_WARPS;
  while (warps > 1 && warps * per_warp > DEFAULT_SMEM) warps /= 2;
  const size_t smem = warps * per_warp;
  if (smem > DEFAULT_SMEM) {
    int limit = 0, dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)limit) return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(ppe_forward_kernel<K, CARRY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  *warps_out = warps;
  *smem_out = smem;
  return cudaSuccess;
}

template <int K, bool CARRY>
cudaError_t launch(const Front& f, float* out, int B, int r_pad, int c_pad,
                   Trans tr, cudaStream_t stream) {
  int warps = 0;
  size_t smem = 0;
  const cudaError_t err = configure<K, CARRY>(c_pad, &warps, &smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + warps - 1) / warps;
  ppe_forward_kernel<K, CARRY><<<blocks, LANES * warps, smem, stream>>>(
      f, out, B, r_pad, c_pad, tr);
  return cudaGetLastError();
}

template <int K, bool CARRY>
cudaError_t shape(int c_pad, int* out) {
  int warps = 0, blocks = 0;
  size_t smem = 0;
  cudaError_t err = configure<K, CARRY>(c_pad, &warps, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ppe_forward_kernel<K, CARRY>, LANES * warps, smem);
  out[0] = warps;
  out[1] = (int)smem;
  out[2] = blocks;
  return err;
}

// The instance for k and r_pad: CARRY when one stripe of 32 k rows does
// not cover r_pad.
template <int K>
cudaError_t launch_k(const Front& f, float* out, int B, int r_pad, int c_pad,
                     Trans tr, cudaStream_t stream) {
  if (r_pad > LANES * K)
    return launch<K, true>(f, out, B, r_pad, c_pad, tr, stream);
  return launch<K, false>(f, out, B, r_pad, c_pad, tr, stream);
}

// The instance for k (1..8), or cudaErrorInvalidValue.
cudaError_t launch_any(int k, const Front& f, float* out, int B, int r_pad,
                       int c_pad, Trans t, cudaStream_t s) {
  switch (k) {
    case 1: return launch_k<1>(f, out, B, r_pad, c_pad, t, s);
    case 2: return launch_k<2>(f, out, B, r_pad, c_pad, t, s);
    case 3: return launch_k<3>(f, out, B, r_pad, c_pad, t, s);
    case 4: return launch_k<4>(f, out, B, r_pad, c_pad, t, s);
    case 5: return launch_k<5>(f, out, B, r_pad, c_pad, t, s);
    case 6: return launch_k<6>(f, out, B, r_pad, c_pad, t, s);
    case 7: return launch_k<7>(f, out, B, r_pad, c_pad, t, s);
    case 8: return launch_k<8>(f, out, B, r_pad, c_pad, t, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int K>
cudaError_t shape_k(int r_pad, int c_pad, int* out) {
  return r_pad > LANES * K ? shape<K, true>(c_pad, out)
                           : shape<K, false>(c_pad, out);
}

}  // namespace

// Raw forward probabilities of B pairs into out (B,) f32, k read rows per
// lane (1..8).  Returns a CUDA error code (cudaErrorInvalidValue for a bad
// k or shape, cudaErrorInvalidConfiguration when one warp's shared memory
// does not fit), 0 on success.
extern "C" int pairhmm_ppe_forward(const void* rows, const void* hap,
                                   const void* rlen, const void* clen,
                                   const void* init_y, void* out, int B,
                                   int r_pad, int c_pad, int k, float p_mm,
                                   float p_gapm, float p_mx, float p_xx,
                                   float p_my, float p_yy, void* stream) {
  if (B <= 0) return 0;
  if (r_pad <= 0 || c_pad <= 0 || k < 1 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  Front f{};
  f.src = PAIR_MINOR;
  f.rows = static_cast<const int32_t*>(rows);
  f.hap = static_cast<const int32_t*>(hap);
  f.rlen = static_cast<const int32_t*>(rlen);
  f.clen = static_cast<const int32_t*>(clen);
  f.init_y = static_cast<const float*>(init_y);
  return static_cast<int>(launch_any(
      k, f, static_cast<float*>(out), B, r_pad, c_pad,
      Trans{p_mm, p_gapm, p_mx, p_xx, p_my, p_yy},
      static_cast<cudaStream_t>(stream)));
}

// Raw forward probabilities of one launch unit read from its unique rows:
// src PLANES (1), PACKED (2) or NIB (3); segs a host array of n_seg rows
// of SEG_FIELDS int64 values, [first, n, src, lens, rows, haps, pairs,
// stride, mini, spans, starts, nr_pad, nh_pad, n_spans] (pointers as
// device addresses; ops/pairhmm_front.py::segment_rows), with first 0 and
// each segment starting where the one before ends; table the 768-entry
// ppe_element_table; out (sum of n,) f32.  Returns a CUDA error code
// (cudaErrorInvalidValue for a bad source, segment table, k or shape,
// cudaErrorInvalidConfiguration when one warp's shared memory does not
// fit), 0 on success.
extern "C" int pairhmm_ppe_forward_unique(
    int src, const void* segs, int n_seg, const void* table, void* out,
    int r_pad, int c_pad, int k, float p_mm, float p_gapm, float p_mx,
    float p_xx, float p_my, float p_yy, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (src < PLANES || src > NIB || n_seg < 1 || n_seg > MAX_SEGMENTS ||
      r_pad <= 0 || c_pad <= 0 || k < 1 || k > MAX_K)
    return static_cast<int>(bad);
  Front f{};
  f.src = src;
  f.n_seg = n_seg;
  f.table = static_cast<const int32_t*>(table);
  const auto* row = static_cast<const long long*>(segs);
  long long B = 0;
  for (int s = 0; s < n_seg; ++s, row += SEG_FIELDS) {
    Seg& g = f.seg[s];
    g.first = row[0];
    g.n = row[1];
    g.src = row[2];
    g.lens = reinterpret_cast<const int32_t*>(row[3]);
    g.rows = reinterpret_cast<const void*>(row[4]);
    g.haps = reinterpret_cast<const void*>(row[5]);
    g.pairs = reinterpret_cast<const int32_t*>(row[6]);
    g.stride = row[7];
    g.mini = reinterpret_cast<const int32_t*>(row[8]);
    g.spans = reinterpret_cast<const int32_t*>(row[9]);
    g.starts = reinterpret_cast<const int32_t*>(row[10]);
    g.nr_pad = static_cast<int>(row[11]);
    g.nh_pad = static_cast<int>(row[12]);
    g.n_spans = static_cast<int>(row[13]);
    if (g.first != B || g.n < 0 || g.src < 0 || g.src + g.n > INT32_MAX ||
        g.nr_pad < 1 || g.nh_pad < 1 || (src == NIB && g.n_spans < 1))
      return static_cast<int>(bad);
    B += g.n;
  }
  if (B > INT32_MAX) return static_cast<int>(bad);
  if (B == 0) return 0;
  return static_cast<int>(launch_any(
      k, f, static_cast<float*>(out), static_cast<int>(B), r_pad, c_pad,
      Trans{p_mm, p_gapm, p_mx, p_xx, p_my, p_yy},
      static_cast<cudaStream_t>(stream)));
}

// The launch shape pairhmm_ppe_forward uses at (r_pad, c_pad, k): out[0]
// warps (pairs) per block, out[1] dynamic shared memory per block in bytes,
// out[2] resident blocks per SM.  Returns a CUDA error code, 0 on success.
extern "C" int pairhmm_ppe_launch_shape(int r_pad, int c_pad, int k,
                                        void* out) {
  auto* o = static_cast<int*>(out);
  if (r_pad <= 0 || c_pad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return shape_k<1>(r_pad, c_pad, o);
    case 2: return shape_k<2>(r_pad, c_pad, o);
    case 3: return shape_k<3>(r_pad, c_pad, o);
    case 4: return shape_k<4>(r_pad, c_pad, o);
    case 5: return shape_k<5>(r_pad, c_pad, o);
    case 6: return shape_k<6>(r_pad, c_pad, o);
    case 7: return shape_k<7>(r_pad, c_pad, o);
    case 8: return shape_k<8>(r_pad, c_pad, o);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
