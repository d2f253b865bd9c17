// PairHMM forward, striped kernel for Hopper (sm_90a): H lanes per pair, K
// read rows per lane.
//
// Replaces the TPU kernel gatk_hc_tpu/ops/pairhmm_pallas.py::_kernel behind
// _pallas_forward(algo="striped").  One template over the stripe height H
// (8, 16 or 32: the lanes of a warp that own one pair), K (the read rows
// each lane holds) and CARRY (whether a pair's rows span several stripes).
// It also replaces the XLA glue in front of _pallas_forward on the
// reference runner's striped path (none of it is Pallas): _unpack_u8
// (:904), prepare_tables_striped (:1327) and dispatch_pairs_striped
// (:1341), through its unique-rows entry (below).
//
// What it computes, per (read, hap) pair b: the same function as the ppe
// kernel (csrc/pairhmm_ppe.cu), the raw f32 forward probability (scaled by
// INITIAL_CONSTANT)
//     sum_{c=1..clen} M[rlen][c]  +  sum_{c=1..clen} X[rlen][c],
// with every DP cell evaluated as
//     M = ((M_diag*p_mm + X_diag*p_gapm) + Y_diag*p_gapm) * dist
//     X = M_up*p_mx + X_up*p_xx
//     Y = M_left*p_my + Y_left*p_yy
// and dist = (read_mask & hap_mask) ? (1-q) : q/3.  The base codes A0 C1 T2
// G3 N4 become one-hot masks A 1, C 2, T 4, G 8 and N 15 where they are
// loaded, so the match is one AND: for codes 0..4 (all that the byte table
// gives) it equals (r == h) | (r == 4) | (h == 4).
//
// Where a pair's inputs come from (the template argument PACKED: each
// <H, K, CARRY> instance is compiled once per source, so that neither
// source pays for the other's registers or branches; the pair-major
// instances are the kernel as it was before the unique-rows entry):
//   pair-major  pairhmm_striped_forward: read codes, 1-q and q/3 (B, r_pad),
//               hap codes (B, c_pad), rlen / clen / init_y (B,), as
//               _pallas_forward takes them;
//   PACKED      pairhmm_striped_forward_unique: one chunk of a group (one
//               segment: the striped path never fuses groups) as the
//               runner ships it raw (ops/pairhmm_front.py): u8 [reads |
//               quals | haps], i32 [read lens | hap lens | init_y bits], i32
//               (2, total) pair indices.  Each segment of H lanes finds its
//               (read, hap) pair in the pair indices (a pair outside nr_pad
//               x nh_pad traps: the launch fails and the process's CUDA
//               context is lost, but nothing is read out of bounds), and
//               loads its rows' base and quality bytes from the unique
//               read row (int64 offsets) through the 768-entry
//               ppe_element_table
//               ([mask | 1-q | q/3] at 0 / 256 / 512; the quality entries
//               repeat with period 128, so a byte indexes them as qual &
//               127 does the reference's tables); the hap is staged from
//               the unique hap row's bytes through the mask segment.  The
//               table is read through the read-only data cache (3 KB, hot
//               in L1).  init_y is f32 bits in i32, reinterpreted.  Only
//               bit patterns move: no float is computed before the step
//               loop, and no per-pair copy of the inputs exists in device
//               memory.
//
// Design.  A segment of H consecutive lanes of a warp owns one pair, so a
// warp holds 32/H pairs.  The read is cut into stripes of H K rows; lane i
// of a segment holds rows i K + 1 .. i K + K of the stripe in registers
// (their read mask, 1-q and q/3, and the previous column's M, X, Y of each
// row) and, at wavefront step t, computes column c = t - i for its K rows
// top to bottom: rows 2..K take "up" from the row just computed.  The
// lane's top row takes "up" from lane i-1's bottom row, computed at step
// t-1, by __shfl_up_sync of width H (3 shuffles per K cells); its
// "diagonal" is that value of the step before.  Lane 0 of a segment takes
// row 0 (M = X = 0, Y = init_y) in the first stripe and the previous
// stripe's last row, which the segment's lane H-1 left in shared memory by
// column, in later stripes (read at step c, rewritten in place H-1 steps
// later; a __syncwarp() orders the stripes), by selects.  Before column 1
// every lane computes exact zeros from zero state: the column-0 boundary.
// Each segment stages its pair's hap once, as byte masks with 32 zero
// slots on each side, so a step reads its column with one LDS.  K is the
// fewest rows per lane that cover r_pad in the fewest stripes of at most
// KMAX(H) rows per lane (ops/pairhmm_striped.py::striped_rows_per_lane):
// one stripe at every main-path r_pad (96 / 160 / 224: K 3 / 5 / 7 at H
// 32, 6 / 10 / 14 at H 16, 12 / 20 / 28 at H 8), and no stripe computes
// more rows than it must.
//
// Bounds when a warp holds several pairs (H < 32).  The loops must be
// warp-uniform (every lane reaches every shuffle with the full mask), so a
// warp runs the most stripes any of its pairs needs and each stripe for
// the most steps any of its live pairs needs (integer __reduce_max_sync;
// no f32 value is reduced across lanes).  A segment that runs past its
// clen computes columns nothing of its own reads (cells feed only their
// own column and the next), so the capture is predicated on column <=
// clen and on the pair's last stripe, and the carry write on column <=
// clen.  Row rlen's place in its lane differs between segments, so the
// lane holding it adds that row's M and X, in column order, into two
// accumulators under a predicate per row.  At H = 32 (one pair per warp)
// the place is warp-uniform: the step loop is instantiated per place and
// adds only that row, with no predicate, as the ppe kernel does.  The lane
// holding row rlen writes the sum; no atomics, no reduction of values
// across lanes.
//
// What bounds it.  Per step a lane issues 8 FMUL and 4 FADD per row, kept
// unfused for exactness, and the mask AND and select per row; per step, 3
// shuffles, one LDS, the lane-0 selects, the capture and the loop.  So it
// is bound by instruction issue, not by device memory: each pair's inputs
// are read once and only its result is written.  Both entries' bound is
// the operations bound (tools/_timing.py::ppe_bound), not bytes: from the
// unique rows a 65,536-pair group of 16,384 reads reads ~6 MB, which stays
// in L2, where the glue this entry replaced wrote ~244 MB of pair-major
// planes at (160, 448) for the kernel to read back.  Lanes wait up to H-1
// steps at the start of a stripe, rows past rlen are computed up to the
// next multiple of H K, and at H < 32 a segment waits for the longest
// clen of its warp and pays the capture predicates.  On an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has every shape), B = 65,536
// pairs at r_pad 160, c_pad 448: H 32 (K 5) takes 2.36 ms per launch, as
// the ppe kernel (2.35 in the same run), H 16 (K 10) 2.76 and H 8 (K 20)
// 2.67, against 8.58 / 11.33 / 19.20 for the one-row-per-lane kernel this
// one replaced; the operations bound is 0.524 ms.  K 20 takes 167
// registers and K 28 222, with no local memory or stack, so H 8 holds
// 2-3 blocks of 4 warps per SM.
//
// Exactness.  Built with -fmad=false (no mul+add contraction) and -ftz=true
// (the reference is flush-to-zero); the multiplies and adds are written with
// __fmul_rn/__fadd_rn, which are never contracted.  No division: q/3 and
// INITIAL/haplen come from the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;
constexpr int MAX_WARPS = 4;
constexpr int HAP_PAD = 32;  // zero slots before column 1 and after c_pad
constexpr int DEFAULT_SMEM = 48 * 1024;
// The most read rows a lane holds, per stripe height (registers).
constexpr int KMAX_32 = 8;
constexpr int KMAX_16 = 20;
constexpr int KMAX_8 = 28;
constexpr int SEG_FIELDS = 14;  // int64 values per segment row (the C entry)

constexpr int kmax(int h) {
  return h == 32 ? KMAX_32 : h == 16 ? KMAX_16 : KMAX_8;
}

struct Trans {
  float p_mm, p_gapm, p_mx, p_xx, p_my, p_yy;
};

// The chunk of a unique-rows launch: launch pair b is the group's pair src
// + b of its (2, stride) pair indices, read from its shipped arrays
// (device pointers).
struct Seg {
  long long src;
  const int32_t* lens;   // [read lens | hap lens | init_y bits]
  const uint8_t* rows;   // [reads | quals], (nr_pad, r_pad) bytes each
  const uint8_t* haps;   // (nh_pad, c_pad) bytes
  const int32_t* pairs;  // (2, stride) read / hap indices
  long long stride;
  int nr_pad, nh_pad;
};

// Everything a launch reads besides its output, passed by value in the
// kernel's parameters.
struct Args {
  const int32_t* rs;     // pair-major: (B, r_pad) read base codes
  const float* omq;      // pair-major: (B, r_pad) 1 - q
  const float* q3;       // pair-major: (B, r_pad) q / 3
  const int32_t* hap;    // pair-major: (B, c_pad) hap base codes
  const int32_t* rlen;   // pair-major: (B,)
  const int32_t* clen;   // pair-major: (B,)
  const float* init_y;   // pair-major: (B,)
  const int32_t* table;  // PACKED: ppe_element_table (768)
  float* out;            // (B,)
  int B, r_pad, c_pad;
  Trans tr;
  Seg seg;               // PACKED
};

// A base code (0..4) as a one-hot mask; N matches every base.
__device__ __forceinline__ int code_mask(int code) {
  return code == 4 ? 15 : 1 << code;
}

// Shared memory per pair: the carried row's M, X, Y by column 0..c_pad
// (CARRY instances only, 4-byte words) and the hap masks with their
// padding (bytes).  The hap copies of a warp's segments start 2 H bytes
// apart modulo 128, so their LDS of one step fall in different banks.
inline __host__ __device__ int carry_words(int c_pad) {
  return 3 * (c_pad + 1);
}
inline __host__ __device__ int hap_bytes(int c_pad, int h) {
  return (c_pad + 2 * HAP_PAD + 127) / 128 * 128 + 2 * h;
}

// One stripe of the lane's pair: `steps` wavefront steps over its K rows.
// QC >= 0 (H = 32): row rlen sits at place QC of its lane in every
// segment; every lane sums that row, and only the lane holding row rlen in
// the last stripe reports it.  QC < 0 (H < 32): the lane adds its row qc
// while step <= cap_lim (the lane holding row rlen, in its pair's last
// stripe, up to column clen; -1 elsewhere).  With CARRY, lane 0 of a later
// stripe (carry_in) reads the previous stripe's last row and lane H-1
// writes its bottom row while step <= carry_lim, both by column.
template <int H, int K, int QC, bool CARRY>
__device__ __forceinline__ void sweep(
    const unsigned char* __restrict__ hs, const int (&rs)[K],
    const float (&omq)[K], const float (&q3)[K], float* cm, float* cx,
    float* cy, bool carry_in, int carry_lim, int steps, int cl, int i,
    int qc, int cap_lim, float iy, Trans tr, float& acc_m, float& acc_x) {
  float md[K], xd[K], yd[K], ml[K], yl[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    md[q] = xd[q] = yd[q] = ml[q] = yl[q] = 0.0f;
  }
  // Y(0, 0) = init_y is row 1's only nonzero diagonal input at column 1
  if (i == 0 && !carry_in) yd[0] = iy;
  float mo = 0.0f, xo = 0.0f, yo = 0.0f;  // bottom row, previous step
  if (QC >= 0) {
    acc_m = 0.0f;
    acc_x = 0.0f;
  }
  // Unrolled twice, which saves the moves that rename the carried
  // registers between steps, except at H = 32 from K 8 (slower, as in the
  // ppe kernel) and where it made nvcc put a stack frame in the carry
  // instances (H 32 K 6, H < 32 K 19); tools/ppe_variants.py.
#pragma unroll((H < 32 ? !(CARRY && K >= 19) : K <= (CARRY ? 5 : 7)) ? 2 : 1)
  for (int step = 1; step <= steps; ++step) {
    const int hw = hs[step];  // this lane's column step - i
    float MA = __shfl_up_sync(FULL, mo, 1, H);
    float XA = __shfl_up_sync(FULL, xo, 1, H);
    float YA = __shfl_up_sync(FULL, yo, 1, H);
    if (i == 0) {
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
      if (QC >= 0 ? q == QC : q == qc && step <= cap_lim) {
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
    if (CARRY && step >= H && step <= carry_lim) {
      const int c = step - (H - 1);  // lane H-1's column: 1..clen
      cm[c] = mo;
      cx[c] = xo;
      cy[c] = yo;
    }
  }
}

// sweep<H, K, qc, CARRY> for a runtime, warp-uniform qc in 0..K-1.
template <int H, int K, bool CARRY, int QC = 0>
__device__ __forceinline__ void sweep_at(
    int qc, const unsigned char* __restrict__ hs, const int (&rs)[K],
    const float (&omq)[K], const float (&q3)[K], float* cm, float* cx,
    float* cy, bool carry_in, int carry_lim, int steps, int cl, int i,
    float iy, Trans tr, float& acc_m, float& acc_x) {
  if constexpr (QC + 1 < K) {
    if (qc != QC) {
      sweep_at<H, K, CARRY, QC + 1>(qc, hs, rs, omq, q3, cm, cx, cy,
                                    carry_in, carry_lim, steps, cl, i, iy,
                                    tr, acc_m, acc_x);
      return;
    }
  }
  sweep<H, K, QC, CARRY>(hs, rs, omq, q3, cm, cx, cy, carry_in, carry_lim,
                         steps, cl, i, QC, -1, iy, tr, acc_m, acc_x);
}

template <int H, int K, bool CARRY, bool PACKED>
__global__ void __launch_bounds__(LANES * MAX_WARPS)
striped_forward_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = H * K;      // rows per stripe
  const int i = threadIdx.x % H;     // lane within the segment
  const int slot = threadIdx.x / H;  // pair within the block
  const int pairs = blockDim.x / H;
  const int64_t b = (int64_t)blockIdx.x * pairs + slot;
  const bool valid = b < a.B;
  if (H == LANES && !valid) return;  // the whole warp: one pair per warp
  int rl = 0, cl = 0;
  float iy = 0.0f;
  // PACKED: the pair's unique read row (its base bytes; its quality bytes
  // lie nr_pad rows further) and unique hap row in the shipped bytes
  const uint8_t* read_u8 = nullptr;
  const uint8_t* hap_u8 = nullptr;
  if (valid) {
    if constexpr (PACKED) {
      const long long e = a.seg.src + b;
      const int pr = a.seg.pairs[e];
      const int ph = a.seg.pairs[a.seg.stride + e];
      if (pr < 0 || pr >= a.seg.nr_pad || ph < 0 || ph >= a.seg.nh_pad)
        __trap();
      rl = a.seg.lens[pr];
      cl = max(0, min(a.seg.lens[a.seg.nr_pad + ph], a.c_pad));
      iy = __int_as_float(a.seg.lens[a.seg.nr_pad + a.seg.nh_pad + ph]);
      read_u8 = a.seg.rows + static_cast<long long>(pr) * a.r_pad;
      hap_u8 = a.seg.haps + static_cast<long long>(ph) * a.c_pad;
    } else {
      rl = a.rlen[b];
      cl = max(0, min(a.clen[b], a.c_pad));
      iy = a.init_y[b];
    }
  }
  // a read length outside 1..r_pad captures no row: the TPU kernel's row
  // mask never fires and it returns 0
  const bool ok = valid && rl >= 1 && rl <= a.r_pad;
  if (H == LANES && !ok) {
    if (i == 0) a.out[b] = 0.0f;
    return;
  }

  float* cm = nullptr;
  float* cx = nullptr;
  float* cy = nullptr;
  int carry_bytes = 0;
  if (CARRY) {
    cm = reinterpret_cast<float*>(smem) + slot * carry_words(a.c_pad);
    cx = cm + (a.c_pad + 1);
    cy = cx + (a.c_pad + 1);
    carry_bytes = pairs * carry_words(a.c_pad) * (int)sizeof(float);
  }
  // hap mask of column c (1-based) at byte HAP_PAD - 1 + c; zeros around
  unsigned char* hap_s = smem + carry_bytes + slot * hap_bytes(a.c_pad, H);
  const int32_t* hap_b = a.hap + b * a.c_pad;
  for (int j = i; j < a.c_pad + 2 * HAP_PAD; j += H) {
    const int col = j - HAP_PAD;
    if constexpr (PACKED)
      hap_s[j] = col >= 0 && col < cl ? __ldg(a.table + hap_u8[col]) : 0;
    else
      hap_s[j] = col >= 0 && col < cl ? code_mask(hap_b[col]) : 0;
  }
  __syncwarp();
  const unsigned char* hs = hap_s + HAP_PAD - 1 - i;  // hs[t]: column t - i

  const int n = ok ? (CARRY ? (rl + S - 1) / S : 1) : 0;  // pair's stripes
  const int last = rl - 1 - (n - 1) * S;  // row rlen in its last stripe
  const int jr = last / K;                // the lane holding it
  const int qc = last % K;                // its place in that lane
  const int n_warp = H == LANES ? n : __reduce_max_sync(FULL, n);
  const int32_t* rs_b = a.rs + b * a.r_pad;
  const float* omq_b = a.omq + b * a.r_pad;
  const float* q3_b = a.q3 + b * a.r_pad;
  const uint8_t* qual_u8 =
      PACKED ? read_u8 + static_cast<long long>(a.seg.nr_pad) * a.r_pad
             : nullptr;
  float acc_m = 0.0f, acc_x = 0.0f;
  for (int s = 0; s < n_warp; ++s) {
    const bool live = s < n;
    int rs[K];
    float omq[K], q3[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int r = s * S + i * K + q;  // 0-based read row
      rs[q] = 0;
      omq[q] = q3[q] = 0.0f;
      if (live && r < rl) {
        if constexpr (PACKED) {
          const int qb = qual_u8[r];
          rs[q] = __ldg(a.table + read_u8[r]);
          omq[q] = __int_as_float(__ldg(a.table + 256 + qb));
          q3[q] = __int_as_float(__ldg(a.table + 512 + qb));
        } else {
          rs[q] = code_mask(rs_b[r]);
          omq[q] = omq_b[r];
          q3[q] = q3_b[r];
        }
      }
    }
    const bool more = s + 1 < n;
    int steps = live ? cl + (more ? H - 1 : jr) : 0;
    if (H < LANES) steps = __reduce_max_sync(FULL, steps);
    const int carry_lim = CARRY && more && i == H - 1 ? cl + H - 1 : -1;
    if constexpr (H == LANES) {
      sweep_at<H, K, CARRY>(qc, hs, rs, omq, q3, cm, cx, cy, s > 0,
                            carry_lim, steps, cl, i, iy, a.tr, acc_m, acc_x);
    } else {
      const int cap_lim = live && !more && i == jr ? cl + i : -1;
      sweep<H, K, -1, CARRY>(hs, rs, omq, q3, cm, cx, cy, s > 0, carry_lim,
                             steps, cl, i, qc, cap_lim, iy, a.tr, acc_m,
                             acc_x);
    }
    if (CARRY) __syncwarp();
  }
  if (ok ? i == jr : valid && i == 0) a.out[b] = __fadd_rn(acc_m, acc_x);
}

// Blocks of up to MAX_WARPS warps, fewer when their shared memory would
// exceed the default 48 KB; a single warp that needs more raises the
// kernel's limit, up to the card's opt-in maximum.
template <int H, int K, bool CARRY, bool PACKED>
cudaError_t configure(int c_pad, int* warps_out, size_t* smem_out) {
  const size_t per_warp =
      (size_t)(LANES / H) *
      (hap_bytes(c_pad, H) +
       (CARRY ? carry_words(c_pad) * sizeof(float) : 0));
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
    err = cudaFuncSetAttribute(striped_forward_kernel<H, K, CARRY, PACKED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  *warps_out = warps;
  *smem_out = smem;
  return cudaSuccess;
}

template <int H, int K, bool CARRY, bool PACKED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  int warps = 0;
  size_t smem = 0;
  const cudaError_t err =
      configure<H, K, CARRY, PACKED>(a.c_pad, &warps, &smem);
  if (err != cudaSuccess) return err;
  const int pairs_per_block = warps * (LANES / H);
  const int blocks = (a.B + pairs_per_block - 1) / pairs_per_block;
  striped_forward_kernel<H, K, CARRY, PACKED>
      <<<blocks, LANES * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

// The launch shape at c_pad: warps per block, dynamic shared memory per
// block (bytes) and the blocks an SM holds at once (occupancy API).
template <int H, int K, bool CARRY, bool PACKED>
cudaError_t shape(int c_pad, int* out) {
  int warps = 0, blocks = 0;
  size_t smem = 0;
  cudaError_t err = configure<H, K, CARRY, PACKED>(c_pad, &warps, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, striped_forward_kernel<H, K, CARRY, PACKED>, LANES * warps,
        smem);
  out[0] = warps;
  out[1] = (int)smem;
  out[2] = blocks;
  return err;
}

// f(K, CARRY) for the instance of stripe height H that runs k rows per
// lane at r_pad: k in 1..KMAX(H), CARRY when one stripe of H k rows does
// not cover r_pad.  The rule (fewest stripes of at most KMAX rows per
// lane, then the fewest rows per lane that cover r_pad in them) carries
// only at k > KMAX / 2, so only those k have a CARRY instance.
template <int H, int K = 1, class F>
cudaError_t with_instance(int k, int r_pad, F&& f) {
  using std::integral_constant;
  if constexpr (K < kmax(H)) {
    if (k != K) return with_instance<H, K + 1>(k, r_pad, f);
  } else {
    if (k != K) return cudaErrorInvalidValue;
  }
  if (r_pad <= H * K)
    return f(integral_constant<int, K>{}, integral_constant<bool, false>{});
  if constexpr (2 * K > kmax(H))
    return f(integral_constant<int, K>{}, integral_constant<bool, true>{});
  return cudaErrorInvalidValue;
}

// The instances of stripe height H for one source, by k: launched on a's
// pairs, or their launch shape at c_pad into o[3].
template <int H, bool PACKED>
int launch_height(const Args& a, int k, cudaStream_t s) {
  return static_cast<int>(
      with_instance<H>(k, a.r_pad, [&](auto kc, auto cc) {
        return launch<H, decltype(kc)::value, decltype(cc)::value, PACKED>(
            a, s);
      }));
}

template <int H, bool PACKED>
int shape_height(int r_pad, int c_pad, int k, int* o) {
  return static_cast<int>(with_instance<H>(k, r_pad, [&](auto kc, auto cc) {
    return shape<H, decltype(kc)::value, decltype(cc)::value, PACKED>(c_pad,
                                                                       o);
  }));
}

}  // namespace

// Translation units.  The library is built from this one source as seven
// translation units, compiled at once and linked into one library
// (ops/_kernels.py UNITS): -DSTRIPED_UNIT=U for U = 1..6 compiles the
// instances of one stripe height and one source, U = 1 + 2 h + PACKED with
// h = 0, 1, 2 for H = 8, 16, 32, behind two unmangled functions, and
// -DSTRIPED_UNIT=0 the C entry points, which call them.  H 8 holds half of
// the 168 instances, so one unit per height would leave half of the work
// in one.  Built without STRIPED_UNIT, the source is one unit that holds
// everything.
#define STRIPED_UNIT_DECLARE(U)                                             \
  extern "C" int pairhmm_striped_unit##U##_launch(const void* a, int k,     \
                                                  void* stream);            \
  extern "C" int pairhmm_striped_unit##U##_shape(int r_pad, int c_pad,      \
                                                 int k, void* out);
#define STRIPED_UNIT_DEFINE(U, H, PACKED)                                   \
  extern "C" int pairhmm_striped_unit##U##_launch(const void* a, int k,     \
                                                  void* stream) {           \
    return launch_height<H, PACKED>(*static_cast<const Args*>(a), k,        \
                                    static_cast<cudaStream_t>(stream));     \
  }                                                                         \
  extern "C" int pairhmm_striped_unit##U##_shape(int r_pad, int c_pad,      \
                                                 int k, void* out) {        \
    return shape_height<H, PACKED>(r_pad, c_pad, k, static_cast<int*>(out)); \
  }

STRIPED_UNIT_DECLARE(1)
STRIPED_UNIT_DECLARE(2)
STRIPED_UNIT_DECLARE(3)
STRIPED_UNIT_DECLARE(4)
STRIPED_UNIT_DECLARE(5)
STRIPED_UNIT_DECLARE(6)
#if !defined(STRIPED_UNIT) || STRIPED_UNIT == 1
STRIPED_UNIT_DEFINE(1, 8, false)
#endif
#if !defined(STRIPED_UNIT) || STRIPED_UNIT == 2
STRIPED_UNIT_DEFINE(2, 8, true)
#endif
#if !defined(STRIPED_UNIT) || STRIPED_UNIT == 3
STRIPED_UNIT_DEFINE(3, 16, false)
#endif
#if !defined(STRIPED_UNIT) || STRIPED_UNIT == 4
STRIPED_UNIT_DEFINE(4, 16, true)
#endif
#if !defined(STRIPED_UNIT) || STRIPED_UNIT == 5
STRIPED_UNIT_DEFINE(5, 32, false)
#endif
#if !defined(STRIPED_UNIT) || STRIPED_UNIT == 6
STRIPED_UNIT_DEFINE(6, 32, true)
#endif

#if !defined(STRIPED_UNIT) || STRIPED_UNIT == 0
namespace {

using UnitLaunch = int (*)(const void*, int, void*);
using UnitShape = int (*)(int, int, int, void*);
// by U - 1
constexpr UnitLaunch UNIT_LAUNCH[6] = {
    pairhmm_striped_unit1_launch, pairhmm_striped_unit2_launch,
    pairhmm_striped_unit3_launch, pairhmm_striped_unit4_launch,
    pairhmm_striped_unit5_launch, pairhmm_striped_unit6_launch};
constexpr UnitShape UNIT_SHAPE[6] = {
    pairhmm_striped_unit1_shape, pairhmm_striped_unit2_shape,
    pairhmm_striped_unit3_shape, pairhmm_striped_unit4_shape,
    pairhmm_striped_unit5_shape, pairhmm_striped_unit6_shape};

// U - 1 of the unit holding stripe height `stripe`'s instances for the
// source, -1 for another stripe height.
int unit_index(int stripe, bool packed) {
  const int h = stripe == 8 ? 0 : stripe == 16 ? 1 : stripe == 32 ? 2 : -1;
  return h < 0 ? -1 : 2 * h + (packed ? 1 : 0);
}

// The instance for (stripe, k, r_pad) and the source, launched on a's
// pairs.
template <bool PACKED>
int launch_any(const Args& a, int stripe, int k, cudaStream_t s) {
  const int u = unit_index(stripe, PACKED);
  if (u < 0) return static_cast<int>(cudaErrorInvalidValue);
  return UNIT_LAUNCH[u](&a, k, s);
}

// The launch shape of that instance at c_pad into out[3].
template <bool PACKED>
int shape_any(int r_pad, int c_pad, int stripe, int k, void* out) {
  const int u = unit_index(stripe, PACKED);
  if (r_pad <= 0 || c_pad <= 0 || u < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return UNIT_SHAPE[u](r_pad, c_pad, k, out);
}

}  // namespace

// Raw forward probabilities of B pairs into out (B,) f32, stripe height
// stripe (8, 16 or 32, dividing r_pad) and k read rows per lane (1 ..
// KMAX(stripe); above KMAX / 2 when r_pad > stripe k).  Returns a CUDA error
// code (cudaErrorInvalidValue for a bad stripe, k or shape,
// cudaErrorInvalidConfiguration when one warp's shared memory does not
// fit), 0 on success.
extern "C" int pairhmm_striped_forward(const void* rs, const void* omq,
                                       const void* q3, const void* hap,
                                       const void* rlen, const void* clen,
                                       const void* init_y, void* out, int B,
                                       int r_pad, int c_pad, int stripe,
                                       int k, float p_mm, float p_gapm,
                                       float p_mx, float p_xx, float p_my,
                                       float p_yy, void* stream) {
  if (B <= 0) return 0;
  if (r_pad <= 0 || c_pad <= 0 || stripe <= 0 || r_pad % stripe != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.rs = static_cast<const int32_t*>(rs);
  a.omq = static_cast<const float*>(omq);
  a.q3 = static_cast<const float*>(q3);
  a.hap = static_cast<const int32_t*>(hap);
  a.rlen = static_cast<const int32_t*>(rlen);
  a.clen = static_cast<const int32_t*>(clen);
  a.init_y = static_cast<const float*>(init_y);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.r_pad = r_pad;
  a.c_pad = c_pad;
  a.tr = Trans{p_mm, p_gapm, p_mx, p_xx, p_my, p_yy};
  return launch_any<false>(a, stripe, k, static_cast<cudaStream_t>(stream));
}

// Raw forward probabilities of one chunk read from its group's shipped raw
// packed rows (the PACKED source; it replaces _unpack_u8 +
// prepare_tables_striped + dispatch_pairs_striped): seg a host array of
// one segment row of SEG_FIELDS int64 values in the ppe entry's layout,
// [first, n, src, lens, rows, haps, pairs, stride, mini, spans, starts,
// nr_pad, nh_pad, n_spans] (pointers as device addresses; first 0; mini,
// spans, starts and n_spans unused; ops/pairhmm_front.py::segment_rows);
// table the 768-entry ppe_element_table; out (n,) f32; stripe and k as
// pairhmm_striped_forward takes them.  Returns a CUDA error code
// (cudaErrorInvalidValue for a bad segment row, stripe, k or shape,
// cudaErrorInvalidConfiguration when one warp's shared memory does not
// fit), 0 on success.
extern "C" int pairhmm_striped_forward_unique(
    const void* seg, const void* table, void* out, int r_pad, int c_pad,
    int stripe, int k, float p_mm, float p_gapm, float p_mx, float p_xx,
    float p_my, float p_yy, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (seg == nullptr || r_pad <= 0 || c_pad <= 0 || stripe <= 0 ||
      r_pad % stripe != 0 || table == nullptr)
    return bad;
  const auto* row = static_cast<const long long*>(seg);
  const long long n = row[1];
  Args a{};
  a.table = static_cast<const int32_t*>(table);
  a.out = static_cast<float*>(out);
  a.r_pad = r_pad;
  a.c_pad = c_pad;
  a.tr = Trans{p_mm, p_gapm, p_mx, p_xx, p_my, p_yy};
  Seg& g = a.seg;
  g.src = row[2];
  g.lens = reinterpret_cast<const int32_t*>(row[3]);
  g.rows = reinterpret_cast<const uint8_t*>(row[4]);
  g.haps = reinterpret_cast<const uint8_t*>(row[5]);
  g.pairs = reinterpret_cast<const int32_t*>(row[6]);
  g.stride = row[7];
  g.nr_pad = static_cast<int>(row[11]);
  g.nh_pad = static_cast<int>(row[12]);
  if (row[0] != 0 || n < 0 || n > INT32_MAX || g.src < 0 ||
      g.src + n > g.stride || g.nr_pad < 1 || g.nh_pad < 1 || !g.lens ||
      !g.rows || !g.haps || !g.pairs)
    return bad;
  if (n == 0) return 0;
  a.B = static_cast<int>(n);
  return launch_any<true>(a, stripe, k, static_cast<cudaStream_t>(stream));
}

// The launch shape pairhmm_striped_forward uses at (r_pad, c_pad, stripe,
// k): out[0] warps per block, out[1] dynamic shared memory per block in
// bytes, out[2] resident blocks per SM.  Returns a CUDA error code, 0 on
// success.
extern "C" int pairhmm_striped_launch_shape(int r_pad, int c_pad, int stripe,
                                            int k, void* out) {
  return shape_any<false>(r_pad, c_pad, stripe, k, out);
}

// The same for pairhmm_striped_forward_unique's instance (its own
// registers, so its resident blocks may differ).
extern "C" int pairhmm_striped_unique_launch_shape(int r_pad, int c_pad,
                                                   int stripe, int k,
                                                   void* out) {
  return shape_any<true>(r_pad, c_pad, stripe, k, out);
}
#endif  // the C entry points
