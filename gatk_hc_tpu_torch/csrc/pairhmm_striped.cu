// PairHMM forward, striped anti-diagonal kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel gatk_hc_tpu/ops/pairhmm_pallas.py::_kernel behind
// _pallas_forward(algo="striped").  One template over the stripe height H
// (8, 16 or 32).
//
// What it computes, per (read, hap) pair b: the same function as the ppe
// kernel (csrc/pairhmm_ppe.cu), the raw f32 forward probability (scaled by
// INITIAL_CONSTANT)
//     sum_{c=1..clen} M[rlen][c]  +  sum_{c=1..clen} X[rlen][c],
// with every DP cell evaluated as
//     M = ((M_diag*p_mm + X_diag*p_gapm) + Y_diag*p_gapm) * dist
//     X = M_up*p_mx + X_up*p_xx
//     Y = M_left*p_my + Y_left*p_yy
// and dist = match ? (1-q) : q/3, match = (r == h) | (r == 4) | (h == 4)
// on the raw base codes A0 C1 T2 G3 N4.
//
// Design.  A segment of H consecutive lanes of one warp owns one pair, so a
// warp holds 32/H pairs.  The DP matrix is swept in stripes of H rows; lane
// i holds row s*H + i + 1 of stripe s and, at wavefront step t, computes
// the cell in column t - i.  Its "up" cell is lane i-1's cell of step t-1
// and its "diagonal" cell is lane i-1's cell of step t-2, i.e. its own
// "up" of step t-1: both arrive with one __shfl_up_sync per state (M, X,
// Y) and step.  "Left" is the lane's own previous cell.  Lane 0 of each
// segment takes "up" from the previous stripe's last row instead, which
// lane H-1 wrote into shared memory, one (M, X, Y) per column.  That one
// row (3 x (c_pad + 1) floats per pair) is the only DP state that leaves
// registers; the TPU kernel's shifted (C + 2H + 1) carry index map was a
// VMEM trick and is not needed here.  Lane 0 reads column t while lane H-1
// writes column t - H + 1, which lane 0 read H - 1 steps earlier, so the
// row is updated in place.  The stripes of one pair run in order in one
// warp, so a __syncwarp() between stripes orders the hand-off.  Each lane
// keeps its row's base code, 1-q and q/3 in registers for the stripe.
//
// Layout.  Pair-major inputs, as _pallas_forward takes them before its
// transpose: read codes / 1-q / q/3 (B, r_pad), hap codes (B, c_pad).  The
// lanes of a segment read consecutive rows (one load per stripe) and, each
// step, a window of consecutive hap columns of their one pair, so the loads
// coalesce.  The TPU transposed to (R, B) because its lanes were pairs.
//
// Work.  A pair needs only the stripes up to the one holding row rlen, and
// only columns up to clen: later cells never feed a captured cell.  The
// loops are warp-uniform (every lane reaches every __shfl_up_sync with the
// full mask): a warp runs the most stripes any of its pairs needs, and each
// stripe for the longest clen among its pairs still live in that stripe;
// other lanes compute nothing and hold zeros.  The bounds are integer
// __reduce_max_sync of lengths; no f32 value is reduced across lanes.
//
// What bounds it.  The function needs 8 f32 multiplies and 4 adds per true
// cell (the same operations bound as ppe, chip_smoke.py::ppe_bound).  Per
// lane-step the kernel also issues 3 shuffles, one hap load (L1-resident:
// a segment's window slides one column per step) and a few integer ops and
// selects, and a stripe's first and last H-1 steps run part of the lanes
// idle.  So it is bound by instruction issue and shuffle throughput, not by
// device memory: the DP state stays on chip.  Shared memory per pair is
// 12 (c_pad + 1) bytes; the launcher puts fewer warps in a block when a
// block would need more than 48 KB and raises the per-block limit only for
// a single warp whose pairs need more.  That shared memory also caps how
// many warps an SM holds, and a warp of H = 8 carries four pairs' rows: on
// an H100 H = 32 runs in about half of ppe4's time at the main path's
// shapes and H = 8 is the slowest instance (chip_smoke.py prints each H's
// ms per launch and blocks per SM; PERF.md).
//
// Exactness.  Built with -fmad=false (no mul+add contraction) and -ftz=true
// (the reference is flush-to-zero); the multiplies and adds are written with
// __fmul_rn/__fadd_rn, which are never contracted.  No division: q/3 and
// INITIAL/haplen come from the host.  The lane holding row rlen adds its M
// and X into two accumulators in column order and writes their sum; no
// atomics, no warp reduction of values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 4;
constexpr int DEFAULT_SMEM = 48 * 1024;

struct Trans {
  float p_mm, p_gapm, p_mx, p_xx, p_my, p_yy;
};

template <int H>
__global__ void __launch_bounds__(32 * MAX_WARPS)
striped_forward_kernel(const int32_t* __restrict__ rs,    // (B, r_pad)
                       const float* __restrict__ omq,     // (B, r_pad)
                       const float* __restrict__ q3,      // (B, r_pad)
                       const int32_t* __restrict__ hap,   // (B, c_pad)
                       const int32_t* __restrict__ rlen,  // (B,)
                       const int32_t* __restrict__ clen,  // (B,)
                       const float* __restrict__ init_y,  // (B,)
                       float* __restrict__ out,           // (B,)
                       int B, int r_pad, int c_pad, Trans t) {
  extern __shared__ float carry[];
  const int lane = threadIdx.x & 31;
  const int i = lane % H;  // row within the stripe
  const int slot = threadIdx.x / H;  // pair within the block
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x / H) + slot;
  const bool valid = b < B;
  // the previous stripe's last row (row 0 before stripe 0), by column
  const int width = c_pad + 1;
  float* cm = carry + (size_t)slot * 3 * width;
  float* cx = cm + width;
  float* cy = cx + width;

  int rl = 0, cl = 0;
  float iy = 0.0f;
  if (valid) {
    rl = rlen[b];
    cl = min(clen[b], c_pad);
    iy = init_y[b];
  }
  // a read length outside 1..r_pad captures no row: the TPU kernel's row
  // mask never fires and it returns 0
  const bool ok = valid && rl >= 1 && rl <= r_pad;
  const int n_stripes = ok ? (rl + H - 1) / H : 0;

  // row 0: M = X = 0, Y = init_y in every column
  if (ok) {
    for (int c = 1 + i; c <= cl; c += H) {
      cm[c] = 0.0f;
      cx[c] = 0.0f;
      cy[c] = iy;
    }
  }
  __syncwarp();

  const int32_t* rs_b = rs + b * r_pad;
  const float* omq_b = omq + b * r_pad;
  const float* q3_b = q3 + b * r_pad;
  const int32_t* hap_b = hap + b * c_pad;
  float acc_m = 0.0f, acc_x = 0.0f;
  const int warp_stripes = __reduce_max_sync(FULL, n_stripes);
  for (int s = 0; s < warp_stripes; ++s) {
    const bool live = s < n_stripes;
    const int row = s * H + i;  // matrix row row + 1
    int rcode = 0;
    float om = 0.0f, qq = 0.0f;
    if (live) {
      rcode = rs_b[row];
      om = omq_b[row];
      qq = q3_b[row];
    }
    const bool capture = live && row + 1 == rl;
    const int cl_live = live ? cl : 0;
    const int steps = __reduce_max_sync(FULL, live ? cl + H - 1 : 0);

    float m_prev = 0.0f, x_prev = 0.0f, y_prev = 0.0f;  // own cell, step t-1
    // the diagonal cell is the "up" cell of the step before; for lane 0 at
    // column 1 it is (s*H, 0): Y(0, 0) = init_y in stripe 0, else zero
    float dm = 0.0f, dx = 0.0f, dy = (i == 0 && s == 0) ? iy : 0.0f;
    // hap code of this lane's column at step 1 (column 1 - i), prefetched
    int h_next = (i == 0 && cl_live >= 1) ? hap_b[0] : 0;
#pragma unroll 1
    for (int step = 1; step <= steps; ++step) {
      const int c = step - i;
      const bool active = c >= 1 && c <= cl_live;
      const int h = h_next;
      // next step's column is c + 1: hap index c
      h_next = (c >= 0 && c < cl_live) ? hap_b[c] : 0;
      float um = __shfl_up_sync(FULL, m_prev, 1, H);
      float ux = __shfl_up_sync(FULL, x_prev, 1, H);
      float uy = __shfl_up_sync(FULL, y_prev, 1, H);
      if (i == 0) {
        um = active ? cm[c] : 0.0f;
        ux = active ? cx[c] : 0.0f;
        uy = active ? cy[c] : 0.0f;
      }
      float M = 0.0f, X = 0.0f, Y = 0.0f;
      if (active) {
        const bool match = (rcode == h) | (rcode == 4) | (h == 4);
        const float dist = match ? om : qq;
        const float t1 = __fmul_rn(dm, t.p_mm);
        const float t2 = __fmul_rn(dx, t.p_gapm);
        const float t3 = __fmul_rn(dy, t.p_gapm);
        M = __fmul_rn(__fadd_rn(__fadd_rn(t1, t2), t3), dist);
        X = __fadd_rn(__fmul_rn(um, t.p_mx), __fmul_rn(ux, t.p_xx));
        Y = __fadd_rn(__fmul_rn(m_prev, t.p_my), __fmul_rn(y_prev, t.p_yy));
        if (capture) {
          acc_m = __fadd_rn(acc_m, M);
          acc_x = __fadd_rn(acc_x, X);
        }
        if (i == H - 1) {  // the stripe's last row, for the next stripe
          cm[c] = M;
          cx[c] = X;
          cy[c] = Y;
        }
      }
      dm = um;
      dx = ux;
      dy = uy;
      m_prev = M;
      x_prev = X;
      y_prev = Y;
    }
    __syncwarp();
  }
  if (ok ? i == (rl - 1) % H : valid && i == 0) {
    out[b] = __fadd_rn(acc_m, acc_x);
  }
}

// Blocks of up to MAX_WARPS warps, fewer when their carry rows would need
// more than the default 48 KB of shared memory; a single warp that needs
// more raises the kernel's limit, up to the card's opt-in maximum.
template <int H>
cudaError_t configure(int c_pad, int* warps_out, size_t* smem_out) {
  const size_t per_warp = (size_t)(32 / H) * 3 * (c_pad + 1) * sizeof(float);
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
    err = cudaFuncSetAttribute(striped_forward_kernel<H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  *warps_out = warps;
  *smem_out = smem;
  return cudaSuccess;
}

template <int H>
cudaError_t launch(const int32_t* rs, const float* omq, const float* q3,
                   const int32_t* hap, const int32_t* rlen,
                   const int32_t* clen, const float* init_y, float* out,
                   int B, int r_pad, int c_pad, Trans t,
                   cudaStream_t stream) {
  int warps = 0;
  size_t smem = 0;
  const cudaError_t err = configure<H>(c_pad, &warps, &smem);
  if (err != cudaSuccess) return err;
  const int pairs_per_block = warps * (32 / H);
  const int blocks = (B + pairs_per_block - 1) / pairs_per_block;
  striped_forward_kernel<H><<<blocks, 32 * warps, smem, stream>>>(
      rs, omq, q3, hap, rlen, clen, init_y, out, B, r_pad, c_pad, t);
  return cudaGetLastError();
}

// The launch shape at c_pad: warps per block, dynamic shared memory per
// block (bytes) and the blocks an SM holds at once (occupancy API).
template <int H>
cudaError_t shape(int c_pad, int* out) {
  int warps = 0, blocks = 0;
  size_t smem = 0;
  cudaError_t err = configure<H>(c_pad, &warps, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, striped_forward_kernel<H>, 32 * warps, smem);
  out[0] = warps;
  out[1] = (int)smem;
  out[2] = blocks;
  return err;
}

}  // namespace

// Raw forward probabilities of B pairs into out (B,) f32.  Requires
// r_pad % stripe == 0 and stripe in {8, 16, 32}; returns a CUDA error code
// (cudaErrorInvalidValue for a bad stripe or shape,
// cudaErrorInvalidConfiguration when one warp's carry rows do not fit in
// shared memory), 0 on success.
extern "C" int pairhmm_striped_forward(const void* rs, const void* omq,
                                       const void* q3, const void* hap,
                                       const void* rlen, const void* clen,
                                       const void* init_y, void* out, int B,
                                       int r_pad, int c_pad, int stripe,
                                       float p_mm, float p_gapm, float p_mx,
                                       float p_xx, float p_my, float p_yy,
                                       void* stream) {
  if (B <= 0) return 0;
  if (r_pad <= 0 || c_pad <= 0 || stripe <= 0 || r_pad % stripe != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Trans t{p_mm, p_gapm, p_mx, p_xx, p_my, p_yy};
  auto* r = static_cast<const int32_t*>(rs);
  auto* o = static_cast<const float*>(omq);
  auto* q = static_cast<const float*>(q3);
  auto* h = static_cast<const int32_t*>(hap);
  auto* rl = static_cast<const int32_t*>(rlen);
  auto* cl = static_cast<const int32_t*>(clen);
  auto* iy = static_cast<const float*>(init_y);
  auto* res = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (stripe) {
    case 8:
      return launch<8>(r, o, q, h, rl, cl, iy, res, B, r_pad, c_pad, t, s);
    case 16:
      return launch<16>(r, o, q, h, rl, cl, iy, res, B, r_pad, c_pad, t, s);
    case 32:
      return launch<32>(r, o, q, h, rl, cl, iy, res, B, r_pad, c_pad, t, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch shape pairhmm_striped_forward uses at c_pad and stripe:
// out[0] warps per block, out[1] dynamic shared memory per block in bytes,
// out[2] resident blocks per SM.  Returns a CUDA error code, 0 on success.
extern "C" int pairhmm_striped_launch_shape(int c_pad, int stripe,
                                            void* out) {
  auto* o = static_cast<int*>(out);
  if (c_pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (stripe) {
    case 8:
      return shape<8>(c_pad, o);
    case 16:
      return shape<16>(c_pad, o);
    case 32:
      return shape<32>(c_pad, o);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
