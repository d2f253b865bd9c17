// PairHMM forward, pair-per-thread ("ppe") kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel family gatk_hc_tpu/ops/pairhmm_pallas.py::
// _kernel_ppe (NR=1), _kernel_ppe2 (NR=2) and _make_kernel_ppe_multi(NR)
// (_kernel_ppe4, _kernel_ppe8) behind _pallas_call_ppe.  One template over
// NR covers all four.
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
// Design.  One thread owns one pair and sweeps its DP matrix row-major, NR
// rows at a time: rows r..r+NR-1 walk the columns together, so rows 2..NR
// take their "up" values from the registers of the row above and only the
// group's last row goes back to memory.  The row-above M/X/Y of the group
// live in (c_pad, B) f32 scratch in device memory, pair-minor so a warp's
// 32 loads of one column coalesce into one 128-byte transaction; the read
// planes (r_pad, 3, B) and hap masks (c_pad, B) are pair-minor for the same
// reason.  A thread stops at its own pair's rlen (rounded up to NR) and
// clen: cells past them never feed a captured cell, so the result is the
// same as the TPU kernel's full padded sweep.  Each column step loads the
// next column's hap mask and row-above values before it stores its own,
// so the loads' latency overlaps the column's arithmetic.  Left to nvcc's
// scheduling, small edits of the source made some NR instances issue a
// load late in the column step and run about 7x slower (chip_smoke.py,
// H100).
//
// What bounds it.  Per cell: 8 f32 multiplies and 4 f32 adds (kept
// unfused, so each takes an instruction slot), one AND and one select;
// row rlen adds its M and X to the two sums (2 adds per column, issued
// predicated in every row of the last group).  Per column step of a row
// group: 16 bytes read (hap mask + row-above M/X/Y) and 12 written, i.e.
// 28/NR bytes per cell.  That scratch misses the 50 MB L2 at main-path
// batch sizes; at one column step per memory round trip the kernel moves
// ~1.2 TB/s of it on an H100 (chip_smoke.py), far above its operations
// bound.  Keeping the row above on chip (shared memory, a warp-cooperative
// tiling) is later work.
//
// Exactness.  Built with -fmad=false (no mul+add contraction) and
// -ftz=true (the reference is flush-to-zero; every input to a cell is a
// flushed result or a table value far above the denormal range, so the
// input flush changes nothing).  The multiplies and adds are also written
// with __fmul_rn/__fadd_rn, which are never contracted.  No division: q/3
// and INITIAL/haplen come from the host, and the omq/q3 planes hold f32
// bits in i32 (reinterpreted with __int_as_float, never converted).  Row
// rlen is summed in column order into two accumulators that are added at
// the end; no atomics, no warp reductions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Trans {
  float p_mm, p_gapm, p_mx, p_xx, p_my, p_yy;
};

template <int NR>
__global__ void __launch_bounds__(128)
ppe_forward_kernel(const int32_t* __restrict__ rows,   // (r_pad, 3, B)
                   const int32_t* __restrict__ hap,    // (c_pad, B)
                   const int32_t* __restrict__ rlen,   // (B,)
                   const int32_t* __restrict__ clen,   // (B,)
                   const float* __restrict__ init_y,   // (B,)
                   float* __restrict__ mbuf,           // (c_pad, B) scratch
                   float* __restrict__ xbuf,
                   float* __restrict__ ybuf,
                   float* __restrict__ out,            // (B,)
                   int B, int r_pad, int c_pad, Trans t) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t stride = B;
  const int rl = rlen[b];
  const int cl = min(clen[b], c_pad);
  const float iy = init_y[b];

  // a read length outside 1..r_pad captures no row: the TPU kernel's
  // row mask never fires and it returns 0
  if (rl < 1 || rl > r_pad) {
    out[b] = 0.0f;
    return;
  }

  // row 0: M = X = 0, Y = init_y in every column
  for (int c = 0; c < cl; ++c) {
    mbuf[c * stride + b] = 0.0f;
    xbuf[c * stride + b] = 0.0f;
    ybuf[c * stride + b] = iy;
  }

  float a_m = 0.0f, a_x = 0.0f;
  const int n_groups = (rl + NR - 1) / NR;
  for (int g = 0; g < n_groups; ++g) {
    const int r0 = g * NR + 1;  // matrix row of the group's first row
    int rs[NR];
    float omq[NR], q3[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int64_t base = (int64_t)(r0 - 1 + q) * 3 * stride + b;
      rs[q] = rows[base];
      omq[q] = __int_as_float(rows[base + stride]);
      q3[q] = __int_as_float(rows[base + 2 * stride]);
    }
    float md[NR], xd[NR], yd[NR], ml[NR], yl[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      md[q] = xd[q] = yd[q] = ml[q] = yl[q] = 0.0f;
    }
    const int qc = rl - r0;  // row rlen's place in this group, if it is here
    // Y(0, 0) = init_y is row 1's only nonzero diagonal input at column 1
    if (r0 == 1) yd[0] = iy;

    int hw = hap[b];
    float ma = mbuf[b], xa = xbuf[b], ya = ybuf[b];
    // Not unrolled: in a first version without the prefetch, nvcc's
    // default unrolling of this loop made NR=1 2.4x and NR=4 6.7x slower
    // on an H100 (same results; chip_smoke.py).
#pragma unroll 1
    for (int c = 0; c < cl; ++c) {
      const int64_t at = c * stride + b;
      // the next column's inputs, loaded before this column's stores (the
      // last column reloads itself; that value is never used)
      const int64_t nx = (int64_t)min(c + 1, cl - 1) * stride + b;
      const int hw_n = hap[nx];
      const float ma_n = mbuf[nx], xa_n = xbuf[nx], ya_n = ybuf[nx];
      float MA = ma, XA = xa, YA = ya;  // the row above, per column
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        const float dist = (rs[q] & hw) != 0 ? omq[q] : q3[q];
        const float t1 = __fmul_rn(md[q], t.p_mm);
        const float t2 = __fmul_rn(xd[q], t.p_gapm);
        const float t3 = __fmul_rn(yd[q], t.p_gapm);
        const float M = __fmul_rn(__fadd_rn(__fadd_rn(t1, t2), t3), dist);
        const float X =
            __fadd_rn(__fmul_rn(MA, t.p_mx), __fmul_rn(XA, t.p_xx));
        const float Y =
            __fadd_rn(__fmul_rn(ml[q], t.p_my), __fmul_rn(yl[q], t.p_yy));
        if (q == qc) {
          a_m = __fadd_rn(a_m, M);
          a_x = __fadd_rn(a_x, X);
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
      mbuf[at] = MA;
      xbuf[at] = XA;
      ybuf[at] = YA;
      hw = hw_n;
      ma = ma_n;
      xa = xa_n;
      ya = ya_n;
    }
  }
  out[b] = __fadd_rn(a_m, a_x);
}

template <int NR>
cudaError_t launch(const int32_t* rows, const int32_t* hap,
                   const int32_t* rlen, const int32_t* clen,
                   const float* init_y, float* mbuf, float* xbuf,
                   float* ybuf, float* out, int B, int r_pad, int c_pad,
                   Trans t, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  ppe_forward_kernel<NR><<<blocks, threads, 0, stream>>>(
      rows, hap, rlen, clen, init_y, mbuf, xbuf, ybuf, out, B, r_pad, c_pad,
      t);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pairhmm_ppe_forward(const void* rows, const void* hap,
                                   const void* rlen, const void* clen,
                                   const void* init_y, void* mbuf,
                                   void* xbuf, void* ybuf, void* out, int B,
                                   int r_pad, int c_pad, int nr, float p_mm,
                                   float p_gapm, float p_mx, float p_xx,
                                   float p_my, float p_yy, void* stream) {
  if (B <= 0) return 0;
  const Trans t{p_mm, p_gapm, p_mx, p_xx, p_my, p_yy};
  auto* r = static_cast<const int32_t*>(rows);
  auto* h = static_cast<const int32_t*>(hap);
  auto* rl = static_cast<const int32_t*>(rlen);
  auto* cl = static_cast<const int32_t*>(clen);
  auto* iy = static_cast<const float*>(init_y);
  auto* m = static_cast<float*>(mbuf);
  auto* x = static_cast<float*>(xbuf);
  auto* y = static_cast<float*>(ybuf);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 1:
      return launch<1>(r, h, rl, cl, iy, m, x, y, o, B, r_pad, c_pad, t, s);
    case 2:
      return launch<2>(r, h, rl, cl, iy, m, x, y, o, B, r_pad, c_pad, t, s);
    case 4:
      return launch<4>(r, h, rl, cl, iy, m, x, y, o, B, r_pad, c_pad, t, s);
    case 8:
      return launch<8>(r, h, rl, cl, iy, m, x, y, o, B, r_pad, c_pad, t, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
