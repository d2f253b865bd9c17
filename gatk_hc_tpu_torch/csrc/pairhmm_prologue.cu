// Prologue of the ppe kernel on the packed and nib shipping paths, for
// Hopper (sm_90a).
//
// Replaces the XLA glue in front of gatk_hc_tpu/ops/pairhmm_pallas.py::
// _pallas_call_ppe on those paths (it is not a Pallas kernel):
//   prologue_packed: _unpack_u8_ppe (:1034) + the gathers of
//     dispatch_pairs_ppe (:1082), as pairhmm_pallas_packed (:1118),
//     pairhmm_pallas_packed_fused (:1154) and the runner's packed-split
//     branch run them;
//   prologue_nib: _unpack_nib_ppe (:1254) + _expand_pairs_from_spans
//     (:1226) + the same gathers, as pairhmm_pallas_packed_nib (:1289) and
//     pairhmm_pallas_packed_nib_fused (:1193) run them.
// Both write exactly the ppe kernel's pair-minor inputs (csrc/
// pairhmm_ppe.cu): rows (r_pad, 3, stride) i32 [base mask | 1-q bits | q/3
// bits], hap (c_pad, stride) i32 base masks, rlen / clen (stride) i32 and
// init_y (stride) f32, for pairs off .. off + n - 1 of a buffer of
// ``stride`` pairs.  A fused launch gives each group its own offset into
// one buffer, and one ppe launch then covers the sum of their pairs.
//
// Inputs are a group's unique rows as shipped by the runner
// (ops/runner.py): packed: u8 [reads (nr_pad, r_pad) | quals (nr_pad,
// r_pad) | haps (nh_pad, c_pad)] plus the pair indices; nib: u8 [nib reads
// (nr_pad, r_pad), each byte (seq_idx << 5) | qual_idx | haps (nh_pad,
// c_pad)] plus a 72-entry mini-table [seq masks (8) | 1-q bits (32) | q/3
// bits (32)] and a span table of (read_base, hap_base, nr, nh) rows.  i32
// is [read lens (nr_pad) | hap lens (nh_pad) | init_y bits (nh_pad)].  The
// 768-entry table is ops/pairhmm_torch.py::ppe_element_table.
//
// Design.  One thread per (pair, row block): blockIdx.x picks 128
// consecutive pairs, so every store of a warp writes 128 consecutive bytes
// of one pair-minor row (coalesced along B); blockIdx.y picks 32 read rows
// (the three planes of each) or 64 hap columns, and y = 0 also writes the
// pair's lengths and init_y.  The unique rows are read 4 bytes at a time
// (r_pad and c_pad multiples of 4); a group's unique bytes are a few MB at
// most, so the L2 holds them while every block reads its pairs' rows.  The
// lookup tables sit in shared memory.  The nib entry expands the span table
// itself: each block loads it into shared memory, takes the exclusive
// prefix sum of nr * nh (a warp-shuffle scan), and each pair i finds its
// span by binary search for the last start <= i (searchsorted side
// "right", minus one), so zero-count padding rows are skipped; nh is
// clamped to at least 1, and positions at or past the total take pair
// (0, 0).  No pair array exists on the host or the card.
//
// What bounds it.  Bytes: per pair it writes 12 r_pad + 4 c_pad + 12 bytes
// and reads about 2 r_pad + c_pad (L2-resident) bytes; no arithmetic on
// floats happens, it moves bit patterns only.  At B 65,536, r_pad 160,
// c_pad 448 the writes are 244 MB, 0.073 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;    // pairs per block
constexpr int ROW_BLOCK = 32;   // read rows per thread (blockIdx.y < row blocks)
constexpr int COL_BLOCK = 64;   // hap columns per thread (the other y)
constexpr int TABLE = 768;      // ppe_element_table
constexpr int MINI = 72;        // the nib mini-table
constexpr int DEFAULT_SMEM = 48 * 1024;

struct Shape {
  int nr_pad, nh_pad, r_pad, c_pad;
};

struct Out {
  int32_t* rows;
  int32_t* hap;
  int32_t* rlen;
  int32_t* clen;
  int32_t* init_y;  // f32 bits
  int stride;
  int off;
};

__host__ __device__ inline int row_blocks(int r_pad) {
  return (r_pad + ROW_BLOCK - 1) / ROW_BLOCK;
}

// Pair i (unique read pr, unique hap ph): this thread's share of its
// outputs.  NIB selects the read encoding: rowtab is the 768 table (packed)
// or the 72-entry mini-table (nib); mask is the byte -> base mask table.
template <bool NIB>
__device__ void write_pair(const uint8_t* __restrict__ u8,
                           const int32_t* __restrict__ i32,
                           const int32_t* rowtab, const int32_t* mask,
                           const Shape& s, const Out& o, int i, int pr,
                           int ph) {
  const size_t col = static_cast<size_t>(o.off) + i;
  const size_t stride = static_cast<size_t>(o.stride);
  const size_t nrr = static_cast<size_t>(s.nr_pad) * s.r_pad;
  const int rb = row_blocks(s.r_pad);
  const int y = blockIdx.y;
  if (y == 0) {
    o.rlen[col] = i32[pr];
    o.clen[col] = i32[s.nr_pad + ph];
    o.init_y[col] = i32[s.nr_pad + s.nh_pad + ph];
  }
  if (y < rb) {
    const int r0 = y * ROW_BLOCK;
    const int r1 = min(s.r_pad, r0 + ROW_BLOCK);
    const size_t row = static_cast<size_t>(pr) * s.r_pad;
    const uint32_t* bases = reinterpret_cast<const uint32_t*>(u8 + row);
    const uint32_t* quals = reinterpret_cast<const uint32_t*>(u8 + nrr + row);
    for (int r = r0; r < r1; r += 4) {
      const uint32_t bw = __ldg(bases + r / 4);
      const uint32_t qw = NIB ? 0u : __ldg(quals + r / 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = (bw >> (8 * j)) & 0xff;
        int32_t m, omq, q3;
        if (NIB) {
          m = rowtab[b >> 5];
          omq = rowtab[8 + (b & 31)];
          q3 = rowtab[40 + (b & 31)];
        } else {
          const int q = (qw >> (8 * j)) & 0xff;
          m = rowtab[b];
          omq = rowtab[256 + q];
          q3 = rowtab[512 + q];
        }
        int32_t* dst = o.rows + static_cast<size_t>(r + j) * 3 * stride + col;
        dst[0] = m;
        dst[stride] = omq;
        dst[2 * stride] = q3;
      }
    }
  } else {
    const int c0 = (y - rb) * COL_BLOCK;
    const int c1 = min(s.c_pad, c0 + COL_BLOCK);
    const uint8_t* haps = u8 + (NIB ? 1 : 2) * nrr;
    const uint32_t* hw = reinterpret_cast<const uint32_t*>(
        haps + static_cast<size_t>(ph) * s.c_pad);
    for (int c = c0; c < c1; c += 4) {
      const uint32_t w = __ldg(hw + c / 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o.hap[static_cast<size_t>(c + j) * stride + col] =
            mask[(w >> (8 * j)) & 0xff];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    prologue_packed_kernel(const uint8_t* __restrict__ u8,
                           const int32_t* __restrict__ i32,
                           const int32_t* __restrict__ pair_read,
                           const int32_t* __restrict__ pair_hap,
                           const int32_t* __restrict__ table, int n, Shape s,
                           Out o) {
  __shared__ int32_t tab[TABLE];
  for (int k = threadIdx.x; k < TABLE; k += THREADS) tab[k] = table[k];
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  write_pair<false>(u8, i32, tab, tab, s, o, i, pair_read[i], pair_hap[i]);
}

__global__ void __launch_bounds__(THREADS)
    prologue_nib_kernel(const uint8_t* __restrict__ u8,
                        const int32_t* __restrict__ i32,
                        const int32_t* __restrict__ minitab,
                        const int32_t* __restrict__ table,
                        const int32_t* __restrict__ spans, int n_spans, int n,
                        Shape s, Out o) {
  extern __shared__ int32_t smem[];
  int32_t* mini = smem;               // MINI
  int32_t* mask = mini + MINI;        // 256: the table's mask segment
  int32_t* sp = mask + 256;           // n_spans x 4
  int32_t* starts = sp + 4 * n_spans; // n_spans
  __shared__ int32_t warp_base[THREADS / 32];
  __shared__ int32_t total;
  const int t = threadIdx.x;
  for (int k = t; k < MINI; k += THREADS) mini[k] = minitab[k];
  for (int k = t; k < 256; k += THREADS) mask[k] = table[k];
  for (int k = t; k < 4 * n_spans; k += THREADS) sp[k] = spans[k];
  __syncthreads();

  // exclusive prefix sum of nr * nh: each thread scans a run of rows, a
  // warp-shuffle scan joins the runs of a warp, thread 0 the warps
  const int lane = t & 31, warp = t >> 5;
  const int per = (n_spans + THREADS - 1) / THREADS;
  const int lo = min(n_spans, t * per), hi = min(n_spans, lo + per);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += sp[4 * j + 2] * sp[4 * j + 3];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_base[warp] = incl;
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      const int v = warp_base[w];
      warp_base[w] = run;
      run += v;
    }
    total = run;
  }
  __syncthreads();
  int run = warp_base[warp] + incl - sum;
  for (int j = lo; j < hi; ++j) {
    starts[j] = run;
    run += sp[4 * j + 2] * sp[4 * j + 3];
  }
  __syncthreads();

  const int i = blockIdx.x * THREADS + t;
  if (i >= n) return;
  // searchsorted(starts, i, side="right") - 1, clipped to the table
  int a = 0, b = n_spans;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (starts[mid] <= i)
      a = mid + 1;
    else
      b = mid;
  }
  const int j = max(0, min(n_spans - 1, a - 1));
  int pr = 0, ph = 0;
  if (i < total) {
    const int nh = max(sp[4 * j + 3], 1);
    const int local = i - starts[j];
    pr = sp[4 * j] + local / nh;
    ph = sp[4 * j + 1] + local % nh;
  }
  write_pair<true>(u8, i32, mini, mask, s, o, i, pr, ph);
}

// Common argument checks; cudaSuccess when the launch may proceed.
cudaError_t check(int n, const Shape& s, const Out& o) {
  if (s.nr_pad <= 0 || s.nh_pad <= 0 || s.r_pad <= 0 || s.c_pad <= 0 ||
      s.r_pad % 4 || s.c_pad % 4 || o.off < 0 || o.stride < o.off + n)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

dim3 grid_for(int n, const Shape& s) {
  return dim3((n + THREADS - 1) / THREADS,
              row_blocks(s.r_pad) + (s.c_pad + COL_BLOCK - 1) / COL_BLOCK);
}

Out make_out(void* rows, void* hap, void* rlen, void* clen, void* init_y,
             int stride, int off) {
  return Out{static_cast<int32_t*>(rows), static_cast<int32_t*>(hap),
             static_cast<int32_t*>(rlen), static_cast<int32_t*>(clen),
             static_cast<int32_t*>(init_y), stride, off};
}

}  // namespace

// Packed prologue of n pairs into pairs off .. off + n - 1 of the
// pair-minor outputs (stride pairs wide).  Returns a CUDA error code
// (cudaErrorInvalidValue for a bad shape), 0 on success.
extern "C" int pairhmm_prologue_packed(
    const void* u8, const void* i32, const void* pair_read,
    const void* pair_hap, const void* table, int n, int nr_pad, int nh_pad,
    int r_pad, int c_pad, void* rows, void* hap, void* rlen, void* clen,
    void* init_y, int stride, int off, void* stream) {
  const Shape s{nr_pad, nh_pad, r_pad, c_pad};
  const Out o = make_out(rows, hap, rlen, clen, init_y, stride, off);
  if (n <= 0) return 0;
  cudaError_t err = check(n, s, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  prologue_packed_kernel<<<grid_for(n, s), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(u8), static_cast<const int32_t*>(i32),
      static_cast<const int32_t*>(pair_read),
      static_cast<const int32_t*>(pair_hap),
      static_cast<const int32_t*>(table), n, s, o);
  return static_cast<int>(cudaGetLastError());
}

// Nib prologue of n pairs, expanded from n_spans span rows, into pairs
// off .. off + n - 1 of the outputs.  Returns a CUDA error code, 0 on
// success (cudaErrorInvalidConfiguration when the span table does not fit
// in shared memory).
extern "C" int pairhmm_prologue_nib(
    const void* u8, const void* i32, const void* minitab, const void* table,
    const void* spans, int n_spans, int n, int nr_pad, int nh_pad, int r_pad,
    int c_pad, void* rows, void* hap, void* rlen, void* clen, void* init_y,
    int stride, int off, void* stream) {
  const Shape s{nr_pad, nh_pad, r_pad, c_pad};
  const Out o = make_out(rows, hap, rlen, clen, init_y, stride, off);
  if (n <= 0) return 0;
  cudaError_t err = check(n, s, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_spans <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int32_t) * (MINI + 256 + 5 * (size_t)n_spans);
  if (smem > DEFAULT_SMEM) {
    int dev = 0, max_smem = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the kernel's static shared memory (warp bases, total) comes on top
    if (smem + 64 > static_cast<size_t>(max_smem))
      return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaFuncSetAttribute(prologue_nib_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  prologue_nib_kernel<<<grid_for(n, s), THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(u8), static_cast<const int32_t*>(i32),
      static_cast<const int32_t*>(minitab),
      static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(spans), n_spans, n, s, o);
  return static_cast<int>(cudaGetLastError());
}
