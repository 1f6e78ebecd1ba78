// K4's pack: the edge filter's threshold and bit packing, hand-written for
// Hopper (sm_90a).  With K4's sweep (dp_wave_kernel<true, false>,
// gotoh_dp.cu) it replaces the edge filter that lara_tpu/ops/gotoh.py:336-383
// (edge_filter_skewed_words) runs as two XLA scans and a pack, and the
// host's unskew of those words (unskew_active_words, :386).  The plain
// version is lara_tpu_torch/ops/gotoh.py::edge_pack.
//
// An edge (a, b) of pair p survives iff
//   prefix(a, b) + sub(a, b) + suffix(a + 1, b + 1) >= opt - subopt
// (generateEdges, edge_filter.hpp:131-158), where the sweep's lane p holds
// the forward prefixes and its lane P + p the prefixes of the reversed
// sequences: suffix(a + 1, b + 1) is that lane's cell (la-1-a, lb-1-b).
//
// The layout, row-major: bit k of word w of pair p is flat cell
// f = 32w + k = a * lb_max + b; the bit is 0 outside 0 <= a < la,
// 0 <= b < lb and past la_max * lb_max.  The n_words =
// ceil(la_max * lb_max / 32) words come first, then opt (the best of the
// forward lane's terminal M, H, V) as the last column.  The words are word
// for word the active section of the driver's one-device upload
// (device_driver._packed_buffer), and the host reads them with one
// contiguous unpack (gotoh.unpack_active_words).
//
// The design.  The sweep's prefixes are skewed: cell (i, j) of a lane sits
// at (i + j) * W + i, W = la_max + 1, so neighbouring cells of a row lie W
// ints apart and only the cells of one diagonal lie side by side.  A CTA
// takes a band of 32 rows (a0 = 32 * blockIdx.x) over every column: 32 rows
// of lb_max bits fill exactly lb_max words, so a band's words start on a
// word boundary and no word is shared between CTAs.  Its warps split the
// columns in runs of whole 32-column words.  A warp sweeps its run as a
// parallelogram: lane t holds row a0 + t and at step s takes column
// c0 + s - t, so the warp's cells of a step lie on one diagonal
// d = a0 + c0 + s: 32 consecutive ints of the forward prefix and, in the
// reversed lane, 32 consecutive ints in descending order.  A lane gathers
// its row's bits into a 32-column word and stores it to shared memory when
// the word is full.  Then the CTA cuts the band's row-major words out of
// that [32, n_col_words + 1] bit matrix with funnel shifts (a word
// straddles two rows where lb_max % 32 != 0, and more where lb_max < 32)
// and stores them coalesced.
//
// What bounds it: bytes, two int32 prefixes read per edge, each once, and
// the words written once (ceil(la_max * lb_max / 32), half the skewed
// layout's (la_max + lb_max + 1) * W / 32).  A warp issues the loads of
// kAhead steps before it uses any, since a run's steps are a chain that
// the memory's latency would otherwise pace where warps are few.  A run's
// first and last 31 steps leave lanes idle: runs of 384 columns at 16S
// keep 93% of the steps' lanes busy.  The substitution score comes from a
// shuffle of the 5x5 matrix held one entry a lane.  Inside a lane's rectangle every prefix
// and suffix is finite, so no sum wraps; the adds still go through
// uint32_t (wadd).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAlpha = 5;         // the Rna5 alphabet
constexpr int kPackWarps = 4;     // warps per CTA
constexpr int kBand = 32;         // rows per CTA, one a lane
constexpr int kAhead = 8;         // steps whose loads a warp issues at once

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// Grid: (ceil(la_max / kBand), pairs); dynamic shared memory
// kBand * (n_col_words + 1) words.  prefix is the sweep's [2 * pairs, D, W],
// finals its [3, 2 * pairs]; out is [pairs, n_words + 1].
__global__ void __launch_bounds__(kPackWarps * 32)
    edge_pack_kernel(const int* __restrict__ prefix,
                     const int* __restrict__ finals,
                     const int* __restrict__ seq_a,
                     const int* __restrict__ seq_b,
                     const int* __restrict__ submat,
                     const int* __restrict__ la_arr,
                     const int* __restrict__ lb_arr, int pairs, int la_max,
                     int lb_max, int subopt, int n_words,
                     int* __restrict__ out) {
  extern __shared__ unsigned band[];  // [kBand][stride] column words
  const int p = blockIdx.y;
  const int a0 = kBand * blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int W = la_max + 1;
  const int n_col_words = (lb_max + 31) >> 5;
  const int stride = n_col_words + 1;  // a zero word ends every row
  const int la = la_arr[p];
  const int lb = lb_arr[p];
  const int opt = max(max(finals[p], finals[2 * pairs + p]),
                      finals[4 * pairs + p]);
  for (int i = threadIdx.x; i < kBand * stride; i += blockDim.x) band[i] = 0;
  __syncthreads();

  // this warp's run of columns [c0, c1): whole words, cut at the pair's lb
  const int per_warp = (n_col_words + kPackWarps - 1) / kPackWarps;
  const int c0 = 32 * per_warp * (threadIdx.x >> 5);
  const int c1 = min(c0 + 32 * per_warp, lb);
  if (a0 < la && c0 < c1) {
    const int a = a0 + lane;
    const bool row = a < la;
    const int cut = wadd(opt, -subopt);
    const size_t lane_cells = static_cast<size_t>(la_max + lb_max + 1) * W;
    const int* fwd = prefix + static_cast<size_t>(p) * lane_cells;
    const int* bwd = prefix + static_cast<size_t>(pairs + p) * lane_cells;
    const int* sb = seq_b + static_cast<size_t>(p) * lb_max;
    const int ca = row ? seq_a[static_cast<size_t>(p) * la_max + a] : 0;
    const int sub_entry = lane < kAlpha * kAlpha ? submat[lane] : 0;
    unsigned bits = 0;
    // the loads of kAhead steps first, then their bits
    for (int s0 = 0; s0 < c1 - c0 + 31; s0 += kAhead) {
      int fv[kAhead], bv[kAhead], cbv[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int b = c0 + s0 + u - lane;
        const int d = a0 + c0 + s0 + u;  // a + b, one diagonal a step
        const bool edge = row && b >= c0 && b < c1;
        fv[u] = edge ? fwd[static_cast<size_t>(d) * W + a] : 0;
        bv[u] = edge ? bwd[static_cast<size_t>(la + lb - 2 - d) * W + la -
                           1 - a]
                     : 0;
        cbv[u] = edge ? sb[b] : 0;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int b = c0 + s0 + u - lane;
        const bool edge = row && b >= c0 && b < c1;
        const int sc = __shfl_sync(kFull, sub_entry, kAlpha * ca + cbv[u]);
        if (edge) {
          bits |= static_cast<unsigned>(wadd(wadd(fv[u], bv[u]), sc) >= cut)
                  << (b & 31);
          if ((b & 31) == 31 || b == c1 - 1) {
            band[lane * stride + (b >> 5)] = bits;
            bits = 0;
          }
        }
      }
    }
  }
  __syncthreads();

  // the band's row-major words: word i holds band cells 32i .. 32i + 31,
  // row r = f / lb_max, column f % lb_max
  int* row_out = out + static_cast<size_t>(p) * (n_words + 1);
  const int word0 = blockIdx.x * lb_max;
  const int band_words = min(lb_max, n_words - word0);
  for (int i = threadIdx.x; i < band_words; i += blockDim.x) {
    const int f = 32 * i;
    int r = f / lb_max;
    int b = f - r * lb_max;
    unsigned word = 0;
    for (int filled = 0; filled < 32 && r < kBand; ++r, b = 0) {
      const int n = min(32 - filled, lb_max - b);
      const unsigned* rp = band + r * stride + (b >> 5);
      const int shift = b & 31;
      unsigned v = rp[0] >> shift;
      if (shift) v |= rp[1] << (32 - shift);
      if (n < 32) v &= (1u << n) - 1u;
      word |= v << filled;
      filled += n;
    }
    row_out[word0 + i] = static_cast<int>(word);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) row_out[n_words] = opt;
}

}  // namespace

extern "C" {

int lara_edge_pack(const int* prefix, const int* finals, const int* seq_a,
                   const int* seq_b, const int* submat, const int* la,
                   const int* lb, int pairs, int la_max, int lb_max,
                   int subopt, int* out, void* stream) {
  const long long cells =
      static_cast<long long>(la_max + lb_max + 1) * (la_max + 1);
  // the sweep's flat indices and a band's bit offsets stay inside int
  if (pairs < 1 || la_max < 1 || lb_max < 1 || cells > INT32_MAX ||
      32LL * lb_max > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_words = static_cast<int>(
      (static_cast<long long>(la_max) * lb_max + 31) / 32);
  const size_t smem = sizeof(unsigned) * kBand * ((lb_max + 31) / 32 + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((la_max + kBand - 1) / kBand, pairs);
  edge_pack_kernel<<<grid, 32 * kPackWarps, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      prefix, finals, seq_a, seq_b, submat, la, lb, pairs, la_max, lb_max,
      subopt, n_words, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
