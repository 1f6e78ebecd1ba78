// K4's pack: the edge filter's threshold and bit packing, hand-written for
// Hopper (sm_90a).  With K4's sweep (dp_wave_kernel<true, false>,
// gotoh_dp.cu) it replaces the edge filter that lara_tpu/ops/gotoh.py:336-383
// (edge_filter_skewed_words) runs as two XLA scans and a pack.  The plain
// version is lara_tpu_torch/ops/gotoh.py::edge_pack.
//
// An edge (a, b) of pair p survives iff
//   prefix(a, b) + sub(a, b) + suffix(a + 1, b + 1) >= opt - subopt
// (generateEdges, edge_filter.hpp:131-158), where the sweep's lane p holds
// the forward prefixes and its lane P + p the prefixes of the reversed
// sequences: suffix(a + 1, b + 1) is that lane's cell (la-1-a, lb-1-b).
// Bit k of word w of pair p is skewed flat index f = 32w + k = d * W + a
// (b = d - a), as the host's unskew_active_words reads it; the bit is 0
// outside 0 <= a < la, 0 <= b < lb and in the padding past D * W.  Word K
// (the last column) is opt, the best of the forward lane's terminal M, H, V.
//
// What bounds it: bytes, two int32 prefixes read per edge (the forward one
// in skewed order, the reversed one in reverse skewed order), each read
// once.  The design: one warp per 32 words, lane t computes bit t of each
// word in turn and __ballot_sync packs it, so every read is 32 neighbouring
// ints of one diagonal; the warp then stores its 32 words at once.  The
// substitution score comes from a shuffle of the 5x5 matrix held one entry
// a lane.  Inside a lane's rectangle every prefix and suffix is finite, so
// no sum wraps; the adds still go through uint32_t (wadd).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kAlpha = 5;         // the Rna5 alphabet
constexpr int kPackWarps = 8;     // warps per CTA

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// Grid: (ceil((K + 1) / (32 * kPackWarps)), pairs).  prefix is the sweep's
// [2 * pairs, D, W], finals its [3, 2 * pairs]; out is [pairs, K + 1].
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
  const int p = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int word0 = 32 * (blockIdx.x * kPackWarps + (threadIdx.x >> 5));
  if (word0 > n_words) return;
  const int W = la_max + 1;
  const int D = la_max + lb_max + 1;
  const int la = la_arr[p];
  const int lb = lb_arr[p];
  const int opt = max(max(finals[p], finals[2 * pairs + p]),
                      finals[4 * pairs + p]);
  const int cut = wadd(opt, -subopt);
  const size_t lane_cells = static_cast<size_t>(D) * W;
  const int* fwd = prefix + static_cast<size_t>(p) * lane_cells;
  const int* bwd = prefix + static_cast<size_t>(pairs + p) * lane_cells;
  const int* sa = seq_a + static_cast<size_t>(p) * la_max;
  const int* sb = seq_b + static_cast<size_t>(p) * lb_max;
  const int sub_entry = lane < kAlpha * kAlpha ? submat[lane] : 0;

  // this lane's flat index in the first word, as (d, a)
  const int f0 = 32 * word0 + lane;
  int d = f0 / W;
  int a = f0 - d * W;
  int mine = 0;
  for (int w = 0; w < 32; ++w) {
    const int b = d - a;
    const bool edge = a < la && b >= 0 && b < lb;  // false past D * W
    int ca = 0, cb = 0, total = 0;
    if (edge) {
      ca = sa[a];
      cb = sb[b];
      total = wadd(
          fwd[static_cast<size_t>(d) * W + a],
          bwd[static_cast<size_t>(la + lb - 2 - d) * W + la - 1 - a]);
    }
    const int sc = __shfl_sync(kFull, sub_entry, kAlpha * ca + cb);
    const unsigned bits =
        __ballot_sync(kFull, edge && wadd(total, sc) >= cut);
    if (lane == w) mine = static_cast<int>(bits);
    // the next word: 32 flat indices on
    a += 32;
    while (a >= W) {
      a -= W;
      ++d;
    }
  }
  int* row = out + static_cast<size_t>(p) * (n_words + 1);
  const int k = word0 + lane;
  if (k < n_words) {
    row[k] = mine;
  } else if (k == n_words) {
    row[k] = opt;
  }
}

}  // namespace

extern "C" {

int lara_edge_pack(const int* prefix, const int* finals, const int* seq_a,
                   const int* seq_b, const int* submat, const int* la,
                   const int* lb, int pairs, int la_max, int lb_max,
                   int subopt, int* out, void* stream) {
  const long long cells =
      static_cast<long long>(la_max + lb_max + 1) * (la_max + 1);
  // flat indices, and the words' bits past them, stay inside int
  if (pairs < 1 || cells + 32 * 32 * kPackWarps > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_words = static_cast<int>((cells + 31) / 32);
  const int per_cta = 32 * kPackWarps;
  const dim3 grid((n_words + 1 + per_cta - 1) / per_cta, pairs);
  edge_pack_kernel<<<grid, 32 * kPackWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      prefix, finals, seq_a, seq_b, submat, la, lb, pairs, la_max, lb_max,
      subopt, n_words, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
