// KB of the port: the wavefront-layout microbenchmark's chain of dependent
// steps, hand-written for Hopper (sm_90a).  It replaces the Pallas kernel of
// benchmark/profile_wavefront_layout.py:47 (make_chain, pallas_call :76); the
// plain version is
// lara_tpu_torch/benchmark/profile_wavefront_layout.py::chain_plain, and the
// entry point that times it is that module's main.
//
// What it computes: from m = x and h = x + 1 over int32 x[rows, cols], reps
// blocks of 64 steps; step t of a block is
//   ms   = roll(m, 1, axis=1), with column 0 set to -5, or with carry to the
//          last column of row r-1 (row 0: of row rows-1)
//   best = max(ms, h);  m_new = best + (t & 3);  h = max(h + 1, m - 2)
//   m    = (col == t % cols) ? -7 : m_new        (h from the OLD m)
// and the output is m + h.  Every add wraps as XLA's int32 adds do, through
// uint32_t (signed overflow is undefined in C++).
//
// What bounds it: the chain.  Every step of a column depends on the step
// before it and on its left neighbour's, and reps * 64 steps run one after
// another; a step is about nine integer operations per element (eleven with
// the carry), so the rate of integer issue bounds a wide row and the
// latency of one step a narrow one.  The design:
//   * one CTA, one warp per row: lane l holds the contiguous run of
//     kRun = cols / 32 columns [l * kRun, l * kRun + kRun) of m and h in
//     registers (kRun a template parameter, so that the arrays stay in
//     registers: 52 at 1664 columns, 8 at 256);
//   * roll is a register shift within the run, updated from the last element
//     down so that the old value of the left neighbour is still there, plus
//     one __shfl_up_sync for the run's first element; lane 0's is column 0,
//     which roll wraps from the last column and the step overwrites (-5, or
//     the carry);
//   * the carry: lane 31 of each warp puts its row's old last element into
//     shared memory (two buffers by step parity), one block barrier per step,
//     then lane 0 reads row r-1's.  That barrier is the cross-row cost that
//     the packed layout pays, and that KB was written to measure.
// The launcher refuses what it cannot run (cols not a multiple of 32, a run
// length it was not built for, more rows than its thread limit allows); it
// has no fallback.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 64;  // steps per block, as the TPU kernel's BLOCK

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// Threads per CTA at most for a run of kRun: the registers of 2 * kRun
// values per thread must fit the SM's 65,536 at that many threads.
template <int kRun>
constexpr int max_threads() {
  return kRun <= 8 ? 1024 : 256;
}

// One CTA of rows warps, warp r on row r.
template <int kRun>
__global__ void __launch_bounds__(max_threads<kRun>())
    wavefront_chain_kernel(const int* __restrict__ x, int* __restrict__ out,
                           int rows, int cols, int carry, int reps) {
  __shared__ int carry_buf[2][32];
  const int r = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = lane * kRun;  // this lane's first column
  const int* xr = x + static_cast<size_t>(r) * cols + c0;
  int m[kRun], h[kRun];
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    m[e] = xr[e];
    h[e] = wadd(m[e], 1);
  }
  const int up = r == 0 ? rows - 1 : r - 1;  // the row whose last column
                                             // column 0 takes (carry)
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 4
    for (int t = 0; t < kBlock; ++t) {
      // roll: the left neighbour of this lane's first column is lane-1's
      // last; column 0 (lane 0) takes -5 or the carried last column
      int first = __shfl_up_sync(kFull, m[kRun - 1], 1);
      if (carry) {
        const int par = t & 1;
        if (lane == 31) carry_buf[par][r] = m[kRun - 1];
        __syncthreads();
        const int last = carry_buf[par][up];
        if (lane == 0) first = last;
      } else if (lane == 0) {
        first = -5;
      }
      const int add = t & 3;
      const int ct = t >= cols ? t - cols : t;  // t % cols: t < 64 <= 2 * cols
#pragma unroll
      for (int e = kRun - 1; e >= 0; --e) {
        const int ms = e > 0 ? m[e - 1] : first;
        const int best = max(ms, h[e]);
        const int hn = max(wadd(h[e], 1), wadd(m[e], -2));  // the old m
        m[e] = c0 + e == ct ? -7 : wadd(best, add);
        h[e] = hn;
      }
    }
  }
  int* outr = out + static_cast<size_t>(r) * cols + c0;
#pragma unroll
  for (int e = 0; e < kRun; ++e) outr[e] = wadd(m[e], h[e]);
}

template <int kRun>
int launch(const int* x, int* out, int rows, int cols, int carry, int reps,
           cudaStream_t stream) {
  if (rows * 32 > max_threads<kRun>())
    return static_cast<int>(cudaErrorInvalidValue);
  wavefront_chain_kernel<kRun><<<1, rows * 32, 0, stream>>>(x, out, rows, cols,
                                                            carry, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: int32 [rows, cols] on the card.  Refused (cudaErrorInvalidValue,
// nothing launched): rows outside 1..32, cols not a multiple of 32 or a run
// of cols / 32 this library was not built for (it is built for the source's
// two widths, runs of 8 and 52), reps < 0, or more rows than the run's
// thread limit (8 rows for a run of 52).
int lara_wavefront_chain(const int* x, int* out, int rows, int cols,
                         int carry, int reps, void* stream) {
  if (rows < 1 || rows > 32 || cols < 32 || cols % 32 != 0 || reps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols / 32) {
    case 8: return launch<8>(x, out, rows, cols, carry, reps, s);    // 256
    case 52: return launch<52>(x, out, rows, cols, carry, reps, s);  // 1664
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
