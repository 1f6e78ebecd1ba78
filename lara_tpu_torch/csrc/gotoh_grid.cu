// K1-grid and K2-grid of the port: the forward affine-Gotoh wavefront and its
// traceback with the diagonal block as the unit of launch, hand-written for
// Hopper (sm_90a).  LARA_DP_GRID=1 selects them.
//
// K1-grid replaces lara_tpu/ops/gotoh_pallas.py::_make_kernel (reached from
// gotoh_scan_pallas and from align_pssm_batch_pallas under LARA_DP_GRID=1);
// K2-grid replaces gotoh_pallas.py::_make_traceback_kernel.  Their plain
// versions are lara_tpu_torch/ops/gotoh.py::gotoh_scan and ::dp_traceback.
//
// The TPU kernels make a block of dchunk diagonals the sequential grid step
// and keep the wavefronts in VMEM scratch between steps.  A GPU grid runs its
// blocks in no order, so here each block of diagonals is one launch, in
// order on one stream, and what the TPU kept in scratch lives in global
// memory between launches:
//
// * K1-grid reads the pre-skewed diagonal-major scores [D, B, W] int32 (the
//   input of gotoh_scan_pallas) and writes dirs [Dp, B, W] int8 (Dp = D
//   rounded up to dchunk) and finals [3, B].  One CTA per lane loads the M, H
//   and V rings of diagonals d-1 and d-2 (K1's shared-memory layout, ring
//   d % 3 holds diagonal d) from `state` [B, 9 W] into shared memory, sweeps
//   its dchunk diagonals as K1 does, and stores the rings back.  The terminal
//   cell (la, lb) goes straight to finals on its diagonal: the one-hot
//   capture of the TPU kernel is a store here.
// * K2-grid walks the blocks in reverse.  One thread per lane carries the
//   walker (cur_d, i, state, gap, cnt, seq) in `walker` [6, B] from launch to
//   launch and steps while the walk stays on the launch's block; the partner
//   row persists in the output.
//
// What bounds them on this card: as K1 and K2, the chain of dependent
// diagonals and steps, plus a launch per block: 2 * ceil(D / dchunk) launches
// per alignment (50 at the 96 x 96 bucket, dchunk 8).  The design takes that
// cost as the variant's definition and keeps each launch as small as K1's
// work for the same diagonals.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gotoh_common.cuh"

namespace {

using namespace lara;

__global__ void dp_grid_forward_kernel(const int* __restrict__ skewed,
                                       const int* __restrict__ la_arr,
                                       const int* __restrict__ lb_arr,
                                       int batch, int width, int d0,
                                       int dchunk, int go, int ge,
                                       int* __restrict__ state,
                                       int8_t* __restrict__ dirs,
                                       int* __restrict__ finals) {
  extern __shared__ int rings[];
  const int b = blockIdx.x;
  const int la = la_arr[b];
  const int lb = lb_arr[b];
  const int d_end = la + lb;
  if (d0 > d_end) return;  // this lane's sweep ended in an earlier block
  const int W = width;
  int* M = rings;
  int* H = rings + 3 * W;
  int* V = rings + 6 * W;
  int* saved = state + static_cast<size_t>(b) * 9 * W;
  for (int k = threadIdx.x; k < 9 * W; k += blockDim.x) {
    rings[k] = d0 == 0 ? kNegInf : saved[k];
  }
  __syncthreads();

  const int d_stop = min(d0 + dchunk - 1, d_end);
  for (int d = d0; d <= d_stop; ++d) {
    const int* t_row = skewed + (static_cast<size_t>(d) * batch + b) * W;
    int8_t* out = dirs + (static_cast<size_t>(d) * batch + b) * W;
    forward_diagonal(
        M, H, V, W, d, la, lb, go, ge, [&](int i) { return t_row[i]; },
        [&](int i, int8_t code) { out[i] = code; }, finals + b, batch);
    __syncthreads();
  }
  if (d_stop < d_end) {
    for (int k = threadIdx.x; k < 9 * W; k += blockDim.x) saved[k] = rings[k];
  }
}

__global__ void dp_grid_traceback_kernel(
    const int8_t* __restrict__ dirs, const int* __restrict__ finals,
    const int* __restrict__ la_arr, const int* __restrict__ lb_arr,
    const int* __restrict__ seq, int batch, int la_max, int lb_max, int d_lo,
    int first, int go, int ge, int* __restrict__ walker,
    int* __restrict__ partner, int* __restrict__ scalars) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const int W = la_max + 1;
  const int fm = finals[b], fh = finals[batch + b], fv = finals[2 * batch + b];
  int* row = partner + static_cast<size_t>(b) * la_max;
  Walker w;
  if (first) {
    for (int a = 0; a < la_max; ++a) row[a] = -1;
    w.i = la_arr[b];
    w.j = lb_arr[b];
    w.state = start_state(fm, fh, fv);
    w.gap = w.cnt = w.seq = 0;
  } else {
    w.i = walker[batch + b];
    w.j = walker[b] - w.i;
    w.state = walker[2 * batch + b];
    w.gap = walker[3 * batch + b];
    w.cnt = walker[4 * batch + b];
    w.seq = walker[5 * batch + b];
  }
  const int* seq_of = seq + static_cast<size_t>(b) * la_max * lb_max;
  while ((w.i > 0 || w.j > 0) && w.i + w.j >= d_lo) {
    walk_step(
        w,
        [&](int d, int i) {
          return static_cast<int>(
              dirs[(static_cast<size_t>(d) * batch + b) * W + i]);
        },
        [&](int a, int bb) { return seq_of[a * lb_max + bb]; }, row, go, ge);
  }
  if (d_lo == 0) {
    scalars[b] = max(max(fm, fh), fv);
    scalars[batch + b] = w.gap;
    scalars[2 * batch + b] = w.cnt;
    scalars[3 * batch + b] = w.seq;
  } else {
    walker[b] = w.i + w.j;
    walker[batch + b] = w.i;
    walker[2 * batch + b] = w.state;
    walker[3 * batch + b] = w.gap;
    walker[4 * batch + b] = w.cnt;
    walker[5 * batch + b] = w.seq;
  }
}

}  // namespace

extern "C" {

// One launch of K1-grid: diagonals [d0, d0 + dchunk) of every lane.
int lara_gotoh_grid_dp(const int* skewed, const int* la, const int* lb,
                       int batch, int width, int d0, int dchunk, int go,
                       int ge, int* state, int8_t* dirs, int* finals,
                       void* stream) {
  const size_t smem = 9 * static_cast<size_t>(width) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dp_grid_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((width + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dp_grid_forward_kernel<<<batch, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      skewed, la, lb, batch, width, d0, dchunk, go, ge, state, dirs, finals);
  return static_cast<int>(cudaGetLastError());
}

// One launch of K2-grid: the walk over diagonals >= d_lo of the block that
// starts at d_lo; `first` marks the launch of the last block (the walk's
// start), and the launch with d_lo == 0 writes the scalars.
int lara_gotoh_grid_tb(const int8_t* dirs, const int* finals, const int* la,
                       const int* lb, const int* seq, int batch, int la_max,
                       int lb_max, int d_lo, int first, int go, int ge,
                       int* walker, int* partner, int* scalars,
                       void* stream) {
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  dp_grid_traceback_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      dirs, finals, la, lb, seq, batch, la_max, lb_max, d_lo, first, go, ge,
      walker, partner, scalars);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
