// K-res of the port: the forward affine-Gotoh wavefront and its traceback in
// one CTA per pair, with the pair's direction codes resident in shared
// memory, hand-written for Hopper (sm_90a).  LARA_DP_RESIDENT=1 selects it
// when the pair fits (lara_tpu_torch/ops/gotoh_plan.py).
//
// It replaces both lara_tpu/ops/gotoh_pallas.py::_make_resident_kernel (K1-res)
// and ::_make_tb_resident_kernel (K2-res).  The plain versions are
// lara_tpu_torch/ops/gotoh.py::dp_forward followed by ::dp_traceback.
//
// The TPU kernels keep the whole diagonal extent of a batch block in VMEM so
// that no DMA streams the scores and codes.  Here one CTA per pair sweeps
// the diagonals as K1 does and writes each cell's direction code into
// dynamic shared memory (D * W int8, D = la_max + lb_max + 1, W = la_max + 1,
// beside K1's nine wavefront rings of W ints), then clears the pair's partner
// row and lets one thread walk the codes back as K2 does.  The codes never
// touch device memory: only partner [B, la_max] and scalars [4, B] (upper,
// gap, n_lines, seq) leave the kernel.
//
// What bounds it on this card: the same dependent chains as K1 and K2, and
// shared memory: 217 KB at 320 x 320 leaves room for one CTA per SM.  The
// plan takes this kernel only where its need fits the card's opt-in limit
// (232,448 bytes on an H100); the launcher refuses anything larger.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gotoh_common.cuh"

namespace {

using namespace lara;

// Shared memory of one CTA: the M, H, V rings, the three terminal values and
// the direction codes.  Keep in step with gotoh_plan.resident_bytes.
size_t resident_bytes(int la_max, int lb_max) {
  const size_t width = static_cast<size_t>(la_max) + 1;
  const size_t num_diag = static_cast<size_t>(la_max) + lb_max + 1;
  return (9 * width + 3) * sizeof(int) + num_diag * width;
}

__global__ void dp_resident_kernel(const int* __restrict__ pssm,
                                   const int* __restrict__ la_arr,
                                   const int* __restrict__ lb_arr,
                                   const int* __restrict__ seq, int batch,
                                   int la_max, int lb_max, int go, int ge,
                                   int* __restrict__ partner,
                                   int* __restrict__ scalars) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int W = la_max + 1;
  const int la = la_arr[b];
  const int lb = lb_arr[b];
  int* M = smem;
  int* H = smem + 3 * W;
  int* V = smem + 6 * W;
  int* fin = smem + 9 * W;
  int8_t* codes = reinterpret_cast<int8_t*>(smem + 9 * W + 3);
  for (int k = threadIdx.x; k < 9 * W; k += blockDim.x) smem[k] = kNegInf;
  __syncthreads();

  const int* P = pssm + static_cast<size_t>(b) * la_max * lb_max;
  for (int d = 0; d <= la + lb; ++d) {
    forward_diagonal(
        M, H, V, W, d, la, lb, go, ge,
        [&](int i) {
          const int j = d - i;
          return (i >= 1 && j >= 1 && j <= lb_max)
                     ? P[(i - 1) * lb_max + (j - 1)]
                     : kNegInf;
        },
        [&](int i, int8_t code) { codes[d * W + i] = code; }, fin, 1);
    __syncthreads();
  }

  int* row = partner + static_cast<size_t>(b) * la_max;
  for (int a = threadIdx.x; a < la_max; a += blockDim.x) row[a] = -1;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int* seq_of = seq + static_cast<size_t>(b) * la_max * lb_max;
  Walker w{la, lb, start_state(fin[0], fin[1], fin[2]), 0, 0, 0};
  while (w.i > 0 || w.j > 0) {
    walk_step(
        w, [&](int d, int i) { return static_cast<int>(codes[d * W + i]); },
        [&](int a, int bb) { return seq_of[a * lb_max + bb]; }, row, go, ge);
  }
  scalars[b] = max(max(fin[0], fin[1]), fin[2]);
  scalars[batch + b] = w.gap;
  scalars[2 * batch + b] = w.cnt;
  scalars[3 * batch + b] = w.seq;
}

}  // namespace

extern "C" {

// The card's opt-in shared memory per block, in bytes.
int lara_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

int lara_gotoh_resident(const int* pssm, const int* la, const int* lb,
                        const int* seq, int batch, int la_max, int lb_max,
                        int go, int ge, int* partner, int* scalars,
                        void* stream) {
  const size_t smem = resident_bytes(la_max, lb_max);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dp_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((la_max + 1 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dp_resident_kernel<<<batch, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      pssm, la, lb, seq, batch, la_max, lb_max, go, ge, partner, scalars);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
