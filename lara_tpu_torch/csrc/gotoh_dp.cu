// K1 and K2 of the port: the forward affine-Gotoh wavefront and its
// traceback, hand-written for Hopper (sm_90a).
//
// K1 replaces lara_tpu/ops/gotoh_pallas.py::_make_stream_kernel; K2 replaces
// gotoh_pallas.py::_make_tb_stream_kernel.  (The TPU's grid-stepped and
// resident layouts of the same functions have their own kernels in
// gotoh_grid.cu and gotoh_resident.cu.)  The plain versions are
// lara_tpu_torch/ops/gotoh.py::dp_forward and ::dp_traceback.
//
// What bounds them on this card.  K1 is a chain of la+lb+1 dependent
// anti-diagonal steps per pair, each O(la) integer max/compare work, reading
// 4 bytes of score and writing 1 direction byte per cell (a few MB per call
// at the bench shapes): it is bound by the latency of the dependent steps,
// not by bytes or operations.  So each pair gets one CTA whose threads stride
// over the diagonal offsets i; the M/H/V rows of diagonals d-1 and d-2 stay
// in shared memory as three rotating rows per state, which needs only one
// __syncthreads() per diagonal.  The TPU's pre-skewed score streams are an
// index map here: cell (i, d-i) reads pssm[b, i-1, d-i-1].  A lane's sweep
// stops at diagonal la+lb and offset la: no valid cell depends on anything
// beyond them.
//
// K2 walks one pointer chain per pair, la+lb dependent one-byte loads: pure
// latency.  One warp per pair clears the partner row, then one thread walks
// it as lara_tpu/ops/gotoh.py::traceback does; the TPU kernel's reverse
// sweep over every diagonal is not needed on a machine with scalar loads.
//
// int32 sums wrap exactly as XLA's do: cells outside a lane's rectangle add
// the NEG_INF sentinel to itself.  Signed overflow is undefined in C++, so
// every add goes through uint32_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -1431655764;  // PSSM_INIT == NEG_INF
constexpr int kMat = 0, kHor = 1, kVer = 2;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// One CTA per lane.  Shared memory: M, H, V rows, each three rings of W ints
// (ring d % 3 holds diagonal d).
__global__ void dp_forward_kernel(const int* __restrict__ pssm,
                                  const int* __restrict__ la_arr,
                                  const int* __restrict__ lb_arr, int batch,
                                  int la_max, int lb_max, int go, int ge,
                                  int8_t* __restrict__ dirs,
                                  int* __restrict__ finals) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int W = la_max + 1;
  const int D = la_max + lb_max + 1;
  const int la = la_arr[b];
  const int lb = lb_arr[b];
  const int d_end = la + lb;
  int* M = smem;
  int* H = smem + 3 * W;
  int* V = smem + 6 * W;
  for (int k = threadIdx.x; k < 3 * W; k += blockDim.x) {
    M[k] = kNegInf;
    H[k] = kNegInf;
    V[k] = kNegInf;
  }
  __syncthreads();

  const int* P = pssm + static_cast<size_t>(b) * la_max * lb_max;
  int8_t* out = dirs + static_cast<size_t>(b) * D * W;
  for (int d = 0; d <= d_end; ++d) {
    const int r0 = (d % 3) * W;        // diagonal d
    const int r1 = ((d + 2) % 3) * W;  // diagonal d-1
    const int r2 = ((d + 1) % 3) * W;  // diagonal d-2
    const int bg = d == 0 ? 0 : wadd(go, wmul(ge, d - 1));
    const int edge_gap = d == 0 ? kNegInf : bg;
    for (int i = threadIdx.x; i <= la; i += blockDim.x) {
      const int j = d - i;
      int m2s = kNegInf, h2s = kNegInf, v2s = kNegInf;
      int m1s = kNegInf, h1s = kNegInf, v1s = kNegInf;
      if (i > 0) {
        m2s = M[r2 + i - 1];
        h2s = H[r2 + i - 1];
        v2s = V[r2 + i - 1];
        m1s = M[r1 + i - 1];
        h1s = H[r1 + i - 1];
        v1s = V[r1 + i - 1];
      }
      const int t = (i >= 1 && j >= 1 && j <= lb_max)
                        ? P[(i - 1) * lb_max + (j - 1)]
                        : kNegInf;

      // M from (i-1, j-1) on d-2; ties M > H > V
      const int best = max(max(m2s, h2s), v2s);
      int m_new = wadd(best, t);
      const int mdir = m2s == best ? kMat : (h2s == best ? kHor : kVer);

      // H from (i, j-1) on d-1; ties ext > M > V
      const int m1 = M[r1 + i], h1 = H[r1 + i], v1 = V[r1 + i];
      const int hh = wadd(h1, ge), hm = wadd(m1, go), hv = wadd(v1, go);
      int h_new = max(max(hh, hm), hv);
      const int hdir = hh == h_new ? kHor : (hm == h_new ? kMat : kVer);

      // V from (i-1, j) on d-1; ties ext > M > H
      const int vv = wadd(v1s, ge), vm = wadd(m1s, go), vh = wadd(h1s, go);
      int v_new = max(max(vv, vm), vh);
      const int vdir = vv == v_new ? kVer : (vm == v_new ? kMat : kHor);

      // borders: cell (0, d) and cell (d, 0)
      const bool top = i == 0, left = i == d;
      if (top || left) m_new = bg;
      if (top) {
        h_new = edge_gap;
        v_new = kNegInf;
      } else if (left) {
        h_new = kNegInf;
      }
      if (left) v_new = edge_gap;

      M[r0 + i] = m_new;
      H[r0 + i] = h_new;
      V[r0 + i] = v_new;
      out[static_cast<size_t>(d) * W + i] =
          static_cast<int8_t>(mdir | (hdir << 2) | (vdir << 4));
      if (d == d_end && i == la) {
        finals[b] = m_new;
        finals[batch + b] = h_new;
        finals[2 * batch + b] = v_new;
      }
    }
    __syncthreads();
  }
}

// One warp per lane: the warp clears the lane's partner row, then its first
// thread walks the direction codes from (la, lb) back to (0, 0).
__global__ void dp_traceback_kernel(const int8_t* __restrict__ dirs,
                                    const int* __restrict__ finals,
                                    const int* __restrict__ la_arr,
                                    const int* __restrict__ lb_arr,
                                    const int* __restrict__ seq, int batch,
                                    int la_max, int lb_max, int go, int ge,
                                    int* __restrict__ partner,
                                    int* __restrict__ scalars) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (b >= batch) return;
  int* row = partner + static_cast<size_t>(b) * la_max;
  for (int a = lane; a < la_max; a += 32) row[a] = -1;
  __syncwarp();
  if (lane != 0) return;

  const int W = la_max + 1;
  const int D = la_max + lb_max + 1;
  const int8_t* code_of = dirs + static_cast<size_t>(b) * D * W;
  const int* seq_of = seq + static_cast<size_t>(b) * la_max * lb_max;
  const int fm = finals[b], fh = finals[batch + b], fv = finals[2 * batch + b];
  const int upper = max(max(fm, fh), fv);
  int state = fm == upper ? kMat : (fh == upper ? kHor : kVer);
  int i = la_arr[b];
  int j = lb_arr[b];
  int gap = 0, cnt = 0, seq_sum = 0;
  while (i > 0 || j > 0) {
    if (i == 0) {
      state = kHor;
    } else if (j == 0) {
      state = kVer;
    }
    const int code = code_of[static_cast<size_t>(i + j) * W + i];
    const int pred = state == kMat   ? (code & 3)
                     : state == kHor ? ((code >> 2) & 3)
                                     : ((code >> 4) & 3);
    if (state == kMat) {
      row[i - 1] = j - 1;
      ++cnt;
      seq_sum = wadd(seq_sum, seq_of[(i - 1) * lb_max + (j - 1)]);
    } else if (state == kHor) {
      gap = wadd(gap, pred == kHor ? ge : go);
    } else {
      gap = wadd(gap, pred == kVer ? ge : go);
    }
    if (state != kHor) --i;
    if (state != kVer) --j;
    state = pred;
  }
  scalars[b] = upper;
  scalars[batch + b] = gap;
  scalars[2 * batch + b] = cnt;
  scalars[3 * batch + b] = seq_sum;
}

}  // namespace

extern "C" {

const char* lara_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int lara_gotoh_dp(const int* pssm, const int* la, const int* lb, int batch,
                  int la_max, int lb_max, int go, int ge, int8_t* dirs,
                  int* finals, void* stream) {
  const int width = la_max + 1;
  const size_t smem = 9 * static_cast<size_t>(width) * sizeof(int);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = ((width + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dp_forward_kernel<<<batch, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      pssm, la, lb, batch, la_max, lb_max, go, ge, dirs, finals);
  return static_cast<int>(cudaGetLastError());
}

int lara_gotoh_tb(const int8_t* dirs, const int* finals, const int* la,
                  const int* lb, const int* seq, int batch, int la_max,
                  int lb_max, int go, int ge, int* partner, int* scalars,
                  void* stream) {
  const int threads = 128;  // four lanes per CTA
  const int blocks = (batch * 32 + threads - 1) / threads;
  dp_traceback_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      dirs, finals, la, lb, seq, batch, la_max, lb_max, go, ge, partner,
      scalars);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
