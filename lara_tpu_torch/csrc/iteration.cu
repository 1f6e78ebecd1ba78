// The fused solver's iteration body on the card, hand-written for Hopper
// (sm_90a): three kernels around the DP (K1 + K2, or the plan's variant)
// and K3, the counterpart of the XLA fusions of the JAX while_loop's body
// (lara_tpu/solver/device_solver.py:447-628).  The plain versions are
// head_plain, lines_plain and tail_plain in
// lara_tpu_torch/solver/device_solver.py; the wrappers are
// lara_tpu_torch/solver/iteration_cuda.py.  One iteration runs
//
//   KI-head -> K1 -> K2 -> KI-lines -> K3 -> KI-tail
//
// * KI-head (JAX :452-506): dual_at_queue, the profits, the per-edge queue
//   top of every entry (run_p, run_idx: _run_top's segmented doubling scan
//   with its tie rule, max profit, then the smallest index), is_top, and
//   the PSSM's run-start cells: where(active, seq_score + max(run_p, 0),
//   PSSM_INIT) at the cell of each run's first entry, into the grid that
//   holds where(active, seq_score, PSSM_INIT) everywhere else
//   (device_solver._prepare builds it once per model).
// * KI-lines (JAX :514-582): slot_edge, line membership, pick and its
//   reverse, the subgradient sg, count, the consistent branch's sum and
//   slot marks, and K3's candidate mask cand_q.
// * KI-tail (JAX :583-628): the lower bound, best-primal tracking, the
//   bound bookkeeping with step halving, the float32 dual update,
//   remaining, lane_active and iterations.
//
// Each kernel runs one CTA per lane: every lane-wide value (the scan's
// passes, count, any_sg) needs only block barriers.  What bounds them: the
// bytes of the [B, D] dual columns, read once or twice (KI-head's scan
// reads D dual_l values a pass, from L1) -- microseconds at the bench's
// shapes, where the plain versions were ~280 kernels an iteration.
//
// Arithmetic of the reference:
// * int32 adds wrap (best_upper - best_lower starts at INFINITY -
//   -INFINITY, seq_score + run_p may wrap): they go through uint32_t.
// * The dual update keeps the reference's float32 order, a multiply, a
//   divide, a multiply and a subtract, each rounded to nearest
//   (__fmul_rn, __fdiv_rn, __fsub_rn: never contracted into an FMA), and
//   truncates toward zero with __float2int_rz, the instruction torch's own
//   CUDA cast emits (saturating; NaN gives 0).
// * Ties: is_top (profit == run_p) and is_top_exact (index == run_idx) are
//   two masks, kept apart.
//
// KI-head writes dual_at_queue and KI-tail every other field of the next
// carry; an output may be the input it replaces (the dispatch graph's
// static carry is updated in place): each element is read by the thread
// that writes it, before it writes it, and a lane's scalars by thread 0
// alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNegInf = -1431655764;    // -INFINITY (types.py)
constexpr int kPssmInit = -1431655764;  // PSSM_INIT (types.py)
constexpr int kMaxThreads = 1024;
constexpr int kLinesThreads = 512;
constexpr int kTailThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// The queue-top monoid as one 64-bit key: the profit, biased to unsigned
// order, in the high word and the complement of the entry index in the low
// word.  _run_top's combine takes (p1, i1) over (p2, i2) iff p1 > p2 or
// (p1 == p2 and i1 <= i2): the larger key.
__device__ __forceinline__ uint64_t top_key(int p, int idx) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(p) ^ 0x80000000u)
          << 32) |
         static_cast<uint32_t>(~idx);
}

__device__ __forceinline__ int key_profit(uint64_t key) {
  return static_cast<int>(static_cast<uint32_t>(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int key_index(uint64_t key) {
  return static_cast<int>(~static_cast<uint32_t>(key));
}

__device__ __forceinline__ uint64_t key_max(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

// KI-head.  Grid: one CTA per lane; shared memory: two buffers of d keys.
// The scan runs its passes forward (the window [i - 2^k + 1, i]), parks
// the forward tops in run_p / run_idx, then runs them backward from the
// masked profits again and combines: _run_top's result for any dual_l
// (a neighbour 2^k away joins where its dual_l is equal, as
// _same_segment_masks has it), also where 2^steps does not cover a run.
__global__ void __launch_bounds__(kMaxThreads)
    iteration_head_kernel(const int* __restrict__ sscore, const int* dual,
                          const int* dual_at_queue,
                          const bool* __restrict__ dvalid,
                          const int* __restrict__ dual_l,
                          const bool* __restrict__ lane_active,
                          const int* __restrict__ seq_score,
                          const bool* __restrict__ active, int d, int ne,
                          int steps, int* daq_out, int* __restrict__ run_p,
                          int* __restrict__ run_idx,
                          bool* __restrict__ is_top,
                          int* __restrict__ pssm) {
  extern __shared__ uint64_t keys[];
  const int lane = blockIdx.x;
  const size_t row = static_cast<size_t>(lane) * d;
  sscore += row;
  dual += row;
  dual_at_queue += row;
  dvalid += row;
  dual_l += row;
  daq_out += row;
  run_p += row;
  run_idx += row;
  is_top += row;
  const bool act = lane_active[lane];
  const uint64_t fill = top_key(kNegInf, d);

  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const int du = dual[i];
    const int q = dual_at_queue[i];
    daq_out[i] = act ? du : q;
    keys[i] = top_key(dvalid[i] ? wadd(sscore[i], du) : kNegInf, i);
  }
  __syncthreads();

  uint64_t* cur = keys;
  uint64_t* nxt = keys + d;
  for (int dir = 0; dir < 2; ++dir) {
    for (int pass = 0, s = 1; pass < steps; ++pass, s <<= 1) {
      for (int i = threadIdx.x; i < d; i += blockDim.x) {
        const int j = dir == 0 ? i - s : i + s;
        const bool same = j >= 0 && j < d && dual_l[j] == dual_l[i];
        nxt[i] = key_max(cur[i], same ? cur[j] : fill);
      }
      __syncthreads();
      uint64_t* t = cur;
      cur = nxt;
      nxt = t;
    }
    if (dir == 0) {
      // park the forward tops (each thread reads back only its own
      // entries), and start the backward scan from the masked profits
      for (int i = threadIdx.x; i < d; i += blockDim.x) {
        run_p[i] = key_profit(cur[i]);
        run_idx[i] = key_index(cur[i]);
        cur[i] = top_key(dvalid[i] ? wadd(sscore[i], dual[i]) : kNegInf, i);
      }
      __syncthreads();
    }
  }

  seq_score += static_cast<size_t>(lane) * ne;
  active += static_cast<size_t>(lane) * ne;
  pssm += static_cast<size_t>(lane) * ne;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const uint64_t top = key_max(top_key(run_p[i], run_idx[i]), cur[i]);
    const int p = key_profit(top);
    run_p[i] = p;
    run_idx[i] = key_index(top);
    const bool valid = dvalid[i];
    is_top[i] = valid && wadd(sscore[i], dual[i]) == p;
    // a run's first entry carries its aggregate into the PSSM
    const int cell = dual_l[i];
    const int prev = i == 0 ? -1 : dual_l[i - 1];
    if (valid && cell != prev && cell >= 0 && cell < ne) {
      pssm[cell] =
          active[cell] ? wadd(seq_score[cell], p > 0 ? p : 0) : kPssmInit;
    }
  }
}

// Whether flat edge id e (a * lb_max + b) is a line: part[a] == b.
__device__ __forceinline__ bool in_lines(const int* part, int e, int lb_max,
                                         int slots) {
  if (e < 0) return false;
  const int a = e / lb_max;
  return a < slots && part[a] == e - a * lb_max;
}

// The sums of v and w over the block, in thread 0 (blockDim.x a multiple
// of 32).
__device__ __forceinline__ void block_sums(uint32_t& v, uint32_t& w,
                                           uint32_t* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_down_sync(kFull, v, o);
    w += __shfl_down_sync(kFull, w, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    scratch[2 * warp] = v;
    scratch[2 * warp + 1] = w;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    v = threadIdx.x < warps ? scratch[2 * threadIdx.x] : 0u;
    w = threadIdx.x < warps ? scratch[2 * threadIdx.x + 1] : 0u;
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_down_sync(kFull, v, o);
      w += __shfl_down_sync(kFull, w, o);
    }
  }
}

// KI-lines.  Grid: one CTA per lane; shared memory: the lane's partner row
// (slots ints), pick (d bytes) and the consistent branch's slot marks
// (slots bytes).
__global__ void __launch_bounds__(kLinesThreads)
    iteration_lines_kernel(
        const int* __restrict__ partner, const int* __restrict__ dual_l,
        const int* __restrict__ dual_m, const int* __restrict__ rev,
        const bool* __restrict__ dvalid, const int* __restrict__ sscore,
        const int* __restrict__ dual, const int* __restrict__ run_p,
        const int* __restrict__ run_idx, const bool* __restrict__ is_top,
        const int* __restrict__ lq, const int* __restrict__ mq,
        const int* __restrict__ nc_base,
        const bool* __restrict__ lane_active, int d, int slots, int cw,
        int lb_max, int ne, int* __restrict__ slot_edge,
        int* __restrict__ sg, int* __restrict__ count,
        int* __restrict__ consistent_sum,
        bool* __restrict__ matched_cons_slot, bool* __restrict__ cand_q) {
  extern __shared__ int smem[];
  __shared__ uint32_t scratch[2 * kLinesThreads / 32];
  __shared__ bool any_sg;
  int* part = smem;
  uint8_t* pick = reinterpret_cast<uint8_t*>(part + slots);
  uint8_t* marks = pick + d;
  const int lane = blockIdx.x;
  const size_t row = static_cast<size_t>(lane) * d;
  const size_t srow = static_cast<size_t>(lane) * slots;
  const size_t qrow = static_cast<size_t>(lane) * cw;

  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int p = partner[srow + s];
    part[s] = p;
    marks[s] = 0;
    slot_edge[srow + s] = p >= 0 ? s * lb_max + p : ne;
  }
  __syncthreads();

  // pick, and the consistent branch at each run's unique top entry
  uint32_t csum = 0;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const int l = dual_l[row + i];
    const int m = dual_m[row + i];
    const bool l_in = in_lines(part, l, lb_max, slots);
    pick[i] = l_in && run_p[row + i] >= 0 && is_top[row + i];
    const int profit = wadd(sscore[row + i], dual[row + i]);
    const bool tis = profit < 0 || (profit == 0 && l < m);
    if (dvalid[row + i] && i == run_idx[row + i] && l_in && !tis) {
      csum += static_cast<uint32_t>(sscore[row + i]);
      marks[l / lb_max] = 1;
      if (in_lines(part, m, lb_max, slots)) marks[m / lb_max] = 1;
    }
  }
  __syncthreads();

  // the subgradient: cycle(i) = pick(rev(i))
  uint32_t pos = 0;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const int r = rev[row + i];
    const bool p = pick[i];
    const bool p_rev = r >= 0 && r < d && pick[r];
    const bool sg_pos = p && !p_rev;
    sg[row + i] = static_cast<int>(sg_pos) - static_cast<int>(p_rev && !p);
    pos += sg_pos;
  }
  block_sums(pos, csum, scratch);
  if (threadIdx.x == 0) {
    const int cnt = static_cast<int>(2u * pos);
    count[lane] = cnt;
    consistent_sum[lane] = static_cast<int>(csum);
    any_sg = cnt > 0;
  }
  __syncthreads();

  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    matched_cons_slot[srow + s] = part[s] >= 0 && marks[s];
  }
  const bool live = any_sg && lane_active[lane];
  const int nc = nc_base[lane];
  for (int j = threadIdx.x; j < cw; j += blockDim.x) {
    cand_q[qrow + j] = live && j < nc &&
                       in_lines(part, lq[qrow + j], lb_max, slots) &&
                       in_lines(part, mq[qrow + j], lb_max, slots);
  }
}

// KI-tail's tensors, in the order of lara_iteration_tail's pointer array
// (iteration_cuda.TAIL_ARGS): the carry before the iteration, this
// iteration's alignment, K3's result and KI-lines', and the next carry
// (which may be the carry before).
struct TailArgs {
  const int* dual;
  const float* step_factor;
  const int* nondecr;
  const int* remaining;
  const bool* lane_active;
  const int* best_lower;
  const int* best_upper;
  const int* best_score;
  const int* best_partner;
  const int* best_nlines;
  const bool* best_matched;
  const int* iterations;
  const int* upper;
  const int* gap_score;
  const int* n_lines;
  const int* seq_part;
  const int* partner;
  const int* match_score;
  const bool* used_slot;
  const int* sg;
  const int* count;
  const int* consistent_sum;
  const bool* matched_cons_slot;
  int* dual_out;
  float* step_factor_out;
  int* nondecr_out;
  int* remaining_out;
  bool* lane_active_out;
  int* best_lower_out;
  int* best_upper_out;
  int* best_score_out;
  int* best_partner_out;
  int* best_nlines_out;
  bool* best_matched_out;
  int* iterations_out;
};
constexpr int kTailPointers = sizeof(TailArgs) / sizeof(void*);

// KI-tail.  Grid: one CTA per lane.  Thread 0 reads the lane's scalars and
// writes their successors; every thread then updates its duals and slots
// from the lane's step and flags in shared memory.
__global__ void __launch_bounds__(kTailThreads)
    iteration_tail_kernel(TailArgs a, int d, int slots, int max_nondecr) {
  __shared__ float step_s;
  __shared__ bool act_s, better_s, any_sg_s;
  const int k = blockIdx.x;
  if (threadIdx.x == 0) {
    const bool act = a.lane_active[k];
    const int cnt = a.count[k];
    const bool any_sg = cnt > 0;
    const int struct_part = any_sg ? a.match_score[k] : a.consistent_sum[k];
    const int lower = wadd(wadd(a.seq_part[k], struct_part), a.gap_score[k]);
    // best primal tracking (lagrange.hpp:416-421)
    const int best_score = a.best_score[k];
    const bool better = act && lower > best_score;
    const int best_nlines = a.best_nlines[k];
    // bound bookkeeping (subgradient_solver.hpp:247-263)
    const int upper = a.upper[k];
    const int bu_old = a.best_upper[k];
    const int bl_old = a.best_lower[k];
    const bool improved_u = act && upper < bu_old;
    const bool improved_l = act && lower > bl_old;
    const int bu = improved_u ? upper : bu_old;
    const int bl = improved_l ? lower : bl_old;
    const int nd_old = a.nondecr[k];
    const int nd = (improved_u || improved_l) ? 0 : nd_old;
    const bool halve = act && nd >= max_nondecr;
    const float sf_old = a.step_factor[k];
    const float sf = halve ? __fdiv_rn(sf_old, 2.0f) : sf_old;
    // dual update (subgradient_solver.hpp:265-271): the step in the
    // reference's order, step_factor * (ub - lb) / max(count, 1)
    const int gap = static_cast<int>(static_cast<uint32_t>(bu) -
                                     static_cast<uint32_t>(bl));
    step_s = __fdiv_rn(__fmul_rn(sf, __int2float_rn(gap)),
                       __int2float_rn(cnt > 1 ? cnt : 1));
    act_s = act;
    better_s = better;
    any_sg_s = any_sg;
    const int rem_old = a.remaining[k];
    const int rem = act ? wadd(rem_old, -1) : rem_old;
    const bool done = act && (bu == bl || rem == 0);
    const int it = a.iterations[k];
    a.best_score_out[k] = better ? lower : best_score;
    a.best_nlines_out[k] = better ? a.n_lines[k] : best_nlines;
    a.best_upper_out[k] = bu;
    a.best_lower_out[k] = bl;
    a.nondecr_out[k] = act ? (halve ? 0 : wadd(nd, 1)) : nd_old;
    a.step_factor_out[k] = sf;
    a.remaining_out[k] = rem;
    a.lane_active_out[k] = act && !done;
    a.iterations_out[k] = wadd(it, act ? 1 : 0);
  }
  __syncthreads();
  const bool act = act_s;
  const float step = step_s;
  const size_t row = static_cast<size_t>(k) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const int du = a.dual[row + i];
    const int g = a.sg[row + i];
    a.dual_out[row + i] =
        act && g != 0
            ? __float2int_rz(__fsub_rn(__int2float_rn(du),
                                       __fmul_rn(step, __int2float_rn(g))))
            : du;
  }
  const bool better = better_s;
  const bool any_sg = any_sg_s;
  const size_t srow = static_cast<size_t>(k) * slots;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int p = a.partner[srow + s];
    const int bp = a.best_partner[srow + s];
    const bool bm = a.best_matched[srow + s];
    const bool matched =
        (any_sg ? a.used_slot[srow + s] : a.matched_cons_slot[srow + s]) &&
        p >= 0;
    a.best_partner_out[srow + s] = better ? p : bp;
    a.best_matched_out[srow + s] = better ? matched : bm;
  }
}

// Opt a kernel in to all the dynamic shared memory the current device
// allows it (the opt-in maximum less the kernel's static shared memory),
// once per device, and return that ceiling in *limit (a ceiling, not a
// reservation; see gotoh_dp.cu).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, std::atomic<int>* limits,
                        int* limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::atomic<int>& known = limits[device % kMaxDevices];
  *limit = known.load();
  if (*limit > 0) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  cudaFuncAttributes attrs;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attrs, kernel);
  if (err != cudaSuccess) return err;
  const int dynamic = optin - static_cast<int>(attrs.sharedSizeBytes);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (err == cudaSuccess) {
    known.store(dynamic);
    *limit = dynamic;
  }
  return err;
}

std::atomic<int> head_limit[kMaxDevices];
std::atomic<int> lines_limit[kMaxDevices];

size_t head_smem(int d) {
  return static_cast<size_t>(2) * d * sizeof(uint64_t);
}

size_t lines_smem(int d, int slots) {
  return static_cast<size_t>(slots) * sizeof(int) + d + slots;
}

}  // namespace

extern "C" {

// KI-head over batch lanes of d dual entries and ne PSSM cells, steps
// doubling passes.  daq_out may be dual_at_queue.
int lara_iteration_head(const int* sscore, const int* dual,
                        const int* dual_at_queue, const bool* dvalid,
                        const int* dual_l, const bool* lane_active,
                        const int* seq_score, const bool* active, int batch,
                        int d, int ne, int steps, int* daq_out, int* run_p,
                        int* run_idx, bool* is_top, int* pssm, void* stream) {
  if (batch < 1 || d < 1 || ne < 1 || steps < 0 || steps > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  cudaError_t err = opt_in_smem(iteration_head_kernel, head_limit, &limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = head_smem(d);
  if (smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = d >= kMaxThreads ? kMaxThreads : (d + 31) / 32 * 32;
  iteration_head_kernel<<<batch, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      sscore, dual, dual_at_queue, dvalid, dual_l, lane_active, seq_score,
      active, d, ne, steps, daq_out, run_p, run_idx, is_top, pssm);
  return static_cast<int>(cudaGetLastError());
}

// KI-lines over batch lanes: d dual entries, slots line slots (la_max), cw
// queue columns, flat edge ids a * lb_max + b under ne.
int lara_iteration_lines(const int* partner, const int* dual_l,
                         const int* dual_m, const int* rev, const bool* dvalid,
                         const int* sscore, const int* dual, const int* run_p,
                         const int* run_idx, const bool* is_top, const int* lq,
                         const int* mq, const int* nc_base,
                         const bool* lane_active, int batch, int d, int slots,
                         int cw, int lb_max, int ne, int* slot_edge, int* sg,
                         int* count, int* consistent_sum,
                         bool* matched_cons_slot, bool* cand_q, void* stream) {
  if (batch < 1 || d < 1 || slots < 1 || cw < 1 || lb_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  cudaError_t err = opt_in_smem(iteration_lines_kernel, lines_limit, &limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = lines_smem(d, slots);
  if (smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  iteration_lines_kernel<<<batch, kLinesThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      partner, dual_l, dual_m, rev, dvalid, sscore, dual, run_p, run_idx,
      is_top, lq, mq, nc_base, lane_active, d, slots, cw, lb_max, ne,
      slot_edge, sg, count, consistent_sum, matched_cons_slot, cand_q);
  return static_cast<int>(cudaGetLastError());
}

// KI-tail over batch lanes of d dual entries and slots line slots; ptrs
// holds n_ptrs device pointers in TailArgs' order.
int lara_iteration_tail(void* const* ptrs, int n_ptrs, int batch, int d,
                        int slots, int max_nondecr, void* stream) {
  if (n_ptrs != kTailPointers || batch < 1 || d < 1 || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs args;
  void** fields = reinterpret_cast<void**>(&args);
  for (int i = 0; i < kTailPointers; ++i) fields[i] = ptrs[i];
  iteration_tail_kernel<<<batch, kTailThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      args, d, slots, max_nondecr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
