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
//   remaining, lane_active and iterations; inside the dispatch graph's
//   WHILE node also the loop's exit for the next trip (the JAX cond,
//   :629-633; csrc/loop_exit.cu), in place of a kernel of its own.
//
// What bounds them: the bytes of the [B, D] dual columns, read once or
// twice -- about a microsecond at the bench's shapes -- but one CTA per
// lane (32 CTAs on 132 SMs at B=32) left them latency-bound at 5-13x that.
// So KI-head and KI-lines spread a lane over several CTAs:
// * KI-head in tiles with a halo of 2^steps - 1 entries on each side, its
//   passes over a loop-invariant packed mask (_Static.seg_mask) in place
//   of two dual_l loads an entry and pass, the forward and backward passes
//   side by side (one barrier a pass);
// * KI-lines as a thread-block cluster per lane (up to 8 CTAs) where the
//   lane is longer than 1024 entries, a thread an entry, each CTA's
//   partial sums and slot marks read across the cluster through
//   distributed shared memory; on shorter lanes one CTA, whose cluster
//   launch and barriers would cost more than they save (and 16-byte loads
//   of four entries a thread, tried, were slower: a thread's entries then
//   wait on each other's gathers).
// KI-tail's work is a lane's 16 scalars and a pass over its rows, whose
// outputs may be their inputs.  Every thread issues all its row loads
// (four entries and four slots, 16 bytes a load) before it waits on the
// lane's step, which one warp computes from the scalars, one a thread: a
// load behind the scalars, or behind a store it may alias, is a round
// trip.  One CTA a lane beat 2-8 CTAs a lane at every bench chunk
// (PERF.md).
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
// that writes it, before it writes it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNegInf = -1431655764;    // -INFINITY (types.py)
constexpr int kPssmInit = -1431655764;  // PSSM_INIT (types.py)
constexpr int kMaxThreads = 1024;
constexpr int kLinesThreads = 1024;
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

// KI-head.  Grid: `tiles` CTAs per lane (lane = blockIdx.x / tiles), CTA t
// owning the entries [t * tile, (t + 1) * tile) of its lane and reading a
// halo of H = 2^steps - 1 entries on each side, clipped to [0, d): the
// extended tile [lo, hi).  After k passes the forward top at i depends
// only on the entries [i - 2^k + 1, i] and the backward top only on
// [i, i + 2^k - 1], so every value an owned entry's output uses lies in the
// extended tile: a neighbour outside it counts as the fill, which is wrong
// only at entries no owned output reads (and right at 0 and d, where the
// reference fills too).  Exact for any tile, any steps and any dual_l.
// The passes join a neighbour 2^k away where seg_mask, the packed
// _same_segment_masks (bit 2k: the left neighbour, bit 2k + 1: the right),
// says so.  Shared memory: the forward and the backward keys of the
// extended tile, two buffers each (`both`: one barrier a pass for the two
// directions), or, where that does not fit, two buffers that run the
// forward passes, park the owned tops in run_p / run_idx and run the
// backward passes after them.  The halo reads sscore, dual, dvalid and
// seg_mask only: never dual_at_queue, which may be daq_out.
__global__ void __launch_bounds__(kMaxThreads)
    iteration_head_kernel(const int* __restrict__ sscore, const int* dual,
                          const int* dual_at_queue,
                          const bool* __restrict__ dvalid,
                          const int* __restrict__ dual_l,
                          const uint64_t* __restrict__ seg_mask,
                          const bool* __restrict__ lane_active,
                          const int* __restrict__ seq_score,
                          const bool* __restrict__ active, int d, int ne,
                          int steps, int tile, int tiles, int both,
                          int* daq_out, int* __restrict__ run_p,
                          int* __restrict__ run_idx,
                          bool* __restrict__ is_top,
                          int* __restrict__ pssm) {
  extern __shared__ uint64_t keys[];
  const int lane = blockIdx.x / tiles;
  const int own_lo = (blockIdx.x % tiles) * tile;
  const int own_hi = d - own_lo > tile ? own_lo + tile : d;
  const int halo = (1 << steps) - 1;
  const int lo = own_lo > halo ? own_lo - halo : 0;
  const int hi = d - own_hi > halo ? own_hi + halo : d;
  const int len = hi - lo;
  const size_t row = static_cast<size_t>(lane) * d;
  sscore += row;
  dual += row;
  dual_at_queue += row;
  dvalid += row;
  dual_l += row;
  seg_mask += row;
  daq_out += row;
  run_p += row;
  run_idx += row;
  is_top += row;
  const uint64_t fill = top_key(kNegInf, d);

  uint64_t* f_cur = keys;
  uint64_t* f_nxt = keys + len;
  uint64_t* b_cur = both ? keys + 2 * len : keys;
  uint64_t* b_nxt = both ? keys + 3 * len : keys + len;
  for (int x = threadIdx.x; x < len; x += blockDim.x) {
    const int i = lo + x;
    const uint64_t key =
        top_key(dvalid[i] ? wadd(sscore[i], dual[i]) : kNegInf, i);
    f_cur[x] = key;
    if (both) b_cur[x] = key;
  }
  __syncthreads();

  for (int round = 0; round < (both ? 1 : 2); ++round) {
    const bool fwd = both || round == 0;
    const bool bwd = both || round == 1;
    for (int pass = 0; pass < steps; ++pass) {
      const int s = 1 << pass;
      for (int x = threadIdx.x; x < len; x += blockDim.x) {
        const uint64_t m = seg_mask[lo + x] >> (2 * pass);
        if (fwd)
          f_nxt[x] = key_max(f_cur[x], (m & 1) && x >= s ? f_cur[x - s] : fill);
        if (bwd)
          b_nxt[x] =
              key_max(b_cur[x], (m & 2) && x < len - s ? b_cur[x + s] : fill);
      }
      __syncthreads();
      if (fwd) {
        uint64_t* t = f_cur;
        f_cur = f_nxt;
        f_nxt = t;
      }
      if (bwd) {
        uint64_t* t = b_cur;
        b_cur = b_nxt;
        b_nxt = t;
      }
    }
    if (!both && round == 0) {
      // park the owned forward tops, and start the backward passes from
      // the masked profits in the same buffers
      for (int i = own_lo + threadIdx.x; i < own_hi; i += blockDim.x) {
        run_p[i] = key_profit(f_cur[i - lo]);
        run_idx[i] = key_index(f_cur[i - lo]);
      }
      __syncthreads();
      for (int x = threadIdx.x; x < len; x += blockDim.x) {
        const int i = lo + x;
        f_cur[x] = top_key(dvalid[i] ? wadd(sscore[i], dual[i]) : kNegInf, i);
      }
      b_cur = f_cur;
      b_nxt = f_nxt;
      __syncthreads();
    }
  }

  const bool act = lane_active[lane];
  seq_score += static_cast<size_t>(lane) * ne;
  active += static_cast<size_t>(lane) * ne;
  pssm += static_cast<size_t>(lane) * ne;
  for (int i = own_lo + threadIdx.x; i < own_hi; i += blockDim.x) {
    const uint64_t fwd_top =
        both ? f_cur[i - lo] : top_key(run_p[i], run_idx[i]);
    const uint64_t top = key_max(fwd_top, b_cur[i - lo]);
    const int p = key_profit(top);
    run_p[i] = p;
    run_idx[i] = key_index(top);
    const int du = dual[i];
    const int q = dual_at_queue[i];
    daq_out[i] = act ? du : q;
    const bool valid = dvalid[i];
    is_top[i] = valid && wadd(sscore[i], du) == p;
    // a run's first entry (its left neighbour, or -1 before entry 0, is
    // another edge: bit 0 clear) carries its aggregate into the PSSM
    const int cell = dual_l[i];
    if (valid && !(seg_mask[i] & 1) && cell >= 0 && cell < ne) {
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

// KI-lines' [B, D] inputs and the sg output.
struct LinesRows {
  const int* dual_l;
  const int* dual_m;
  const int* rev;
  const bool* dvalid;
  const int* sscore;
  const int* dual;
  const int* run_p;
  const int* run_idx;
  const bool* is_top;
  int* sg;
};

// The two halves of a cluster barrier (barrier.cluster): a CTA's threads
// arrive, releasing their shared-memory writes, and later wait, acquiring
// the others'; work between the two overlaps the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// KI-lines.  Grid: a cluster of C CTAs per lane (lane = blockIdx.x / C),
// or one CTA (C = 1, no cluster) where the lane is short.  Rank r owns the
// entries [r * dper, (r + 1) * dper), the line slots [r * sper, ...) and
// the queue columns [r * qper, ...) of its lane; each CTA keeps the lane's
// whole partner row in its own shared memory for in_lines.  pick of the
// reverse entry r is a function of entry r alone, so it is computed from
// r's inputs, gathered with the entry's own loads (reading it from the
// owning CTA's shared memory, after a cluster barrier, was slower on the
// card: PERF.md).  Each CTA marks the consistent branch's slots in its own
// shared memory and keeps its partial sg_pos count and sum there; across
// one cluster barrier (K3's candidate tests run between its arrive and its
// wait) every CTA adds up the C partials (DSMEM reads) into count,
// consistent_sum and any_sg, and the owner of each slot ORs the C marks.
// A second barrier, waited for at the very end, keeps every CTA's shared
// memory alive until the others are done reading it.  Shared memory: the
// partner row (slots ints), the slot marks (slots bytes) and the owned
// columns' candidates (qper bytes).
__global__ void __launch_bounds__(kLinesThreads)
    iteration_lines_kernel(
        const int* __restrict__ partner, LinesRows rows,
        const int* __restrict__ lq, const int* __restrict__ mq,
        const int* __restrict__ nc_base,
        const bool* __restrict__ lane_active, int d, int slots, int cw,
        int lb_max, int ne, int dper, int sper, int qper,
        int* __restrict__ slot_edge, int* __restrict__ count,
        int* __restrict__ consistent_sum,
        bool* __restrict__ matched_cons_slot, bool* __restrict__ cand_q) {
  extern __shared__ __align__(16) int smem[];
  __shared__ uint32_t scratch[2 * kLinesThreads / 32];
  __shared__ uint32_t partial[2];  // this CTA's sg_pos count and sum
  __shared__ bool live_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / C;
  int* part = smem;
  uint8_t* marks = reinterpret_cast<uint8_t*>(part + slots);
  uint8_t* cand = marks + slots;
  const size_t row = static_cast<size_t>(lane) * d;
  const size_t srow = static_cast<size_t>(lane) * slots;
  const size_t qrow = static_cast<size_t>(lane) * cw;
  const int e_lo = min(d, rank * dper), e_hi = min(d, e_lo + dper);
  const int s_lo = min(slots, rank * sper), s_hi = min(slots, s_lo + sper);
  const int q_lo = min(cw, rank * qper), q_hi = min(cw, q_lo + qper);

  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int p = partner[srow + s];
    part[s] = p;
    marks[s] = 0;
    if (s >= s_lo && s < s_hi)
      slot_edge[srow + s] = p >= 0 ? s * lb_max + p : ne;
  }
  __syncthreads();

  // pick and its reverse, the subgradient (cycle(i) = pick(rev(i))), and
  // the consistent branch at each run's unique top entry
  uint32_t pos = 0, csum = 0;
  for (int i = e_lo + threadIdx.x; i < e_hi; i += blockDim.x) {
    const size_t at = row + i;
    const int l = rows.dual_l[at];
    const int m = rows.dual_m[at];
    const int ss = rows.sscore[at];
    const int du = rows.dual[at];
    const int rp = rows.run_p[at];
    const int ri = rows.run_idx[at];
    const bool valid = rows.dvalid[at];
    const bool top = rows.is_top[at];
    const int r = rows.rev[at];
    // the reverse entry's inputs, loaded unconditionally (entry 0 of the
    // row where r is out of range) so that they issue before any store
    const bool r_ok = r >= 0 && r < d;
    const size_t r_at = row + (r_ok ? r : 0);
    const int r_l = rows.dual_l[r_at];
    const int r_rp = rows.run_p[r_at];
    const bool r_top = rows.is_top[r_at];
    const bool l_in = in_lines(part, l, lb_max, slots);
    const bool p = l_in && rp >= 0 && top;
    const bool p_rev =
        r_ok && in_lines(part, r_l, lb_max, slots) && r_rp >= 0 && r_top;
    const bool sg_pos = p && !p_rev;
    pos += sg_pos;
    rows.sg[at] = static_cast<int>(sg_pos) - static_cast<int>(p_rev && !p);
    const int profit = wadd(ss, du);
    const bool tis = profit < 0 || (profit == 0 && l < m);
    if (valid && i == ri && l_in && !tis) {
      csum += static_cast<uint32_t>(ss);
      marks[l / lb_max] = 1;
      if (in_lines(part, m, lb_max, slots)) marks[m / lb_max] = 1;
    }
  }
  block_sums(pos, csum, scratch);
  if (threadIdx.x == 0) {
    partial[0] = pos;
    partial[1] = csum;
  }
  if (C > 1) cluster_arrive();
  // K3's candidates of the owned columns, all but `live`
  const int nc = nc_base[lane];
  for (int j = q_lo + threadIdx.x; j < q_hi; j += blockDim.x) {
    cand[j - q_lo] = j < nc && in_lines(part, lq[qrow + j], lb_max, slots) &&
                     in_lines(part, mq[qrow + j], lb_max, slots);
  }
  if (C > 1) {
    cluster_wait();
  } else {
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    uint32_t lane_pos = 0, lane_sum = 0;
    for (int k = 0; k < C; ++k) {
      const uint32_t* other =
          k == rank ? partial : cluster.map_shared_rank(partial, k);
      lane_pos += other[0];
      lane_sum += other[1];
    }
    const int cnt = static_cast<int>(2u * lane_pos);
    if (rank == 0) {
      count[lane] = cnt;
      consistent_sum[lane] = static_cast<int>(lane_sum);
    }
    live_s = cnt > 0 && lane_active[lane];
  }
  // a slot is marked where any CTA of the cluster marked it
  for (int s = s_lo + threadIdx.x; s < s_hi; s += blockDim.x) {
    uint8_t marked = 0;
    for (int k = 0; k < C; ++k)
      marked |= (k == rank ? marks : cluster.map_shared_rank(marks, k))[s];
    matched_cons_slot[srow + s] = part[s] >= 0 && marked;
  }
  // done reading the other CTAs' shared memory
  if (C > 1) cluster_arrive();
  __syncthreads();
  const bool live = live_s;
  for (int j = q_lo + threadIdx.x; j < q_hi; j += blockDim.x) {
    cand_q[qrow + j] = live && cand[j - q_lo];
  }
  // no CTA may leave while another still reads its shared memory
  if (C > 1) cluster_wait();
}

// KI-tail's tensors, in the order of lara_iteration_tail's pointer array
// (iteration_cuda.tail): the carry before the iteration, this iteration's
// alignment, K3's result and KI-lines', and the next carry (which may be
// the carry before).
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

// The lane's scalar inputs, one a thread of warp 0: their TailArgs fields
// (lane_active a byte, the others 32 bits).
enum TailScalar {
  kAct, kCount, kMatchScore, kConsistentSum, kSeqPart, kGapScore,
  kBestScore, kBestNlines, kNLines, kUpper, kBestUpper, kBestLower,
  kNondecr, kStepFactor, kRemaining, kIterations, kTailScalars
};
#define LARA_TAIL_FIELD(f) \
  static_cast<int>(offsetof(TailArgs, f) / sizeof(void*))
__constant__ int kTailScalarField[kTailScalars] = {
    LARA_TAIL_FIELD(lane_active),  LARA_TAIL_FIELD(count),
    LARA_TAIL_FIELD(match_score),  LARA_TAIL_FIELD(consistent_sum),
    LARA_TAIL_FIELD(seq_part),     LARA_TAIL_FIELD(gap_score),
    LARA_TAIL_FIELD(best_score),   LARA_TAIL_FIELD(best_nlines),
    LARA_TAIL_FIELD(n_lines),      LARA_TAIL_FIELD(upper),
    LARA_TAIL_FIELD(best_upper),   LARA_TAIL_FIELD(best_lower),
    LARA_TAIL_FIELD(nondecr),      LARA_TAIL_FIELD(step_factor),
    LARA_TAIL_FIELD(remaining),    LARA_TAIL_FIELD(iterations)};
#undef LARA_TAIL_FIELD

// Four consecutive entries of a row from i (below hi): one 16-byte load
// (kVec: hi and i multiples of 4, the row 16-byte aligned), else four
// scalar loads, each within the row.
template <bool kVec>
__device__ __forceinline__ int4 load4(const int* p, int i, int hi) {
  if (kVec) return *reinterpret_cast<const int4*>(p + i);
  return make_int4(p[i], i + 1 < hi ? p[i + 1] : 0, i + 2 < hi ? p[i + 2] : 0,
                   i + 3 < hi ? p[i + 3] : 0);
}

template <bool kVec>
__device__ __forceinline__ void store4(int* p, int i, int hi, int4 v) {
  if (kVec) {
    *reinterpret_cast<int4*>(p + i) = v;
    return;
  }
  p[i] = v.x;
  if (i + 1 < hi) p[i + 1] = v.y;
  if (i + 2 < hi) p[i + 2] = v.z;
  if (i + 3 < hi) p[i + 3] = v.w;
}

// Four bools as the bytes of a word (byte j: entry i + j).
template <bool kVec>
__device__ __forceinline__ uint32_t load4b(const bool* p, int i, int hi) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(p);
  if (kVec) return *reinterpret_cast<const uint32_t*>(b + i);
  uint32_t v = b[i];
  for (int j = 1; j < 4; ++j)
    if (i + j < hi) v |= static_cast<uint32_t>(b[i + j]) << (8 * j);
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4b(bool* p, int i, int hi, uint32_t v) {
  uint8_t* b = reinterpret_cast<uint8_t*>(p);
  if (kVec) {
    *reinterpret_cast<uint32_t*>(b + i) = v;
    return;
  }
  for (int j = 0; j < 4; ++j)
    if (i + j < hi) b[i + j] = static_cast<uint8_t>(v >> (8 * j));
}

__device__ __forceinline__ int lane_of(int4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The dual update (subgradient_solver.hpp:265-271) of four entries.
__device__ __forceinline__ int4 dual_step(int4 du, int4 g, bool act,
                                          float step) {
  int out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = lane_of(du, j), s = lane_of(g, j);
    out[j] = act && s != 0
                 ? __float2int_rz(__fsub_rn(__int2float_rn(u),
                                            __fmul_rn(step,
                                                      __int2float_rn(s))))
                 : u;
  }
  return make_int4(out[0], out[1], out[2], out[3]);
}

// A thread's four slots: partner, best_partner, and the bytes of
// best_matched, used_slot and matched_cons_slot.
struct SlotQuad {
  int4 p, bp;
  uint32_t bm, used, cons;
};

template <bool kVec>
__device__ __forceinline__ SlotQuad load_slots(const TailArgs& a, size_t srow,
                                               int s, int hi) {
  return {load4<kVec>(a.partner + srow, s, hi),
          load4<kVec>(a.best_partner + srow, s, hi),
          load4b<kVec>(a.best_matched + srow, s, hi),
          load4b<kVec>(a.used_slot + srow, s, hi),
          load4b<kVec>(a.matched_cons_slot + srow, s, hi)};
}

// Best-primal tracking of four slots (lagrange.hpp:416-421).
template <bool kVec>
__device__ __forceinline__ void store_slots(const TailArgs& a, size_t srow,
                                            int s, int hi, const SlotQuad& q,
                                            bool better, bool any_sg) {
  const uint32_t pick = any_sg ? q.used : q.cons;
  uint32_t matched = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (((pick >> (8 * j)) & 0xffu) && lane_of(q.p, j) >= 0)
      matched |= 1u << (8 * j);
  store4<kVec>(a.best_partner_out + srow, s, hi, better ? q.p : q.bp);
  store4b<kVec>(a.best_matched_out + srow, s, hi, better ? matched : q.bm);
}

// KI-tail.  Grid: one CTA per lane (lane = blockIdx.x), four dual entries
// and four line slots a thread, the block striding over longer lanes
// (iteration_cuda.tail_grid chooses the threads).  Every thread first
// issues the loads of its first four entries and slots (dual, sg;
// partner, best_partner, best_matched, used_slot, matched_cons_slot), 16
// bytes at a time where kVec; only then does it wait for the lane's step.
// Warp 0 meanwhile loads the lane's 16 scalars, one a thread, both arms of
// the any_sg select among them, and computes the lower bound, best
// primal, bounds, halving, the step and lane_active, which go through
// shared memory to the block; thread 0 writes the lane's scalar outputs
// (after the shuffles, so after every scalar input was read).
//
// With `loop` (only inside the dispatch graph's WHILE node, where
// lara_iteration_tail_fold sets it and `handle`), KI-tail also evaluates
// the loop's condition for the next trip, the work of loop_exit_kernel:
// every CTA takes a ticket in the 64-bit word at loop + 2 (the CTAs so
// far, and the lanes they left active), and the last one sets the WHILE
// node's condition to loop[0] > 0 && any lane active, where set takes one
// from loop[0] and adds one to loop[1], and zeroes the word.  The lanes'
// activity travels in the tickets, so nothing is read back.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    iteration_tail_kernel(const __grid_constant__ TailArgs a, int d,
                          int slots, int max_nondecr,
                          cudaGraphConditionalHandle handle,
                          int* __restrict__ loop) {
  __shared__ float step_s;
  __shared__ int flags_s;  // bit 0: act, 1: better, 2: any_sg
  unsigned long long ticket = 0;  // thread 0's, after its own add
  const int k = blockIdx.x;
  const size_t row = static_cast<size_t>(k) * d;
  const size_t srow = static_cast<size_t>(k) * slots;
  const int i0 = 4 * threadIdx.x;
  const int stride = 4 * blockDim.x;

  int4 du = {}, g = {};
  if (i0 < d) {
    du = load4<kVec>(a.dual + row, i0, d);
    g = load4<kVec>(a.sg + row, i0, d);
  }
  SlotQuad sq = {};
  if (i0 < slots) sq = load_slots<kVec>(a, srow, i0, slots);

  if (threadIdx.x < 32) {
    const int f = threadIdx.x;
    uint32_t v = 0;
    if (f < kTailScalars) {
      const void* src =
          reinterpret_cast<const void* const*>(&a)[kTailScalarField[f]];
      v = f == kAct ? static_cast<const uint8_t*>(src)[k]
                    : static_cast<const uint32_t*>(src)[k];
    }
    auto at = [&](int field) {
      return static_cast<int>(__shfl_sync(kFull, v, field));
    };
    const bool act = at(kAct) != 0;
    const int cnt = at(kCount);
    const bool any_sg = cnt > 0;
    const int lower = wadd(wadd(at(kSeqPart),
                                any_sg ? at(kMatchScore) : at(kConsistentSum)),
                           at(kGapScore));
    // best primal tracking (lagrange.hpp:416-421)
    const int best_score = at(kBestScore);
    const bool better = act && lower > best_score;
    const int best_nlines = at(kBestNlines);
    const int n_lines = at(kNLines);
    // bound bookkeeping (subgradient_solver.hpp:247-263)
    const int upper = at(kUpper);
    const int bu_old = at(kBestUpper);
    const int bl_old = at(kBestLower);
    const bool improved_u = act && upper < bu_old;
    const bool improved_l = act && lower > bl_old;
    const int bu = improved_u ? upper : bu_old;
    const int bl = improved_l ? lower : bl_old;
    const int nd_old = at(kNondecr);
    const int nd = (improved_u || improved_l) ? 0 : nd_old;
    const bool halve = act && nd >= max_nondecr;
    const float sf_old = __int_as_float(at(kStepFactor));
    const float sf = halve ? __fdiv_rn(sf_old, 2.0f) : sf_old;
    const int rem_old = at(kRemaining);
    const int rem = act ? wadd(rem_old, -1) : rem_old;
    const bool done = act && (bu == bl || rem == 0);
    const int it = at(kIterations);
    if (f == 0) {
      // dual update (subgradient_solver.hpp:265-271): the step in the
      // reference's order, step_factor * (ub - lb) / max(count, 1)
      const int gap = static_cast<int>(static_cast<uint32_t>(bu) -
                                       static_cast<uint32_t>(bl));
      step_s = __fdiv_rn(__fmul_rn(sf, __int2float_rn(gap)),
                         __int2float_rn(cnt > 1 ? cnt : 1));
      flags_s = (act ? 1 : 0) | (better ? 2 : 0) | (any_sg ? 4 : 0);
      a.best_score_out[k] = better ? lower : best_score;
      a.best_nlines_out[k] = better ? n_lines : best_nlines;
      a.best_upper_out[k] = bu;
      a.best_lower_out[k] = bl;
      a.nondecr_out[k] = act ? (halve ? 0 : wadd(nd, 1)) : nd_old;
      a.step_factor_out[k] = sf;
      a.remaining_out[k] = rem;
      a.lane_active_out[k] = act && !done;
      a.iterations_out[k] = wadd(it, act ? 1 : 0);
      if (loop != nullptr) {
        // this CTA's ticket and its lane's lane_active in one 64-bit add:
        // the CTAs that came before in the low word, the active lanes
        // among them in the high one.  Taken before the rows (the WHILE
        // node reads the condition after the whole body), its result read
        // after them.
        const unsigned long long mine = 1ull | (act && !done ? 1ull << 32
                                                             : 0ull);
        ticket = atomicAdd(reinterpret_cast<unsigned long long*>(loop + 2),
                           mine) + mine;
      }
    }
  }
  __syncthreads();
  const float step = step_s;
  const bool act = flags_s & 1, better = flags_s & 2, any_sg = flags_s & 4;
  if (i0 < d)
    store4<kVec>(a.dual_out + row, i0, d, dual_step(du, g, act, step));
  if (i0 < slots) store_slots<kVec>(a, srow, i0, slots, sq, better, any_sg);
  // entries and slots past the first four a thread (lanes longer than
  // four times the block)
  for (int i = i0 + stride; i < d; i += stride) {
    const int4 u = load4<kVec>(a.dual + row, i, d);
    const int4 s = load4<kVec>(a.sg + row, i, d);
    store4<kVec>(a.dual_out + row, i, d, dual_step(u, s, act, step));
  }
  for (int s = i0 + stride; s < slots; s += stride)
    store_slots<kVec>(a, srow, s, slots, load_slots<kVec>(a, srow, s, slots),
                      better, any_sg);

  // the last CTA to take a ticket sets the loop's condition for the next
  // trip
  if (threadIdx.x == 0 && loop != nullptr &&
      static_cast<uint32_t>(ticket) == gridDim.x) {
    const bool run = (ticket >> 32) != 0 && loop[0] > 0;
    cudaGraphSetConditional(handle, run ? 1u : 0u);
    if (run) {
      loop[0] -= 1;
      loop[1] += 1;
    }
    *reinterpret_cast<unsigned long long*>(loop + 2) = 0;
  }
}
// iteration_tail_kernel's arguments: TailArgs, three ints, then the
// condition handle and the loop counters
constexpr int kTailKernelArgs = 6;

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

}  // namespace

extern "C" {

// KI-head over batch lanes of d dual entries and ne PSSM cells, steps
// doubling passes, `tiles` CTAs a lane of `tile` entries each, an extended
// tile of at most `span` entries (iteration_cuda.head_grid chooses them;
// this only checks that they cover the lane and the halos).  daq_out may
// be dual_at_queue.
int lara_iteration_head(const int* sscore, const int* dual,
                        const int* dual_at_queue, const bool* dvalid,
                        const int* dual_l, const uint64_t* seg_mask,
                        const bool* lane_active, const int* seq_score,
                        const bool* active, int batch, int d, int ne,
                        int steps, int tile, int tiles, int span,
                        int* daq_out, int* run_p, int* run_idx, bool* is_top,
                        int* pssm, void* stream) {
  if (batch < 1 || d < 1 || ne < 1 || steps < 1 || steps > 30 || tile < 1 ||
      tile > d || tiles < 1 || static_cast<long long>(tiles) * tile < d ||
      static_cast<long long>(tiles - 1) * tile >= d || span > d ||
      (span < d && span < tile + 2 * ((1LL << steps) - 1)) ||
      static_cast<long long>(batch) * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  cudaError_t err = opt_in_smem(iteration_head_kernel, head_limit, &limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t buffer = static_cast<size_t>(span) * sizeof(uint64_t);
  const int both = 4 * buffer <= static_cast<size_t>(limit);
  const size_t smem = (both ? 4 : 2) * buffer;
  if (smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads =
      span >= kMaxThreads ? kMaxThreads : (span + 31) / 32 * 32;
  iteration_head_kernel<<<batch * tiles, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      sscore, dual, dual_at_queue, dvalid, dual_l, seg_mask, lane_active,
      seq_score, active, d, ne, steps, tile, tiles, both, daq_out, run_p,
      run_idx, is_top, pssm);
  return static_cast<int>(cudaGetLastError());
}

// KI-lines over batch lanes, a cluster of `cluster` CTAs each (1 to 8): d
// dual entries, slots line slots (la_max), cw queue columns, flat edge ids
// a * lb_max + b under ne; each CTA owns dper entries, sper slots and qper
// columns (iteration_cuda.lines_grid chooses them; this only checks that
// the cluster covers the lane).
int lara_iteration_lines(const int* partner, const int* dual_l,
                         const int* dual_m, const int* rev, const bool* dvalid,
                         const int* sscore, const int* dual, const int* run_p,
                         const int* run_idx, const bool* is_top, const int* lq,
                         const int* mq, const int* nc_base,
                         const bool* lane_active, int batch, int d, int slots,
                         int cw, int lb_max, int ne, int cluster, int dper,
                         int sper, int qper, int* slot_edge, int* sg,
                         int* count, int* consistent_sum,
                         bool* matched_cons_slot, bool* cand_q,
                         void* stream) {
  if (batch < 1 || d < 1 || slots < 1 || cw < 1 || lb_max < 1 ||
      cluster < 1 || cluster > 8 || dper < 1 || sper < 1 || qper < 1 ||
      static_cast<long long>(dper) * cluster < d ||
      static_cast<long long>(sper) * cluster < slots ||
      static_cast<long long>(qper) * cluster < cw ||
      static_cast<long long>(batch) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int limit = 0;
  cudaError_t err =
      opt_in_smem(iteration_lines_kernel, lines_limit, &limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem =
      static_cast<size_t>(slots) * (sizeof(int) + 1) + qper;
  if (smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  const LinesRows rows{dual_l, dual_m, rev,     dvalid, sscore,
                       dual,   run_p,  run_idx, is_top, sg};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  // a thread an entry (up to 1024): a thread's second entry waits for its
  // first one's gathers
  cfg.blockDim =
      dim3(dper >= kLinesThreads ? kLinesThreads : (dper + 31) / 32 * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, iteration_lines_kernel, partner, rows, lq,
                           mq, nc_base, lane_active, d, slots, cw, lb_max, ne,
                           dper, sper, qper, slot_edge,
                           count, consistent_sum, matched_cons_slot, cand_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// KI-tail over batch lanes of d dual entries and slots line slots; ptrs
// holds n_ptrs device pointers in TailArgs' order.  One CTA a lane of
// `threads` threads, 16-byte loads where `vec` (iteration_cuda.tail_grid
// chooses them; this only checks that `vec` may load 16 bytes).  Outside a
// loop graph: KI-tail sets no condition.
int lara_iteration_tail(void* const* ptrs, int n_ptrs, int batch, int d,
                        int slots, int max_nondecr, int threads, int vec,
                        void* stream) {
  if (n_ptrs != kTailPointers || batch < 1 || d < 1 || slots < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    bool aligned = d % 4 == 0 && slots % 4 == 0;
    for (int i = 0; i < n_ptrs; ++i)
      aligned = aligned && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
    if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  }
  TailArgs args;
  void** fields = reinterpret_cast<void**>(&args);
  for (int i = 0; i < kTailPointers; ++i) fields[i] = ptrs[i];
  const cudaGraphConditionalHandle none = 0;
  const auto kernel =
      vec ? iteration_tail_kernel<true> : iteration_tail_kernel<false>;
  kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, d, slots, max_nondecr, none, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Fold the loop exit into the KI-tail of a loop body: give the one KI-tail
// kernel node of `graph` (a WHILE node's body, before instantiation) the
// condition `handle` and the loop counters `loop` (iterations left,
// iterations run, then the CTAs' ticket, a zero 64-bit word), which its
// launch outside the loop left unset.  Kernel nodes of other libraries,
// whose parameters this runtime cannot read, are skipped.
// cudaErrorSymbolNotFound unless the graph holds exactly one.
int lara_iteration_tail_fold(void* graph, cudaGraphConditionalHandle handle,
                             int* loop) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  int found = 0;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (type != cudaGraphNodeTypeKernel) continue;
    cudaKernelNodeParams kp = {};
    err = cudaGraphKernelNodeGetParams(node, &kp);
    if (err == cudaErrorInvalidDeviceFunction) {
      // a kernel of another library (torch's): not KI-tail; clear the
      // error this runtime recorded
      (void)cudaGetLastError();
      continue;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (kp.func != reinterpret_cast<void*>(iteration_tail_kernel<true>) &&
        kp.func != reinterpret_cast<void*>(iteration_tail_kernel<false>))
      continue;
    if (kp.kernelParams == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    // the launch's arguments, copied out before the node's own copy goes,
    // and the condition and the counters in place of its none
    TailArgs targs = *static_cast<const TailArgs*>(kp.kernelParams[0]);
    int ints[3];
    for (int i = 0; i < 3; ++i)
      ints[i] = *static_cast<const int*>(kp.kernelParams[1 + i]);
    void* args[kTailKernelArgs] = {&targs,    ints,    ints + 1,
                                   ints + 2, &handle, &loop};
    kp.kernelParams = args;
    err = cudaGraphKernelNodeSetParams(node, &kp);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++found;
  }
  return found == 1 ? 0 : static_cast<int>(cudaErrorSymbolNotFound);
}

}  // extern "C"
