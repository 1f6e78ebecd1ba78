// K3 of the port: the greedy lookahead matching rounds loop, hand-written
// for Hopper (sm_90a).
//
// Replaces lara_tpu/solver/matching_pallas.py::_make_kernel (the state
// machine matching_rounds_values), which replays computeGreedyMatching +
// solveConflicts (reference matching.hpp:99-192) over queue-ordered
// candidate columns.  The plain version is
// lara_tpu_torch/solver/matching_device.py::rounds_loop.
//
// What bounds it on this card.  The work per lane is a data-dependent
// sequence of rounds; each round selects the next lh <= 8 unblocked columns
// at or after a scan pointer, resolves their conflicts exactly, and blocks
// every later column that shares an endpoint with a kept entry.  Bytes are
// small (the W columns of one lane are re-read once per round, mostly from
// L1), so the bound is the latency of the round chain, and the TPU kernel's
// fixed-shape [B, W] passes per round (a full cumsum ladder and lh one-hot
// reductions) would be wasted work here.  The design gives each lane one CTA
// that runs the whole loop in-kernel:
//   * the selection scans tiles of blockDim columns from the pointer with a
//     warp ballot plus a block-wide prefix, and stops at the first tile that
//     completes the selection;
//   * one thread replays solveConflicts by the 2^lh subset memo of
//     matching_device._solve_conflicts_enum; the memo entries are filled in
//     descending subset order, which visits every strict superset first, as
//     the popcount-descending order does;
//   * all threads stride the blocking update over the columns at or after
//     the new pointer (nothing before it is read again) and the line-slot
//     update.
// The blocked mask lives in a [B, W] byte scratch the wrapper allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLh = 8;
constexpr int kMaxConf = kMaxLh * (kMaxLh - 1) / 2;
constexpr int kThreads = 256;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// solveConflicts over the sel_cnt selected slots; returns the bitmask of
// eliminated slots.  Run by one thread.
__device__ int solve_conflicts(const int* sel_l, const int* sel_m,
                               const int* sel_w, int sel_cnt, int lh,
                               const int* cx, const int* cy, int* mask_e,
                               int* memo_w, int* memo_e) {
  const int n_conf = lh * (lh - 1) / 2;
  int full = 0;
  int touch[kMaxLh];
  for (int e = 0; e < lh; ++e) touch[e] = 0;
  for (int c = 0; c < n_conf; ++c) {
    const int x = cx[c], y = cy[c];
    if (x < sel_cnt && y < sel_cnt &&
        (sel_l[x] == sel_l[y] || sel_l[x] == sel_m[y] ||
         sel_m[x] == sel_l[y] || sel_m[x] == sel_m[y])) {
      full |= 1 << c;
      touch[x] |= 1 << c;
      touch[y] |= 1 << c;
    }
  }
  if (full == 0) return 0;
  const int n_sub = 1 << lh;
  // remaining-conflict mask per eliminated-slot subset E
  mask_e[0] = full;
  for (int e = 1; e < n_sub; ++e) {
    mask_e[e] = mask_e[e & (e - 1)] & ~touch[__ffs(e) - 1];
  }
  memo_w[n_sub - 1] = 0;
  memo_e[n_sub - 1] = 0;
  for (int e = n_sub - 2; e >= 0; --e) {
    const int m = mask_e[e];
    int val_w = 0, val_e = 0;
    if (m != 0) {
      const int c0 = __ffs(m) - 1;  // first remaining conflict
      const int s = cy[c0], l = cx[c0];  // S = the higher (lighter) slot
      const int w_s = sel_w[s], w_l = sel_w[l];
      if ((m & (m - 1)) == 0) {
        val_w = w_s;
        val_e = 1 << s;
      } else {
        const int es = e | (1 << s), el = e | (1 << l);
        const int weight_s = w_s + memo_w[es];
        const int weight_l = w_l + memo_w[el];
        // explore L only when S is strictly heavier and the filtered
        // conflict lists differ (matching.hpp:121-133)
        const bool l_wins = weight_s > w_l && mask_e[es] != mask_e[el] &&
                            weight_s > weight_l;
        if (l_wins) {
          val_w = weight_l;
          val_e = memo_e[el] | (1 << l);
        } else {
          val_w = weight_s;
          val_e = memo_e[es] | (1 << s);
        }
      }
    }
    memo_w[e] = val_w;
    memo_e[e] = val_e;
  }
  return memo_e[0];
}

// One CTA of kThreads threads per lane.
__global__ void matching_rounds_kernel(
    const int* __restrict__ lq, const int* __restrict__ mq,
    const int* __restrict__ wq, const uint8_t* __restrict__ live,
    const int* __restrict__ line, int width, int slots, int lh,
    uint8_t* __restrict__ blocked, int* __restrict__ score_out,
    uint8_t* __restrict__ used_out) {
  __shared__ int sel_l[kMaxLh], sel_m[kMaxLh], sel_w[kMaxLh], sel_rank[kMaxLh];
  __shared__ int kept_l[kMaxLh], kept_m[kMaxLh];
  __shared__ int cx[kMaxConf], cy[kMaxConf];
  __shared__ int mask_e[1 << kMaxLh], memo_w[1 << kMaxLh],
      memo_e[1 << kMaxLh];
  __shared__ int warp_cnt[kThreads / 32];
  __shared__ int s_ptr, s_n_kept, s_ncand;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * width;
  const int* L = lq + row;
  const int* Mq = mq + row;
  const int* Wq = wq + row;
  const uint8_t* live_row = live + row;
  uint8_t* blk = blocked + row;
  const int* line_row = line + static_cast<size_t>(blockIdx.x) * slots;
  uint8_t* used = used_out + static_cast<size_t>(blockIdx.x) * slots;

  if (tid == 0) {
    s_ptr = 0;
    s_ncand = 0;
    int c = 0;
    for (int x = 0; x < lh; ++x) {
      for (int y = x + 1; y < lh; ++y) {
        cx[c] = x;
        cy[c] = y;
        ++c;
      }
    }
  }
  __syncthreads();
  int local = 0;
  for (int w = tid; w < width; w += blockDim.x) {
    const bool is_live = live_row[w] != 0;
    blk[w] = is_live ? 0 : 1;
    local += is_live;
  }
  for (int s = tid; s < slots; s += blockDim.x) used[s] = 0;
  if (local) atomicAdd(&s_ncand, local);
  __syncthreads();
  const int lh_lane = min(lh, s_ncand);  // matching.hpp:153-156
  int score = 0;  // thread 0's

  while (true) {
    const int ptr = s_ptr;
    __syncthreads();  // every thread has read s_ptr before it changes
    if (ptr >= width) break;

    // ---- the next lh_lane unblocked columns at or after ptr ----
    int found = 0;
    for (int base = ptr; base < width && found < lh_lane;
         base += blockDim.x) {
      const int w = base + tid;
      const bool ok = w < width && blk[w] == 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) warp_cnt[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
      for (int k = 0; k < blockDim.x / 32; ++k) {
        const int c = warp_cnt[k];
        if (k < warp) before += c;
        total += c;
      }
      const int rank = found + before + __popc(ballot & ((1u << lane) - 1));
      if (ok && rank < lh_lane) {
        sel_l[rank] = L[w];
        sel_m[rank] = Mq[w];
        sel_w[rank] = Wq[w];
        sel_rank[rank] = w;
      }
      found += total;
      __syncthreads();  // warp_cnt and the selection are complete
    }

    // ---- resolve conflicts, keep survivors, advance the pointer ----
    if (tid == 0) {
      const int sel_cnt = min(found, lh_lane);
      int new_ptr = width;
      int n_kept = 0;
      if (sel_cnt > 0) {
        const int elim = solve_conflicts(sel_l, sel_m, sel_w, sel_cnt, lh,
                                         cx, cy, mask_e, memo_w, memo_e);
        for (int k = 0; k < sel_cnt; ++k) {
          if ((elim >> k) & 1) continue;
          score = wadd(score, sel_w[k]);
          kept_l[n_kept] = sel_l[k];
          kept_m[n_kept] = sel_m[k];
          ++n_kept;
        }
        if (sel_cnt >= lh_lane) new_ptr = sel_rank[sel_cnt - 1] + 1;
      }
      s_ptr = new_ptr;
      s_n_kept = n_kept;
    }
    __syncthreads();

    // ---- block columns sharing a kept endpoint; mark used line slots ----
    const int n_kept = s_n_kept;
    if (n_kept > 0) {
      for (int w = s_ptr + tid; w < width; w += blockDim.x) {
        const int l = L[w], m = Mq[w];
        bool hit = false;
        for (int k = 0; k < n_kept; ++k) {
          const int kl = kept_l[k], km = kept_m[k];
          hit |= l == kl || l == km || m == kl || m == km;
        }
        if (hit) blk[w] = 1;
      }
      for (int s = tid; s < slots; s += blockDim.x) {
        const int e = line_row[s];
        for (int k = 0; k < n_kept; ++k) {
          if (e == kept_l[k] || e == kept_m[k]) used[s] = 1;
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) score_out[blockIdx.x] = score;
}

}  // namespace

extern "C" int lara_matching_rounds(const int* lq, const int* mq,
                                    const int* wq, const uint8_t* live,
                                    const int* line, int batch, int width,
                                    int slots, int lh, uint8_t* blocked,
                                    int* score, uint8_t* used, void* stream) {
  if (lh < 1 || lh > kMaxLh) return static_cast<int>(cudaErrorInvalidValue);
  matching_rounds_kernel<<<batch, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      lq, mq, wq, live, line, width, slots, lh, blocked, score, used);
  return static_cast<int>(cudaGetLastError());
}
