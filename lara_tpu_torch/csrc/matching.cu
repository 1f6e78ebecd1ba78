// K3 of the port: the greedy lookahead matching rounds loop, designed for
// Hopper (sm_90a).
//
// Replaces lara_tpu/solver/matching_pallas.py::_make_kernel (the state
// machine matching_rounds_values, launched by the pallas_call of
// rounds_loop_pallas), which replays computeGreedyMatching + solveConflicts
// (reference matching.hpp:99-192) over queue-ordered candidate columns.  The
// plain version is lara_tpu_torch/solver/matching_device.py::rounds_loop;
// the result is bit for bit the same.
//
// What bounds it on this card.  A lane (one pair of the batch) is a chain of
// rounds.  Each round selects the next lh <= 8 unblocked columns at or after
// a scan pointer, resolves their conflicts exactly and keeps the survivors,
// whose endpoints block every later column that shares one.  A round needs
// the endpoints its predecessor kept, so a lane's time is the latency of
// its chain (some 150 rounds on the longest lane of a 16S batch), not bytes
// (13 a column, each column read about once) nor operations (a few hundred
// a round).  The TPU kernel's fixed [BB, W] passes per round (a cumsum
// ladder, lh one-hot reductions, a blocking pass over all W columns and S
// line slots) would put O(W) work and block-wide barriers on that chain.
// The design keeps the chain short instead:
//   * One warp per lane, one lane per CTA, the lanes spread over the SMs.  A
//     lane's round state lives in its warp's registers and shared memory;
//     the warp syncs by __ballot_sync, __reduce_add_sync and __syncwarp
//     only, never by a block barrier.
//   * Lazy blocking.  The kept endpoints (two per kept column) go into an
//     open-addressing hash set.  Selection tests a column when it reads it
//     (live, and neither endpoint in the set); a column before the pointer
//     is never read again, so no blocked mask is ever written.  used_slot is
//     written once at the end: slot s is used iff line[s] is in the set.
//     Column work falls from O(rounds * W) to O(W + rounds * 32).  The set
//     has a power of two >= 4W entries (at most 2W keys: at most half full,
//     so a probe always ends, most at its first entry), in shared memory up
//     to kSmemTableMax entries (W <= 4096) and beyond that in a global
//     scratch that the wrapper allocates.
//     INT32_MIN marks an empty entry; a kept key equal to it is a flag.
//   * Selection by ballot: 32 consecutive columns per warp step from the
//     pointer, each lane's rank the __popc of the lower lanes' ballot bits,
//     ending at the step that completes the selection.
//   * The conflict memo across the warp.  Lane c tests conflict pair c and
//     one ballot gives the conflict mask: no conflict, nothing to solve; one
//     conflict, its higher (lighter) slot goes.  Otherwise the 2^sel subsets
//     of eliminated slots are dealt to the lanes (subset e to lane e mod 32)
//     and filled one popcount level at a time, supersets first, with a
//     __syncwarp between levels, under the reference's tie rules.
//   * The queue in shared memory: cp.async stages a lane's columns (lq, mq,
//     wq; live by a plain load) into a ring of kRingMin..kRingMax columns,
//     the whole row when W <= kRingMax.  A wider row streams through the
//     ring half a ring at a time, which is safe because the pointer only
//     moves forward: a refill overwrites only columns before the current
//     32-column window, and the next round starts inside that window.
// Score adds stay in uint32_t, as the reference's int32 sums wrap.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxLh = 8;
constexpr int kMaxSub = 1 << kMaxLh;
constexpr int kSubPerLane = kMaxSub / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kEmpty = -2147483647 - 1;  // INT32_MIN: an empty entry
// these four must agree with lara_tpu_torch/solver/matching_cuda.py
constexpr int kRingMin = 128;
constexpr int kRingMax = 2048;
constexpr int kTableMin = 64;
constexpr int kSmemTableMax = 16384;
constexpr int kBytesPerColumn = 13;  // lq, mq, wq and the live byte
constexpr int kBatch = 8;  // loads a lane keeps in flight in a pass
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The kept endpoints: open addressing with linear probing.  ``entry`` is
// shared memory or global memory (kSharedTable of the kernel), so the
// compiler knows which.
struct KeptSet {
  int* entry;
  unsigned mask;
  int shift;
  bool has_empty;  // a kept endpoint equal to kEmpty

  __device__ __forceinline__ unsigned home(int key) const {
    return (static_cast<unsigned>(key) * 0x9E3779B1u) >> shift;
  }
  // the probe after a first one at h found neither key nor an empty entry
  __device__ __forceinline__ bool probe_on(unsigned h, int key) const {
    for (h = (h + 1) & mask;; h = (h + 1) & mask) {
      const int v = entry[h];
      if (v == key) return true;
      if (v == kEmpty) return false;
    }
  }
  // is key kept, given the entry v at its home h (loaded by the caller, so
  // that several first probes are in flight at once)
  __device__ __forceinline__ bool resolve(int key, unsigned h, int v) const {
    if (key == kEmpty) return has_empty;
    if (v == key) return true;
    if (v == kEmpty) return false;
    return probe_on(h, key);
  }
  // several lanes insert at once; a key already there stays as it is
  __device__ __forceinline__ void insert(int key) {
    if (key == kEmpty) return;
    for (unsigned h = home(key);; h = (h + 1) & mask) {
      const int old = atomicCAS(entry + h, kEmpty, key);
      if (old == kEmpty || old == key) return;
    }
  }
  // the endpoints of the lanes' columns that are kept (warp-wide call)
  __device__ __forceinline__ void add(bool kept, int l, int m) {
    if (kept) {
      insert(l);
      insert(m);
    }
    if (__any_sync(kAll, kept && (l == kEmpty || m == kEmpty))) {
      has_empty = true;
    }
  }
};

// The per-lane state that the warp shares.
struct WarpState {
  int sel_l[kMaxLh], sel_m[kMaxLh], sel_w[kMaxLh];
  int memo_w[kMaxSub], memo_e[kMaxSub];
  int pair_x[32], pair_y[32];  // conflict pair c = (x, y), x < y
};

// Stage columns [lo, hi) into the ring (column c at c & mask) and count
// this lane's share of the live ones.  The slots they take hold columns
// before the current window, which no lane reads again.  The live bytes
// come by plain loads, kBatch in flight at a time.
__device__ unsigned stage(int* ring_l, int* ring_m, int* ring_w,
                          uint8_t* ring_live, int mask, const int* L,
                          const int* M, const int* W, const uint8_t* live,
                          int lo, int hi, int lane) {
  __syncwarp();
  unsigned n_live = 0;
  for (int base = lo; base < hi; base += 32 * kBatch) {
    uint8_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = base + 32 * k + lane;
      v[k] = c < hi ? live[c] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = base + 32 * k + lane;
      if (c < hi) {
        const int s = c & mask;
        cp_async4(ring_l + s, L + c);
        cp_async4(ring_m + s, M + c);
        cp_async4(ring_w + s, W + c);
        ring_live[s] = v[k];
        n_live += v[k] != 0;
      }
    }
  }
  cp_async_wait_all();
  __syncwarp();
  return n_live;
}

// This lane's share of the live columns in [lo, hi), not staged.
__device__ unsigned count_live(const uint8_t* live, int lo, int hi,
                               int lane) {
  unsigned n_live = 0;
  for (int base = lo; base < hi; base += 32 * kBatch) {
    uint8_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int c = base + 32 * k + lane;
      v[k] = c < hi ? live[c] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) n_live += v[k] != 0;
  }
  return n_live;
}

// solveConflicts over the sel_cnt selected slots; returns the bitmask of
// eliminated slots, the same in every lane.  Lane c holds conflict pair c
// = (px, py) and, for c < sel_cnt, the weight my_w of selected slot c.
__device__ int solve_conflicts(WarpState& st, int sel_cnt, int n_conf,
                               int px, int py, int my_w, int lane) {
  const int lx = st.sel_l[px], mx = st.sel_m[px];
  const int ly = st.sel_l[py], my = st.sel_m[py];
  const bool active = lane < n_conf && py < sel_cnt &&
                      (lx == ly || lx == my || mx == ly || mx == my);
  const unsigned full = __ballot_sync(kAll, active);
  if (full == 0) return 0;
  if ((full & (full - 1)) == 0) {  // one conflict: its higher slot goes
    return 1 << __shfl_sync(kAll, py, __ffs(full) - 1);
  }
  // touch[i]: the conflicts that involve slot i; lane i keeps its own
  unsigned touch[kMaxLh];
  unsigned my_touch = 0;
#pragma unroll
  for (int i = 0; i < kMaxLh; ++i) {
    touch[i] = __ballot_sync(kAll, active && (px == i || py == i));
    if (lane == i) my_touch = touch[i];
  }
  // memo[e]: the best (weight, eliminated set) below the state that has
  // eliminated the slots of e.  Subset e belongs to lane e mod 32.  What
  // does not depend on the memo is found first for each of this lane's
  // subsets; then the levels fill from the most slots down, e | bit one
  // level above e.
  const int n_sub = 1 << sel_cnt;
  const int per_lane = (n_sub + 31) / 32;
  int es_[kSubPerLane], el_[kSubPerLane], ws_[kSubPerLane], wl_[kSubPerLane];
  int bit_s[kSubPerLane], bit_l[kSubPerLane];
  bool differ[kSubPerLane], pending[kSubPerLane];
#pragma unroll
  for (int j = 0; j < kSubPerLane; ++j) {
    pending[j] = false;
    if (j >= per_lane) continue;
    const int e = lane + 32 * j;
    unsigned m = full;  // the conflicts that remain once e is eliminated
#pragma unroll
    for (int i = 0; i < kMaxLh; ++i) {
      if ((e >> i) & 1) m &= ~touch[i];
    }
    const int c0 = m != 0 ? __ffs(m) - 1 : 0;  // the first remaining one
    const int s = st.pair_y[c0], l = st.pair_x[c0];  // S: the higher slot
    ws_[j] = __shfl_sync(kAll, my_w, s);
    wl_[j] = __shfl_sync(kAll, my_w, l);
    const unsigned t_s = __shfl_sync(kAll, my_touch, s);
    const unsigned t_l = __shfl_sync(kAll, my_touch, l);
    bit_s[j] = 1 << s;
    bit_l[j] = 1 << l;
    es_[j] = e | bit_s[j];
    el_[j] = e | bit_l[j];
    differ[j] = (m & ~t_s) != (m & ~t_l);
    if (e < n_sub) {
      if (m == 0) {
        st.memo_w[e] = 0;
        st.memo_e[e] = 0;
      } else if ((m & (m - 1)) == 0) {
        st.memo_w[e] = ws_[j];
        st.memo_e[e] = bit_s[j];
      } else {
        pending[j] = true;
      }
    }
  }
  __syncwarp();
  for (int level = sel_cnt - 2; level >= 0; --level) {
#pragma unroll
    for (int j = 0; j < kSubPerLane; ++j) {
      const int e = lane + 32 * j;
      if (!pending[j] || __popc(e) != level) continue;
      const int weight_s = wadd(ws_[j], st.memo_w[es_[j]]);
      const int weight_l = wadd(wl_[j], st.memo_w[el_[j]]);
      // explore L only when S is strictly heavier and the filtered
      // conflict lists differ (matching.hpp:121-133)
      if (weight_s > wl_[j] && differ[j] && weight_s > weight_l) {
        st.memo_w[e] = weight_l;
        st.memo_e[e] = st.memo_e[el_[j]] | bit_l[j];
      } else {
        st.memo_w[e] = weight_s;
        st.memo_e[e] = st.memo_e[es_[j]] | bit_s[j];
      }
    }
    __syncwarp();
  }
  return st.memo_e[0];
}

// One warp (one CTA of 32 threads) per lane of the batch; the set of kept
// endpoints in shared memory (kSharedTable) or in table_global.
template <bool kSharedTable>
__global__ void __launch_bounds__(32) matching_rounds_kernel(
    const int* __restrict__ lq, const int* __restrict__ mq,
    const int* __restrict__ wq, const uint8_t* __restrict__ live,
    const int* __restrict__ line, int width, int slots, int lh,
    int ring_size, int table_bits, int* table_global,
    int* __restrict__ score_out, uint8_t* __restrict__ used_out) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ WarpState st;
  const int lane = threadIdx.x;
  const unsigned lanes_below = (1u << lane) - 1;
  const size_t row = static_cast<size_t>(blockIdx.x) * width;
  const int* L = lq + row;
  const int* M = mq + row;
  const int* W = wq + row;
  const uint8_t* live_row = live + row;
  const int* line_row = line + static_cast<size_t>(blockIdx.x) * slots;
  uint8_t* used = used_out + static_cast<size_t>(blockIdx.x) * slots;

  const int table_size = 1 << table_bits;
  KeptSet kept;
  unsigned char* ring_base = dyn;
  if (kSharedTable) {
    kept.entry = reinterpret_cast<int*>(dyn);
    ring_base += static_cast<size_t>(table_size) * sizeof(int);
  } else {
    kept.entry = table_global + static_cast<size_t>(blockIdx.x) * table_size;
  }
  kept.mask = static_cast<unsigned>(table_size - 1);
  kept.shift = 32 - table_bits;
  kept.has_empty = false;
  int* ring_l = reinterpret_cast<int*>(ring_base);
  int* ring_m = ring_l + ring_size;
  int* ring_w = ring_m + ring_size;
  uint8_t* ring_live = reinterpret_cast<uint8_t*>(ring_w + ring_size);
  const int ring_mask = ring_size - 1;

  const int4 empty4 = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  for (int i = 4 * lane; i < table_size; i += 4 * 32) {
    *reinterpret_cast<int4*>(kept.entry + i) = empty4;
  }

  // this lane's conflict pair, in the reference's order (0,1),(0,2),..,(1,2)
  const int n_conf = lh * (lh - 1) / 2;
  int px = 0, py = 0;
  if (lane < n_conf) {
    int c = lane;
    while (c >= lh - 1 - px) {
      c -= lh - 1 - px;
      ++px;
    }
    py = px + 1 + c;
  }
  st.pair_x[lane] = px;
  st.pair_y[lane] = py;

  // stage the first ring of columns; count the live ones of the row
  int hi = min(width, ring_size);  // columns before hi are staged
  unsigned n_live = stage(ring_l, ring_m, ring_w, ring_live, ring_mask, L, M,
                          W, live_row, 0, hi, lane) +
                    count_live(live_row, hi, width, lane);
  n_live = __reduce_add_sync(kAll, n_live);
  const int lh_lane = min(lh, static_cast<int>(n_live));  // matching.hpp:153

  // The current window: columns [pos, pos + 32), this lane's column pos +
  // lane in registers, ok while it is live and no kept endpoint blocks it.
  // Columns before ptr are consumed.  A kept column of the window enters
  // the set only when the warp leaves the window (kept_here); meanwhile
  // each round tests the window against the endpoints it kept, by shuffles.
  uint32_t score = 0;  // this lane's share
  int pos = 0, ptr = 0;
  int cl = 0, cm = 0, cw = 0;
  bool ok = false, kept_here = false;
  auto load_window = [&]() {
    if (hi < min(pos + 32, width)) {
      const int next = min(hi + ring_size / 2, width);
      stage(ring_l, ring_m, ring_w, ring_live, ring_mask, L, M, W, live_row,
            hi, next, lane);
      hi = next;
    }
    const int s = (pos + lane) & ring_mask;
    cl = ring_l[s];
    cm = ring_m[s];
    cw = ring_w[s];
    const bool is_live = pos + lane < width && ring_live[s] != 0;
    const unsigned hl = kept.home(cl), hm = kept.home(cm);
    const int vl = kept.entry[hl], vm = kept.entry[hm];
    ok = is_live && !kept.resolve(cl, hl, vl) && !kept.resolve(cm, hm, vm);
  };
  if (width > 0) load_window();
  while (ptr < width) {
    // ---- the next lh_lane unblocked columns at or after ptr ----
    int found = 0, found_before = 0, my_rank = -1, next_ptr = width;
    while (true) {
      const bool cand = ok && pos + lane >= ptr;
      const unsigned ballot = __ballot_sync(kAll, cand);
      const int rank = found + __popc(ballot & lanes_below);
      if (cand && rank < lh_lane) {
        st.sel_l[rank] = cl;
        st.sel_m[rank] = cm;
        st.sel_w[rank] = cw;
        my_rank = rank;
      }
      found_before = found;
      found += __popc(ballot);
      if (found >= lh_lane) {  // this window completes the selection
        const unsigned last = __ballot_sync(kAll, cand && rank == lh_lane - 1);
        if (last != 0) next_ptr = pos + __ffs(last);  // its column + 1
        break;
      }
      if (pos + 32 >= width) break;
      // leave the window: its kept columns go into the set first
      kept.add(kept_here, cl, cm);
      kept_here = false;
      my_rank = -1;
      pos += 32;
      __syncwarp();
      load_window();
    }
    const int sel_cnt = min(found, lh_lane);
    __syncwarp();  // the selection is complete
    if (sel_cnt == 0) break;  // nothing left: the pointer goes to width

    // ---- resolve conflicts, keep the survivors ----
    int kl = 0, km = 0, kw = 0;
    if (lane < sel_cnt) {
      kl = st.sel_l[lane];
      km = st.sel_m[lane];
      kw = st.sel_w[lane];
    }
    const int elim = solve_conflicts(st, sel_cnt, n_conf, px, py, kw, lane);
    const bool keep = lane < sel_cnt && ((elim >> lane) & 1) == 0;
    if (keep) score += static_cast<uint32_t>(kw);
    // a kept column from an earlier window enters the set now
    kept.add(keep && lane < found_before, kl, km);
    if (my_rank >= 0 && ((elim >> my_rank) & 1) == 0) kept_here = true;
    // block the window's columns that share an endpoint kept just now
#pragma unroll
    for (int k = 0; k < kMaxLh; ++k) {
      if (k >= sel_cnt) break;
      const int a = __shfl_sync(kAll, kl, k), b = __shfl_sync(kAll, km, k);
      if (((elim >> k) & 1) == 0 &&
          (cl == a || cl == b || cm == a || cm == b)) {
        ok = false;
      }
    }
    ptr = next_ptr;
    __syncwarp();  // every lane has read the selection before the next
  }
  kept.add(kept_here, cl, cm);
  score = __reduce_add_sync(kAll, score);
  __syncwarp();  // every insert is seen by the used_slot pass

  // slot s is used iff its edge is a kept endpoint; first probes in flight
  // kBatch at a time
  for (int base = 0; base < slots; base += 32 * kBatch) {
    int e[kBatch], v[kBatch];
    unsigned h[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int s = base + 32 * k + lane;
      e[k] = s < slots ? line_row[s] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      h[k] = kept.home(e[k]);
      v[k] = kept.entry[h[k]];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int s = base + 32 * k + lane;
      if (s < slots) used[s] = kept.resolve(e[k], h[k], v[k]) ? 1 : 0;
    }
  }
  if (lane == 0) score_out[blockIdx.x] = static_cast<int>(score);
}

}  // namespace

// ring: staged columns per lane, a power of two in [kRingMin, kRingMax];
// table_size: entries of the kept set, a power of two > 2 * width, in
// shared memory when table_global is null (then at most kSmemTableMax),
// else table_global holds batch * table_size ints.
extern "C" int lara_matching_rounds(const int* lq, const int* mq,
                                    const int* wq, const uint8_t* live,
                                    const int* line, int batch, int width,
                                    int slots, int lh, int ring,
                                    int table_size, int* table_global,
                                    int* score, uint8_t* used, void* stream) {
  const bool ring_ok = ring >= kRingMin && ring <= kRingMax &&
                       (ring & (ring - 1)) == 0;
  const bool table_ok =
      table_size >= kTableMin && (table_size & (table_size - 1)) == 0 &&
      static_cast<long long>(table_size) > 2LL * width &&
      (table_global != nullptr || table_size <= kSmemTableMax);
  if (lh < 1 || lh > kMaxLh || batch < 1 || width < 0 || slots < 0 ||
      !ring_ok || !table_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int table_bits = 0;
  while ((1 << table_bits) < table_size) ++table_bits;
  const bool shared_table = table_global == nullptr;
  const size_t smem =
      static_cast<size_t>(ring) * kBytesPerColumn +
      (shared_table ? static_cast<size_t>(table_size) * sizeof(int) : 0);
  auto kernel = shared_table ? matching_rounds_kernel<true>
                             : matching_rounds_kernel<false>;
  // opt in to the shared memory above 48 KB once per device and size
  static std::atomic<int> opted[2][kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::atomic<int>& done = opted[shared_table ? 1 : 0][device % kMaxDevices];
  if (smem > 48 * 1024 && static_cast<int>(smem) > done.load()) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    done.store(static_cast<int>(smem));
  }
  kernel<<<batch, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      lq, mq, wq, live, line, width, slots, lh, ring, table_bits,
      table_global, score, used);
  return static_cast<int>(cudaGetLastError());
}
