// K1 and K2 of the port: the forward affine-Gotoh wavefront and its
// traceback, hand-written for Hopper (sm_90a), over two layouts.
//
// K1 (dp_wave_kernel<false, false>) replaces lara_tpu/ops/gotoh_pallas.py:253
// (_make_stream_kernel); K2 (dp_walk_kernel) replaces gotoh_pallas.py:366
// (_make_tb_stream_kernel).  K1-grid (dp_wave_kernel<false, true>) replaces
// gotoh_pallas.py:41 (_make_kernel, pallas_call :654 and :876) and K2-grid
// (dp_walk_kernel over the grid layout) replaces :145
// (_make_traceback_kernel, pallas_call :984); LARA_DP_GRID=1 selects them.
// K-res (dp_wave_kernel<false, false, true>) replaces both
// gotoh_pallas.py:468 (_make_resident_kernel, K1-res) and :550
// (_make_tb_resident_kernel, K2-res); LARA_DP_RESIDENT=1 selects it where
// the pair fits (lara_tpu_torch/ops/gotoh_plan.py).  The plain versions are
// lara_tpu_torch/ops/gotoh.py::dp_forward, ::gotoh_scan and ::dp_traceback.
//
// The two layouts: K1 reads a score grid [B, LA, LB] and writes its codes
// lane-major, [B, D, W]; K1-grid reads the pre-skewed scores [D, B, W] (the
// input of gotoh_scan_pallas) and writes its codes diagonal-major,
// [Dp, B, W] (Dp = D rounded up to dchunk; rows past a lane's la + lb stay
// undefined).  The TPU kernels of the grid layout make a block of dchunk
// diagonals a sequential grid step and keep the wavefronts in VMEM scratch
// between steps; here, as in K1, a loop inside the block walks every
// diagonal, so K1-grid and K2-grid are K1 and K2 in the grid layout, one
// launch each per alignment call: only the score loads, the code stores
// and K2's strides differ, and dchunk only sets Dp.  So the same things
// bound them: K1-grid the chain of diagonals and the integer issue rate, as
// K1 (below); K2-grid the latency of its walk, as K2; and the design below
// answers both.  (The first port of the grid layout ran one launch per
// block of dchunk diagonals, the wavefronts reloaded from global memory at
// each, and a walk that read a code from global memory at every step.)
//
// K1: what bounds it.  A pair is a chain of la+lb+1 dependent anti-diagonals
// of about 20 integer operations per cell, reading a 4-byte score and
// writing a 1-byte code per cell: bytes bound it at ~0.14 ms for a full
// 16S chunk (B=32, 1536x1536), but what it meets first is the chain itself
// (la+lb+1 steps, each a shuffle and a few dozen dependent instructions)
// and the integer issue rate of the SMs that hold the pairs: an SM issues
// 64 integer lanes per clock, two warp instructions, so every instruction
// of a warp step counts.  A block barrier per diagonal and a score load on
// every diagonal's dependent chain (the first port of this kernel, one CTA
// per pair) cost 4.2 ms there.  The design:
//   * rows in registers: a warp owns a strip of 32 rows, one per lane, and
//     lane t runs one column behind lane t-1.  It takes the up cell from
//     lane t-1 by __shfl_up_sync, keeps the up-left cell from its previous
//     step and its own row's left cell in registers: a step is a shuffle
//     and a few dozen ALU instructions, with no barrier;
//   * strips across warps: the last lane of strip k hands its row to strip
//     k+1 through a ring of tagged cells in the consumer's shared memory
//     (below); the consumer polls eight cells at a time, and the producer
//     checks the consumer's count before it overwrites a slot.  The whole
//     warp polls, so that it never diverges around its shuffles: a warp
//     whose lane 0 alone spun ran its steps 5x slower on the card.  Strip k
//     runs on CTA k % C of the pair's cluster, warp (k / C) % nw; a warp
//     takes strips k, k + C*nw, ... until la is covered.  (Consecutive
//     strips on one CTA, so that most handoffs stay in its shared memory,
//     ran a lone 16S pair no faster on 16 CTAs and 12-18% slower on 4 to
//     12: a CTA's strips then run at once and share its SM's schedulers.)
//   * scores staged ahead: each lane copies its own score row into shared
//     memory by cp.async, 32 columns at a time into a ring of three chunks,
//     one chunk ahead of the sweep; no score load sits on the chain.
//     K1-grid stages 32 steps at a time into the same ring: lane t's score
//     at step s is skewed[base+s, b, base+t], so a step's 32 copies are one
//     contiguous 128-byte row of the skewed stream (4-byte copies: W is odd
//     in general), and lane t keeps step s in the slot where K1 keeps
//     column s-t-1, which spreads a step's 32 reads over the 32 banks;
//   * coalesced code stores: at warp step s lane t writes cell
//     (base+t, s-t) on diagonal base+s, so a step is one 32-byte store into
//     dirs[b, base+s, base:base+32] (K1-grid: dirs[base+s, b, base:base+32]);
//   * a short step: only the first 32 steps of a strip (and strip 0) test
//     for row 0 and column 0, lane 31 writes the ring once per block of
//     eight steps, and the ring is polled without branches;
//   * filling the card: a cluster of C CTAs per pair, the ring written
//     into distributed shared memory where producer and consumer sit on
//     different CTAs.  The wrapper takes C from B and the card
//     (gotoh_cuda.choose_cluster): at most 4 where B pairs fill the SMs (4
//     at B=32 on 132 SMs, 1 at B=128), so that a pair's strips share few
//     SMs; where B leaves SMs idle, up to 16 (kMaxCluster, non-portable on
//     Hopper: one GPC), as long as the card seats all B clusters at once
//     (cudaOccupancyMaxActiveClusters, lara_wave_clusters).  A step's
//     time grows with the strip warps an SM runs at once: a lone 16S pair
//     on 4 CTAs kept 12-13 strip warps an SM while 128 SMs sat idle; on 16
//     CTAs of 4 warps it keeps one strip warp a scheduler.
// Cells left of column 0 (j < 0) hold values that depend only on the
// diagonal, never on the scores; they reach a valid cell only through the
// M and H direction codes of the left border (i, 0).  The wrapper computes
// those two codes for every i once per (go, ge, W) on the host and passes
// them in (border), so the sweep starts at column 0.
//
// K2: what bounds it.  The walk from (la, lb) back to (0, 0) is la+lb
// dependent steps of one code byte each: latency.  One thread walking global
// memory (the first port) paid a memory round trip per step, 1.1 ms at 16S
// inside an iteration, where K1 has just pushed the codes out of L2.  The
// design: one warp per pair copies a window of 128 diagonals x 64 offsets
// around the walk into shared memory by cp.async;
// lane 0 walks 32 steps inside it (any 64 steps from the window's anchor
// stay inside: a step lowers d by 1 or 2 and i by 0 or 1), while the next
// window, anchored where the walk stands at the switch, is in flight.  The
// seq-score sum comes off the chain: after the walk the warp sums
// seq[b, i, partner[i]] over the matched rows (uint32 adds commute).
// K2-grid is the same kernel over the diagonal-major codes: a lane starts
// at byte b*W and a diagonal is B*W bytes on, where K2 has b*D*W and W.
//
// K-res is K1 and K2 in one launch with the codes in shared memory, so that
// no code byte touches device memory: only partner [B, la_max] and scalars
// [4, B] (upper, gap, n_lines, seq) leave the kernel, as on the TPU, whose
// resident kernels keep every diagonal in VMEM.  What bounds it: K1's chain
// and issue rate, then K2's walk, on one CTA per pair, and shared memory.
// The first port ran a diagonal per block barrier with the codes
// diagonal-major (D x W bytes, 217 KB at 320 x 320: one CTA per SM and a
// thread per cell), 2.2-2.7x this design's time on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md).  The design: K1's sweep on
// one CTA of nw warps (strips taken round-robin, as many warps as the
// codes leave room for, at most one per strip), which stores its codes
// into shared memory instead of dirs, row-major: lane t packs the codes of
// steps 4q .. 4q+3 of its row i into one 32-bit word and stores it as word
// q of row i (byte j + (i & 31) holds cell (i, j)).  The pitch is an odd
// number of words, so a warp step's 32 stores fall in 32 banks; the whole
// store is (la_max + 1) * pitch words, 114,276 bytes at 320 x 320 where the
// diagonal-major codes took 205,761.  After a block barrier, lane 0 of warp
// 0 walks as K2 does, each step a byte of shared memory, and the warp sums
// the seq scores over the matched rows off the walk's chain.
//
// K4's sweep is K1 in a prefix mode (dp_wave_kernel<true, false>): the same
// strips, rings and step, but each cell stores the int32 max(M, H, V) where
// K1 stores its int8 code (128 bytes per warp step, still coalesced), and a
// lane's scores come from the sequences and the 5x5 substitution matrix
// instead of a score grid.  It replaces the edge filter's two XLA scans
// (lara_tpu/ops/gotoh.py:336-383, gotoh_scan(emit="prefix") and
// suffix_scan): one launch runs 2B lanes, B over the forward grid and B over
// each lane's reversed sequences, whose forward prefix at (la-1-a, lb-1-b)
// is the suffix score of cell (a, b) (the native baseline's two forward
// sweeps, lara_tpu_torch/native/src/baseline.cpp:133-160).  The scores of a
// 32-column chunk are looked up once per 32 steps, by two shuffles a column
// (B's residue from the lane that read it, then the score from the lane
// that holds that matrix entry), off the step's chain; the codes and the
// border are not computed.  Its bound is bytes (the int32 prefix of every
// valid cell, written once), but like K1 it meets the chain and the integer
// issue rate first; at 16S its 2B lanes get two CTAs each, where K1's B get
// four.  The plain version is lara_tpu_torch/ops/gotoh.py::edge_sweep; the
// pack that follows is csrc/edge_filter.cu.
//
// int32 sums wrap exactly as XLA's do: every add goes through uint32_t
// (signed overflow is undefined in C++), and the NEG_INF sentinel adds to
// itself outside a lane's rectangle as it does there.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kNegInf = -1431655764;  // PSSM_INIT == NEG_INF
constexpr int kMat = 0, kHor = 1, kVer = 2;
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAlpha = 5;  // the Rna5 alphabet of K4's sequences

// K1 shared memory, per warp: a score ring of three 32-column chunks for
// each of its 32 rows, then its input ring of kRing (M, H, V) cells, each
// value in a 64-bit word beside a tag (the cell's index + 1): one aligned
// 64-bit store is seen whole or not at all, so the consumer polls the tags
// and no fence orders the ring against the code stores in flight (a
// release per handoff cost more than the sweep itself).
constexpr int kTileCols = 96;
constexpr int kRing = 88;
constexpr int kSub = 8;  // steps between ring reads and checks
constexpr int kMaxWarps = 16;
constexpr int kMaxCluster = 16;  // CTAs per pair; above 8 non-portable
constexpr int kWarpInts = 32 * kTileCols + 6 * kRing;

// K2 window: kWinRows diagonals x 64 offsets, each diagonal's 64 bytes
// inside the five 16-byte blocks that hold them (80 bytes).
constexpr int kWinRows = 128;
constexpr int kWinBytes = 80;
constexpr int kSeg = 32;  // steps walked per window

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring and the consumed counts live in the consumer's and the
// producer's shared memory: a thread polls only its own CTA's shared memory
// (volatile loads) and stores into a neighbour's through distributed
// shared memory (relaxed stores at cluster scope, to generic addresses
// mapped once per strip).  The tags carry the ordering, so no fence waits
// for the code stores in flight.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long poll64(unsigned a) {
  unsigned long long v;
  asm volatile("ld.volatile.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ int poll32(unsigned a) {
  int v;
  asm volatile("ld.volatile.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void put64(unsigned long long* p,
                                      unsigned long long v) {
  asm volatile("st.relaxed.cluster.u64 [%0], %1;\n" ::"l"(p), "l"(v));
}

__device__ __forceinline__ void put32(int* p, int v) {
  asm volatile("st.relaxed.cluster.u32 [%0], %1;\n" ::"l"(p), "r"(v));
}

__device__ __forceinline__ unsigned long long tagged(int tag, int value) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(tag)) << 32) |
         static_cast<uint32_t>(value);
}

__device__ __forceinline__ bool has_tag(unsigned long long w, int tag) {
  return static_cast<int>(w >> 32) == tag;
}

// Lane 0's up cells for the kSub columns from ring slot ``slot`` on, the
// first one tagged ``tag``: true when the ``need`` of them are all there.
// Every slot is read and the tags are and-ed without a branch: the loop is
// on the chain of every strip but the first.
__device__ __forceinline__ bool read_ring(unsigned ring_at, int slot, int tag,
                                          int need, int* rm, int* rh,
                                          int* rv) {
  bool ready = true;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    const int sl = slot + u < kRing ? slot + u : slot + u - kRing;
    const unsigned long long w0 = poll64(ring_at + 24 * sl);
    const unsigned long long w1 = poll64(ring_at + 24 * sl + 8);
    const unsigned long long w2 = poll64(ring_at + 24 * sl + 16);
    const bool here = has_tag(w0, tag + u) & has_tag(w1, tag + u) &
                      has_tag(w2, tag + u);
    ready = ready & (here | (u >= need));
    rm[u] = static_cast<int>(w0);
    rh[u] = static_cast<int>(w1);
    rv[u] = static_cast<int>(w2);
  }
  return ready;
}

// One step of the wavefront for one lane: the cell (i, j) from its diagonal
// (dm, dh, dv), left (cm, ch, cv) and up (um, uh, uv) neighbours; returns
// the packed code and updates (cm, ch, cv) to the new cell.  Only an
// ``kEdge`` step may meet row 0 or column 0.
template <bool kEdge>
__device__ __forceinline__ int wave_cell(int i, int j, int sc, int dm, int dh,
                                         int dv, int& cm, int& ch, int& cv,
                                         int um, int uh, int uv, int go,
                                         int ge, int border_code) {
  // M from (i-1, j-1); ties M > H > V
  const int best = max(max(dm, dh), dv);
  int mn = wadd(best, sc);
  const int mdir = dm == best ? kMat : (dh == best ? kHor : kVer);
  // H from (i, j-1); ties ext > M > V
  const int hh = wadd(ch, ge), hm = wadd(cm, go), hv = wadd(cv, go);
  int hn = max(max(hh, hm), hv);
  const int hdir = hh == hn ? kHor : (hm == hn ? kMat : kVer);
  // V from (i-1, j); ties ext > M > H
  const int vv = wadd(uv, ge), vm = wadd(um, go), vh = wadd(uh, go);
  int vn = max(max(vv, vm), vh);
  const int vdir = vv == vn ? kVer : (vm == vn ? kMat : kHor);
  int mh = mdir | (hdir << 2);
  if constexpr (kEdge) {
    // borders: cell (0, j) and cell (i, 0); (0, 0) is (0, NEG, NEG)
    if (i == 0) {
      const int bg = j == 0 ? 0 : wadd(go, wmul(ge, j - 1));
      mn = bg;
      hn = j == 0 ? kNegInf : bg;
      vn = kNegInf;
    }
    if (j == 0) {
      const int bg = i == 0 ? 0 : wadd(go, wmul(ge, i - 1));
      mn = bg;
      hn = kNegInf;
      vn = i == 0 ? kNegInf : bg;
      mh = border_code;
    }
  }
  cm = mn;
  ch = hn;
  cv = vn;
  return mh | (vdir << 4);
}

// The end of a walk, by its warp: the seq-score sum of pair b over the
// matched rows of its partner row (off the walk's chain: uint32 adds
// commute), then lane 0 writes the pair's scalars [4, batch] (upper, gap,
// n_lines, seq).
__device__ __forceinline__ void walk_scalars(const int* row,
                                             const int* __restrict__ seq,
                                             int b, int batch, int la_max,
                                             int lb_max, int upper, int gap,
                                             int cnt,
                                             int* __restrict__ scalars) {
  const int lane = threadIdx.x & 31;
  const int* seq_of = seq + static_cast<size_t>(b) * la_max * lb_max;
  uint32_t sum = 0;
  for (int a = lane; a < la_max; a += 32) {
    const int p = row[a];
    if (p >= 0) sum += static_cast<uint32_t>(seq_of[a * lb_max + p]);
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) {
    scalars[b] = upper;
    scalars[batch + b] = gap;
    scalars[2 * batch + b] = cnt;
    scalars[3 * batch + b] = static_cast<int>(sum);
  }
}

// K-res's traceback, by one warp once the sweep is done: lane 0 walks from
// (la, lb) as K2 does, reading the code of cell (i, j) from byte
// j + (i & 31) of row i of codes (4 * pitch bytes a row), and writes the
// partner row of pair b; then walk_scalars.
__device__ __forceinline__ void resident_walk(
    const uint32_t* codes, int pitch, const int* fin, int la, int lb, int b,
    int batch, int la_max, int lb_max, int go, int ge,
    const int* __restrict__ seq, int* __restrict__ partner,
    int* __restrict__ scalars) {
  const int lane = threadIdx.x & 31;
  int* row = partner + static_cast<size_t>(b) * la_max;
  for (int a = lane; a < la_max; a += 32) row[a] = -1;
  __syncwarp();
  const int fm = fin[0], fh = fin[1], fv = fin[2];
  const int upper = max(max(fm, fh), fv);
  int gap = 0, cnt = 0;
  if (lane == 0) {
    const uint8_t* cb = reinterpret_cast<const uint8_t*>(codes);
    const int row_bytes = 4 * pitch;
    int state = fm == upper ? kMat : (fh == upper ? kHor : kVer);
    int i = la, j = lb;
    while (i > 0 || j > 0) {
      if (i == 0) {
        state = kHor;
      } else if (j == 0) {
        state = kVer;
      }
      const int code = cb[i * row_bytes + j + (i & 31)];
      const int pred = (code >> (2 * state)) & 3;
      if (state == kMat) {
        row[i - 1] = j - 1;
        ++cnt;
      } else {
        gap = wadd(gap, pred == state ? ge : go);
      }
      if (state != kHor) --i;
      if (state != kVer) --j;
      state = pred;
    }
  }
  __syncwarp();
  walk_scalars(row, seq, b, batch, la_max, lb_max, upper, gap, cnt, scalars);
}

// Grid: batch * C CTAs in clusters of C (one cluster per pair), nw warps
// each.  Shared memory: nw * kWarpInts ints, then cons[nw]: the cells
// consumed from the ring that warp w feeds (written by its consumer); K-res
// then fin[3] and, from the next 16-byte boundary, its codes.
// K1 (kPrefix and kSkewed false) reads the score grid pssm
// [batch, la_max, lb_max] and the border codes and writes int8 codes to out
// [batch, D, W]; K1-grid (kSkewed) reads the pre-skewed scores from pssm
// [D, batch, W] (D = la_max + lb_max + 1) and writes its codes to out
// [Dp, batch, W]; K4's sweep (kPrefix) reads seq_a [batch/2, la_max], seq_b
// [batch/2, lb_max] and submat [5, 5] (lane b < batch/2 forward, lane
// batch/2 + b the reversed sequences of pair b, with the la and lb of pair
// b) and writes int32 prefixes to out [batch, D, W].  K-res (kResident,
// one CTA per pair) reads K1's score grid and the seq scores seq
// [batch, la_max, lb_max] and writes the partner rows to out
// [batch, la_max] and the scalars to finals [4, batch]; its codes take
// (la_max + 1) * pitch words.
template <bool kPrefix, bool kSkewed, bool kResident = false>
__global__ void __launch_bounds__(kMaxWarps * 32)
    dp_wave_kernel(const int* __restrict__ pssm, const int* __restrict__ seq_a,
                   const int* __restrict__ seq_b,
                   const int* __restrict__ submat,
                   const int* __restrict__ la_arr,
                   const int* __restrict__ lb_arr,
                   const int8_t* __restrict__ border, int la_max, int lb_max,
                   int go, int ge, int nw, int batch, int vec16,
                   void* __restrict__ out, int* __restrict__ finals,
                   const int* __restrict__ seq, int pitch) {
  static_assert(!(kPrefix && kSkewed), "K4's sweep has no skewed layout");
  static_assert(!(kResident && (kPrefix || kSkewed)),
                "K-res sweeps K1's score grid");
  using Cell = std::conditional_t<kPrefix, int, int8_t>;
  extern __shared__ __align__(16) int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* tile = smem + warp * kWarpInts + lane * kTileCols;
  unsigned long long* ring = reinterpret_cast<unsigned long long*>(
      smem + warp * kWarpInts + 32 * kTileCols);
  int* cons = smem + nw * kWarpInts;
  int* fin = cons + nw;  // K-res: the terminal M, H, V
  uint32_t* codes = reinterpret_cast<uint32_t*>(
      smem + ((nw * (kWarpInts + 1) + 3 + 3) & ~3));
  for (int x = lane; x < 3 * kRing; x += 32) ring[x] = 0;  // no tag is 0
  if (threadIdx.x < nw) cons[threadIdx.x] = 0;
  cluster.sync();

  const int W = la_max + 1;
  // K4: the pair whose sequences lane b sweeps, and whether reversed
  const int half = batch / 2;
  const int pair = kPrefix && b >= half ? b - half : b;
  const bool rev = kPrefix && b >= half;
  const int la = la_arr[pair];
  const int lb = lb_arr[pair];
  const int ncol = lb + 1;
  const int nstrips = (la + 32) / 32;  // rows 0..la
  const int P = C * nw;
  // diagonal d of lane b's codes (K1-grid: also of its scores) starts at
  // d * dstride in out_b (P_b)
  const size_t dstride = kSkewed ? static_cast<size_t>(batch) * W : W;
  const int* P_b =
      kPrefix   ? pssm
      : kSkewed ? pssm + static_cast<size_t>(b) * W
                : pssm + static_cast<size_t>(b) * la_max * lb_max;
  const int* sa =
      kPrefix ? seq_a + static_cast<size_t>(pair) * la_max : seq_a;
  const int* sb =
      kPrefix ? seq_b + static_cast<size_t>(pair) * lb_max : seq_b;
  // K4: lane x < 25 holds submat[x], read by shuffles
  const int sub_entry = kPrefix && lane < kAlpha * kAlpha ? submat[lane] : 0;
  // K-res stores its codes in shared memory: out is its partner rows
  Cell* out_b = kResident ? nullptr
                : static_cast<Cell*>(out) +
                      (kSkewed ? static_cast<size_t>(b) * W
                               : static_cast<size_t>(b) * (la_max + lb_max + 1) *
                                     W);

  for (int k = rank + C * warp; k < nstrips; k += P) {
    const int base = 32 * k;
    const int i = base + lane;
    const bool has_up = k > 0;
    const bool has_down = k + 1 < nstrips;
    // cell index of column 0 in the ring between strips k-1 and k, and in
    // the one between k and k+1 (monotonic over a warp's strips)
    const int e_in = has_up ? (k - 1) / P * ncol : 0;
    const int e_out = k / P * ncol;
    // the consumer of this strip's last row: strip k+1
    const int c_rank = (k + 1) % C, c_warp = ((k + 1) / C) % nw;
    unsigned long long* out_ring = cluster.map_shared_rank(
        reinterpret_cast<unsigned long long*>(smem + c_warp * kWarpInts +
                                              32 * kTileCols),
        c_rank);
    // the producer of row base-1: strip k-1
    const int p_rank = (k + C - 1) % C;
    const int p_warp = has_up ? ((k - 1) / C) % nw : 0;
    int* in_cons = cluster.map_shared_rank(cons + p_warp, p_rank);
    const unsigned ring_at = smem_addr(ring), cons_at = smem_addr(cons + warp);

    // score row i-1, columns [32c, 32c+32) into chunk slot c % 3 (K1-grid:
    // the scores of steps [32c, 32c+32), each where K1 keeps column s-t-1)
    const bool row_ok = i >= 1 && i <= la;
    const int* src_row =
        kSkewed ? P_b + static_cast<size_t>(base) * dstride + i
                : P_b + static_cast<size_t>(i - 1) * lb_max;
    // K4: the first matrix entry of row i-1's residue (row x of the
    // reversed grid is A[la-1-x])
    const int sub_row =
        kPrefix && row_ok ? kAlpha * sa[rev ? la - i : i - 1] : 0;
    auto load_chunk = [&](int c) {
      const int c0 = 32 * c;
      if constexpr (kPrefix) {
        // the whole warp takes part in the shuffles: c0 < lb is uniform
        if (c0 < lb) {
          int* dst = tile + (c % 3) * 32;
          const int col = c0 + lane;
          const int cb = col < lb ? sb[rev ? lb - 1 - col : col] : 0;
#pragma unroll 8
          for (int x = 0; x < 32; ++x) {
            const int v = __shfl_sync(
                kFull, sub_entry, sub_row + __shfl_sync(kFull, cb, x));
            if (row_ok) dst[x] = v;
          }
        }
      } else if constexpr (kSkewed) {
        // cell (i, s - t) of step s lies on diagonal base + s; copy the
        // cells 1 <= j <= lb (the border's scores are never read)
        if (row_ok && c0 - lane <= lb) {
          const int* src = src_row + static_cast<size_t>(c0) * dstride;
          int slot = 32 * (c % 3) + kTileCols - 1 - lane;  // (c0 - t - 1)
          if (slot >= kTileCols) slot -= kTileCols;        // mod 96
#pragma unroll 8
          for (int x = 0; x < 32; ++x) {
            if (static_cast<unsigned>(c0 + x - lane - 1) <
                static_cast<unsigned>(lb))
              cp_async4(tile + slot, src);
            src += dstride;
            slot = slot == kTileCols - 1 ? 0 : slot + 1;
          }
        }
        cp_async_commit();
      } else {
        if (row_ok && c0 < lb) {
          int* dst = tile + (c % 3) * 32;
          const int n = min(32, lb - c0);
          if (vec16) {
            for (int x = 0; x < n; x += 4)
              cp_async16(dst + x, src_row + c0 + x);
          } else {
            for (int x = 0; x < n; ++x) cp_async4(dst + x, src_row + c0 + x);
          }
        }
        cp_async_commit();
      }
    };
    load_chunk(0);

    int cm = kNegInf, ch = kNegInf, cv = kNegInf;  // (i, j-1)
    int dm = kNegInf, dh = kNegInf, dv = kNegInf;  // (i-1, j-1)
    int ci = kTileCols - 1 - lane;                 // (j-1) mod 96
    const int bcode = !kPrefix && i <= la ? border[i] : 0;
    const bool row_valid = i <= la;
    // K-res: the codes of steps 4q .. 4q+3 (cells j = 4q - lane ..), stored
    // as word q of row i
    uint32_t word = 0;
    uint32_t* crow = codes + static_cast<size_t>(row_valid ? i : 0) * pitch;
    // code (K4: prefix) of cell (i, j) at out_b[(i + j) * W + i]; j = s - lane
    Cell* outp = out_b + static_cast<size_t>(base) * dstride + i;
    int in_slot = e_in % kRing, out_slot = e_out % kRing;
    int cons_seen = -kRing;  // the consumer's count, last read
    // the step at which this lane meets cell (la, lb), and the last column
    // it stores (none outside rows 0 .. la)
    const int fin_s = i == la ? lb + lane : -1;
    const int j_hi = row_valid ? lb : -1;
    const int nsteps = lb + 32;
    for (int s0 = 0; s0 < nsteps; s0 += kSub) {
      if ((s0 & 31) == 0) {
        load_chunk((s0 >> 5) + 1);
        if constexpr (!kPrefix) cp_async_wait<1>();
      }
      // the up cells of lane 0's columns s0 .. s0+kSub-1, from the ring: every
      // lane reads them (one broadcast load each), so the warp polls and
      // waits as one and never diverges around its shuffles
      int rm[kSub], rh[kSub], rv[kSub];
      const bool take = has_up && s0 <= lb;
      if (take) {
        const int need = min(kSub, lb + 1 - s0);
        while (!read_ring(ring_at, in_slot, e_in + s0 + 1, need, rm, rh, rv)) {
        }
      } else {
#pragma unroll
        for (int u = 0; u < kSub; ++u) rm[u] = rh[u] = rv[u] = kNegInf;
      }
      // room in the consumer's ring for this block's cells of row base+31
      const int out_last = min(s0 + kSub - 1 - 31, lb);
      if (has_down && out_last >= 0) {
        const int room = e_out + out_last + 1 - kRing;
        while (cons_seen < room) cons_seen = poll32(cons_at);
      }
      // lane 31's cells of this block, for the consumer's ring
      int km[kSub], kh[kSub], kv[kSub];
      auto block = [&](auto edge) {
        constexpr bool kEdge = decltype(edge)::value;
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int s = s0 + u;
          const int j = s - lane;
          int um = __shfl_up_sync(kFull, cm, 1);
          int uh = __shfl_up_sync(kFull, ch, 1);
          int uv = __shfl_up_sync(kFull, cv, 1);
          if (lane == 0) {
            um = rm[u];
            uh = rh[u];
            uv = rv[u];
          }
          const int sc = tile[ci];
          ci = ci == kTileCols - 1 ? 0 : ci + 1;
          const int code = wave_cell<kEdge>(i, j, sc, dm, dh, dv, cm, ch, cv,
                                            um, uh, uv, go, ge, bcode);
          dm = um;
          dh = uh;
          dv = uv;
          km[u] = cm;
          kh[u] = ch;
          kv[u] = cv;
          if constexpr (kResident) {
            word |= static_cast<uint32_t>(code) << (8 * (u & 3));
            if ((u & 3) == 3) {
              // cells j - 3 .. j of row i: store unless none is inside
              if (row_valid && j >= 0 && j - 3 <= lb) crow[s >> 2] = word;
              word = 0;
            }
            if (s == fin_s) {
              fin[0] = cm;
              fin[1] = ch;
              fin[2] = cv;
            }
          } else {
            // past the first 32 steps j >= 1
            const bool store =
                kEdge ? row_valid &&
                            static_cast<unsigned>(j) <= static_cast<unsigned>(lb)
                      : j <= j_hi;
            if (store) {
              if constexpr (kPrefix) {
                *outp = max(max(cm, ch), cv);
              } else {
                *outp = static_cast<int8_t>(code);
              }
            }
            if (s == fin_s) {
              finals[b] = cm;
              finals[batch + b] = ch;
              finals[2 * batch + b] = cv;
            }
            outp += dstride;
          }
        }
      };
      // only the first 32 steps of a strip meet column 0, only strip 0
      // meets row 0
      if (s0 < 32 || k == 0) {
        block(std::true_type());
      } else {
        block(std::false_type());
      }
      if (has_down && lane == 31) {
        auto put = [&](int u) {
          const int tag = e_out + s0 + u - 31 + 1;
          put64(out_ring + 3 * out_slot, tagged(tag, km[u]));
          put64(out_ring + 3 * out_slot + 1, tagged(tag, kh[u]));
          put64(out_ring + 3 * out_slot + 2, tagged(tag, kv[u]));
          out_slot = out_slot + 1 == kRing ? 0 : out_slot + 1;
        };
        // columns s0-31 .. s0-32+kSub: all inside [0, lb] but at the ends
        if (s0 >= 32 && s0 + kSub - 32 <= lb) {
#pragma unroll
          for (int u = 0; u < kSub; ++u) put(u);
        } else {
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const int j = s0 + u - 31;
            if (j >= 0 && j <= lb) put(u);
          }
        }
      }
      if (take) {
        if (lane == 0) put32(in_cons, e_in + min(s0 + kSub, ncol));
        in_slot = in_slot + kSub >= kRing ? in_slot + kSub - kRing
                                          : in_slot + kSub;
      }
    }
    if constexpr (!kPrefix) cp_async_wait<0>();
    __syncwarp();
  }
  // no CTA may leave while a neighbour still writes into its shared memory
  cluster.sync();
  if constexpr (kResident) {
    if (warp == 0) resident_walk(codes, pitch, fin, la, lb, b, batch, la_max,
                                 lb_max, go, ge, seq,
                                 static_cast<int*>(out), finals);
  }
}

// One warp per pair.  Shared memory: two windows of kWinRows x kWinBytes.
// Cell (i, d - i) of lane b is byte b * lane_stride + d * diag_stride + i of
// dirs, total_bytes long (K2: [batch, D, W], lane_stride D * W and
// diag_stride W; K2-grid: [Dp, batch, W], lane_stride W and diag_stride
// batch * W).  Window anchored at (da, ia): diagonals da-127 .. da, offsets
// ia-63 .. ia; diagonal da-r starts at byte ((K - r*diag_stride) & 15) of
// its 80-byte row, K = the byte index of (da, ia-63) in dirs.
__global__ void __launch_bounds__(32)
    dp_walk_kernel(const int8_t* __restrict__ dirs,
                   const int* __restrict__ finals,
                   const int* __restrict__ la_arr,
                   const int* __restrict__ lb_arr,
                   const int* __restrict__ seq, int batch, int la_max,
                   int lb_max, long long lane_stride, int diag_stride,
                   long long total_bytes, int go, int ge,
                   int* __restrict__ partner, int* __restrict__ scalars) {
  __shared__ __align__(16) uint8_t win[2][kWinRows * kWinBytes];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  int* row = partner + static_cast<size_t>(b) * la_max;
  for (int a = lane; a < la_max; a += 32) row[a] = -1;

  const long long lane_base = b * lane_stride;
  // copy the window anchored at (da, ia) into buffer w: lane t takes the
  // diagonals da-t, da-t-32, da-t-64, da-t-96
  auto load_window = [&](int w, int da, int ia) {
#pragma unroll
    for (int q = 0; q < kWinRows / 32; ++q) {
      const int r = lane + 32 * q;
      if (da - r < 0) continue;
      const long long g =
          lane_base + static_cast<long long>(da - r) * diag_stride + ia - 63;
      const long long a0 = g & ~15LL;
#pragma unroll
      for (int x = 0; x < kWinBytes / 16; ++x) {
        const long long a = a0 + 16 * x;
        if (a >= 0 && a < total_bytes) {
          cp_async16(&win[w][r * kWinBytes + 16 * x], dirs + a);
        }
      }
    }
    cp_async_commit();
  };

  const int fm = finals[b], fh = finals[batch + b], fv = finals[2 * batch + b];
  const int upper = max(max(fm, fh), fv);
  int state = fm == upper ? kMat : (fh == upper ? kHor : kVer);
  int i = la_arr[b];
  int j = lb_arr[b];
  int gap = 0, cnt = 0;
  int cur = 0;
  int da = i + j, ia = i;  // anchor of the window in buffer cur
  load_window(cur, da, ia);
  cp_async_wait<0>();
  __syncwarp();
  // Segment n walks steps 32n .. 32n+31 in the window anchored at step
  // 32(n-1) (segment 0 in the one anchored at step 0), while the window
  // anchored at step 32n is copied for segment n+1.
  bool first = true;
  while (i > 0 || j > 0) {
    const int nda = i + j, nia = i;
    if (!first) load_window(cur ^ 1, nda, nia);
    if (lane == 0) {
      const uint8_t* wb = win[cur];
      const long long k0 =
          lane_base + static_cast<long long>(da) * diag_stride + ia - 63;
      const int kmod = static_cast<int>(k0 & 15);
      const int wmod = diag_stride & 15;
      for (int n = 0; n < kSeg && (i > 0 || j > 0); ++n) {
        if (i == 0) {
          state = kHor;
        } else if (j == 0) {
          state = kVer;
        }
        const int r = da - (i + j);
        const int off = (kmod - r * wmod) & 15;
        const int code = wb[r * kWinBytes + off + i - ia + 63];
        const int pred = (code >> (2 * state)) & 3;
        if (state == kMat) {
          row[i - 1] = j - 1;
          ++cnt;
        } else {
          gap = wadd(gap, pred == state ? ge : go);
        }
        if (state != kHor) --i;
        if (state != kVer) --j;
        state = pred;
      }
    }
    i = __shfl_sync(kFull, i, 0);
    j = __shfl_sync(kFull, j, 0);
    state = __shfl_sync(kFull, state, 0);
    if (first) {
      first = false;  // segment 1 walks on in the same window
      continue;
    }
    cp_async_wait<0>();
    __syncwarp();
    cur ^= 1;
    da = nda;
    ia = nia;
  }
  cp_async_wait<0>();
  __syncwarp();
  walk_scalars(row, seq, b, batch, la_max, lb_max, upper, gap, cnt, scalars);
}

// Whether the strip schedule of p warps per pair always finishes
// (gotoh_plan.schedule_safe says why): with more strips than warps, a row
// must stay short of the point where the last warp's strip waits on one
// that the first warp has not started.
bool ring_safe(int la_max, int lb_max, int p) {
  const int strips = (la_max + 32) / 32;
  return strips <= p || p * (kRing + 28 - kSub) >= lb_max + 32;
}

// K-res's codes: words per row, the least odd number past the last word a
// lane stores ((lb_max + 31) / 4), and the shared memory of a CTA of nw
// warps.  Keep in step with gotoh_plan.resident_pitch and resident_bytes.
int resident_pitch(int lb_max) { return ((lb_max + 31) / 4 + 1) | 1; }

size_t resident_bytes(int la_max, int lb_max, int nw) {
  const size_t head = (static_cast<size_t>(nw) * (kWarpInts + 1) + 3 + 3) & ~3;
  return (head + static_cast<size_t>(la_max + 1) * resident_pitch(lb_max)) *
         sizeof(int);
}

// Opt one instance of dp_wave_kernel in, on the current device, once: to
// kMaxSmem of dynamic shared memory, and to clusters of more than 8 CTAs.
// The shared memory attribute is a ceiling, not a reservation: each launch
// still asks for its own size, and launch_wave refuses more than kMaxSmem.
// Setting it to a launch's own size instead would let a smaller launch fail
// a CUDA graph captured at a larger size.
constexpr int kMaxDevices = 64;

template <bool kPrefix, bool kSkewed, bool kResident>
cudaError_t opt_in() {
  static std::atomic<bool> done[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || done[device % kMaxDevices].load()) return err;
  auto* kernel = dp_wave_kernel<kPrefix, kSkewed, kResident>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done[device % kMaxDevices].store(true);
  return err;
}

// Warps per CTA of K1, K1-grid and K4's sweep at la_max rows in clusters of
// ``cluster`` CTAs per lane, and the shared memory of such a CTA.
int wave_warps(int la_max, int cluster) {
  const int strips = (la_max + 32) / 32;
  return std::min(kMaxWarps, (strips + cluster - 1) / cluster);
}

size_t wave_bytes(int nw) {
  return (static_cast<size_t>(nw) * kWarpInts + nw) * sizeof(int);
}

// A launch configuration of ``ctas`` CTAs of nw warps in clusters of
// ``cluster``; ``attr`` holds its one attribute.
cudaLaunchConfig_t wave_config(int ctas, int cluster, int nw, size_t smem,
                               void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// K1, K1-grid (kSkewed) or K4's sweep (kPrefix) over ``batch`` lanes in
// clusters of ``cluster`` CTAs per lane, wave_warps each; K-res (kResident)
// on one CTA of nw warps per pair.
template <bool kPrefix, bool kSkewed, bool kResident = false>
int launch_wave(const int* pssm, const int* seq_a, const int* seq_b,
                const int* submat, const int* la, const int* lb,
                const int8_t* border, int batch, int la_max, int lb_max,
                int go, int ge, int cluster, int vec16, void* out,
                int* finals, void* stream, const int* seq = nullptr,
                int nw = 0) {
  if (!kResident && cluster >= 1) nw = wave_warps(la_max, cluster);
  if (cluster < 1 || cluster > kMaxCluster || (kResident && cluster != 1) ||
      nw < 1 || nw > kMaxWarps || !ring_safe(la_max, lb_max, cluster * nw))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kResident ? resident_bytes(la_max, lb_max, nw)
                                : wave_bytes(nw);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in<kPrefix, kSkewed, kResident>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wave_config(batch * cluster, cluster, nw, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, dp_wave_kernel<kPrefix, kSkewed, kResident>,
                           pssm, seq_a, seq_b, submat, la, lb, border, la_max,
                           lb_max, go, ge, nw, batch, vec16, out, finals, seq,
                           resident_pitch(lb_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of ``cluster`` CTAs of one instance at la_max rows the
// current card holds at once (0 where it cannot seat one).
template <bool kPrefix, bool kSkewed>
int wave_clusters(int la_max, int cluster, int* count) {
  *count = 0;
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in<kPrefix, kSkewed, false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = wave_warps(la_max, cluster);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wave_config(cluster, cluster, nw, wave_bytes(nw), nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(
      count, dp_wave_kernel<kPrefix, kSkewed, false>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // no later launch may report it
    *count = 0;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* lara_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The card's opt-in shared memory per block, in bytes.
int lara_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// The clusters of ``cluster`` CTAs that the current card holds at once for
// K1 (kind 0), K1-grid (1) or K4's sweep (2) at la_max rows, into count.
int lara_wave_clusters(int kind, int la_max, int cluster, int* count) {
  switch (kind) {
    case 0:
      return wave_clusters<false, false>(la_max, cluster, count);
    case 1:
      return wave_clusters<false, true>(la_max, cluster, count);
    case 2:
      return wave_clusters<true, false>(la_max, cluster, count);
  }
  *count = 0;
  return static_cast<int>(cudaErrorInvalidValue);
}

int lara_gotoh_dp(const int* pssm, const int* la, const int* lb,
                  const int8_t* border, int batch, int la_max, int lb_max,
                  int go, int ge, int cluster, int8_t* dirs, int* finals,
                  void* stream) {
  const int vec16 = (lb_max % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(pssm) % 16 == 0);
  return launch_wave<false, false>(pssm, nullptr, nullptr, nullptr, la, lb,
                                   border, batch, la_max, lb_max, go, ge,
                                   cluster, vec16, dirs, finals, stream);
}

// K1-grid: skewed [num_diag, batch, width] int32 in, dirs [Dp, batch, width]
// (written on the valid cells only) and finals [3, batch] out.
int lara_gotoh_grid_dp(const int* skewed, const int* la, const int* lb,
                       const int8_t* border, int batch, int num_diag,
                       int width, int go, int ge, int cluster, int8_t* dirs,
                       int* finals, void* stream) {
  return launch_wave<false, true>(skewed, nullptr, nullptr, nullptr, la, lb,
                                  border, batch, width - 1, num_diag - width,
                                  go, ge, cluster, 0, dirs, finals, stream);
}

// K-res: the forward sweep of a [batch, la_max, lb_max] score grid and its
// traceback in one CTA of nw warps per pair (gotoh_plan.resident_warps);
// partner [batch, la_max] and scalars [4, batch] out, seq [batch, la_max,
// lb_max] the seq scores.
int lara_gotoh_resident(const int* pssm, const int* la, const int* lb,
                        const int8_t* border, const int* seq, int batch,
                        int la_max, int lb_max, int go, int ge, int nw,
                        int* partner, int* scalars, void* stream) {
  const int vec16 = (lb_max % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(pssm) % 16 == 0);
  return launch_wave<false, false, true>(
      pssm, nullptr, nullptr, nullptr, la, lb, border, batch, la_max, lb_max,
      go, ge, 1, vec16, partner, scalars, stream, seq, nw);
}

// K4's sweep over 2 * pairs lanes: prefix [2 * pairs, D, W] int32 (written
// on the valid cells only), finals [3, 2 * pairs].
int lara_edge_sweep(const int* seq_a, const int* seq_b, const int* submat,
                    const int* la, const int* lb, int pairs, int la_max,
                    int lb_max, int go, int ge, int cluster, int* prefix,
                    int* finals, void* stream) {
  return launch_wave<true, false>(nullptr, seq_a, seq_b, submat, la, lb,
                                  nullptr, 2 * pairs, la_max, lb_max, go, ge,
                                  cluster, 0, prefix, finals, stream);
}

int lara_gotoh_tb(const int8_t* dirs, const int* finals, const int* la,
                  const int* lb, const int* seq, int batch, int la_max,
                  int lb_max, int go, int ge, int* partner, int* scalars,
                  void* stream) {
  if (reinterpret_cast<uintptr_t>(dirs) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long lane_bytes =
      static_cast<long long>(la_max + lb_max + 1) * (la_max + 1);
  dp_walk_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      dirs, finals, la, lb, seq, batch, la_max, lb_max, lane_bytes,
      la_max + 1, batch * lane_bytes, go, ge, partner, scalars);
  return static_cast<int>(cudaGetLastError());
}

// K2-grid: the walk over K1-grid's dirs [num_rows, batch, la_max + 1].
int lara_gotoh_grid_tb(const int8_t* dirs, const int* finals, const int* la,
                       const int* lb, const int* seq, int batch, int num_rows,
                       int la_max, int lb_max, int go, int ge, int* partner,
                       int* scalars, void* stream) {
  if (reinterpret_cast<uintptr_t>(dirs) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int width = la_max + 1;
  dp_walk_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      dirs, finals, la, lb, seq, batch, la_max, lb_max, width, batch * width,
      static_cast<long long>(num_rows) * batch * width, go, ge, partner,
      scalars);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
