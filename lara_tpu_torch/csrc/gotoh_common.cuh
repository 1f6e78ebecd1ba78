// Device code of K-res (gotoh_resident.cu), the one DP variant that runs a
// diagonal per block barrier: K1's cell update and K2's traceback step
// (gotoh_dp.cu), with the same int32 arithmetic.  Sums wrap as XLA's do: cells
// outside a lane's rectangle add the NEG_INF sentinel to itself, and signed
// overflow is undefined in C++, so every add goes through uint32_t.

#pragma once

#include <stdint.h>

namespace lara {

constexpr int kNegInf = -1431655764;  // PSSM_INIT == NEG_INF
constexpr int kMat = 0, kHor = 1, kVer = 2;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// One anti-diagonal d of one lane's forward sweep, offsets i = threadIdx.x,
// threadIdx.x + blockDim.x, ... <= la.  M, H and V each hold three rings of W
// ints; ring d % 3 holds diagonal d, and the rings of d-1 and d-2 are read.
// score(i) is the score of cell (i, d - i); emit(i, code) stores its direction
// code mdir | hdir << 2 | vdir << 4.  At d == la + lb the terminal cell's
// M, H and V go to fin[0], fin[stride] and fin[2 * stride].  The caller
// synchronises the block between diagonals.
template <class Score, class Emit>
__device__ __forceinline__ void forward_diagonal(int* M, int* H, int* V, int W,
                                                 int d, int la, int lb, int go,
                                                 int ge, Score score, Emit emit,
                                                 int* fin, int stride) {
  const int r0 = (d % 3) * W;        // diagonal d
  const int r1 = ((d + 2) % 3) * W;  // diagonal d-1
  const int r2 = ((d + 1) % 3) * W;  // diagonal d-2
  const int bg = d == 0 ? 0 : wadd(go, wmul(ge, d - 1));
  const int edge_gap = d == 0 ? kNegInf : bg;
  for (int i = threadIdx.x; i <= la; i += blockDim.x) {
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
    const int t = score(i);

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
    emit(i, static_cast<int8_t>(mdir | (hdir << 2) | (vdir << 4)));
    if (d == la + lb && i == la) {
      fin[0] = m_new;
      fin[stride] = h_new;
      fin[2 * stride] = v_new;
    }
  }
}

// A traceback walker (lara_tpu/ops/gotoh.py::traceback, whose gap score is
// evaluateLines, lagrange.hpp:147-221): the current cell (i, j), the state
// it is in, and the sums so far.
struct Walker {
  int i, j, state, gap, cnt, seq;
};

// The state the walk starts in at (la, lb): the best of the terminal M, H, V,
// ties M > H > V.
__device__ __forceinline__ int start_state(int fm, int fh, int fv) {
  const int upper = max(max(fm, fh), fv);
  return fm == upper ? kMat : (fh == upper ? kHor : kVer);
}

// One step of the walk from a cell other than (0, 0).  code_at(d, i) is the
// direction code of cell (i, d - i), seq_at(a, b) the sequence score of the
// line (a, b); a match records row[a] = b.
template <class CodeAt, class SeqAt>
__device__ __forceinline__ void walk_step(Walker& w, CodeAt code_at,
                                          SeqAt seq_at, int* row, int go,
                                          int ge) {
  if (w.i == 0) {
    w.state = kHor;
  } else if (w.j == 0) {
    w.state = kVer;
  }
  const int pred = (code_at(w.i + w.j, w.i) >> (2 * w.state)) & 3;
  if (w.state == kMat) {
    row[w.i - 1] = w.j - 1;
    ++w.cnt;
    w.seq = wadd(w.seq, seq_at(w.i - 1, w.j - 1));
  } else {
    w.gap = wadd(w.gap, pred == w.state ? ge : go);
  }
  if (w.state != kHor) --w.i;
  if (w.state != kVer) --w.j;
  w.state = pred;
}

}  // namespace lara
