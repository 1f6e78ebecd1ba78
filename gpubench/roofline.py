"""Operations and bytes that the solver's two main kernels need for one
call, from the real (unpadded) lengths of its lanes, and the peaks of the
card they are held against.

Peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet; they assume the
full 700 W, so the card's power limit is recorded beside every share):

* HBM: 3.35 TB/s.
* Integer DP operations: the SMs (132) x 64 INT32 lanes each x 2
  operations a clock, at the SM clock that ``nvidia-smi`` reads beside the
  window.  Two a clock because the three-input IADD3 and VIMNMX3 each do
  two of the recurrence's operations (an add of three terms, a max of
  three).

K1 (``dp_wave_kernel``, the forward Gotoh DP of one iteration) computes,
per cell (i, j) of a lane's la x lb grid, the affine-gap recurrence

    E(i,j) = max(E(i,j-1) + ge, H(i,j-1) + go)        2 adds, 1 max
    F(i,j) = max(F(i-1,j) + ge, H(i-1,j) + go)        2 adds, 1 max
    H(i,j) = max(H(i-1,j-1) + s(i,j), E(i,j), F(i,j))  1 add, 2 maxes

and its traceback code, which arm won: two comparisons for H and one each
for E and F.  That is 9 + 4 = 13 operations a cell.  It reads the cell's
int32 score (4 bytes) and writes its one-byte code; per lane it reads la
and lb and writes three int32 finals.  Every lane is computed on every
iteration, finished or not, so a call's count is that of all its lanes;
a padding lane is a 1 x 1 problem.

K3 (``matching_rounds_kernel``, the greedy lookahead matching) walks each
lane's queue of interaction candidates, one per undirected dual pair (half
the lane's directed duals), reading its l, m and weight (int32 each) and
its live flag (one byte), and writes the lane's int32 score.  How far the
walk goes depends on the data, so no operation count is kept: its bound is
the bytes, a lower bound of what it moves (the line slots it also reads
are left out).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
OPS_PER_LANE_CLOCK = 2
K1_OPS_PER_CELL = 13
K1_BYTES_PER_CELL = 4 + 1
K1_BYTES_PER_LANE = 2 * 4 + 3 * 4
K3_BYTES_PER_CANDIDATE = 3 * 4 + 1
K3_BYTES_PER_LANE = 4


class Work(NamedTuple):
    ops: float
    bytes: float


def k1_call(lanes: Iterable[Tuple[int, int]]) -> Work:
    """K1's work for one call over lanes of (la, lb)."""
    cells = lanes_n = 0
    for la, lb in lanes:
        cells += la * lb
        lanes_n += 1
    return Work(K1_OPS_PER_CELL * cells,
                K1_BYTES_PER_CELL * cells + K1_BYTES_PER_LANE * lanes_n)


def k3_call(duals: Iterable[int]) -> Work:
    """K3's work for one call over lanes of ``duals`` directed duals each."""
    nbytes = 0
    for d in duals:
        nbytes += K3_BYTES_PER_CANDIDATE * (d // 2) + K3_BYTES_PER_LANE
    return Work(0.0, nbytes)


def peak_int_ops(sms: int, sm_clock_mhz: float) -> float:
    """Integer DP operations a second at ``sm_clock_mhz``."""
    return sms * INT32_LANES_PER_SM * OPS_PER_LANE_CLOCK * sm_clock_mhz * 1e6


def share(work: Work, seconds: float, sms: int, sm_clock_mhz: float):
    """(percent of the roofline, the bound that binds: 'ops' or 'bytes'):
    the least time the card could take, the larger of operations over the
    integer peak and bytes over HBM's, over the time taken."""
    t_ops = work.ops / peak_int_ops(sms, sm_clock_mhz)
    t_bytes = work.bytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes)
    return 100.0 * bound / seconds, "ops" if t_ops >= t_bytes else "bytes"
