// Honest single-thread CPU baseline: the complete per-pair Lagrangian solve
// in C++ -- Gotoh edge filter, per-iteration Gotoh alignment over the PSSM
// with traceback, and the native Lagrange bookkeeping (lagrange_host.cpp).
//
// Purpose: a defensible LaRA-equivalent CPU performance anchor.  The
// reference binary cannot be built here (empty vendored submodules), so this
// solver IS the measured stand-in for a single scalar LaRA 2 thread
// (reference/src/subgradient_solver.hpp:219-331).  Multi-thread and
// SIMD numbers are extrapolated from it (benchmark/RESULTS.md).
//
// Semantics are identical to the tested Python oracle
// (lara_tpu_torch/solver/oracle.py): int64 DP over the reference's border
// initialisation (edge_filter.hpp:79-97), traceback tie policy M > H > V at
// the end state and M-predecessor, gap states prefer extending
// (oracle.align_pssm), per-run gap scoring go + (k-1)*ge
// (lagrange.hpp:147-221).  The subgradient bookkeeping is
// lara_lagrange_step from lagrange_host.cpp, linked into the same object.
//
// C ABI for ctypes; no Python.h.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

typedef int32_t i32;
typedef int64_t i64;
using std::vector;

// from lagrange_host.cpp (same shared object)
extern "C" {
void* lara_lagrange_create(int la, int lb, const i32* seq_score,
                           const uint8_t* active, int n_dual,
                           const i32* dual_l, const i32* dual_m,
                           const i32* sscore, const i32* rev,
                           int num_iterations, int max_nondecr,
                           float step_factor, int lookahead, i32* pssm_out,
                           int pssm_stride);
int lara_lagrange_step(void* handle, const i32* lines_ab, int n_lines,
                       i32 gap_score, i32 upper);
int lara_lagrange_result(void* handle, int lib_linear, i32 lib_min,
                         i32 lib_max, i32* cols_out, int capacity,
                         i64* meta_out);
void lara_lagrange_destroy(void* handle);
}

namespace {

constexpr i64 NEG_INF = -1431655764;  // lara::infinity negated (data_types.hpp:77)

inline i64 max3(i64 a, i64 b, i64 c) { return std::max(a, std::max(b, c)); }

// Full M/H/V Gotoh matrices ([la+1] x [lb+1], row-major) over a row-scored
// cell function; border init per edge_filter.hpp:79-97 / oracle.gotoh_matrices.
template <class ScoreAt>
void gotoh_full(int la, int lb, i64 go, i64 ge, ScoreAt score_at, i64* M,
                i64* H, i64* V) {
    const int w = lb + 1;
    M[0] = 0;
    H[0] = NEG_INF;
    V[0] = NEG_INF;
    for (int j = 1; j <= lb; ++j) {
        i64 bg = go + ge * (j - 1);
        M[j] = bg;
        H[j] = bg;
        V[j] = NEG_INF;
    }
    for (int i = 1; i <= la; ++i) {
        i64* Mr = M + i * w;
        i64* Hr = H + i * w;
        i64* Vr = V + i * w;
        const i64* Mp = M + (i - 1) * w;
        const i64* Hp = H + (i - 1) * w;
        const i64* Vp = V + (i - 1) * w;
        i64 bg = go + ge * (i - 1);
        Mr[0] = bg;
        Hr[0] = NEG_INF;
        Vr[0] = bg;
        for (int j = 1; j <= lb; ++j) {
            Mr[j] = max3(Mp[j - 1], Hp[j - 1], Vp[j - 1]) + score_at(i - 1, j - 1);
            Vr[j] = max3(Mp[j] + go, Hp[j] + go, Vp[j] + ge);
            Hr[j] = max3(Mr[j - 1] + go, Vr[j - 1] + go, Hr[j - 1] + ge);
        }
    }
}

// Combined max(M, H, V) per cell, used by the edge filter (only the
// elementwise best matters for prefix/suffix scores).
template <class ScoreAt>
void gotoh_best(int la, int lb, i64 go, i64 ge, ScoreAt score_at, i64* best) {
    const int w = lb + 1;
    // rolling rows for M/H/V; `best` is filled as we go
    vector<i64> Mp(w), Hp(w), Vp(w), Mr(w), Hr(w), Vr(w);
    Mp[0] = 0;
    Hp[0] = NEG_INF;
    Vp[0] = NEG_INF;
    best[0] = 0;
    for (int j = 1; j <= lb; ++j) {
        i64 bg = go + ge * (j - 1);
        Mp[j] = bg;
        Hp[j] = bg;
        Vp[j] = NEG_INF;
        best[j] = bg;
    }
    for (int i = 1; i <= la; ++i) {
        i64 bg = go + ge * (i - 1);
        Mr[0] = bg;
        Hr[0] = NEG_INF;
        Vr[0] = bg;
        best[i * w] = bg;
        for (int j = 1; j <= lb; ++j) {
            Mr[j] = max3(Mp[j - 1], Hp[j - 1], Vp[j - 1]) + score_at(i - 1, j - 1);
            Vr[j] = max3(Mp[j] + go, Hp[j] + go, Vp[j] + ge);
            Hr[j] = max3(Mr[j - 1] + go, Vr[j - 1] + go, Hr[j - 1] + ge);
            best[i * w + j] = max3(Mr[j], Hr[j], Vr[j]);
        }
        std::swap(Mp, Mr);
        std::swap(Hp, Hr);
        std::swap(Vp, Vr);
    }
}

enum { ST_M = 0, ST_H = 1, ST_V = 2 };

}  // namespace

extern "C" {

// Edge prefilter (generateEdges, edge_filter.hpp:131-158): forward +
// reversed Gotoh over the substitution matrix; keep (a, b) iff
// prefix + s(a,b) + suffix >= opt - subopt.  Returns 0 ok, -1 on the
// forward/backward optimal-score mismatch assert.
int lara_baseline_edge_filter(int la, int lb, const i32* seq_a,
                              const i32* seq_b, const i32* submat, int alpha,
                              i32 go, i32 ge, i32 subopt, uint8_t* active_out,
                              i64* opt_out) {
    const int w = lb + 1;
    vector<i64> fwd((la + 1) * (i64)w), bwd((la + 1) * (i64)w);
    auto sub_f = [&](int a, int b) -> i64 {
        return submat[seq_a[a] * alpha + seq_b[b]];
    };
    auto sub_r = [&](int a, int b) -> i64 {
        return submat[seq_a[la - 1 - a] * alpha + seq_b[lb - 1 - b]];
    };
    gotoh_best(la, lb, go, ge, sub_f, fwd.data());
    gotoh_best(la, lb, go, ge, sub_r, bwd.data());
    i64 opt = fwd[la * (i64)w + lb];
    if (opt != bwd[la * (i64)w + lb]) return -1;  // edge_filter.hpp:141
    i64 cut = opt - (i64)subopt;
    for (int a = 0; a < la; ++a)
        for (int b = 0; b < lb; ++b) {
            i64 total = fwd[a * (i64)w + b] + sub_f(a, b) +
                        bwd[(la - 1 - a) * (i64)w + (lb - 1 - b)];
            active_out[a * lb + b] = total >= cut ? 1 : 0;
        }
    *opt_out = opt;
    return 0;
}

// Full single-thread per-pair solve.  Model arrays as in
// lara_lagrange_create; cols_out receives (a, b, weight) triplets.
// meta_out: [n_cols, best_lower, best_upper, iterations].
// Returns n_cols, or -1 on invariant failure / capacity overflow.
int lara_baseline_solve(int la, int lb, const i32* seq_score,
                        const uint8_t* active, int n_dual, const i32* dual_l,
                        const i32* dual_m, const i32* sscore, const i32* rev,
                        i32 go, i32 ge, int num_iterations, int max_nondecr,
                        float step_factor, int lookahead, int lib_linear,
                        i32 lib_min, i32 lib_max, i32* cols_out, int capacity,
                        i64* meta_out) {
    vector<i32> pssm((i64)la * lb);
    void* solver = lara_lagrange_create(
        la, lb, seq_score, active, n_dual, dual_l, dual_m, sscore, rev,
        num_iterations, max_nondecr, step_factor, lookahead, pssm.data(), lb);
    if (!solver) return -1;

    const int w = lb + 1;
    vector<i64> M((la + 1) * (i64)w), H((la + 1) * (i64)w),
        V((la + 1) * (i64)w);
    vector<i32> lines(2 * std::min(la, lb));
    auto score_at = [&](int a, int b) -> i64 { return pssm[a * (i64)lb + b]; };

    int status = 0;
    while (status == 0) {
        // ---- relaxed problem: Gotoh DP over the current PSSM ----
        gotoh_full(la, lb, go, ge, score_at, M.data(), H.data(), V.data());
        i64 mf = M[la * (i64)w + lb], hf = H[la * (i64)w + lb],
            vf = V[la * (i64)w + lb];
        i64 upper = max3(mf, hf, vf);
        // end-state preference M > H > V (oracle.align_pssm)
        int state = mf == upper ? ST_M : (hf == upper ? ST_H : ST_V);

        // ---- traceback: lines + affine gap score ----
        int i = la, j = lb;
        int n_lines = 0;
        i64 gap_score = 0;
        while (i > 0 || j > 0) {
            if (i == 0)
                state = ST_H;
            else if (j == 0)
                state = ST_V;
            if (state == ST_M) {
                --i;
                --j;
                lines[2 * n_lines] = i;
                lines[2 * n_lines + 1] = j;
                ++n_lines;
                i64 target = M[(i + 1) * (i64)w + (j + 1)] - score_at(i, j);
                // predecessor preference M > H > V
                if (M[i * (i64)w + j] == target)
                    state = ST_M;
                else if (H[i * (i64)w + j] == target)
                    state = ST_H;
                else
                    state = ST_V;
            } else if (state == ST_H) {
                i64 target = H[i * (i64)w + j];
                --j;
                // preference H (extend) > M > V; gap char costs ge when the
                // run continues left, go at the run head (lagrange.hpp:147-221)
                if (H[i * (i64)w + j] + ge == target) {
                    state = ST_H;
                    gap_score += ge;
                } else {
                    gap_score += go;
                    state = (M[i * (i64)w + j] + go == target) ? ST_M : ST_V;
                }
            } else {  // ST_V
                i64 target = V[i * (i64)w + j];
                --i;
                if (V[i * (i64)w + j] + ge == target) {
                    state = ST_V;
                    gap_score += ge;
                } else {
                    gap_score += go;
                    state = (M[i * (i64)w + j] + go == target) ? ST_M : ST_H;
                }
            }
        }
        // lines were collected end-to-start; the step expects ascending order
        for (int k = 0; k < n_lines / 2; ++k) {
            std::swap(lines[2 * k], lines[2 * (n_lines - 1 - k)]);
            std::swap(lines[2 * k + 1], lines[2 * (n_lines - 1 - k) + 1]);
        }

        status = lara_lagrange_step(solver, lines.data(), n_lines,
                                    (i32)gap_score, (i32)upper);
        if (status < 0) {
            lara_lagrange_destroy(solver);
            return -1;
        }
    }

    int n = lara_lagrange_result(solver, lib_linear, lib_min, lib_max,
                                 cols_out, capacity, meta_out);
    lara_lagrange_destroy(solver);
    return n;
}

}  // extern "C"
