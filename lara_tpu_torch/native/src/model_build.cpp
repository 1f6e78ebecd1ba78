// Native interaction-model build: the per-pair dual table constructed in C++.
//
// Vector math (seq-score grid, edge filter) stays in NumPy/XLA; this covers
// the irregular part of the Lagrange constructor -- candidate enumeration
// over (head contact x tail contact) pairs with the non-crossing predicate,
// edge-major ordering, reverse-index resolution and the static matching
// queue permutation (reference/src/lagrange.hpp:264-300,
// matching.hpp:149-151).  Bit-identical to
// lara_tpu_torch.solver.interactions.build_pair_model (fuzz-pinned in
// tests/test_interactions_native.py); the float32 structScore arithmetic
// replicates NumPy's operation order exactly.
//
// C ABI for ctypes; no Python.h.

#include <algorithm>
#include <cstdint>
#include <vector>

typedef int32_t i32;
typedef int64_t i64;
using std::vector;

extern "C" {

// Returns the number of dual entries written (D), or -1 if `cap` is too
// small.  Arrays out_l/out_m/out_s/out_rev/out_qperm each hold `cap` i32.
int lara_build_model(int la, int lb, const uint8_t* active,
                     const i32* pa, const float* wa, int ka,
                     const i32* pb, const float* wb, int kb,
                     float balance,
                     i32* out_l, i32* out_m, i32* out_s,
                     i32* out_rev, i32* out_qperm, int cap) {
    struct Entry {
        i32 m;
        i32 s;
    };
    vector<Entry> run;
    run.reserve((size_t)ka * kb);
    int d = 0;
    for (int a = 0; a < la; ++a) {
        for (int b = 0; b < lb; ++b) {
            if (!active[(size_t)a * lb + b]) continue;
            run.clear();
            for (int x = 0; x < ka; ++x) {
                const i32 a2 = pa[(size_t)a * ka + x];
                if (a2 < 0) continue;
                const float wh = wa[(size_t)a * ka + x];
                for (int y = 0; y < kb; ++y) {
                    const i32 b2 = pb[(size_t)b * kb + y];
                    if (b2 < 0) continue;
                    if (!active[(size_t)a2 * lb + b2]) continue;
                    const bool noncross =
                        (a < a2 && b < b2) || (a2 < a && b2 < b);
                    if (!noncross) continue;
                    // structScore in float32, NumPy's operation order:
                    // ((balance * (wh+wt)) / 2) * 8192, then trunc
                    const float wt = wb[(size_t)b * kb + y];
                    const float ss =
                        balance * (wh + wt) / 2.0f * 8192.0f;
                    run.push_back(Entry{a2 * lb + b2, (i32)ss});
                }
            }
            if (run.empty()) continue;
            if (d + (int)run.size() > cap) return -1;
            // edge-major invariant: partners ascending within the run
            std::sort(run.begin(), run.end(),
                      [](const Entry& u, const Entry& v) { return u.m < v.m; });
            const i32 l = a * lb + b;
            for (const Entry& e : run) {
                out_l[d] = l;
                out_m[d] = e.m;
                out_s[d] = e.s;
                ++d;
            }
        }
    }

    // reverse index: (m, l) always exists; entries are sorted by (l, m), so
    // binary search over the run of out_l == m for partner l
    for (int i = 0; i < d; ++i) {
        const i32 l = out_l[i];
        const i32 m = out_m[i];
        // first entry with out_l == m
        int lo = 0, hi = d;
        while (lo < hi) {
            const int mid = (lo + hi) / 2;
            if (out_l[mid] < m || (out_l[mid] == m && out_m[mid] < l))
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo >= d || out_l[lo] != m || out_m[lo] != l) return -2;
        out_rev[i] = lo;
    }

    // static matching-queue order: sort by (-2*s, l, m), stable over the
    // already (l, m)-sorted entries (matching.hpp:149-151)
    for (int i = 0; i < d; ++i) out_qperm[i] = i;
    std::stable_sort(out_qperm, out_qperm + d, [&](i32 u, i32 v) {
        const i64 ku = -2 * (i64)out_s[u];
        const i64 kv = -2 * (i64)out_s[v];
        return ku < kv;  // ties keep (l, m) order by stability
    });
    return d;
}

}  // extern "C"
