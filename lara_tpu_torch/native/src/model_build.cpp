// Native interaction-model build: a chunk's per-pair dual tables constructed
// in C++.
//
// The edge filter runs on the device; the seq-score grid is gathered on the
// device from the sequences (and on the host only where a reader asks for
// it, lara_tpu_torch.solver.interactions.PairModel.seq_score).  This covers
// the irregular part of the Lagrange constructor -- candidate enumeration
// over (head contact x tail contact) pairs with the non-crossing predicate,
// edge-major ordering, reverse-index resolution and the static matching
// queue permutation (reference/src/lagrange.hpp:264-300,
// matching.hpp:149-151) -- for every pair of a chunk at once, on its own
// threads, with no Python in between: ctypes releases the interpreter's
// lock for the whole call.  Bit-identical to the NumPy mirror
// lara_tpu_torch.solver.interactions._build_pair_model_numpy and to
// lara_tpu.solver.interactions.build_pair_model (tests/
// test_torch_model_build.py); the float32 structScore arithmetic replicates
// NumPy's operation order exactly.
//
// C ABI for ctypes; no Python.h.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

typedef int32_t i32;
typedef int64_t i64;
using std::vector;

namespace {

// One pair's inputs: its [la, lb] active grid, row a at active + a *
// row_stride bytes, and its padded adjacency tables (partners, pad -1, and
// weights, [la, ka] and [lb, kb]).
struct PairIn {
    int la, lb;
    const uint8_t* active;
    i64 row_stride;
    const i32* pa;
    const float* wa;
    int ka;
    const i32* pb;
    const float* wb;
    int kb;
    float balance;
};

// One pair's dual columns (edge-major) and its build's seconds.
struct PairOut {
    vector<i32> l, m, s, rev, q;
    double seconds = 0.0;
};

bool has_partner(const i32* partners, int k) {
    for (int x = 0; x < k; ++x)
        if (partners[x] >= 0) return true;
    return false;
}

// The per-pair build; returns 0, or -2 if the table is not symmetric.
int build_pair(const PairIn& in, PairOut& out) {
    struct Entry {
        i32 m;
        i32 s;
    };
    const int la = in.la, lb = in.lb, ka = in.ka, kb = in.kb;
    auto active = [&](int a, int b) {
        return in.active[a * in.row_stride + b] != 0;
    };
    // a cell whose row or column has no contact has no candidate: skip it
    vector<uint8_t> b_contact(lb);
    for (int b = 0; b < lb; ++b)
        b_contact[b] = has_partner(in.pb + (size_t)b * kb, kb);
    vector<Entry> run;
    run.reserve((size_t)ka * kb);
    for (int a = 0; a < la; ++a) {
        if (!has_partner(in.pa + (size_t)a * ka, ka)) continue;
        for (int b = 0; b < lb; ++b) {
            if (!b_contact[b] || !active(a, b)) continue;
            run.clear();
            for (int x = 0; x < ka; ++x) {
                const i32 a2 = in.pa[(size_t)a * ka + x];
                if (a2 < 0) continue;
                const float wh = in.wa[(size_t)a * ka + x];
                for (int y = 0; y < kb; ++y) {
                    const i32 b2 = in.pb[(size_t)b * kb + y];
                    if (b2 < 0) continue;
                    if (!active(a2, b2)) continue;
                    const bool noncross =
                        (a < a2 && b < b2) || (a2 < a && b2 < b);
                    if (!noncross) continue;
                    // structScore in float32, NumPy's operation order:
                    // ((balance * (wh+wt)) / 2) * 8192, then trunc
                    const float wt = in.wb[(size_t)b * kb + y];
                    const float ss =
                        in.balance * (wh + wt) / 2.0f * 8192.0f;
                    run.push_back(Entry{a2 * lb + b2, (i32)ss});
                }
            }
            if (run.empty()) continue;
            // edge-major invariant: partners ascending within the run
            std::sort(run.begin(), run.end(),
                      [](const Entry& u, const Entry& v) { return u.m < v.m; });
            const i32 l = a * lb + b;
            for (const Entry& e : run) {
                out.l.push_back(l);
                out.m.push_back(e.m);
                out.s.push_back(e.s);
            }
        }
    }
    const int d = (int)out.l.size();
    const i32* ol = out.l.data();
    const i32* om = out.m.data();

    // reverse index: (m, l) always exists; entries are sorted by (l, m), so
    // binary search over the run of out_l == m for partner l
    out.rev.resize(d);
    for (int i = 0; i < d; ++i) {
        const i32 l = ol[i];
        const i32 m = om[i];
        // first entry with out_l == m
        int lo = 0, hi = d;
        while (lo < hi) {
            const int mid = (lo + hi) / 2;
            if (ol[mid] < m || (ol[mid] == m && om[mid] < l))
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo >= d || ol[lo] != m || om[lo] != l) return -2;
        out.rev[i] = lo;
    }

    // static matching-queue order: sort by (-2*s, l, m), stable over the
    // already (l, m)-sorted entries (matching.hpp:149-151)
    out.q.resize(d);
    for (int i = 0; i < d; ++i) out.q[i] = i;
    const i32* os = out.s.data();
    std::stable_sort(out.q.begin(), out.q.end(), [&](i32 u, i32 v) {
        const i64 ku = -2 * (i64)os[u];
        const i64 kv = -2 * (i64)os[v];
        return ku < kv;  // ties keep (l, m) order by stability
    });
    return 0;
}

struct Chunk {
    vector<PairOut> pairs;
};

}  // namespace

extern "C" {

// Builds the models of a chunk of n pairs on min(threads, n) threads, the
// caller's among them; each takes the next pair not yet taken.  Pair k's
// active grid is active + k * lane_stride bytes, its row a + a * row_stride
// bytes further; pa[k]/wa[k] and pb[k]/wb[k] are its padded adjacency
// tables of ka[k] and kb[k] columns.  Writes each pair's dual count to
// out_d[k] and its build's seconds to out_seconds[k], and the chunk to
// *handle for lara_chunk_take.  Returns 0; -2 if a pair's interaction table
// is not symmetric, -3 if memory ran out (*handle is then null).
int lara_build_chunk(int n, const uint8_t* active, i64 lane_stride,
                     i64 row_stride, const i32* la, const i32* lb,
                     const i32* const* pa, const float* const* wa,
                     const i32* ka, const i32* const* pb,
                     const float* const* wb, const i32* kb,
                     const float* balance, int threads, i32* out_d,
                     double* out_seconds, void** handle) {
    *handle = nullptr;
    Chunk* chunk = new (std::nothrow) Chunk;
    if (!chunk) return -3;
    std::atomic<int> next(0);
    std::atomic<int> status(0);
    auto work = [&]() {
        for (int k = next++; k < n && status.load() == 0; k = next++) {
            const PairIn in{la[k], lb[k], active + (i64)k * lane_stride,
                            row_stride, pa[k], wa[k], ka[k], pb[k], wb[k],
                            kb[k], balance[k]};
            PairOut& out = chunk->pairs[k];
            const auto start = std::chrono::steady_clock::now();
            int rc;
            try {
                rc = build_pair(in, out);
            } catch (const std::exception&) {
                rc = -3;
            }
            out.seconds = std::chrono::duration<double>(
                std::chrono::steady_clock::now() - start).count();
            if (rc) {
                int zero = 0;
                status.compare_exchange_strong(zero, rc);
            }
        }
    };
    vector<std::thread> pool;
    try {
        chunk->pairs.resize(n);
        pool.reserve(std::max(0, std::min(threads, n) - 1));
    } catch (const std::bad_alloc&) {
        delete chunk;
        return -3;
    }
    for (int t = 1; t < std::min(threads, n); ++t) {
        try {
            pool.emplace_back(work);
        } catch (const std::system_error&) {
            break;  // a thread that cannot start leaves its pairs to the rest
        }
    }
    work();
    for (std::thread& t : pool) t.join();
    if (status.load()) {
        delete chunk;
        return status.load();
    }
    for (int k = 0; k < n; ++k) {
        out_d[k] = (i32)chunk->pairs[k].l.size();
        out_seconds[k] = chunk->pairs[k].seconds;
    }
    *handle = chunk;
    return 0;
}

// Copies a lara_build_chunk's dual columns into out, [5, total] int32 (l, m,
// s, rev, qperm; each row the pairs' entries in pair order), where out is
// not null and total is the sum of the pairs' dual counts, and frees the
// chunk.
void lara_chunk_take(void* handle, i32* out, i64 total) {
    Chunk* chunk = static_cast<Chunk*>(handle);
    i64 sum = 0;
    for (const PairOut& p : chunk->pairs) sum += (i64)p.l.size();
    if (out && sum == total) {
        i64 off = 0;
        for (const PairOut& p : chunk->pairs) {
            const vector<i32>* cols[5] = {&p.l, &p.m, &p.s, &p.rev, &p.q};
            for (int c = 0; c < 5; ++c)
                std::memcpy(out + c * total + off, cols[c]->data(),
                            cols[c]->size() * sizeof(i32));
            off += (i64)p.l.size();
        }
    }
    delete chunk;
}

}  // extern "C"
