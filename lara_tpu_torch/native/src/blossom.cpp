// Maximum-weight matching on general graphs, O(V^3) blossom algorithm.
//
// Native replacement for LEMON's MaxWeightedMatching used by the reference's
// exact-matching escape hatch (-m 0, reference/src/matching.hpp:201-238).
// Implements the primal-dual blossom-shrinking method (Galil's formulation,
// following van Rantwijk's well-known presentation): maintain vertex/blossom
// dual variables, grow alternating trees from free vertices, shrink odd
// cycles into blossoms, augment along zero-slack edges, and adjust duals by
// the minimum of the four classic delta terms.  Weights are int64; all
// arithmetic is exact (S-S edge slacks stay even, so delta3 = slack/2 is an
// integer).
//
// Exposed as a C ABI for ctypes; no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <vector>

using std::vector;
typedef long long ll;

namespace {

struct MaxWeightMatching {
    int nvertex = 0, nedge = 0;
    vector<int> eu, ev;          // edge endpoints
    vector<ll> wt;               // edge weights
    vector<int> endpoint;        // endpoint[p] = vertex at endpoint p (p = 2k|2k+1)
    vector<vector<int>> neighbend;  // remote endpoints incident to v

    vector<int> mate;            // mate[v] = remote endpoint, or -1
    vector<int> label;           // per vertex/blossom: 0 free, 1 S, 2 T (bit 4 = visited)
    vector<int> labelend;
    vector<int> inblossom;       // top-level blossom containing v
    vector<int> blossomparent;
    vector<vector<int>> blossomchilds;
    vector<int> blossombase;
    vector<vector<int>> blossomendps;
    vector<int> bestedge;        // least-slack edge candidates (delta2/delta3)
    vector<vector<int>> blossombestedges;
    vector<int> unusedblossoms;
    vector<ll> dualvar;
    vector<char> allowedge;
    vector<int> queue_;

    ll slack(int k) const { return dualvar[eu[k]] + dualvar[ev[k]] - 2 * wt[k]; }

    void blossomLeaves(int b, vector<int>& out) const {
        if (b < nvertex) {
            out.push_back(b);
        } else {
            for (int t : blossomchilds[b]) blossomLeaves(t, out);
        }
    }

    static int wrap(int j, int n) {
        int r = j % n;
        return r < 0 ? r + n : r;
    }

    void assignLabel(int w, int t, int p) {
        int b = inblossom[w];
        label[w] = label[b] = t;
        labelend[w] = labelend[b] = p;
        bestedge[w] = bestedge[b] = -1;
        if (t == 1) {
            blossomLeaves(b, queue_);
        } else {
            int base = blossombase[b];
            assignLabel(endpoint[mate[base]], 1, mate[base] ^ 1);
        }
    }

    // Trace back from both ends of edge (v, w); return base vertex of the new
    // blossom if the paths meet (odd cycle), else -1 (augmenting path).
    int scanBlossom(int v, int w) {
        vector<int> path;
        int base = -1;
        while (v != -1 || w != -1) {
            int b = inblossom[v];
            if (label[b] & 4) {
                base = blossombase[b];
                break;
            }
            path.push_back(b);
            label[b] |= 4;
            if (labelend[b] == -1) {
                v = -1;
            } else {
                v = endpoint[labelend[b]];
                b = inblossom[v];
                v = endpoint[labelend[b]];
            }
            if (w != -1) std::swap(v, w);
        }
        for (int b : path) label[b] &= ~4;
        return base;
    }

    void addBlossom(int base, int k) {
        int v = eu[k], w = ev[k];
        int bb = inblossom[base], bv = inblossom[v], bw = inblossom[w];
        int b = unusedblossoms.back();
        unusedblossoms.pop_back();
        blossombase[b] = base;
        blossomparent[b] = -1;
        blossomparent[bb] = b;
        vector<int> path, endps;
        while (bv != bb) {
            blossomparent[bv] = b;
            path.push_back(bv);
            endps.push_back(labelend[bv]);
            v = endpoint[labelend[bv]];
            bv = inblossom[v];
        }
        path.push_back(bb);
        std::reverse(path.begin(), path.end());
        std::reverse(endps.begin(), endps.end());
        endps.push_back(2 * k);
        while (bw != bb) {
            blossomparent[bw] = b;
            path.push_back(bw);
            endps.push_back(labelend[bw] ^ 1);
            w = endpoint[labelend[bw]];
            bw = inblossom[w];
        }
        // attach children BEFORE relabeling: blossomLeaves(b) must see them
        blossomchilds[b] = path;
        blossomendps[b] = std::move(endps);
        label[b] = 1;
        labelend[b] = labelend[bb];
        dualvar[b] = 0;
        vector<int> leaves;
        blossomLeaves(b, leaves);
        for (int leaf : leaves) {
            if (label[inblossom[leaf]] == 2) queue_.push_back(leaf);
            inblossom[leaf] = b;
        }
        // recompute least-slack edges to other S-blossoms
        vector<int> bestedgeto(2 * nvertex, -1);
        for (int child : path) {
            vector<int> nblist;
            if (blossombestedges[child].empty()) {
                vector<int> childLeaves;
                blossomLeaves(child, childLeaves);
                for (int leaf : childLeaves)
                    for (int p : neighbend[leaf]) nblist.push_back(p / 2);
            } else {
                nblist = blossombestedges[child];
            }
            for (int kk : nblist) {
                int i = eu[kk], j = ev[kk];
                if (inblossom[j] == b) std::swap(i, j);
                int bj = inblossom[j];
                if (bj != b && label[bj] == 1 &&
                    (bestedgeto[bj] == -1 || slack(kk) < slack(bestedgeto[bj])))
                    bestedgeto[bj] = kk;
            }
            blossombestedges[child].clear();
            bestedge[child] = -1;
        }
        blossombestedges[b].clear();
        for (int kk : bestedgeto)
            if (kk != -1) blossombestedges[b].push_back(kk);
        bestedge[b] = -1;
        for (int kk : blossombestedges[b])
            if (bestedge[b] == -1 || slack(kk) < slack(bestedge[b])) bestedge[b] = kk;
    }

    void expandBlossom(int b, bool endstage) {
        for (int s : blossomchilds[b]) {
            blossomparent[s] = -1;
            if (s < nvertex) {
                inblossom[s] = s;
            } else if (endstage && dualvar[s] == 0) {
                expandBlossom(s, endstage);
            } else {
                vector<int> leaves;
                blossomLeaves(s, leaves);
                for (int v : leaves) inblossom[v] = s;
            }
        }
        if (!endstage && label[b] == 2) {
            // relabel the cycle: the T-structure through this blossom survives
            int entrychild = inblossom[endpoint[labelend[b] ^ 1]];
            int n = (int)blossomchilds[b].size();
            int j = 0;
            while (blossomchilds[b][j] != entrychild) ++j;
            int jstep, endptrick;
            if (j & 1) {
                j -= n;
                jstep = 1;
                endptrick = 0;
            } else {
                jstep = -1;
                endptrick = 1;
            }
            int p = labelend[b];
            while (j != 0) {
                label[endpoint[p ^ 1]] = 0;
                label[endpoint[blossomendps[b][wrap(j - endptrick, n)] ^ endptrick ^ 1]] = 0;
                assignLabel(endpoint[p ^ 1], 2, p);
                allowedge[blossomendps[b][wrap(j - endptrick, n)] / 2] = 1;
                j += jstep;
                p = blossomendps[b][wrap(j - endptrick, n)] ^ endptrick;
                allowedge[p / 2] = 1;
                j += jstep;
            }
            int bv = blossomchilds[b][wrap(j, n)];
            label[endpoint[p ^ 1]] = label[bv] = 2;
            labelend[endpoint[p ^ 1]] = labelend[bv] = p;
            bestedge[bv] = -1;
            j += jstep;
            while (blossomchilds[b][wrap(j, n)] != entrychild) {
                bv = blossomchilds[b][wrap(j, n)];
                if (label[bv] == 1) {
                    j += jstep;
                    continue;
                }
                vector<int> leaves;
                blossomLeaves(bv, leaves);
                int v = -1;
                for (int leaf : leaves)
                    if (label[leaf] != 0) {
                        v = leaf;
                        break;
                    }
                if (v != -1) {
                    label[v] = 0;
                    label[endpoint[mate[blossombase[bv]]]] = 0;
                    assignLabel(v, 2, labelend[v]);
                }
                j += jstep;
            }
        }
        label[b] = labelend[b] = -1;
        blossomchilds[b].clear();
        blossomendps[b].clear();
        blossombase[b] = -1;
        blossombestedges[b].clear();
        bestedge[b] = -1;
        unusedblossoms.push_back(b);
    }

    // Rotate blossom b so vertex v becomes its base; fix matching inside.
    void augmentBlossom(int b, int v) {
        int t = v;
        while (blossomparent[t] != b) t = blossomparent[t];
        if (t >= nvertex) augmentBlossom(t, v);
        int n = (int)blossomchilds[b].size();
        int i = 0;
        while (blossomchilds[b][i] != t) ++i;
        int j = i, jstep, endptrick;
        if (i & 1) {
            j -= n;
            jstep = 1;
            endptrick = 0;
        } else {
            jstep = -1;
            endptrick = 1;
        }
        while (j != 0) {
            j += jstep;
            t = blossomchilds[b][wrap(j, n)];
            int p = blossomendps[b][wrap(j - endptrick, n)] ^ endptrick;
            if (t >= nvertex) augmentBlossom(t, endpoint[p]);
            j += jstep;
            t = blossomchilds[b][wrap(j, n)];
            if (t >= nvertex) augmentBlossom(t, endpoint[p ^ 1]);
            mate[endpoint[p]] = p ^ 1;
            mate[endpoint[p ^ 1]] = p;
        }
        std::rotate(blossomchilds[b].begin(), blossomchilds[b].begin() + i,
                    blossomchilds[b].end());
        std::rotate(blossomendps[b].begin(), blossomendps[b].begin() + i,
                    blossomendps[b].end());
        blossombase[b] = blossombase[blossomchilds[b][0]];
    }

    void augmentMatching(int k) {
        int pairs[2][2] = {{eu[k], 2 * k + 1}, {ev[k], 2 * k}};
        for (auto& sp : pairs) {
            int s = sp[0], p = sp[1];
            for (;;) {
                int bs = inblossom[s];
                if (bs >= nvertex) augmentBlossom(bs, s);
                mate[s] = p;
                if (labelend[bs] == -1) break;
                int t = endpoint[labelend[bs]];
                int bt = inblossom[t];
                s = endpoint[labelend[bt]];
                int j = endpoint[labelend[bt] ^ 1];
                if (bt >= nvertex) augmentBlossom(bt, j);
                mate[j] = labelend[bt];
                p = labelend[bt] ^ 1;
            }
        }
    }

    // Returns mate per vertex (vertex index or -1).
    vector<int> solve(int n, int m, const int* us, const int* vs, const ll* ws) {
        nvertex = n;
        nedge = m;
        eu.assign(us, us + m);
        ev.assign(vs, vs + m);
        wt.assign(ws, ws + m);
        ll maxweight = 0;
        for (int k = 0; k < m; ++k) maxweight = std::max(maxweight, wt[k]);
        endpoint.resize(2 * m);
        neighbend.assign(n, {});
        for (int k = 0; k < m; ++k) {
            endpoint[2 * k] = eu[k];
            endpoint[2 * k + 1] = ev[k];
            neighbend[eu[k]].push_back(2 * k + 1);
            neighbend[ev[k]].push_back(2 * k);
        }
        mate.assign(n, -1);
        label.assign(2 * n, 0);
        labelend.assign(2 * n, -1);
        inblossom.resize(n);
        for (int v = 0; v < n; ++v) inblossom[v] = v;
        blossomparent.assign(2 * n, -1);
        blossomchilds.assign(2 * n, {});
        blossombase.resize(2 * n);
        for (int v = 0; v < n; ++v) blossombase[v] = v;
        for (int b = n; b < 2 * n; ++b) blossombase[b] = -1;
        blossomendps.assign(2 * n, {});
        bestedge.assign(2 * n, -1);
        blossombestedges.assign(2 * n, {});
        unusedblossoms.clear();
        for (int b = n; b < 2 * n; ++b) unusedblossoms.push_back(b);
        dualvar.assign(2 * n, 0);
        for (int v = 0; v < n; ++v) dualvar[v] = maxweight;
        allowedge.assign(m, 0);

        for (int stage = 0; stage < n; ++stage) {
            std::fill(label.begin(), label.end(), 0);
            std::fill(bestedge.begin(), bestedge.end(), -1);
            for (int b = n; b < 2 * n; ++b) blossombestedges[b].clear();
            std::fill(allowedge.begin(), allowedge.end(), 0);
            queue_.clear();
            for (int v = 0; v < n; ++v)
                if (mate[v] == -1 && label[inblossom[v]] == 0) assignLabel(v, 1, -1);
            bool augmented = false;
            for (;;) {
                while (!queue_.empty() && !augmented) {
                    int v = queue_.back();
                    queue_.pop_back();
                    for (int p : neighbend[v]) {
                        int k = p / 2;
                        int w = endpoint[p];
                        if (inblossom[v] == inblossom[w]) continue;
                        ll kslack = 0;
                        if (!allowedge[k]) {
                            kslack = slack(k);
                            if (kslack <= 0) allowedge[k] = 1;
                        }
                        if (allowedge[k]) {
                            if (label[inblossom[w]] == 0) {
                                assignLabel(w, 2, p ^ 1);
                            } else if (label[inblossom[w]] == 1) {
                                int base = scanBlossom(v, w);
                                if (base >= 0) {
                                    addBlossom(base, k);
                                } else {
                                    augmentMatching(k);
                                    augmented = true;
                                    break;
                                }
                            } else if (label[w] == 0) {
                                label[w] = 2;
                                labelend[w] = p ^ 1;
                            }
                        } else if (label[inblossom[w]] == 1) {
                            int b = inblossom[v];
                            if (bestedge[b] == -1 || kslack < slack(bestedge[b]))
                                bestedge[b] = k;
                        } else if (label[w] == 0) {
                            if (bestedge[w] == -1 || kslack < slack(bestedge[w]))
                                bestedge[w] = k;
                        }
                    }
                }
                if (augmented) break;
                // dual update: delta1 (free the duals), delta2 (S-free edge),
                // delta3 (S-S edge), delta4 (T-blossom expansion)
                int deltatype = 1, deltaedge = -1, deltablossom = -1;
                ll delta = dualvar[0];
                for (int v = 1; v < n; ++v) delta = std::min(delta, dualvar[v]);
                for (int v = 0; v < n; ++v) {
                    if (label[inblossom[v]] == 0 && bestedge[v] != -1) {
                        ll d = slack(bestedge[v]);
                        if (d < delta) {
                            delta = d;
                            deltatype = 2;
                            deltaedge = bestedge[v];
                        }
                    }
                }
                for (int b = 0; b < 2 * n; ++b) {
                    if (blossomparent[b] == -1 && label[b] == 1 && bestedge[b] != -1) {
                        ll d = slack(bestedge[b]) / 2;
                        if (d < delta) {
                            delta = d;
                            deltatype = 3;
                            deltaedge = bestedge[b];
                        }
                    }
                }
                for (int b = n; b < 2 * n; ++b) {
                    if (blossombase[b] >= 0 && blossomparent[b] == -1 && label[b] == 2 &&
                        dualvar[b] < delta) {
                        delta = dualvar[b];
                        deltatype = 4;
                        deltablossom = b;
                    }
                }
                for (int v = 0; v < n; ++v) {
                    int l = label[inblossom[v]];
                    if (l == 1)
                        dualvar[v] -= delta;
                    else if (l == 2)
                        dualvar[v] += delta;
                }
                for (int b = n; b < 2 * n; ++b) {
                    if (blossombase[b] >= 0 && blossomparent[b] == -1) {
                        if (label[b] == 1)
                            dualvar[b] += delta;
                        else if (label[b] == 2)
                            dualvar[b] -= delta;
                    }
                }
                if (deltatype == 1) {
                    break;  // optimum reached
                } else if (deltatype == 2) {
                    allowedge[deltaedge] = 1;
                    int i = eu[deltaedge];
                    if (label[inblossom[i]] == 0) i = ev[deltaedge];
                    queue_.push_back(i);
                } else if (deltatype == 3) {
                    allowedge[deltaedge] = 1;
                    queue_.push_back(eu[deltaedge]);
                } else {
                    expandBlossom(deltablossom, false);
                }
            }
            if (!augmented) break;
            for (int b = n; b < 2 * n; ++b)
                if (blossomparent[b] == -1 && blossombase[b] >= 0 && label[b] == 1 &&
                    dualvar[b] == 0)
                    expandBlossom(b, true);
        }
        vector<int> result(n, -1);
        for (int v = 0; v < n; ++v)
            if (mate[v] >= 0) result[v] = endpoint[mate[v]];
        return result;
    }
};

}  // namespace

extern "C" {

// mate_out must hold n ints; returns total matched weight.
ll lara_max_weight_matching(int n, int m, const int* us, const int* vs,
                            const ll* ws, int* mate_out) {
    if (n <= 0) return 0;
    MaxWeightMatching solver;
    vector<int> mate = solver.solve(n, m, us, vs, ws);
    for (int v = 0; v < n; ++v) mate_out[v] = mate[v];
    ll total = 0;
    // total weight: per matched pair, the heaviest edge connecting it
    // (parallel edges are legal input, as in LEMON)
    for (int v = 0; v < n; ++v) {
        int w = mate[v];
        if (w > v) {
            ll best = 0;
            for (int k = 0; k < m; ++k)
                if ((us[k] == v && vs[k] == w) || (us[k] == w && vs[k] == v))
                    best = std::max(best, ws[k]);
            total += best;
        }
    }
    return total;
}
}
