// Native graph query kernels for the pose graph.
//
// The reference keeps its whole graph substrate in C++ (MapperGraph +
// BreadthFirstTraversal, Mapper.cpp:1215-1305; nanoflann KD queries,
// Mapper.cpp:1837-1912). Here the compute path is JAX, but the per-scan
// graph traversals are host-side and O(V) in Python — this library hosts
// them natively: distance-bounded BFS over CSR adjacency and the
// loop-closure candidate sweep (FindPossibleLoopClosure,
// Mapper.cpp:1960-2010).
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC graph_ops.cpp -o libgraph_ops.so
// Bound via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <queue>
#include <vector>

extern "C" {

// Distance-bounded BFS (BreadthFirstTraversal + NearScanVisitor,
// Mapper.cpp:1244-1348): explore from `start`, include nodes whose
// reference position is within sqrt(max_sq) of (cx, cy); expansion only
// continues through included nodes. Marks visited_out[i]=1 for included
// nodes and returns their count (order: BFS discovery order written to
// order_out if non-null).
int64_t bfs_within_radius(
    int64_t n,
    const double* xy,            // (n, 2) reference positions
    const uint8_t* present,      // (n,) 0 = removed (tombstone)
    const int64_t* indptr,       // CSR row offsets (n + 1)
    const int64_t* indices,      // CSR column indices
    int64_t start,
    double cx, double cy, double max_sq,
    uint8_t* visited_out,        // (n,) zeroed by caller
    int64_t* order_out           // (n,) optional
) {
    if (start < 0 || start >= n || !present[start]) return 0;
    std::vector<uint8_t> seen(static_cast<size_t>(n), 0);
    std::queue<int64_t> q;
    q.push(start);
    seen[start] = 1;
    int64_t count = 0;
    while (!q.empty()) {
        int64_t v = q.front();
        q.pop();
        const double dx = xy[2 * v] - cx;
        const double dy = xy[2 * v + 1] - cy;
        if (dx * dx + dy * dy <= max_sq) {
            visited_out[v] = 1;
            if (order_out) order_out[count] = v;
            ++count;
            for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
                const int64_t u = indices[e];
                // stale CSR rows may still point at removed nodes; the
                // real graph no longer has those edges
                if (!present[u]) continue;
                if (!seen[u]) {
                    seen[u] = 1;
                    q.push(u);
                }
            }
        }
    }
    return count;
}

// Loop-closure candidate sweep (FindPossibleLoopClosure,
// Mapper.cpp:1960-2010): walk candidate slots in order; collect those
// within sqrt(max_sq) of (cx, cy) that are not near-linked; when a
// candidate leaves the radius, emit the chain if it has >= min_chain.
// present[i]=0 marks removed scans (skipped). Returns chain length
// (indices into the slot array written to chain_out) and updates
// *start_idx to resume the sweep.
int64_t loop_candidate_sweep(
    int64_t n_slots,
    const double* xy,            // (n_slots, 2) candidate positions
    const uint8_t* present,      // (n_slots,)
    const uint8_t* near_linked,  // (n_slots,) 1 = graph-connected
    double cx, double cy, double max_sq,
    int64_t min_chain,
    int64_t* start_idx,          // in/out
    int64_t* chain_out           // (n_slots,)
) {
    int64_t chain_len = 0;
    int64_t i = *start_idx;
    for (; i < n_slots; ++i) {
        if (!present[i]) continue;
        const double dx = xy[2 * i] - cx;
        const double dy = xy[2 * i + 1] - cy;
        if (dx * dx + dy * dy < max_sq) {
            if (near_linked[i]) {
                chain_len = 0;  // linked scan invalidates the chain
            } else {
                chain_out[chain_len++] = i;
            }
        } else {
            if (chain_len >= min_chain) {
                *start_idx = i + 1;
                return chain_len;
            }
            chain_len = 0;
        }
    }
    *start_idx = i;
    return chain_len;  // trailing chain (caller applies no min per ref)
}

// Near-chain walk (FindNearChains, Mapper.cpp:1683-1793), single-sensor
// slot space: for each near scan (BFS order, slots in state-id order),
// extend a contiguous chain outward while candidates stay within
// sqrt(max_sq) of (cx, cy). Encountering the query scan's slot marks the
// chain invalid (it is still walked and marked processed, like the
// reference). Missing state ids simply do not exist in slot space (the
// reference `continue`s over them). Emits (lo, hi, valid) rows; returns
// the row count.
int64_t near_chains_sweep(
    int64_t n,
    const double* xy,          // (n, 2) reference positions
    const uint8_t* present,    // (n,) 0 = removed (walked over, like the
                               // reference continues over missing ids)
    const int64_t* nears,      // (m,) near slots in BFS order
    int64_t m,
    int64_t scan_slot,         // slot of the query scan, or -1
    double cx, double cy, double max_sq,
    uint8_t* processed,        // (n,) zeroed by caller
    int64_t* out               // (m, 3) rows [lo, hi, valid]
) {
    int64_t cnt = 0;
    for (int64_t k = 0; k < m; ++k) {
        const int64_t s = nears[k];
        if (s == scan_slot || processed[s]) continue;
        processed[s] = 1;
        bool valid = true;
        int64_t lo = s, hi = s + 1;
        for (int64_t i = s - 1; i >= 0; --i) {
            if (i == scan_slot) valid = false;
            if (!present[i]) continue;
            const double dx = xy[2 * i] - cx;
            const double dy = xy[2 * i + 1] - cy;
            if (dx * dx + dy * dy < max_sq) {
                lo = i;
                processed[i] = 1;
            } else {
                break;
            }
        }
        for (int64_t i = s + 1; i < n; ++i) {
            if (i == scan_slot) valid = false;
            if (!present[i]) continue;
            const double dx = xy[2 * i] - cx;
            const double dy = xy[2 * i + 1] - cy;
            if (dx * dx + dy * dy < max_sq) {
                hi = i + 1;
                processed[i] = 1;
            } else {
                break;
            }
        }
        out[3 * cnt] = lo;
        out[3 * cnt + 1] = hi;
        out[3 * cnt + 2] = valid ? 1 : 0;
        ++cnt;
    }
    return cnt;
}

// Radius query over all vertices (FindNearByVertices without the KD tree
// — brute force is faster at these sizes and trivially vectorizes).
int64_t radius_query(
    int64_t n,
    const double* xy,
    double cx, double cy, double max_sq,
    int64_t* out_idx
) {
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double dx = xy[2 * i] - cx;
        const double dy = xy[2 * i + 1] - cy;
        if (dx * dx + dy * dy <= max_sq) out_idx[count++] = i;
    }
    return count;
}

// Viewpoint-independent structure of ScanMatcher::FindValidPoints
// (Mapper.cpp:1113-1164): walk the beam endpoints keeping a trailing
// anchor; every time the current point is > 0.1 m from the anchor, emit a
// delimiter (anchor recorded) and advance. Returns the delimiter count D;
// fills delim_idx (D), anchors (D,2) and next_delim (n) — the delimiter
// that flushes each point, or -1.
int64_t fvp_structure(
    int64_t n,
    const double* xy,          // (n, 2) beam endpoints (local or world)
    int64_t* delim_idx,        // (n,)
    double* anchors,           // (n, 2)
    int64_t* next_delim        // (n,)
) {
    double ax = 0.0, ay = 0.0;
    bool have_anchor = false;
    int64_t d = 0;
    int64_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        next_delim[i] = -1;
        const double px = xy[2 * i];
        const double py = xy[2 * i + 1];
        const bool finite =
            px == px && py == py &&
            px - px == 0.0 && py - py == 0.0;  // not NaN/inf
        if (!have_anchor) {
            if (finite) {
                ax = px; ay = py;
                have_anchor = true;
            }
            continue;
        }
        const double dx = ax - px;
        const double dy = ay - py;
        if (dx * dx + dy * dy > 0.01) {  // (0.1 m)^2, strict >
            delim_idx[d] = i;
            anchors[2 * d] = ax;
            anchors[2 * d + 1] = ay;
            for (int64_t j = prev; j < i; ++j) next_delim[j] = d;
            prev = i;
            ax = px; ay = py;
            ++d;
        }
    }
    return d;
}

// One-call build of the streaming (B, 8) f32 scan pack
// (mapper/streaming.scan_pack): [local_xy, fvp_anchor_xy,
// fvp_current_xy, next_delim, flags(bit0 finite, bit1 delim-valid)].
// Replaces ~10 per-scan numpy ops (~0.14 ms/scan of host time in the
// drain accumulation window — VERDICT r4 next #1b). Bit-identical to
// the numpy path: same fvp_structure walk, same f64->f32 casts.
void scan_pack(
    int64_t n,
    const double* local_xy,    // (n, 2) sensor-frame beam endpoints
    const double* ranges,      // (n,)
    float* pack                // (n, 8) output
) {
    std::vector<int64_t> delim_idx(static_cast<size_t>(n));
    std::vector<double> anchors(static_cast<size_t>(2 * n));
    std::vector<int64_t> next_delim(static_cast<size_t>(n));
    const int64_t d = fvp_structure(
        n, local_xy, delim_idx.data(), anchors.data(), next_delim.data());
    for (int64_t i = 0; i < n; ++i) {
        const double r = ranges[i];
        const bool finite = r == r && r - r == 0.0;
        float* row = pack + 8 * i;
        row[0] = finite ? static_cast<float>(local_xy[2 * i]) : 0.0f;
        row[1] = finite ? static_cast<float>(local_xy[2 * i + 1]) : 0.0f;
        row[2] = 0.0f;
        row[3] = 0.0f;
        row[4] = 0.0f;
        row[5] = 0.0f;
        row[6] = static_cast<float>(next_delim[i]);
        row[7] = static_cast<float>((finite ? 1 : 0) | (i < d ? 2 : 0));
    }
    for (int64_t k = 0; k < d; ++k) {
        float* row = pack + 8 * k;
        row[2] = static_cast<float>(anchors[2 * k]);
        row[3] = static_cast<float>(anchors[2 * k + 1]);
        // current_xy = the f32-cast, ZEROED-if-nonfinite local point at
        // the delimiter index (an infinite point can be a delimiter:
        // the fvp walk's finite check only guards the initial anchor,
        // and inf distances trivially pass the >0.1 m test — the numpy
        // path reads from the already-zeroed pack columns)
        const int64_t di = delim_idx[k];
        const double rr = ranges[di];
        const bool fin = rr == rr && rr - rr == 0.0;
        row[4] = fin ? static_cast<float>(local_xy[2 * di]) : 0.0f;
        row[5] = fin ? static_cast<float>(local_xy[2 * di + 1]) : 0.0f;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Block-sparse SE(2) normal-equation solver.
//
// The reference solves its pose-graph normal equations with Ceres'
// SPARSE_NORMAL_CHOLESKY (recommended config, README.md:164;
// ceres_solver.cpp:25-193). A dense Cholesky serves small graphs
// (solver/se2_solver.py DENSE_MAX_NODES), but beyond that dense is
// O(n^3)/O(n^2) memory and iterative CG needs many steps on loopy graphs.
// This is the large-graph path: a simplicial sparse Cholesky over 3x3
// SE(2) blocks with a minimum-degree fill-reducing ordering, run on the
// host (the analog of Ceres' CPU sparse backend — SURVEY.md section 7.3
// sanctions "sparse-Cholesky-on-host" for exactly this regime).
//
// Matrix model: H is n x n of 3x3 blocks, SPD after gauge fixing (the
// caller zeroes fixed rows/cols and puts 1 on their scalar diagonal).
// Inputs are the block diagonal (n,3,3) and per-edge off-diagonal blocks
// (e,3,3) with H[dst,src] = block^T implied.

namespace {

// 3x3 dense helpers, row-major double[9].
inline bool chol3(const double* a, double* l) {
    // l lower-triangular with a = l l^T; false if not SPD
    double l00s = a[0];
    if (l00s <= 0.0) return false;
    double l00 = std::sqrt(l00s);
    double l10 = a[3] / l00;
    double l20 = a[6] / l00;
    double d1 = a[4] - l10 * l10;
    if (d1 <= 0.0) return false;
    double l11 = std::sqrt(d1);
    double l21 = (a[7] - l20 * l10) / l11;
    double d2 = a[8] - l20 * l20 - l21 * l21;
    if (d2 <= 0.0) return false;
    double l22 = std::sqrt(d2);
    l[0] = l00; l[1] = 0.0; l[2] = 0.0;
    l[3] = l10; l[4] = l11; l[5] = 0.0;
    l[6] = l20; l[7] = l21; l[8] = l22;
    return true;
}

// out = x * inv(l)^T  (solve out * l^T = x), l lower-triangular; per row
// forward substitution on l * out_row^T = x_row^T.
inline void solve_right_lt(const double* l, const double* x, double* out) {
    for (int r = 0; r < 3; ++r) {
        const double* xr = x + 3 * r;
        double* or_ = out + 3 * r;
        or_[0] = xr[0] / l[0];
        or_[1] = (xr[1] - l[3] * or_[0]) / l[4];
        or_[2] = (xr[2] - l[6] * or_[0] - l[7] * or_[1]) / l[8];
    }
}

// v := inv(l) v (forward substitution, 3-vector)
inline void fsub3(const double* l, double* v) {
    v[0] = v[0] / l[0];
    v[1] = (v[1] - l[3] * v[0]) / l[4];
    v[2] = (v[2] - l[6] * v[0] - l[7] * v[1]) / l[8];
}

// v := inv(l)^T v (back substitution with the transpose)
inline void bsub3(const double* l, double* v) {
    v[2] = v[2] / l[8];
    v[1] = (v[1] - l[7] * v[2]) / l[4];
    v[0] = (v[0] - l[3] * v[1] - l[6] * v[2]) / l[0];
}

// c -= a * b^T
inline void gemm_nt_sub(const double* a, const double* b, double* c) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            c[3 * i + j] -= a[3 * i] * b[3 * j] +
                            a[3 * i + 1] * b[3 * j + 1] +
                            a[3 * i + 2] * b[3 * j + 2];
        }
}

// v -= a * w  (3x3 times 3-vector)
inline void gemv_sub(const double* a, const double* w, double* v) {
    for (int i = 0; i < 3; ++i)
        v[i] -= a[3 * i] * w[0] + a[3 * i + 1] * w[1] + a[3 * i + 2] * w[2];
}

// v -= a^T * w
inline void gemv_t_sub(const double* a, const double* w, double* v) {
    for (int i = 0; i < 3; ++i)
        v[i] -= a[i] * w[0] + a[3 + i] * w[1] + a[6 + i] * w[2];
}

// Minimum-degree ordering on the node graph (plain MD with explicit
// clique formation — pose graphs have degree ~3-6 so the quotient-graph
// machinery of AMD is not needed at these sizes). perm[new] = old.
void min_degree_order(
    int64_t n, const std::vector<std::vector<int64_t>>& adj_in,
    std::vector<int64_t>& perm) {
    std::vector<std::vector<int64_t>> adj(adj_in);  // sorted unique rows
    std::vector<char> eliminated(static_cast<size_t>(n), 0);
    // lazy min-heap of (degree, node); stale entries skipped on pop
    typedef std::pair<int64_t, int64_t> DN;
    std::priority_queue<DN, std::vector<DN>, std::greater<DN>> heap;
    for (int64_t i = 0; i < n; ++i)
        heap.push({static_cast<int64_t>(adj[i].size()), i});
    perm.clear();
    perm.reserve(static_cast<size_t>(n));
    std::vector<int64_t> merged;
    while (!heap.empty()) {
        DN top = heap.top();
        heap.pop();
        int64_t v = top.second;
        if (eliminated[v]) continue;
        if (top.first != static_cast<int64_t>(adj[v].size())) {
            heap.push({static_cast<int64_t>(adj[v].size()), v});
            continue;  // stale degree
        }
        eliminated[v] = 1;
        perm.push_back(v);
        // form the clique among v's active neighbors
        std::vector<int64_t>& nb = adj[v];
        for (size_t a = 0; a < nb.size(); ++a) {
            int64_t u = nb[a];
            if (eliminated[u]) continue;
            // new adj[u] = (adj[u] ∪ nb) \ {u, v, eliminated}
            merged.clear();
            merged.reserve(adj[u].size() + nb.size());
            std::merge(adj[u].begin(), adj[u].end(), nb.begin(), nb.end(),
                       std::back_inserter(merged));
            std::vector<int64_t>& au = adj[u];
            au.clear();
            int64_t prev = -1;
            for (int64_t w : merged) {
                if (w == prev || w == u || eliminated[w]) continue;
                au.push_back(w);
                prev = w;
            }
            heap.push({static_cast<int64_t>(au.size()), u});
        }
        nb.clear();
        nb.shrink_to_fit();
    }
}

}  // namespace

namespace {

// Symbolic analysis, reusable across LM iterations (the pattern is fixed
// within one Compute(); only the damped values change).
struct CholSymbolic {
    int64_t n = 0;
    std::vector<int64_t> perm;    // perm[new] = old
    std::vector<int64_t> parent;  // etree
    // permuted strict-lower pattern of A by row: (col, edge tag);
    // tag = +(k+1) stores off[k], -(k+1) stores off[k]^T
    std::vector<std::vector<std::pair<int64_t, int64_t>>> rowpat;
    std::vector<int64_t> Lp;      // block column pointers (n+1)
    std::vector<int64_t> Li;      // row indices (nnz)
};

CholSymbolic* chol_analyze_impl(
    int64_t n, int64_t e, const int64_t* src, const int64_t* dst) {
    auto* S = new CholSymbolic();
    S->n = n;
    // -- adjacency (unique, no self loops) --------------------------------
    std::vector<std::vector<int64_t>> adj(static_cast<size_t>(n));
    for (int64_t k = 0; k < e; ++k) {
        int64_t s = src[k], d = dst[k];
        if (s == d || s < 0 || d < 0 || s >= n || d >= n) continue;
        adj[s].push_back(d);
        adj[d].push_back(s);
    }
    for (int64_t i = 0; i < n; ++i) {
        std::sort(adj[i].begin(), adj[i].end());
        adj[i].erase(std::unique(adj[i].begin(), adj[i].end()),
                     adj[i].end());
    }
    min_degree_order(n, adj, S->perm);
    std::vector<int64_t> iperm(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) iperm[S->perm[i]] = i;

    S->rowpat.resize(static_cast<size_t>(n));
    for (int64_t k = 0; k < e; ++k) {
        int64_t s = src[k], d = dst[k];
        if (s == d || s < 0 || d < 0 || s >= n || d >= n) continue;
        int64_t ps = iperm[s], pd = iperm[d];
        // block H[s,d] = off[k] (tag +), H[d,s] = off[k]^T (tag -);
        // store the strict-lower entry of the permuted matrix
        if (ps > pd) S->rowpat[ps].push_back({pd, k + 1});
        else S->rowpat[pd].push_back({ps, -(k + 1)});
    }
    for (int64_t i = 0; i < n; ++i)
        std::sort(S->rowpat[i].begin(), S->rowpat[i].end());

    // -- elimination tree (liu's algorithm with path compression) ---------
    S->parent.assign(static_cast<size_t>(n), -1);
    std::vector<int64_t> ancestor(static_cast<size_t>(n), -1);
    for (int64_t k2 = 0; k2 < n; ++k2) {
        for (const auto& pc : S->rowpat[k2]) {
            int64_t i = pc.first;
            while (i != -1 && i < k2) {
                int64_t next = ancestor[i];
                ancestor[i] = k2;
                if (next == -1) { S->parent[i] = k2; break; }
                i = next;
            }
        }
    }

    // -- column counts via ereach ------------------------------------------
    std::vector<int64_t> mark(static_cast<size_t>(n), -1);
    std::vector<int64_t> colcount(static_cast<size_t>(n), 0);
    for (int64_t k2 = 0; k2 < n; ++k2) {
        mark[k2] = k2;
        for (const auto& pc : S->rowpat[k2]) {
            int64_t i = pc.first;
            while (mark[i] != k2) {
                mark[i] = k2;
                ++colcount[i];
                i = S->parent[i];
                if (i == -1 || i >= k2) break;
            }
        }
    }
    S->Lp.assign(static_cast<size_t>(n) + 1, 0);
    for (int64_t i = 0; i < n; ++i) S->Lp[i + 1] = S->Lp[i] + colcount[i];
    S->Li.resize(static_cast<size_t>(S->Lp[n]));
    return S;
}

// Numeric factor + solve against a prepared symbolic analysis.
// Returns nnz(L) or -1 on pivot failure.
int64_t chol_factor_solve_impl(
    CholSymbolic* S, const double* diag, const double* off,
    const double* b, double* x) {
    const int64_t n = S->n;
    const std::vector<int64_t>& Lp = S->Lp;
    std::vector<int64_t>& Li = S->Li;
    const int64_t nnz = Lp[n];
    std::vector<double> Lx(static_cast<size_t>(nnz) * 9);
    std::vector<double> Ld(static_cast<size_t>(n) * 9);  // diag factors
    std::vector<int64_t> Lnext(Lp.begin(), Lp.end() - 1);  // fill cursors

    // -- numeric: up-looking block rows ------------------------------------
    std::vector<double> xwork(static_cast<size_t>(n) * 9, 0.0);
    std::vector<int64_t> mark(static_cast<size_t>(n), -1);
    std::vector<int64_t> estack(static_cast<size_t>(n));
    double dwork[9];
    double lkj[9];
    for (int64_t k2 = 0; k2 < n; ++k2) {
        // scatter A row k2 (strict lower) into xwork; collect ereach
        int64_t top = n;
        mark[k2] = k2;
        for (const auto& pc : S->rowpat[k2]) {
            int64_t c = pc.first;
            int64_t tag = pc.second;
            const double* blk = off + 9 * (std::llabs(tag) - 1);
            double* xc = xwork.data() + 9 * c;
            if (tag > 0) {
                for (int t = 0; t < 9; ++t) xc[t] += blk[t];
            } else {
                for (int r = 0; r < 3; ++r)
                    for (int cc = 0; cc < 3; ++cc)
                        xc[3 * r + cc] += blk[3 * cc + r];
            }
            // walk up the etree to collect the row pattern
            int64_t i = c, len = 0;
            while (mark[i] != k2) {
                mark[i] = k2;
                estack[len++] = i;
                i = S->parent[i];
                if (i == -1 || i >= k2) break;
            }
            while (len > 0) estack[--top] = estack[--len];
        }
        // diagonal accumulator
        const double* dk = diag + 9 * S->perm[k2];
        for (int t = 0; t < 9; ++t) dwork[t] = dk[t];
        // process pattern ascending (estack[top..n-1] holds disjoint
        // ascending path segments; sort to get global ascending order)
        std::sort(estack.begin() + top, estack.end());
        for (int64_t si = top; si < n; ++si) {
            int64_t j = estack[si];
            double* xj = xwork.data() + 9 * j;
            solve_right_lt(Ld.data() + 9 * j, xj, lkj);
            for (int t = 0; t < 9; ++t) xj[t] = 0.0;
            // update x with column j of L (rows r: j < r < k2)
            for (int64_t p = Lp[j]; p < Lnext[j]; ++p) {
                gemm_nt_sub(lkj, Lx.data() + 9 * p,
                            xwork.data() + 9 * Li[p]);
            }
            gemm_nt_sub(lkj, lkj, dwork);
            // append L[k2, j]
            int64_t p = Lnext[j]++;
            Li[p] = k2;
            std::memcpy(Lx.data() + 9 * p, lkj, 9 * sizeof(double));
        }
        if (!chol3(dwork, Ld.data() + 9 * k2)) return -1;
    }

    // -- triangular solves --------------------------------------------------
    // y = inv(L) P b ; x = P^T inv(L)^T y
    std::vector<double> y(static_cast<size_t>(n) * 3);
    for (int64_t i = 0; i < n; ++i) {
        const double* bi = b + 3 * S->perm[i];
        y[3 * i] = bi[0]; y[3 * i + 1] = bi[1]; y[3 * i + 2] = bi[2];
    }
    for (int64_t j = 0; j < n; ++j) {
        double* yj = y.data() + 3 * j;
        fsub3(Ld.data() + 9 * j, yj);
        for (int64_t p = Lp[j]; p < Lnext[j]; ++p) {
            gemv_sub(Lx.data() + 9 * p, yj, y.data() + 3 * Li[p]);
        }
    }
    for (int64_t j = n - 1; j >= 0; --j) {
        double* yj = y.data() + 3 * j;
        for (int64_t p = Lp[j]; p < Lnext[j]; ++p) {
            gemv_t_sub(Lx.data() + 9 * p, y.data() + 3 * Li[p], yj);
        }
        bsub3(Ld.data() + 9 * j, yj);
    }
    for (int64_t i = 0; i < n; ++i) {
        double* xi = x + 3 * S->perm[i];
        xi[0] = y[3 * i]; xi[1] = y[3 * i + 1]; xi[2] = y[3 * i + 2];
    }
    return nnz;
}

// -- SE(2) normal-equation assembly ------------------------------------------
// The host LM's assembly (solver/se2_solver.py host_sparse_lm) in one pass
// over the edges. Every value takes the IEEE operations of the NumPy twin
// (_np_normal_blocks, _np_chi2) in the same order, so the results are
// bit-identical: the element-wise terms as written there; np.einsum's
// contractions over j = 0, 1, 2 from a zero start, except its dot product
// of a sqrt_info row with the residual, which its two-lane loop sums as
// (t0 + t2) + t1; np.add.at's scatter, every src contribution in edge
// order before every dst one; np.sum's pairwise sum for chi2. The
// transcendental parts (cos and sin of the source heading, the wrapped
// heading residual) are NumPy's, passed in. Build without FMA contraction.

// numpy's pairwise summation (blocks of 128 with 8 accumulators)
double pairwise_sum(const double* a, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        double r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        double res = ((r[0] + r[1]) + (r[2] + r[3])) +
                     ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// Edge k's whitened residual r (3) and, with ja/jb non-null, its whitened
// Jacobians (row-major 3x3) with respect to the source and the target.
inline void edge_terms(
    int64_t k, const int64_t* src, const int64_t* dst, const double* poses,
    const double* rel, const double* sqrt_info, const double* ca,
    const double* sa, const double* rth, double* r, double* ja,
    double* jb) {
    const double* pa = poses + 3 * src[k];
    const double* pb = poses + 3 * dst[k];
    const double* rl = rel + 3 * k;
    const double* S = sqrt_info + 9 * k;
    const double c = ca[k], s = sa[k];
    const double dx = pb[0] - pa[0];
    const double dy = pb[1] - pa[1];
    const double v[3] = {(c * dx + s * dy) - rl[0],
                         (-s * dx + c * dy) - rl[1], rth[k]};
    for (int i = 0; i < 3; ++i) {
        const double* si = S + 3 * i;
        const double lane0 = (si[0] * v[0] + 0.0) + si[2] * v[2];
        const double lane1 = (si[1] * v[1] + 0.0) + 0.0;
        r[i] = 0.0 + (lane0 + lane1);
    }
    if (ja == nullptr) return;
    const double ra[9] = {-c, -s, -s * dx + c * dy,
                          s, -c, -c * dx - s * dy,
                          0.0, 0.0, -1.0};
    const double rb[9] = {c, s, 0.0, -s, c, 0.0, 0.0, 0.0, 1.0};
    for (int i = 0; i < 3; ++i) {
        const double* si = S + 3 * i;
        for (int m = 0; m < 3; ++m) {
            ja[3 * i + m] = ((0.0 + si[0] * ra[m]) + si[1] * ra[3 + m]) +
                            si[2] * ra[6 + m];
            jb[3 * i + m] = ((0.0 + si[0] * rb[m]) + si[1] * rb[3 + m]) +
                            si[2] * rb[6 + m];
        }
    }
}

// out (3x3) = a^T b, summed over rows 0, 1, 2 from a zero start
inline void at_b(const double* a, const double* b, double* out) {
    for (int i = 0; i < 3; ++i)
        for (int m = 0; m < 3; ++m)
            out[3 * i + m] = ((0.0 + a[i] * b[m]) + a[3 + i] * b[3 + m]) +
                             a[6 + i] * b[6 + m];
}

// out (3) = -(a^T r)
inline void neg_at_r(const double* a, const double* r, double* out) {
    for (int i = 0; i < 3; ++i)
        out[i] = -(((0.0 + a[i] * r[0]) + a[3 + i] * r[1]) + a[6 + i] * r[2]);
}

}  // namespace

extern "C" {

// Stateful API: analyze once per Compute() (ordering + etree + pattern),
// then factor+solve per LM iteration with only the values changing.
void* sparse_chol_analyze(
    int64_t n, int64_t e, const int64_t* src, const int64_t* dst) {
    return chol_analyze_impl(n, e, src, dst);
}

int64_t sparse_chol_factor_solve(
    void* handle, const double* diag, const double* off,
    const double* b, double* x) {
    return chol_factor_solve_impl(
        static_cast<CholSymbolic*>(handle), diag, off, b, x);
}

void sparse_chol_free(void* handle) {
    delete static_cast<CholSymbolic*>(handle);
}

// One-shot convenience wrapper (analyze + factor + solve).
// Returns nnz(L) in blocks on success, -1 if a diagonal pivot fails
// (caller falls back to the iterative path).
int64_t sparse_block_solve(
    int64_t n, int64_t e,
    const int64_t* src, const int64_t* dst,  // (e,) node indices
    const double* diag,   // (n, 9) damped gauge-fixed diagonal blocks
    const double* off,    // (e, 9) H[src[k], dst[k]] blocks
    const double* b,      // (n, 3)
    double* x             // (n, 3) out
) {
    CholSymbolic* S = chol_analyze_impl(n, e, src, dst);
    int64_t nnz = chol_factor_solve_impl(S, diag, off, b, x);
    delete S;
    return nnz;
}

// The normal equations' blocks of e edges over n poses: diag (n, 9) and
// grad (n, 3) overwritten, hab (e, 9) the H[src[k], dst[k]] blocks.
// Returns chi2, the sum of the squared whitened residuals.
double se2_normal_blocks(
    int64_t n, int64_t e, const int64_t* src, const int64_t* dst,
    const double* poses, const double* rel, const double* sqrt_info,
    const double* ca, const double* sa, const double* rth,
    double* diag, double* hab, double* grad) {
    std::fill(diag, diag + 9 * n, 0.0);
    std::fill(grad, grad + 3 * n, 0.0);
    // the dst contributions, added after every src one
    std::unique_ptr<double[]> rr(new double[3 * e]);
    std::unique_ptr<double[]> hbb(new double[9 * e]);
    std::unique_ptr<double[]> gb(new double[3 * e]);
    double r[3], ja[9], jb[9], blk[9], g[3];
    for (int64_t k = 0; k < e; ++k) {
        edge_terms(k, src, dst, poses, rel, sqrt_info, ca, sa, rth, r, ja,
                   jb);
        for (int i = 0; i < 3; ++i) rr[3 * k + i] = r[i] * r[i];
        at_b(ja, ja, blk);
        double* d = diag + 9 * src[k];
        for (int m = 0; m < 9; ++m) d[m] += blk[m];
        at_b(ja, jb, hab + 9 * k);
        at_b(jb, jb, hbb.get() + 9 * k);
        neg_at_r(ja, r, g);
        double* gs = grad + 3 * src[k];
        for (int i = 0; i < 3; ++i) gs[i] += g[i];
        neg_at_r(jb, r, gb.get() + 3 * k);
    }
    for (int64_t k = 0; k < e; ++k) {
        double* d = diag + 9 * dst[k];
        for (int m = 0; m < 9; ++m) d[m] += hbb[9 * k + m];
        double* gd = grad + 3 * dst[k];
        for (int i = 0; i < 3; ++i) gd[i] += gb[3 * k + i];
    }
    return 0.0 + pairwise_sum(rr.get(), 3 * e);
}

// chi2 alone: se2_normal_blocks' return value without the blocks.
double se2_chi2(
    int64_t e, const int64_t* src, const int64_t* dst, const double* poses,
    const double* rel, const double* sqrt_info, const double* ca,
    const double* sa, const double* rth) {
    std::unique_ptr<double[]> rr(new double[3 * e]);
    double r[3];
    for (int64_t k = 0; k < e; ++k) {
        edge_terms(k, src, dst, poses, rel, sqrt_info, ca, sa, rth, r,
                   nullptr, nullptr);
        for (int i = 0; i < 3; ++i) rr[3 * k + i] = r[i] * r[i];
    }
    return 0.0 + pairwise_sum(rr.get(), 3 * e);
}

// Occupancy ray accumulation for BULK map rebuilds (the 500k-node merge),
// a host loop over every beam step. The cell sequence is IDENTICAL to
// kernels/occupancy.trace_beams (closed-form Bresenham
// minor(k) = (2k*dy + dx) / (2dx), endpoint pass+hit per RayTrace,
// Karto.h:6217-6231) — equivalence is golden-tested.
void occupancy_raster(
    const int32_t* start_cells,  // (n, 2) sensor cell (x, y) per beam
    const int32_t* end_cells,    // (n, 2) endpoint cell
    const uint8_t* beam_valid,   // (n,)
    const uint8_t* end_valid,    // (n,)
    int64_t n, int64_t width, int64_t height,
    int32_t* pass_cnt,           // (height, width), accumulated in place
    int32_t* hit_cnt             // (height, width)
) {
    for (int64_t i = 0; i < n; ++i) {
        if (!beam_valid[i]) continue;
        int64_t x0 = start_cells[2 * i], y0 = start_cells[2 * i + 1];
        int64_t x1 = end_cells[2 * i], y1 = end_cells[2 * i + 1];
        const bool steep = std::llabs(y1 - y0) > std::llabs(x1 - x0);
        int64_t ax0 = steep ? y0 : x0, ay0 = steep ? x0 : y0;
        int64_t ax1 = steep ? y1 : x1, ay1 = steep ? x1 : y1;
        if (ax0 > ax1) { std::swap(ax0, ax1); std::swap(ay0, ay1); }
        const int64_t dx = ax1 - ax0;
        const int64_t dy = std::llabs(ay1 - ay0);
        const int64_t ystep = (ay0 < ay1) ? 1 : -1;
        const int64_t dx2 = 2 * std::max<int64_t>(dx, 1);
        for (int64_t k = 0; k <= dx; ++k) {
            const int64_t minor = ay0 + ystep * ((2 * k * dy + dx) / dx2);
            const int64_t px = steep ? minor : ax0 + k;
            const int64_t py = steep ? ax0 + k : minor;
            if (px >= 0 && px < width && py >= 0 && py < height) {
                ++pass_cnt[py * width + px];
            }
        }
        if (end_valid[i] && x1 >= 0 && x1 < width && y1 >= 0 &&
            y1 < height) {
            ++pass_cnt[y1 * width + x1];
            ++hit_cnt[y1 * width + x1];
        }
    }
}

// Augment a base undirected-CSR with k new edges, reproducing
// pose_graph._query_structure's numpy augmentation layout BIT-EXACTLY
// (new src-half entries extend each row's src segment at segend0, new
// dst-half entries append at the row tail; equal insert positions keep
// (pos, src) lexicographic stable order — the np.lexsort + np.insert
// semantics). One native call replaces ~15 numpy ops that ran once per
// drained scan on the host bookkeeping path.
void augment_csr(
    int64_t n, int64_t ne0,
    const int64_t* indptr0,   // (n+1,) base row pointers
    const int64_t* indices0,  // (ne0,) base adjacency
    const int64_t* segend0,   // (n,) src-segment end per row
    int64_t k,
    const int64_t* es,        // (k,) new edge sources
    const int64_t* ed,        // (k,) new edge destinations
    int64_t* out_indptr,      // (n+1,)
    int64_t* out_indices      // (ne0 + 2k,)
) {
    const int64_t m = 2 * k;
    std::vector<int64_t> bsrc(m), bdst(m), pos(m), ord(m);
    for (int64_t i = 0; i < k; ++i) {
        bsrc[i] = es[i]; bdst[i] = ed[i]; pos[i] = segend0[es[i]];
        bsrc[k + i] = ed[i]; bdst[k + i] = es[i];
        pos[k + i] = indptr0[ed[i] + 1];
    }
    for (int64_t i = 0; i < m; ++i) ord[i] = i;
    std::stable_sort(ord.begin(), ord.end(),
                     [&](int64_t a, int64_t b) {
                         if (pos[a] != pos[b]) return pos[a] < pos[b];
                         return bsrc[a] < bsrc[b];
                     });
    // merged indices: walk the base array, splicing sorted inserts
    int64_t src_i = 0, ins_i = 0, out_i = 0;
    while (ins_i < m || src_i < ne0) {
        if (ins_i < m && pos[ord[ins_i]] <= src_i) {
            out_indices[out_i++] = bdst[ord[ins_i++]];
        } else {
            out_indices[out_i++] = indices0[src_i++];
        }
    }
    // indptr: base + running count of new half-edges per source row
    std::vector<int64_t> cnt(n + 1, 0);
    for (int64_t i = 0; i < m; ++i) ++cnt[bsrc[i] + 1];
    int64_t run = 0;
    out_indptr[0] = indptr0[0];
    for (int64_t r = 0; r < n; ++r) {
        run += cnt[r + 1];
        out_indptr[r + 1] = indptr0[r + 1] + run;
    }
}

// The lifelong decay's reading overlap (computeReadingOverlapRatio,
// slam_toolbox_lifelong.cpp:455-478) of n candidates in one pass: row i
// counts its sensor-frame points points[start[i] .. start[i] + count[i])
// whose world position, at the sensor pose (x, y, cos, sin) pose[i],
// lies strictly inside bounds[i] = (x_l, x_u, y_l, y_u). Each point is
// moved as LocalizedScan.points_world moves it, x + c*lx - s*ly and
// y + s*lx + c*ly left to right (no contraction: -ffp-contract=off), so
// the counts equal NumPy's on the same doubles.
void decay_reading_overlap(
    int64_t n,
    const int64_t* start,     // (n,) first row of each candidate's points
    const int64_t* count,     // (n,) its number of points
    const double* points,     // (rows, 2) filtered sensor-frame points
    const double* pose,       // (n, 4) x, y, cos, sin of the sensor pose
    const double* bounds,     // (n, 4) x_l, x_u, y_l, y_u
    int64_t* inside           // (n,) out: points strictly inside
) {
    for (int64_t i = 0; i < n; ++i) {
        const double x = pose[4 * i], y = pose[4 * i + 1];
        const double c = pose[4 * i + 2], s = pose[4 * i + 3];
        const double xl = bounds[4 * i], xu = bounds[4 * i + 1];
        const double yl = bounds[4 * i + 2], yu = bounds[4 * i + 3];
        const double* p = points + 2 * start[i];
        int64_t k = 0;
        for (int64_t j = 0; j < count[i]; ++j) {
            const double lx = p[2 * j], ly = p[2 * j + 1];
            const double wx = x + c * lx - s * ly;
            const double wy = y + s * lx + c * ly;
            k += (wx > xl) & (wx < xu) & (wy > yl) & (wy < yu);
        }
        inside[i] = k;
    }
}

// LocalizedScan.bounding_box of n scans whose pose moved, in one pass:
// row i's box over its sensor position (x, y) of pose[i] = (x, y, cos,
// sin) and its points rows start[i] .. start[i] + count[i] moved as
// decay_reading_overlap moves them, written as (min x, min y, max x,
// max y) to box[i]. Min and max are exact, so the boxes equal NumPy's.
void decay_boxes(
    int64_t n,
    const int64_t* start,     // (n,) first row of each scan's points
    const int64_t* count,     // (n,) its number of points
    const double* points,     // (rows, 2) filtered sensor-frame points
    const double* pose,       // (n, 4) x, y, cos, sin of the sensor pose
    double* box               // (n, 4) out
) {
    for (int64_t i = 0; i < n; ++i) {
        const double x = pose[4 * i], y = pose[4 * i + 1];
        const double c = pose[4 * i + 2], s = pose[4 * i + 3];
        double x0 = x, y0 = y, x1 = x, y1 = y;
        const double* p = points + 2 * start[i];
        for (int64_t j = 0; j < count[i]; ++j) {
            const double lx = p[2 * j], ly = p[2 * j + 1];
            const double wx = x + c * lx - s * ly;
            const double wy = y + s * lx + c * ly;
            x0 = std::min(x0, wx);
            x1 = std::max(x1, wx);
            y0 = std::min(y0, wy);
            y1 = std::max(y1, wy);
        }
        box[4 * i] = x0;
        box[4 * i + 1] = y0;
        box[4 * i + 2] = x1;
        box[4 * i + 3] = y1;
    }
}

}  // extern "C"
