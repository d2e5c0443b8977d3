// Block Thomas (LDL^T) factorization of the odometry chain's
// block-tridiagonal system, and its two solve sweeps.
//
// Replaces no Pallas kernel: it is the counterpart of the three lax.scans
// of slam_toolbox_tpu/solver/chain_precond.py (factorize :82, apply's
// forward :162 and backward :172 sweeps), which XLA runs as sequential
// loops of 3x3 block ops inside lm_solve's jitted CG loop. The port's plain
// versions (solver/chain_precond.py factorize, apply) are Python loops of
// tiny tensor ops, O(n) launches a call; this is one launch a call.
//
//   chain_factorize: S_0 = D_0, S_i = D_i - U_{i-1}^T Sinv_{i-1} U_{i-1},
//                    Sinv_i = inv3(S_i) (adjugate / det, |det| below 1e-20
//                    taken as 1e-20), fixed nodes' D_i the identity; then
//                    T_i = U_i^T Sinv_i and W_i = Sinv_i U_i.
//   chain_apply:     y_0 = f_0 r_0, y_i = f_i r_i - T_{i-1} y_{i-1};
//                    w_i = Sinv_i y_i; z_{n-1} = w_{n-1},
//                    z_i = w_i - W_i z_{i+1}; out_i = f_i z_i.
//
// Bound on the H100: neither bytes nor operations. The function reads and
// writes each 3x3 block once (about 46 values a node to factorize, 34 to
// apply; at n = 2,100 in f32 0.1 us at 3.35 TB/s), but its floor is n
// dependent 3x3 steps: a row's inverse needs the previous row's.
//
// Design: one block of 256 threads per system. Warp 0 runs the dependent
// chain, its lanes owning the entries of the step's 3x3 (factorize) or
// 3-vector (apply) operations. To factorize, lane e < 9 forms entry e of
// S_i, the nine entries go to every lane by shuffles, lane e forms its
// cofactor and divides it by the determinant (whose row-0 terms come by
// shuffles too), and the nine entries of Sinv_i go round again for the
// next row: the nine divisions of a row run side by side, where one
// thread would run them one after another. The sweeps' rows are three
// products, which every lane repeats in registers. The chain reads only
// registers: each row's operands are loaded from shared memory one row
// ahead. The other seven warps stage the next tile of kTile rows (D and
// U; or T, r and f; or W, w and f) into shared memory ahead of the chain
// and compute the independent products (T and W; w) for the tile the
// chain passed before the last barrier. A __syncthreads between tiles
// orders all of it (and makes the chain's global writes visible to the
// other warps).
//
// Exactness: the arithmetic is the plain version's expression by
// expression (with --fmad=false nothing is contracted); the 3x3 products
// sum in another order than PyTorch's matmul, so the two agree to
// rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;
constexpr unsigned kFull = 0xffffffffu;

// P^T Q for 3x3 row-major blocks (out[r][c] = sum_k P[k][r] Q[k][c])
template <typename T>
__device__ __forceinline__ T tmul_entry(const T* P, const T* Q, int r, int c) {
    return P[r] * Q[c] + P[3 + r] * Q[3 + c] + P[6 + r] * Q[6 + c];
}

// P Q
template <typename T>
__device__ __forceinline__ T mul_entry(const T* P, const T* Q, int r, int c) {
    return P[3 * r] * Q[c] + P[3 * r + 1] * Q[3 + c] + P[3 * r + 2] * Q[6 + c];
}

// M v
template <typename T>
__device__ __forceinline__ T mv_entry(const T* M, const T* v, int r) {
    return M[3 * r] * v[0] + M[3 * r + 1] * v[1] + M[3 * r + 2] * v[2];
}

// T_i = U_i^T Sinv_i and W_i = Sinv_i U_i for rows [lo, hi), by threads
// [first, first + count) of the block
template <typename T>
__device__ void tw_rows(const T* __restrict__ U, const T* Sinv, T* Tm, T* W,
                        int lo, int hi, int first, int count) {
    for (int k = threadIdx.x - first; k < (hi - lo) * 9; k += count) {
        const int i = lo + k / 9, e = k % 9, r = e / 3, c = e % 3;
        const T* u = U + (size_t)i * 9;
        const T* s = Sinv + (size_t)i * 9;
        Tm[(size_t)i * 9 + e] = tmul_entry(u, s, r, c);
        W[(size_t)i * 9 + e] = mul_entry(s, u, r, c);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_factorize_kernel(const T* __restrict__ D, const T* __restrict__ U,
                       const T* __restrict__ f, int n, T* __restrict__ Sinv,
                       T* __restrict__ Tm, T* __restrict__ W) {
    // buffer b holds rows [t kTile, (t + 1) kTile) of tile t = b mod 2:
    // D_i projected, and U_{i-1} (row 0's unused)
    __shared__ T sD[2][kTile * 9];
    __shared__ T sU[2][kTile * 9];
    const int tiles = (n + kTile - 1) / kTile;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int stagers = kThreads - 32;

    auto stage = [&](int t, int first, int count) {
        const int lo = t * kTile, rows = min(kTile, n - lo);
        T* d = sD[t & 1];
        T* u = sU[t & 1];
        for (int k = threadIdx.x - first; k < rows * 9; k += count) {
            const int i = lo + k / 9, e = k % 9;
            d[k] = f[i] > (T)0 ? D[(size_t)i * 9 + e]
                               : (e % 4 == 0 ? (T)1 : (T)0);
            if (i > 0) u[k] = U[(size_t)(i - 1) * 9 + e];
        }
    };

    stage(0, 0, kThreads);
    __syncthreads();
    // lane e owns entry e = (r, c) of the row's 3x3 blocks (lanes past 8
    // shadow entry 8); P is Sinv of the previous row, in every lane
    const int e = min(lane, 8), r = e / 3, c = e % 3;
    // the lanes holding the four entries of the minor lane e's cofactor
    // takes: adj[r][c] = (-1)^(r+c) (S[c1][r1] S[c2][r2] - S[c1][r2] S[c2][r1])
    const int c1 = c == 0 ? 1 : 0, c2 = c == 2 ? 1 : 2;
    const int r1 = r == 0 ? 1 : 0, r2 = r == 2 ? 1 : 2;
    const bool odd = (r + c) & 1;
    T P[9];
    for (int t = 0; t < tiles; ++t) {
        if (warp == 0) {
            const int lo = t * kTile, rows = min(kTile, n - lo);
            const T* d = sD[t & 1];
            const T* u = sU[t & 1];
            // the next row's operands: D_i[r][c], and columns r and c of
            // U_{i-1}
            T dn = d[e], urn[3], ucn[3];
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                urn[m] = u[3 * m + r];
                ucn[m] = u[3 * m + c];
            }
            for (int k = 0; k < rows; ++k) {
                const int i = lo + k;
                const T de = dn;
                T ur[3], uc[3];
#pragma unroll
                for (int m = 0; m < 3; ++m) {
                    ur[m] = urn[m];
                    uc[m] = ucn[m];
                }
                if (k + 1 < rows) {
                    const int next = (k + 1) * 9;
                    dn = d[next + e];
#pragma unroll
                    for (int m = 0; m < 3; ++m) {
                        urn[m] = u[next + 3 * m + r];
                        ucn[m] = u[next + 3 * m + c];
                    }
                }
                // S_i[r][c] = D_i[r][c] - ((U^T Sinv_prev) U)[r][c], the
                // product in the plain version's order
                T Se = de;
                if (i > 0) {
                    T a[3];
#pragma unroll
                    for (int l = 0; l < 3; ++l)
                        a[l] = ur[0] * P[l] + ur[1] * P[3 + l] +
                               ur[2] * P[6 + l];
                    Se = de - (a[0] * uc[0] + a[1] * uc[1] + a[2] * uc[2]);
                }
                const T x1 = __shfl_sync(kFull, Se, c1 * 3 + r1);
                const T x2 = __shfl_sync(kFull, Se, c2 * 3 + r2);
                const T x3 = __shfl_sync(kFull, Se, c1 * 3 + r2);
                const T x4 = __shfl_sync(kFull, Se, c2 * 3 + r1);
                const T minor = x1 * x2 - x3 * x4;
                const T adj = odd ? -minor : minor;
                // det = a A + b B + c C: row 0 of S, and the cofactors
                // adj[0][0], adj[1][0], adj[2][0] of lanes 0, 3 and 6
                const T a = __shfl_sync(kFull, Se, 0);
                const T b = __shfl_sync(kFull, Se, 1);
                const T cc = __shfl_sync(kFull, Se, 2);
                const T A = __shfl_sync(kFull, adj, 0);
                const T B = __shfl_sync(kFull, adj, 3);
                const T C = __shfl_sync(kFull, adj, 6);
                T det = a * A + b * B + cc * C;
                // NaN fails the comparison and stays, as in the plain version
                if (fabs(det) < (T)1e-20) det = (T)1e-20;
                const T pe = adj / det;
                if (lane < 9) Sinv[(size_t)i * 9 + lane] = pe;
#pragma unroll
                for (int m = 0; m < 9; ++m) P[m] = __shfl_sync(kFull, pe, m);
            }
        } else {
            if (t + 1 < tiles) stage(t + 1, 32, stagers);
            if (t > 0)
                tw_rows(U, Sinv, Tm, W, (t - 1) * kTile,
                        min(t * kTile, n - 1), 32, stagers);
        }
        __syncthreads();
    }
    tw_rows(U, Sinv, Tm, W, (tiles - 1) * kTile, n - 1, 0, kThreads);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_apply_kernel(const T* __restrict__ Sinv, const T* __restrict__ Tm,
                   const T* __restrict__ W, const T* __restrict__ r,
                   const T* __restrict__ f, int n, T* __restrict__ z) {
    // a tile's rows: the 3x3 operator (T_{i-1} forward, W_i backward), the
    // vector (r_i forward, w_i backward) and f_i
    __shared__ T sM[2][kTile * 9];
    __shared__ T sV[2][kTile * 3];
    __shared__ T sF[2][kTile];
    const int tiles = (n + kTile - 1) / kTile;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int stagers = kThreads - 32;

    // forward: buffer of tile t holds T_{i-1} (row 0's unused) and r_i
    auto stage_fwd = [&](int t, int first, int count) {
        const int lo = t * kTile, rows = min(kTile, n - lo);
        for (int k = threadIdx.x - first; k < rows * 13; k += count) {
            const int row = k / 13, e = k % 13, i = lo + row;
            if (e < 9) {
                if (i > 0) sM[t & 1][row * 9 + e] = Tm[(size_t)(i - 1) * 9 + e];
            } else if (e < 12) {
                sV[t & 1][row * 3 + e - 9] = r[(size_t)i * 3 + e - 9];
            } else {
                sF[t & 1][row] = f[i];
            }
        }
    };
    // w_i = Sinv_i y_i in place over y, rows [lo, hi)
    auto w_rows = [&](int lo, int hi, int first, int count) {
        for (int i = lo + threadIdx.x - first; i < hi; i += count) {
            const T* s = Sinv + (size_t)i * 9;
            T y[3] = {z[(size_t)i * 3], z[(size_t)i * 3 + 1],
                      z[(size_t)i * 3 + 2]};
            z[(size_t)i * 3] = mv_entry(s, y, 0);
            z[(size_t)i * 3 + 1] = mv_entry(s, y, 1);
            z[(size_t)i * 3 + 2] = mv_entry(s, y, 2);
        }
    };

    stage_fwd(0, 0, kThreads);
    __syncthreads();
    T v[3];   // the previous row's y (forward) or z (backward)
    for (int t = 0; t < tiles; ++t) {
        if (warp == 0) {
            const int lo = t * kTile, rows = min(kTile, n - lo);
            const T* m = sM[t & 1];
            const T* rv = sV[t & 1];
            const T* fv = sF[t & 1];
            // the next row's operands, loaded a row ahead
            T mn[9], rn[3], fn = fv[0];
#pragma unroll
            for (int q = 0; q < 9; ++q) mn[q] = m[q];
#pragma unroll
            for (int q = 0; q < 3; ++q) rn[q] = rv[q];
            for (int k = 0; k < rows; ++k) {
                const int i = lo + k;
                T mk[9], rk[3];
                const T fk = fn;
#pragma unroll
                for (int q = 0; q < 9; ++q) mk[q] = mn[q];
#pragma unroll
                for (int q = 0; q < 3; ++q) rk[q] = rn[q];
                if (k + 1 < rows) {
#pragma unroll
                    for (int q = 0; q < 9; ++q) mn[q] = m[(k + 1) * 9 + q];
#pragma unroll
                    for (int q = 0; q < 3; ++q) rn[q] = rv[(k + 1) * 3 + q];
                    fn = fv[k + 1];
                }
                T y[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const T ri = rk[c] * fk;
                    y[c] = i == 0 ? ri : ri - mv_entry(mk, v, c);
                }
#pragma unroll
                for (int c = 0; c < 3; ++c) v[c] = y[c];
                if (lane < 3)
                    z[(size_t)i * 3 + lane] =
                        lane == 0 ? y[0] : (lane == 1 ? y[1] : y[2]);
            }
        } else {
            if (t + 1 < tiles) stage_fwd(t + 1, 32, stagers);
            if (t > 0) w_rows((t - 1) * kTile, t * kTile, 32, stagers);
        }
        __syncthreads();
    }
    w_rows((tiles - 1) * kTile, n, 0, kThreads);
    __syncthreads();

    // backward, tiles from the last: buffer of tile t holds W_i (row n-1's
    // unused), w_i and f_i
    auto stage_bwd = [&](int t, int first, int count) {
        const int lo = t * kTile, rows = min(kTile, n - lo);
        for (int k = threadIdx.x - first; k < rows * 13; k += count) {
            const int row = k / 13, e = k % 13, i = lo + row;
            if (e < 9) {
                if (i < n - 1) sM[t & 1][row * 9 + e] = W[(size_t)i * 9 + e];
            } else if (e < 12) {
                sV[t & 1][row * 3 + e - 9] = z[(size_t)i * 3 + e - 9];
            } else {
                sF[t & 1][row] = f[i];
            }
        }
    };
    stage_bwd(tiles - 1, 0, kThreads);
    __syncthreads();
    for (int t = tiles - 1; t >= 0; --t) {
        if (warp == 0) {
            const int lo = t * kTile, rows = min(kTile, n - lo);
            const T* m = sM[t & 1];
            const T* wv = sV[t & 1];
            const T* fv = sF[t & 1];
            // the next row's (i - 1's) operands, loaded a row ahead
            T mn[9], wn[3], fn = fv[rows - 1];
#pragma unroll
            for (int q = 0; q < 9; ++q) mn[q] = m[(rows - 1) * 9 + q];
#pragma unroll
            for (int q = 0; q < 3; ++q) wn[q] = wv[(rows - 1) * 3 + q];
            for (int k = rows - 1; k >= 0; --k) {
                const int i = lo + k;
                T mk[9], wk[3];
                const T fk = fn;
#pragma unroll
                for (int q = 0; q < 9; ++q) mk[q] = mn[q];
#pragma unroll
                for (int q = 0; q < 3; ++q) wk[q] = wn[q];
                if (k > 0) {
#pragma unroll
                    for (int q = 0; q < 9; ++q) mn[q] = m[(k - 1) * 9 + q];
#pragma unroll
                    for (int q = 0; q < 3; ++q) wn[q] = wv[(k - 1) * 3 + q];
                    fn = fv[k - 1];
                }
                T zi[3];
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    zi[c] = i == n - 1 ? wk[c] : wk[c] - mv_entry(mk, v, c);
#pragma unroll
                for (int c = 0; c < 3; ++c) v[c] = zi[c];
                if (lane < 3)
                    z[(size_t)i * 3 + lane] =
                        (lane == 0 ? zi[0] : (lane == 1 ? zi[1] : zi[2])) *
                        fk;
            }
        } else if (t > 0) {
            stage_bwd(t - 1, 32, stagers);
        }
        __syncthreads();
    }
}

template <typename T>
int factorize(const void* D, const void* U, const void* f, int n, void* Sinv,
              void* Tm, void* W, cudaStream_t s) {
    chain_factorize_kernel<T><<<1, kThreads, 0, s>>>(
        (const T*)D, (const T*)U, (const T*)f, n, (T*)Sinv, (T*)Tm, (T*)W);
    return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* Sinv, const void* Tm, const void* W, const void* r,
          const void* f, int n, void* z, cudaStream_t s) {
    chain_apply_kernel<T><<<1, kThreads, 0, s>>>(
        (const T*)Sinv, (const T*)Tm, (const T*)W, (const T*)r, (const T*)f,
        n, (T*)z);
    return (int)cudaGetLastError();
}

}  // namespace

// D (n,3,3), U (n-1,3,3), f (n) -> Sinv (n,3,3), T and W (n-1,3,3); f64
// when dbl is nonzero, else f32. U, T and W are not read or written at
// n = 1.
extern "C" int chain_factorize(const void* D, const void* U, const void* f,
                               int n, int dbl, void* Sinv, void* Tm, void* W,
                               void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return dbl ? factorize<double>(D, U, f, n, Sinv, Tm, W, s)
               : factorize<float>(D, U, f, n, Sinv, Tm, W, s);
}

// Sinv (n,3,3), T and W (n-1,3,3), r (n,3), f (n) -> z (n,3)
extern "C" int chain_apply(const void* Sinv, const void* Tm, const void* W,
                           const void* r, const void* f, int n, int dbl,
                           void* z, void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    return dbl ? apply<double>(Sinv, Tm, W, r, f, n, z, s)
               : apply<float>(Sinv, Tm, W, r, f, n, z, s);
}
