// score_tail: the rest of a match after the coarse window sums: the
// responses with their penalties, the tie average, the positional
// covariance and, under `refine`, the fine pass with the angular
// covariance; the packed 13-float result.
//
// Replaces no Pallas kernel. It stands for the XLA-fused tensor code of
// the JAX package's _score_impl after the window sums (slam_toolbox_tpu/
// kernels/match.py:758-800, with _tie_average :599, _positional_cov :626,
// _angular_cov :656 and the fine pass's gathers of _score_tensor :493),
// which the reference's docstring keeps on XLA's gather path; in the port
// the plain version is kernels/step_cuda.py score_tail_plain.
//
//   raw (na, ny, nx) int32 window sums of the coarse lattice, the raster
//   (G*G + 1,) int8 (the last cell the sink), center_off (5,), local (B, 2)
//   f32 with row stride lstride, finite (B,) bool, the coarse headings ang
//   (na,), the coarse offsets x_off (nx,) / y_off (ny,), the fine offsets
//   x_off_f / y_off_f (3,) -> out (13,) f32 [best, mean (3), cov (9)];
//   aux (18 + 10 na_f,) f32 or null: the intermediates step_cuda.AUX_HEAD
//   describes.
//
// Bound: bytes at the loop geometry (21 x 81 x 81 sums, 0.55 MB), about
// 0.16 us at 3.35 TB/s; at the bench geometry the fine pass's 11 x 9 x
// 1081 gathers (with the angular pass's 11 x 1081) are the work, about
// 0.1 MB of raster lines, 0.04 us. The kernel is latency-bound well above
// both: one block per match walks five dependent phases (the maximum, the
// tie sums, the covariance sums, the fine gathers, the angular gathers),
// each ended by a block reduction. Design: one block of 1024 threads, so
// every reduction is a fixed warp-shuffle tree and repeats bit for bit;
// the coarse responses are formed from the sums on the fly in each pass
// (no (na, ny, nx) f32 tensor is written); the fine and angular sums are
// int32, per-warp partials added by shared-memory integer atomics (exact
// in any order); the 99 fine responses and 11 angular ones are taken by
// one thread in a fixed order.
//
// Numerics: built with --fmad=false; every elementwise f32 operation in
// the plain version's order, with PyTorch's rule for a division by a
// Python number on a card (a product with the f32 reciprocal: the
// responses' 1 / (B * 100), the penalties' 1 / dist_var_penalty and
// 1 / ang_var_penalty, the angular wrap's 1 / (2 pi)); cosf, sinf, atan2f,
// floorf, ceilf and rintf without fast math; NaN-propagating clamps and
// maxima as PyTorch's. So responses, their maximum, the tie counts, the
// fine cells and sums and the angular cell and sums equal the plain
// version's bit for bit wherever the means they follow do; the sums of
// the means and covariances are taken in another order than PyTorch's.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadings = 512;
constexpr int kMaxFine = 64;
constexpr int kAuxHead = 18;
constexpr float kTol = 1e-6f;          // KT_TOLERANCE
constexpr float kMaxVariance = 500.0f;  // MAX_VARIANCE
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr unsigned kFull = 0xffffffffu;

struct TailArgs {
    const int* raw;
    int na, ny, nx;
    const signed char* grid;
    int G;
    const float* center_off;
    const float* local;
    int lstride, B;
    const bool* finite;
    const float* ang;
    const float* x_off;
    const float* y_off;
    const float* x_off_f;
    const float* y_off_f;
    float scale, fine_angle_offset, fine_angle_res, coarse_angle_res;
    int penalize;
    float dist_var_penalty, ang_var_penalty, min_dist_pen, min_ang_pen;
    int na_f, refine;
    float* out;
    float* aux;
};

__device__ __forceinline__ float round_half_away(float x) {
    return x >= 0.0f ? floorf(x + 0.5f) : ceilf(x - 0.5f);
}

__device__ __forceinline__ float clamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
    return isnan(v) ? v : fminf(v, hi);
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || a > b) ? a : b;
}

// 1 - 0.2 * sq / var_penalty as PyTorch forms it on a card, clamped
__device__ __forceinline__ float penalty(float sq, float inv_var, float lo) {
    return clamp_min(1.0f - (0.2f * sq) * inv_var, lo);
}

__device__ __forceinline__ float response(int raw, float inv_b100,
                                          bool penalize, float pen) {
    float r = (float)raw * inv_b100;
    if (!penalize) return r;
    return fabsf(r) > kTol ? r * pen : r;
}

// The N values of every thread summed in a fixed tree (warp shuffles,
// then warp 0 over the warps' partials); every thread gets the sums.
template <int N>
__device__ void block_sum(float* v, float* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k)
        for (int o = 16; o > 0; o >>= 1)
            v[k] += __shfl_down_sync(kFull, v[k], o);
    if (lane == 0)
        for (int k = 0; k < N; ++k) sh[warp * N + k] = v[k];
    __syncthreads();
    if (warp == 0) {
        for (int k = 0; k < N; ++k) {
            float x = sh[lane * N + k];
            for (int o = 16; o > 0; o >>= 1)
                x += __shfl_down_sync(kFull, x, o);
            if (lane == 0) sh[kWarps * N + k] = x;
        }
    }
    __syncthreads();
    for (int k = 0; k < N; ++k) v[k] = sh[kWarps * N + k];
    __syncthreads();
}

__device__ float block_max(float v, float* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = 16; o > 0; o >>= 1)
        v = nan_max(v, __shfl_down_sync(kFull, v, o));
    if (lane == 0) sh[warp] = v;
    __syncthreads();
    if (warp == 0) {
        float x = sh[lane];
        for (int o = 16; o > 0; o >>= 1)
            x = nan_max(x, __shfl_down_sync(kFull, x, o));
        if (lane == 0) sh[kWarps] = x;
    }
    __syncthreads();
    v = sh[kWarps];
    __syncthreads();
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    return v;
}

// the rotated beam offset of beam b under heading (c, s), in cells, as
// _rotated_tables forms it (int32, then widened as .long() does)
__device__ __forceinline__ void rotated(const TailArgs& p, int b, float c,
                                        float s, long long* dx,
                                        long long* dy) {
    float lx = p.local[(long long)b * p.lstride];
    float ly = p.local[(long long)b * p.lstride + 1];
    *dx = (int)round_half_away((c * lx - s * ly) * p.scale);
    *dy = (int)round_half_away((s * lx + c * ly) * p.scale);
}

__global__ void __launch_bounds__(kThreads) score_tail_kernel(TailArgs p) {
    __shared__ float sh[kWarps * 5 + 5];
    __shared__ float cos_a[kMaxHeadings], sin_a[kMaxHeadings];
    __shared__ float pen_a[kMaxHeadings];
    __shared__ float fang[kMaxFine], fcos[kMaxFine], fsin[kMaxFine];
    __shared__ int fsum[kMaxFine * 9], asum[kMaxFine];
    __shared__ long long fcx[3], fcy[3], cell[2];
    __shared__ float fine[5];   // best_f, mean_f (3), fine tie count

    const int tid = threadIdx.x;
    const float c0 = p.center_off[0], c1 = p.center_off[1];
    const float ch = p.center_off[2];
    const float o0 = p.center_off[3], o1 = p.center_off[4];
    const bool pz = p.penalize != 0;
    const float inv_b100 = 1.0f / ((float)p.B * 100.0f);
    const float inv_dvp = 1.0f / p.dist_var_penalty;
    const float inv_avp = 1.0f / p.ang_var_penalty;
    const int na = p.na, ny = p.ny, nx = p.nx;
    const int cells = ny * nx;
    const long long N = (long long)na * cells;

    for (int a = tid; a < na; a += kThreads) {
        float h = p.ang[a];
        cos_a[a] = cosf(h);
        sin_a[a] = sinf(h);
        float d = h - ch;
        pen_a[a] = penalty(d * d, inv_avp, p.min_ang_pen);
    }
    __syncthreads();

    // 1. the best coarse response
    float best = -INFINITY;
    for (long long e = tid; e < N; e += kThreads) {
        int a = (int)(e / cells);
        int r = (int)(e - (long long)a * cells);
        int i = r / nx, j = r - i * nx;
        float yi = p.y_off[i], xj = p.x_off[j];
        float pen = penalty(yi * yi + xj * xj, inv_dvp, p.min_dist_pen)
                    * pen_a[a];
        best = nan_max(best, response(p.raw[e], inv_b100, pz, pen));
    }
    best = block_max(best, sh);

    // 2. the tie average: count, x, y, cos and sin sums of the tie set
    const float thr = best - kTol;
    float t[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (long long e = tid; e < N; e += kThreads) {
        int a = (int)(e / cells);
        int r = (int)(e - (long long)a * cells);
        int i = r / nx, j = r - i * nx;
        float yi = p.y_off[i], xj = p.x_off[j];
        float pen = penalty(yi * yi + xj * xj, inv_dvp, p.min_dist_pen)
                    * pen_a[a];
        if (response(p.raw[e], inv_b100, pz, pen) >= thr) {
            t[0] += 1.0f;
            t[1] += c0 + xj;
            t[2] += c1 + yi;
            t[3] += cos_a[a];
            t[4] += sin_a[a];
        }
    }
    block_sum<5>(t, sh);
    const float cnt_c = t[0];
    const float avg_x = t[1] / cnt_c, avg_y = t[2] / cnt_c;
    const float mh = atan2f(t[4] / cnt_c, t[3] / cnt_c);
    const float best_c = clamp_max(best, 1.0f);

    // 3. the positional covariance over the best response per cell
    const float dx = avg_x - c0, dy = avg_y - c1;
    const float use_thr = best_c - 0.1f;
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int e = tid; e < cells; e += kThreads) {
        int i = e / nx, j = e - i * nx;
        float yi = p.y_off[i], xj = p.x_off[j];
        float dpen = penalty(yi * yi + xj * xj, inv_dvp, p.min_dist_pen);
        float pr = -INFINITY;
        for (int a = 0; a < na; ++a)
            pr = nan_max(pr, response(p.raw[(long long)a * cells + e],
                                      inv_b100, pz, dpen * pen_a[a]));
        if (pr >= use_thr) {
            float xm = xj - dx, ym = yi - dy;
            q[0] += pr;
            q[1] += (xm * xm) * pr;
            q[2] += (xm * ym) * pr;
            q[3] += (ym * ym) * pr;
        }
    }
    block_sum<4>(q, sh);
    const float norm = q[0];
    const float step_xy = p.x_off[1] - p.x_off[0];
    const float var_th = 4.0f * (p.coarse_angle_res * p.coarse_angle_res);
    const float min_var = 0.1f * (step_xy * step_xy);
    const float mult = 1.0f / clamp_min(best_c, kTol);
    float cov[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    if (best_c < kTol) {
        cov[0] = kMaxVariance;
        cov[4] = kMaxVariance;
        cov[8] = var_th;
    } else if (norm > kTol) {
        float vxy = (q[2] / norm) * mult;
        cov[0] = clamp_min(q[1] / norm, min_var) * mult;
        cov[1] = vxy;
        cov[3] = vxy;
        cov[4] = clamp_min(q[3] / norm, min_var) * mult;
        cov[8] = var_th;
    }
    if (tid == 0 && p.aux != nullptr) {
        for (int k = 0; k < 10 * p.na_f + kAuxHead; ++k) p.aux[k] = 0.0f;
        p.aux[0] = cnt_c;
        p.aux[1] = best_c;
        p.aux[2] = avg_x;
        p.aux[3] = avg_y;
        p.aux[4] = mh;
    }
    if (!p.refine) {
        if (tid == 0) {
            p.out[0] = best_c;
            p.out[1] = avg_x;
            p.out[2] = avg_y;
            p.out[3] = mh;
            for (int k = 0; k < 9; ++k) p.out[4 + k] = cov[k];
        }
        return;
    }

    // 4. the fine pass: headings around the coarse mean, 3 x 3 cells
    const int naf = p.na_f;
    for (int a = tid; a < naf; a += kThreads) {
        float h = (mh - p.fine_angle_offset) + p.fine_angle_res * (float)a;
        fang[a] = h;
        fcos[a] = cosf(h);
        fsin[a] = sinf(h);
        asum[a] = 0;
    }
    for (int k = tid; k < naf * 9; k += kThreads) fsum[k] = 0;
    if (tid < 3) {
        fcx[tid] = (int)round_half_away(((avg_x + p.x_off_f[tid]) - o0)
                                        * p.scale);
        fcy[tid] = (int)round_half_away(((avg_y + p.y_off_f[tid]) - o1)
                                        * p.scale);
    }
    __syncthreads();
    const int G = p.G;
    const int sinkv = p.grid[(long long)G * G];
    for (int a = 0; a < naf; ++a) {
        int s[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        for (int b = tid; b < p.B; b += kThreads) {
            long long bx, by;
            rotated(p, b, fcos[a], fsin[a], &bx, &by);
            const bool fin = p.finite[b];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                long long gy = by + fcy[i];
                bool oky = fin && gy >= 0 && gy < G;
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    long long gx = bx + fcx[j];
                    bool ok = oky && gx >= 0 && gx < G;
                    s[3 * i + j] += ok ? (int)p.grid[gy * G + gx] : sinkv;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            int v = warp_sum(s[k]);
            if ((tid & 31) == 0) atomicAdd(&fsum[9 * a + k], v);
        }
    }
    __syncthreads();

    // the fine responses, their tie average and the angular cell, by one
    // thread in a fixed order
    if (tid == 0) {
        float fr[kMaxFine * 9];
        float fbest = -INFINITY;
        for (int a = 0; a < naf; ++a) {
            float d = fang[a] - mh;
            float apen = penalty(d * d, inv_avp, p.min_ang_pen);
            for (int i = 0; i < 3; ++i)
                for (int j = 0; j < 3; ++j) {
                    float yi = p.y_off_f[i], xj = p.x_off_f[j];
                    float pen = penalty(yi * yi + xj * xj, inv_dvp,
                                        p.min_dist_pen) * apen;
                    int k = 9 * a + 3 * i + j;
                    fr[k] = response(fsum[k], inv_b100, pz, pen);
                    fbest = nan_max(fbest, fr[k]);
                }
        }
        const float fthr = fbest - kTol;
        float n = 0.0f, sx = 0.0f, sy = 0.0f, tc = 0.0f, ts = 0.0f;
        for (int a = 0; a < naf; ++a)
            for (int i = 0; i < 3; ++i)
                for (int j = 0; j < 3; ++j)
                    if (fr[9 * a + 3 * i + j] >= fthr) {
                        n += 1.0f;
                        sx += avg_x + p.x_off_f[j];
                        sy += avg_y + p.y_off_f[i];
                        tc += fcos[a];
                        ts += fsin[a];
                    }
        const float mfx = sx / n, mfy = sy / n;
        fine[0] = clamp_max(fbest, 1.0f);
        fine[1] = mfx;
        fine[2] = mfy;
        fine[3] = atan2f(ts / n, tc / n);
        fine[4] = n;
        cell[0] = (long long)round_half_away((mfx - o0) * p.scale);
        cell[1] = (long long)round_half_away((mfy - o1) * p.scale);
    }
    __syncthreads();

    // 5. the angular covariance's sums at the fine mean's cell
    for (int a = 0; a < naf; ++a) {
        int s = 0;
        for (int b = tid; b < p.B; b += kThreads) {
            long long bx, by;
            rotated(p, b, fcos[a], fsin[a], &bx, &by);
            long long gx = bx + cell[0], gy = by + cell[1];
            bool ok = p.finite[b] && gx >= 0 && gx < G && gy >= 0 && gy < G;
            s += ok ? (int)p.grid[gy * G + gx] : sinkv;
        }
        s = warp_sum(s);
        if ((tid & 31) == 0) atomicAdd(&asum[a], s);
    }
    __syncthreads();

    if (tid == 0) {
        const float best_f = fine[0], mfh = fine[3];
        const float best_angle =
            mfh + kTwoPi * rintf((mh - mfh) * (1.0f / kTwoPi));
        const float athr = best_f - 0.1f;
        float an = 0.0f, acc = 0.0f;
        for (int a = 0; a < naf; ++a) {
            float ra = (float)asum[a] * inv_b100;
            if (ra >= athr) {
                float d = fang[a] - best_angle;
                an += ra;
                acc += (d * d) * ra;
            }
        }
        const float step_sq = p.fine_angle_res * p.fine_angle_res;
        acc = acc < kTol ? step_sq : acc;
        cov[8] = an > kTol ? acc / an : 1000.0f * step_sq;
        p.out[0] = best_f;
        p.out[1] = fine[1];
        p.out[2] = fine[2];
        p.out[3] = mfh;
        for (int k = 0; k < 9; ++k) p.out[4 + k] = cov[k];
        if (p.aux != nullptr) {
            float* x = p.aux;
            x[5] = fine[4];
            x[6] = best_f;
            x[7] = fine[1];
            x[8] = fine[2];
            x[9] = mfh;
            for (int k = 0; k < 3; ++k) {
                x[10 + k] = (float)fcx[k];
                x[13 + k] = (float)fcy[k];
            }
            x[16] = (float)cell[0];
            x[17] = (float)cell[1];
            for (int k = 0; k < 9 * naf; ++k) x[kAuxHead + k] = fsum[k];
            for (int a = 0; a < naf; ++a)
                x[kAuxHead + 9 * naf + a] = asum[a];
        }
    }
}

}  // namespace

extern "C" int score_tail(
    const int* raw, int na, int ny, int nx, const signed char* grid, int G,
    const float* center_off, const float* local, int lstride, int B,
    const bool* finite, const float* ang, const float* x_off,
    const float* y_off, const float* x_off_f, const float* y_off_f,
    float scale, float fine_angle_offset, float fine_angle_res,
    float coarse_angle_res, int penalize, float dist_var_penalty,
    float ang_var_penalty, float min_dist_pen, float min_ang_pen, int na_f,
    int refine, float* out, float* aux, cudaStream_t stream) {
    if (na < 1 || na > kMaxHeadings || ny < 1 || nx < 2 || B < 1
            || na_f < 1 || na_f > kMaxFine || G < 1)
        return (int)cudaErrorInvalidValue;
    TailArgs p{raw, na, ny, nx, grid, G, center_off, local, lstride, B,
               finite, ang, x_off, y_off, x_off_f, y_off_f, scale,
               fine_angle_offset, fine_angle_res, coarse_angle_res,
               penalize, dist_var_penalty, ang_var_penalty, min_dist_pen,
               min_ang_pen, na_f, refine, out, aux};
    score_tail_kernel<<<1, kThreads, 0, stream>>>(p);
    return (int)cudaGetLastError();
}
