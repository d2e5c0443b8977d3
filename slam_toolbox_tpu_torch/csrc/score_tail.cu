// score_tail: the rest of a match after the coarse window sums: the
// responses with their penalties, the tie average, the positional
// covariance and, under `refine`, the fine pass with the angular
// covariance; the packed 13-float result.
//
// Replaces no Pallas kernel. It stands for the XLA-fused tensor code of
// the JAX package's _score_impl after the window sums (slam_toolbox_tpu/
// kernels/match.py:717-800, with _tie_average :599, _positional_cov :626,
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
//   describes. The launch geometry (cluster, threads, smem, mode) is
//   step_cuda.score_tail_launch's: 16 CTAs of 512 threads, the fastest of
//   2-16 CTAs of 128-1,024 threads at both of the port's lattices, in the
//   resident mode wherever a CTA's responses fit its shared memory and
//   na <= kMaxHeadings, else in the streamed mode, and in the wide mode
//   where na_f > kMaxFine or the beams' 8 bytes each pass a CTA's room
//   (below). ws (10 na_f,) int32 is the wide mode's workspace (null in
//   the others).
//
// Bound: bytes at the loop geometry (21 x 81 x 81 sums, 0.55 MB), about
// 0.16 us at 3.35 TB/s; at the bench geometry the fine pass's 11 x 9 x
// 1081 gathers (with the angular pass's 11 x 1081) are the work, about
// 0.1 MB of raster lines, 0.04 us. The kernel is latency-bound well above
// both: five dependent phases (the maximum, the tie sums, the covariance
// sums, the fine gathers, the angular gathers), each ended by a reduction.
//
// Design: one thread-block cluster per match (cluster CTAs of `threads`,
// launched with cudaLaunchKernelEx), so each phase runs on up to 16 SMs
// and a phase's end is a cluster barrier, not a second launch. Under
// refine the beams' local x, y are copied into each CTA's shared memory
// (cp.async) while the coarse phases run.
//   - CTA r owns a contiguous range of the ny*nx lattice cells with all na
//     headings of each: the cell's distance penalty is formed once, the
//     per-cell maximum over headings (the positional covariance's) stays
//     in the CTA, and no element index needs a division. Each coarse
//     response is formed once from `raw` (read once, coalesced along the
//     cells) into the CTA's dynamic shared memory, with the cell maxima;
//     the tie and covariance passes read shared memory only. That is the
//     resident mode. In the streamed mode (any lattice, any na) nothing
//     of the responses is kept: the tie pass and the covariance pass form
//     each response and cell maximum again from `raw` (3.4 MB at 21 x 201
//     x 201, which stays in the 50 MB L2 between passes) with the same
//     penalty and response calls in the same order, and the tie pass
//     forms each heading's cosine and sine by the same cosf / sinf of the
//     same angle; every thread walks the same cells and the reduction
//     trees do not change, so the two modes' outputs are equal bit for
//     bit. Its dynamic shared memory is the beams alone.
//   - The wide mode is the streamed mode with nothing sized by the match
//     in shared memory: the beams' local x, y are read from `local` (L1
//     and L2) at each rotation, and the fine window sums and angular sums
//     are added by every CTA straight into the workspace in global memory
//     (int32 atomics, exact in any order; zeroed at the start, ordered by
//     the cluster barriers, read back through L2), while the fine
//     headings' angles, cosines, sines, penalties and responses are formed
//     again where they are used, by the same calls on the same operands.
//     So it takes any number of fine headings and any B, and its outputs
//     equal the streamed mode's bit for bit.
//   - Reductions: each CTA reduces its part in a fixed warp-shuffle tree;
//     after a cluster barrier one warp of each CTA reads the CTAs'
//     partials through distributed shared memory and combines them in a
//     fixed tree over the ranks, so every CTA holds the same maximum and
//     tie sums, and a launch repeats bit for bit. The covariance partials
//     go to rank 0, which adds them in rank order. No float atomics; the
//     fine and angular window sums are int32, added by shared and
//     distributed shared memory integer atomics (exact in any order).
//   - The fine pass's (heading, 32-beam) tasks and the angular pass's
//     (heading, 128-beam) tasks are spread over every warp of the cluster.
//     Every CTA adds the 99 (up to 9 kMaxFine) fine sums of all ranks and
//     one warp of each forms the fine responses, their maximum, tie sums
//     and the angular cell (the same on every CTA); the angular sums and
//     the covariance partials land in rank 0, whose first warp forms the
//     angular covariance and the output.
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
//
// Built with SCORE_TAIL_PHASE_CLOCK defined (chip_smoke.py builds it as a
// second library; the package never loads it), rank 0's first thread adds
// the %globaltimer time of each of the five phases into a device buffer
// that score_tail_phases reads.
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxHeadings = 512;
constexpr int kMaxFine = 64;
constexpr int kAuxHead = 18;
constexpr int kAngChunk = 128;     // beams of an angular task (4 a lane)
constexpr int kBatch = 24;         // coarse headings loaded at once
constexpr float kTol = 1e-6f;          // KT_TOLERANCE
constexpr float kMaxVariance = 500.0f;  // MAX_VARIANCE
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr unsigned kFull = 0xffffffffu;

#ifdef SCORE_TAIL_PHASE_CLOCK
constexpr int kPhases = 5;
// per phase the summed ns, then the launches stamped
__device__ unsigned long long g_phase_ns[kPhases + 1];
__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define PHASE_START unsigned long long t_prev_ = globaltimer()
#define PHASE_STAMP(k) do { if (rank == 0 && threadIdx.x == 0) { \
    unsigned long long t_ = globaltimer(); g_phase_ns[k] += t_ - t_prev_; \
    t_prev_ = t_; if ((k) == 0) g_phase_ns[kPhases] += 1; } } while (0)
#else
#define PHASE_START
#define PHASE_STAMP(k)
#endif

struct TailArgs {
    const int* __restrict__ raw;
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
    int cpc;    // lattice cells per CTA
    float* out;
    float* aux;
    int* ws;    // the wide mode's fine sums (9 na_f) and angular sums (na_f)
};

// a CTA's partials that the other CTAs read: [0] maximum, [1:6] tie count
// and x, y, cos, sin sums
constexpr int kPart = 6;

struct Shared {
    float red[kMaxWarps * 5 + 5];
    float cos_a[kMaxHeadings], sin_a[kMaxHeadings];   // resident mode
    float part[kPart];
    float total[kPart];            // the cluster's, combined in rank order
    float qall[kMaxCluster * 4];   // rank 0: each rank's covariance sums
    float fang[kMaxFine], fcos[kMaxFine], fsin[kMaxFine];
    int fsum[kMaxFine * 9];        // this CTA's fine window sums
    int ftot[kMaxFine * 9];        // all ranks' (every CTA)
    float fpen[kMaxFine * 9];      // the fine cells' penalties
    int asum[kMaxFine];            // rank 0: the angular sums
    long long fcx[3], fcy[3], cell[2];
    float fr[kMaxFine * 9];        // the fine responses
    float fine[5];   // best_f, mean_f (3), fine tie count
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

// The coarse responses of lattice cell e (of `cells`) in heading order,
// each as phase 1 forms it: f(a, heading angle, response) for a = 0..na-1,
// the sums loaded kBatch headings at once
template <typename F>
__device__ __forceinline__ void cell_responses(const TailArgs& p, int e,
                                               int cells, float dpen,
                                               float ch, float inv_avp,
                                               float inv_b100, bool pz,
                                               F f) {
    for (int a0 = 0; a0 < p.na; a0 += kBatch) {
        int v[kBatch];
        float h[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            const bool in = a0 + k < p.na;
            v[k] = in ? __ldg(p.raw + (size_t)(a0 + k) * cells + e) : 0;
            h[k] = in ? __ldg(p.ang + a0 + k) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (a0 + k < p.na) {
                const float d = h[k] - ch;
                const float apen = penalty(d * d, inv_avp, p.min_ang_pen);
                f(a0 + k, h[k], response(v[k], inv_b100, pz, dpen * apen));
            }
        }
    }
}

// The N values of every thread of the CTA summed in a fixed tree (warp
// shuffles, then warp 0 over the warps' partials) into dst[0:N] (this
// CTA's shared memory or another's), written by the first thread; the
// caller's next barrier publishes them.
template <int N>
__device__ void block_sum_to(float* v, float* sh, float* dst) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k)
        for (int o = 16; o > 0; o >>= 1)
            v[k] += __shfl_down_sync(kFull, v[k], o);
    if (lane == 0)
        for (int k = 0; k < N; ++k) sh[warp * N + k] = v[k];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
            float x = lane < nw ? sh[lane * N + k] : 0.0f;
            for (int o = 16; o > 0; o >>= 1)
                x += __shfl_down_sync(kFull, x, o);
            if (lane == 0) dst[k] = x;
        }
    }
}

// the CTA's maximum (NaN first) into *dst, as block_sum_to
__device__ void block_max_to(float v, float* sh, float* dst) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    for (int o = 16; o > 0; o >>= 1)
        v = nan_max(v, __shfl_down_sync(kFull, v, o));
    if (lane == 0) sh[warp] = v;
    __syncthreads();
    if (warp == 0) {
        float x = lane < nw ? sh[lane] : -INFINITY;
        for (int o = 16; o > 0; o >>= 1)
            x = nan_max(x, __shfl_down_sync(kFull, x, o));
        if (lane == 0) *dst = x;
    }
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    return v;
}

// a warp's sum in a fixed tree, broadcast from lane 0 (every lane gets
// the same bits)
__device__ __forceinline__ float warp_sum_f(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    return __shfl_sync(kFull, v, 0);
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = nan_max(v, __shfl_down_sync(kFull, v, o));
    return __shfl_sync(kFull, v, 0);
}

// The cluster's C partials of N floats at `slot` in each CTA's shared
// memory, combined by the first warp in a fixed tree over the ranks (lane
// r reads rank r's through distributed shared memory; `init`, the
// operation's identity, fills the lanes past C) into `dst` in this CTA's:
// every CTA gets the same bits. Ends with a CTA barrier.
template <int N, typename Op>
__device__ void cluster_combine(cg::cluster_group& cluster,
                                float* slot, float* dst, int C, float init,
                                Op op) {
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        float v[N];
        const float* src = cluster.map_shared_rank(slot, lane < C ? lane : 0);
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = lane < C ? src[k] : init;
#pragma unroll
        for (int k = 0; k < N; ++k) {
            for (int o = 16; o > 0; o >>= 1)
                v[k] = op(v[k], __shfl_down_sync(kFull, v[k], o));
            if (lane == 0) dst[k] = v[k];
        }
    }
    __syncthreads();
}

// the rotated beam offset of beam b (its local x, y at beams[stride * b]
// and the next float: shared memory, or `local` in the wide mode) under
// heading (c, s), in cells, as _rotated_tables forms it (int32, then
// widened as .long() does)
__device__ __forceinline__ void rotated(const float* beams, int stride,
                                        int b, float c, float s, float scale,
                                        long long* dx, long long* dy) {
    const float lx = beams[(size_t)stride * b];
    const float ly = beams[(size_t)stride * b + 1];
    *dx = (int)round_half_away((c * lx - s * ly) * scale);
    *dy = (int)round_half_away((s * lx + c * ly) * scale);
}

// fine heading a's angle around the coarse mean heading mh
__device__ __forceinline__ float fine_angle(const TailArgs& p, float mh,
                                           int a) {
    return (mh - p.fine_angle_offset) + p.fine_angle_res * (float)a;
}

// fine cell k = 9 a + 3 i + j's penalty, as the plain version forms it
__device__ __forceinline__ float fine_penalty(const TailArgs& p, float mh,
                                             int k, float inv_avp,
                                             float inv_dvp) {
    const int a = k / 9, ij = k - 9 * a;
    const int i = ij / 3, j = ij - 3 * i;
    const float d = fine_angle(p, mh, a) - mh;
    const float apen = penalty(d * d, inv_avp, p.min_ang_pen);
    const float yi = p.y_off_f[i], xj = p.x_off_f[j];
    return penalty(yi * yi + xj * xj, inv_dvp, p.min_dist_pen) * apen;
}

// kMode: 0 resident, 1 streamed, 2 wide (one instantiation per mode, so
// the resident mode's code carries none of the others' branches)
template <int kMode>
__global__ void __launch_bounds__(kMaxThreads)
score_tail_kernel(TailArgs p) {
    // resident: resp (na, cpc), cmax (cpc,), then the beams' local x, y
    // (B, 2); streamed: the beams alone; wide: nothing
    extern __shared__ float dyn[];
    __shared__ Shared s;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int C = (int)cluster.num_blocks();
    const int tid = threadIdx.x, T = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    PHASE_START;

    const float c0 = p.center_off[0], c1 = p.center_off[1];
    const float ch = p.center_off[2];
    const float o0 = p.center_off[3], o1 = p.center_off[4];
    const bool pz = p.penalize != 0;
    const float inv_b100 = 1.0f / ((float)p.B * 100.0f);
    const float inv_dvp = 1.0f / p.dist_var_penalty;
    const float inv_avp = 1.0f / p.ang_var_penalty;
    const int na = p.na, nx = p.nx;
    const int cells = p.ny * nx;
    const int cpc = p.cpc;
    const int lo = rank * cpc;
    const int mine = max(0, min(cells - lo, cpc));   // cells of this CTA
    constexpr bool streamed = kMode != 0;
    constexpr bool wide = kMode == 2;
    float* resp = dyn;
    float* cmax = dyn + (size_t)na * cpc;
    // the beams' local x, y and their stride: in shared memory, or read
    // from `local` in the wide mode
    const float* beams = wide ? p.local : (streamed ? dyn : cmax + cpc);
    const int bstride = wide ? p.lstride : 2;
    // the wide mode's fine and angular sums, zeroed before phase 1's
    // cluster barriers
    int* ws_f = p.ws;
    int* ws_a = p.ws + 9 * p.na_f;
    if (wide) {
        for (int k = rank * T + tid; k < 10 * p.na_f; k += C * T)
            p.ws[k] = 0;
    }

    // under refine, the beams copied into shared memory while the coarse
    // phases run (4-byte asynchronous copies: any row stride)
    if (p.refine && !wide) {
        float* dst = streamed ? dyn : cmax + cpc;
        for (int b = tid; b < p.B; b += T) {
            const float* src = p.local + (size_t)b * p.lstride;
            __pipeline_memcpy_async(dst + 2 * b, src, 4);
            __pipeline_memcpy_async(dst + 2 * b + 1, src + 1, 4);
        }
        __pipeline_commit();
    }

    // the headings' cosines and sines for phase 2 (published by phase 1's
    // barriers; the streamed mode forms them there); rank 0's angular sums
    // start at 0
    if (!streamed) {
        for (int a = tid; a < na; a += T) {
            s.cos_a[a] = cosf(p.ang[a]);
            s.sin_a[a] = sinf(p.ang[a]);
        }
    }
    for (int k = tid; k < kMaxFine; k += T) s.asum[k] = 0;

    // 1. the coarse responses of this CTA's cells (into shared memory in
    // the resident mode), the cells' maxima over headings, and the best
    // response; the headings' penalties are formed beside the sums' loads
    float best = -INFINITY;
    for (int l = tid; l < mine; l += T) {
        const int e = lo + l;
        const int i = e / nx, j = e - i * nx;
        const float yi = p.y_off[i], xj = p.x_off[j];
        const float dpen = penalty(yi * yi + xj * xj, inv_dvp,
                                   p.min_dist_pen);
        float pr = -INFINITY;
        cell_responses(p, e, cells, dpen, ch, inv_avp, inv_b100, pz,
                       [&](int a, float, float r) {
                           if (!streamed) resp[(size_t)a * cpc + l] = r;
                           pr = nan_max(pr, r);
                       });
        if (!streamed) cmax[l] = pr;
        best = nan_max(best, pr);
    }
    block_max_to(best, s.red, &s.part[0]);
    cluster.sync();
    cluster_combine<1>(cluster, &s.part[0], &s.total[0], C, -INFINITY,
                       [](float a, float b) { return nan_max(a, b); });
    best = s.total[0];
    PHASE_STAMP(0);

    // 2. the tie average: count, x, y, cos and sin sums of the tie set
    const float thr = best - kTol;
    float t[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int l = tid; l < mine; l += T) {
        const int e = lo + l;
        const int i = e / nx, j = e - i * nx;
        const float yi = p.y_off[i], xj = p.x_off[j];
        if (streamed) {
            const float dpen = penalty(yi * yi + xj * xj, inv_dvp,
                                       p.min_dist_pen);
            cell_responses(p, e, cells, dpen, ch, inv_avp, inv_b100, pz,
                           [&](int, float h, float r) {
                               if (r >= thr) {
                                   t[0] += 1.0f;
                                   t[1] += c0 + xj;
                                   t[2] += c1 + yi;
                                   t[3] += cosf(h);
                                   t[4] += sinf(h);
                               }
                           });
            continue;
        }
        for (int a = 0; a < na; ++a) {
            if (resp[(size_t)a * cpc + l] >= thr) {
                t[0] += 1.0f;
                t[1] += c0 + xj;
                t[2] += c1 + yi;
                t[3] += s.cos_a[a];
                t[4] += s.sin_a[a];
            }
        }
    }
    block_sum_to<5>(t, s.red, &s.part[1]);
    cluster.sync();
    cluster_combine<5>(cluster, &s.part[1], &s.total[1], C, 0.0f,
                       [](float a, float b) { return a + b; });
    for (int k = 0; k < 5; ++k) t[k] = s.total[1 + k];
    const float cnt_c = t[0];
    const float avg_x = t[1] / cnt_c, avg_y = t[2] / cnt_c;
    const float mh = atan2f(t[4] / cnt_c, t[3] / cnt_c);
    const float best_c = clamp_max(best, 1.0f);
    PHASE_STAMP(1);

    // 3. the positional covariance's sums over this CTA's cell maxima,
    // pushed into rank 0
    const float dx = avg_x - c0, dy = avg_y - c1;
    const float use_thr = best_c - 0.1f;
    float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int l = tid; l < mine; l += T) {
        const int e = lo + l;
        float pr;
        if (streamed) {
            const int i = e / nx, j = e - i * nx;
            const float yi = p.y_off[i], xj = p.x_off[j];
            const float dpen = penalty(yi * yi + xj * xj, inv_dvp,
                                       p.min_dist_pen);
            pr = -INFINITY;
            cell_responses(p, e, cells, dpen, ch, inv_avp, inv_b100, pz,
                           [&](int, float, float r) { pr = nan_max(pr, r); });
        } else {
            pr = cmax[l];
        }
        if (pr >= use_thr) {
            const int i = e / nx, j = e - i * nx;
            const float xm = p.x_off[j] - dx, ym = p.y_off[i] - dy;
            q[0] += pr;
            q[1] += (xm * xm) * pr;
            q[2] += (xm * ym) * pr;
            q[3] += (ym * ym) * pr;
        }
    }
    block_sum_to<4>(q, s.red, cluster.map_shared_rank(&s.qall[0], 0)
                              + rank * 4);
    PHASE_STAMP(2);

    const int naf = p.na_f;
    const int G = p.G;
    const int sinkv = p.grid[(long long)G * G];
    const int W = C * (T >> 5);            // warps of the cluster
    const int gw = rank * (T >> 5) + warp;  // this warp's cluster index
    // the fine headings' cosines and sines, and the fine responses: kept
    // in shared memory, or formed again in the wide mode
    auto fcos = [&](int a) {
        return wide ? cosf(fine_angle(p, mh, a)) : s.fcos[a];
    };
    auto fsin = [&](int a) {
        return wide ? sinf(fine_angle(p, mh, a)) : s.fsin[a];
    };
    auto ftot = [&](int k) { return wide ? __ldcg(ws_f + k) : s.ftot[k]; };
    auto fresp = [&](int k) {
        return wide ? response(ftot(k), inv_b100, pz,
                               fine_penalty(p, mh, k, inv_avp, inv_dvp))
                    : s.fr[k];
    };
    if (p.refine) {
        // 4. the fine pass: headings around the coarse mean, 3 x 3 cells
        if (!wide) {
            for (int a = tid; a < naf; a += T) {
                const float h = fine_angle(p, mh, a);
                s.fang[a] = h;
                s.fcos[a] = cosf(h);
                s.fsin[a] = sinf(h);
            }
            // each fine cell's penalty (heading a, cell (i, j))
            for (int k = tid; k < naf * 9; k += T) {
                s.fpen[k] = fine_penalty(p, mh, k, inv_avp, inv_dvp);
                s.fsum[k] = 0;
            }
        }
        if (tid < 3) {
            s.fcx[tid] = (int)round_half_away(
                ((avg_x + p.x_off_f[tid]) - o0) * p.scale);
            s.fcy[tid] = (int)round_half_away(
                ((avg_y + p.y_off_f[tid]) - o1) * p.scale);
        }
        __pipeline_wait_prior(0);
        __syncthreads();
        // a task is (heading, 32 beams), a lane per beam
        const int nch = (p.B + 31) / 32;
        for (int task = gw; task < naf * nch; task += W) {
            const int a = task / nch;
            const int b = (task - a * nch) * 32 + lane;
            int sm[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
            if (b < p.B) {
                long long bx, by;
                rotated(beams, bstride, b, fcos(a), fsin(a), p.scale, &bx,
                        &by);
                const bool fin = p.finite[b];
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    const long long gy = by + s.fcy[i];
                    const bool oky = fin && gy >= 0 && gy < G;
#pragma unroll
                    for (int j = 0; j < 3; ++j) {
                        const long long gx = bx + s.fcx[j];
                        const bool ok = oky && gx >= 0 && gx < G;
                        sm[3 * i + j] = ok ? (int)__ldg(p.grid + gy * G + gx)
                                           : sinkv;
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                const int v = warp_sum(sm[k]);
                if (lane == 0)
                    atomicAdd(wide ? ws_f + 9 * a + k : &s.fsum[9 * a + k],
                              v);
            }
        }
        cluster.sync();
        if (!wide) {
            for (int k = tid; k < naf * 9; k += T) {
                int v = 0;
                for (int r = 0; r < C; ++r)
                    v += cluster.map_shared_rank(&s.fsum[0], r)[k];
                s.ftot[k] = v;
            }
            __syncthreads();
        }

        // the fine responses, their tie average and the angular cell, by
        // the first warp of every CTA (the same bits on each)
        if (warp == 0) {
            float fbest = -INFINITY;
            for (int k = lane; k < naf * 9; k += 32) {
                if (!wide)
                    s.fr[k] = response(s.ftot[k], inv_b100, pz, s.fpen[k]);
                fbest = nan_max(fbest, fresp(k));
            }
            fbest = warp_max(fbest);
            const float fthr = fbest - kTol;
            float n = 0.0f, sx = 0.0f, sy = 0.0f, tc = 0.0f, ts = 0.0f;
            for (int k = lane; k < naf * 9; k += 32) {   // this lane's fr
                if (fresp(k) >= fthr) {
                    const int a = k / 9, ij = k - 9 * a;
                    const int i = ij / 3, j = ij - 3 * i;
                    n += 1.0f;
                    sx += avg_x + p.x_off_f[j];
                    sy += avg_y + p.y_off_f[i];
                    tc += fcos(a);
                    ts += fsin(a);
                }
            }
            n = warp_sum_f(n);
            sx = warp_sum_f(sx);
            sy = warp_sum_f(sy);
            tc = warp_sum_f(tc);
            ts = warp_sum_f(ts);
            if (lane == 0) {
                const float mfx = sx / n, mfy = sy / n;
                s.fine[0] = clamp_max(fbest, 1.0f);
                s.fine[1] = mfx;
                s.fine[2] = mfy;
                s.fine[3] = atan2f(ts / n, tc / n);
                s.fine[4] = n;
                s.cell[0] = (long long)round_half_away((mfx - o0) * p.scale);
                s.cell[1] = (long long)round_half_away((mfy - o1) * p.scale);
            }
        }
        __syncthreads();
        PHASE_STAMP(3);

        // 5. the angular covariance's sums at the fine mean's cell, added
        // into rank 0
        const long long cx = s.cell[0], cy = s.cell[1];
        const int nca = (p.B + kAngChunk - 1) / kAngChunk;
        for (int task = gw; task < naf * nca; task += W) {
            const int a = task / nca;
            const int b0 = (task - a * nca) * kAngChunk + lane;
            const float ca = fcos(a), sa = fsin(a);
            int v = 0;
#pragma unroll
            for (int m = 0; m < kAngChunk / 32; ++m) {
                const int b = b0 + 32 * m;
                if (b < p.B) {
                    long long bx, by;
                    rotated(beams, bstride, b, ca, sa, p.scale, &bx, &by);
                    long long gx = bx + cx, gy = by + cy;
                    bool ok = p.finite[b] && gx >= 0 && gx < G && gy >= 0
                              && gy < G;
                    v += ok ? (int)__ldg(p.grid + gy * G + gx) : sinkv;
                }
            }
            v = warp_sum(v);
            if (lane == 0)
                atomicAdd(wide ? ws_a + a
                               : cluster.map_shared_rank(&s.asum[0], 0) + a,
                          v);
        }
    }
    cluster.sync();
    if (rank != 0) return;

    // rank 0: the covariance from every rank's sums in rank order, the
    // angular covariance, the output and aux
    float qs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < C; ++r)
        for (int k = 0; k < 4; ++k) qs[k] += s.qall[r * 4 + k];
    const float norm = qs[0];
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
        float vxy = (qs[2] / norm) * mult;
        cov[0] = clamp_min(qs[1] / norm, min_var) * mult;
        cov[1] = vxy;
        cov[3] = vxy;
        cov[4] = clamp_min(qs[3] / norm, min_var) * mult;
        cov[8] = var_th;
    }
    if (p.refine && warp == 0) {
        const float best_f = s.fine[0], mfh = s.fine[3];
        const float best_angle =
            mfh + kTwoPi * rintf((mh - mfh) * (1.0f / kTwoPi));
        const float athr = best_f - 0.1f;
        float an = 0.0f, acc = 0.0f;
        for (int a = lane; a < naf; a += 32) {
            float ra = (float)(wide ? __ldcg(ws_a + a) : s.asum[a])
                       * inv_b100;
            if (ra >= athr) {
                float d = (wide ? fine_angle(p, mh, a) : s.fang[a])
                          - best_angle;
                an += ra;
                acc += (d * d) * ra;
            }
        }
        an = warp_sum_f(an);
        acc = warp_sum_f(acc);
        const float step_sq = p.fine_angle_res * p.fine_angle_res;
        acc = acc < kTol ? step_sq : acc;
        cov[8] = an > kTol ? acc / an : 1000.0f * step_sq;
    }
    if (tid == 0) {
        p.out[0] = p.refine ? s.fine[0] : best_c;
        p.out[1] = p.refine ? s.fine[1] : avg_x;
        p.out[2] = p.refine ? s.fine[2] : avg_y;
        p.out[3] = p.refine ? s.fine[3] : mh;
        for (int k = 0; k < 9; ++k) p.out[4 + k] = cov[k];
    }
    if (p.aux != nullptr) {
        float* x = p.aux;
        for (int k = tid; k < kAuxHead + 10 * naf; k += T) {
            float v = 0.0f;
            if (k == 0) v = cnt_c;
            else if (k == 1) v = best_c;
            else if (k == 2) v = avg_x;
            else if (k == 3) v = avg_y;
            else if (k == 4) v = mh;
            else if (p.refine) {
                if (k == 5) v = s.fine[4];
                else if (k < 10) v = s.fine[k - 6];
                else if (k < 13) v = (float)s.fcx[k - 10];
                else if (k < 16) v = (float)s.fcy[k - 13];
                else if (k < kAuxHead) v = (float)s.cell[k - 16];
                else if (k < kAuxHead + 9 * naf) v = ftot(k - kAuxHead);
                else v = wide ? __ldcg(ws_a + k - kAuxHead - 9 * naf)
                              : s.asum[k - kAuxHead - 9 * naf];
            }
            x[k] = v;
        }
    }
    PHASE_STAMP(p.refine ? 4 : 2);
}

std::once_flag g_attr_once;
cudaError_t g_attr_err = cudaSuccess;
int g_max_dynamic = 0;   // the dynamic shared bytes a CTA may take

constexpr int kModes = 3;

// the kernel of a mode (0 resident, 1 streamed, 2 wide)
const void* kernel_of(int mode) {
    return mode == 2 ? (const void*)score_tail_kernel<2>
           : mode == 1 ? (const void*)score_tail_kernel<1>
                       : (const void*)score_tail_kernel<0>;
}

void set_attributes() {
    int dev = 0, optin = 0;
    g_attr_err = cudaGetDevice(&dev);
    if (g_attr_err == cudaSuccess)
        g_attr_err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    g_max_dynamic = optin;
    for (int mode = 0; mode < kModes && g_attr_err == cudaSuccess;
         ++mode) {
        cudaFuncAttributes fa;
        g_attr_err = cudaFuncGetAttributes(&fa, kernel_of(mode));
        if (g_attr_err == cudaSuccess)
            g_max_dynamic = std::min(g_max_dynamic,
                                     optin - (int)fa.sharedSizeBytes);
    }
    for (int mode = 0; mode < kModes && g_attr_err == cudaSuccess;
         ++mode) {
        g_attr_err = cudaFuncSetAttribute(
            kernel_of(mode), cudaFuncAttributeMaxDynamicSharedMemorySize,
            g_max_dynamic);
        if (g_attr_err == cudaSuccess)
            g_attr_err = cudaFuncSetAttribute(
                kernel_of(mode),
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
}

// the launch configuration of one cluster (attr holds its dimension)
void launch_config(int cluster, int threads, int smem, cudaStream_t stream,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(cluster, 1, 1);
    cfg->blockDim = dim3(threads, 1, 1);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
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
    int refine, int cluster, int threads, int smem, int mode, float* out,
    float* aux, int* ws, cudaStream_t stream) {
    const bool streamed = mode != 0, wide = mode == 2;
    if (na < 1 || (!streamed && na > kMaxHeadings) || ny < 1 || nx < 2
            || B < 1 || na_f < 1 || (!wide && na_f > kMaxFine) || G < 1
            || cluster < 1 || cluster > kMaxCluster || threads < 32
            || threads > kMaxThreads || threads % 32 != 0 || mode < 0
            || mode >= kModes || (wide && ws == nullptr))
        return (int)cudaErrorInvalidValue;
    const int cells = ny * nx;
    const int cpc = (cells + cluster - 1) / cluster;
    // the dynamic shared bytes of the mode's layout
    const long long need = wide ? 0LL
        : (streamed ? 0LL : (long long)(na + 1) * cpc * 4) + 8LL * B;
    if (need != (long long)smem) return (int)cudaErrorInvalidValue;
    std::call_once(g_attr_once, set_attributes);
    if (g_attr_err != cudaSuccess) return (int)g_attr_err;
    if (smem > g_max_dynamic) return (int)cudaErrorInvalidValue;
    TailArgs p{raw, na, ny, nx, grid, G, center_off, local, lstride, B,
               finite, ang, x_off, y_off, x_off_f, y_off_f, scale,
               fine_angle_offset, fine_angle_res, coarse_angle_res,
               penalize, dist_var_penalty, ang_var_penalty, min_dist_pen,
               min_ang_pen, na_f, refine, cpc, out, aux, ws};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    launch_config(cluster, threads, smem, stream, &cfg, attr);
    cudaError_t err = wide ? cudaLaunchKernelEx(&cfg, score_tail_kernel<2>, p)
        : streamed ? cudaLaunchKernelEx(&cfg, score_tail_kernel<1>, p)
                   : cudaLaunchKernelEx(&cfg, score_tail_kernel<0>, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The clusters of `cluster` CTAs x `threads` threads with `smem` dynamic
// shared bytes a CTA, of the mode's kernel, that the card can hold at
// once (cudaOccupancyMaxActiveClusters) into *count; 0 where the card
// cannot schedule one (another part, a partition), where a launch would
// fail.
extern "C" int score_tail_clusters(int cluster, int threads, int smem,
                                   int mode, int* count) {
    if (mode < 0 || mode >= kModes) return (int)cudaErrorInvalidValue;
    std::call_once(g_attr_once, set_attributes);
    if (g_attr_err != cudaSuccess) return (int)g_attr_err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    launch_config(cluster, threads, smem, nullptr, &cfg, attr);
    return (int)cudaOccupancyMaxActiveClusters(count, kernel_of(mode),
                                               &cfg);
}

#ifdef SCORE_TAIL_PHASE_CLOCK
// reset != 0: zero the phase sums; else copy the kPhases sums (ns) and
// the count of stamped launches into host
extern "C" int score_tail_phases(unsigned long long* host, int reset) {
    if (reset) {
        unsigned long long zero[kPhases + 1] = {};
        return (int)cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero));
    }
    return (int)cudaMemcpyFromSymbol(host, g_phase_ns,
                                     sizeof(unsigned long long)
                                     * (kPhases + 1));
}
#endif
