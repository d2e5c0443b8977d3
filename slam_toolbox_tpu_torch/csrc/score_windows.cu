// Coarse correlative window sums of the scan matcher.
//
// Replaces the Pallas kernel slam_toolbox_tpu/kernels/match_pallas.py
// score_windows (_make_score_kernel._score_kernel; pallas_call at :119).
// For heading a, lattice cell (i, j) and beam b it adds
//   finite[b] * raster[cand_y0 + 2i + dy[a,b], cand_x0 + 2j + dx[a,b]]
// into an int32 sum; cells outside the G x G grid add 0. The TPU version
// reads a parity-split raster in aligned 2-D windows with 32 row-phase
// accumulators, all Mosaic alignment devices; this kernel gathers
// straight from the plain row-major int8 raster.
//
// Two forms:
// - the table form (score_windows) takes the rotated beam table d (na, B,
//   2) int32 and the lattice origin cand_x0 / cand_y0 from memory: the
//   exact two-call match's path, whose tables the host builds;
// - the head form (score_windows_head) forms them itself, folding in the
//   match's head (the XLA-fused code at the top of the JAX package's
//   _score_impl, slam_toolbox_tpu/kernels/match.py:749-760, with
//   _rotated_tables :612; the plain version is kernels/step_cuda.py
//   score_head_plain): in a block on heading a, thread 0 forms
//     h = (center_off[2] - angle_offset) + angle_res * a,
//   its cosf / sinf and the origin into shared memory while every
//   thread's first staged beam (flag and local point) is in flight across
//   the batch's barrier, and where the table form loads (dx, dy) each
//   thread rotates the beam's local (x, y) (row stride lstride) instead:
//     dx = round_half_away((c lx - s ly) scale),
//     dy = round_half_away((s lx + c ly) scale);
//   the origin is round_half_away(((center_off[0] + x_off[0]) -
//   center_off[3]) scale) and the same in y, and block (0, a, 0) writes
//   ang[a] = h. The (na, B) table is never written or read: the 0.18 MB
//   that a separate head kernel wrote and this one read back from L2 at
//   the bench geometry, and that kernel's launch, are gone. (Each thread
//   taking its own cosf / sinf measured about 38% slower on the H100 at
//   the bench geometry than this.)
//
// What bounds it on the H100: not bytes (the raster, 4.2 MB at G 2051,
// sits in the 50 MB L2) but the instructions executed per gathered byte
// and the loads in flight: 21 x 1081 x 676 = 15.3 M one-byte gathers at
// the bench geometry, each needing its cell's coordinates, a bounds test
// and an address if done per cell. The head form adds at most a chunk's
// rotations a block (361 beams at the bench geometry), against 128
// gathers a beam.
//
// The design:
// - Per-beam lattice spans. For each (heading, beam) the block computes
//   once, in 64-bit with floor division, the lattice rows [i_lo, i_hi)
//   and columns [j_lo, j_hi) whose cells fall inside the grid, and a base
//   offset (cand_y0 + dy) * G + cand_x0 + dx. A non-finite beam, or one
//   whose span is empty (the INT_MIN and 1 << 28 entries of NaN beams
//   included), is dropped; a beam that covers the whole lattice is full;
//   the rest are partial. Full and partial beams are staged in shared
//   memory in two lists.
// - Full beams are summed with no test: acc += raster[base + 2iG + 2j],
//   the offset precomputed per cell. Partial beams add two unsigned
//   range compares per cell. Every warp of a block walks the same list,
//   so the branch is uniform; the raster is read through the read-only
//   path, and neighbouring beams hit neighbouring raster windows in L1.
// - Several cells per thread (CPT), so one staged beam feeds CPT
//   independent loads, and the beam loop is unrolled for more in flight.
// - The beams of a heading are cut into chunks, one block per (cell
//   tile, heading, chunk); a block's warps split its chunk, sum in shared
//   memory and add each cell's sum to the output with one int32
//   atomicAdd. The launcher zero-fills the output with cudaMemsetAsync on
//   the caller's stream (recorded under CUDA graph capture), so a call
//   makes no PyTorch launch, and picks the number of chunks from na, ny *
//   nx and the SM count so that both matcher geometries fill the card:
//   the bench lattice (26 x 26, 6 tiles) takes 3 chunks of 361 beams, 378
//   blocks; the loop lattice (81 x 81, 52 tiles) 1 chunk, 1,092 blocks.
//   This measured faster at both geometries than blocks that own every
//   beam of their cells and store once, with no atomics and no fill.
// - Geometry. The narrow kernels (every geometry the port builds: the
//   table form's score_windows_kernel, the head form's instantiation of
//   score_windows_any_kernel) pack a span's start and length into 16 bits
//   each and take int32 raster offsets: lattice sides up to 65,535,
//   offsets, the lattice's reach included, below 2**31, at most 65,535
//   headings (gridDim.y). Past any of these the launcher picks the wide
//   instantiation of either form: 32-bit span fields, 64-bit offsets and
//   cell indices, and the headings in launches of 65,535 (a heading
//   offset a0), so any geometry whose tensors the card holds runs on a
//   kernel.
// int32 sums of int8 values are exact in any order; the head form's
// rotations are the plain version's f32 operations in its order (built
// with --fmad=false, cosf / sinf without fast math, round half away as
// rasterize.round_half_away, the cast to int32 as PyTorch's .to(int32)).
// So both forms equal the plain versions (the head form the plain head
// then the plain sums) bit for bit.
#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CPT = 4;            // lattice cells per thread
constexpr int TILE = 32 * CPT;    // lattice cells per block
constexpr int NT = 256;           // threads per block
constexpr int SB = 1152;          // beams staged in shared memory at a time
constexpr int kMaxGridY = 65535;  // headings one launch covers (gridDim.y)

// Lattice indices i in [0, n) with 0 <= o + 2i < G, as [*lo, *lo + count);
// floor division by arithmetic shift, so negative o rounds the right way.
__device__ __forceinline__ int lattice_span(long long o, int G, int n,
                                            int* lo) {
    long long l = -(o >> 1);            // ceil(-o / 2)
    long long h = ((G - 1 - o) >> 1) + 1;
    l = l < 0 ? 0 : l;
    h = h > n ? n : h;
    *lo = (int)l;
    return h > l ? (int)(h - l) : 0;
}

__device__ __forceinline__ float round_half_away(float x) {
    return x >= 0.0f ? floorf(x + 0.5f) : ceilf(x - 0.5f);
}

// a partial beam's span: 16-bit fields (narrow) or 32-bit (wide)
__device__ __forceinline__ void put_span(uint2* s, int ilo, int ni, int jlo,
                                         int nj) {
    *s = make_uint2((unsigned)ilo | (unsigned)ni << 16,
                    (unsigned)jlo | (unsigned)nj << 16);
}
__device__ __forceinline__ void put_span(int4* s, int ilo, int ni, int jlo,
                                         int nj) {
    *s = make_int4(ilo, ni, jlo, nj);
}
__device__ __forceinline__ void get_span(const uint2& sp, int* ilo,
                                         unsigned* ni, int* jlo,
                                         unsigned* nj) {
    *ilo = sp.x & 0xffff;
    *jlo = sp.y & 0xffff;
    *ni = sp.x >> 16;
    *nj = sp.y >> 16;
}
__device__ __forceinline__ void get_span(const int4& sp, int* ilo,
                                         unsigned* ni, int* jlo,
                                         unsigned* nj) {
    *ilo = sp.x;
    *ni = (unsigned)sp.y;
    *jlo = sp.z;
    *nj = (unsigned)sp.w;
}

// The narrow table form: every geometry the port builds.
__global__ void __launch_bounds__(NT) score_windows_kernel(
    const int8_t* __restrict__ grid, int G, const int2* __restrict__ d,
    const int* __restrict__ cand_x0, const int* __restrict__ cand_y0,
    int B, int chunk, int ny, int nx, const uint8_t* __restrict__ finite,
    int* __restrict__ out) {
    __shared__ int s_base[SB];     // full beams from the front, partial
    __shared__ uint2 s_span[SB];   // from the back: (i_lo | ni << 16, ...)
    __shared__ int s_sum[TILE];
    __shared__ int s_n[2];
    const int a = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int W = NT / 32;
    const int ncell = ny * nx;
    const long long cx = cand_x0[0], cy = cand_y0[0];

    // this thread's cells; a cell past the lattice reads cell 0's offset
    // (valid for any beam that reads it) and is never stored
    int ci[CPT], cj[CPT], off[CPT], acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        int cell = blockIdx.x * TILE + c * 32 + lane;
        cell = cell < ncell ? cell : 0;
        ci[c] = cell / nx;
        cj[c] = cell - ci[c] * nx;
        off[c] = 2 * (ci[c] * G + cj[c]);
        acc[c] = 0;
    }
    for (int k = threadIdx.x; k < TILE; k += NT) s_sum[k] = 0;

    const int b_end = min(B, (int)blockIdx.z * chunk + chunk);
    for (int b0 = blockIdx.z * chunk; b0 < b_end; b0 += SB) {
        const int nb = min(SB, b_end - b0);
        if (threadIdx.x == 0) s_n[0] = s_n[1] = 0;
        __syncthreads();
        for (int k0 = 0; k0 < nb; k0 += NT) {   // uniform trip count
            const int k = k0 + threadIdx.x;
            int cls = 0, base = 0, ilo = 0, jlo = 0, ni = 0, nj = 0;
            if (k < nb && finite[b0 + k]) {
                const int2 t = d[(size_t)a * B + b0 + k];
                const long long y0 = cy + t.y, x0 = cx + t.x;
                ni = lattice_span(y0, G, ny, &ilo);
                nj = lattice_span(x0, G, nx, &jlo);
                if (ni && nj) {
                    cls = ni == ny && nj == nx ? 1 : 2;
                    base = (int)(y0 * G + x0);
                }
            }
            const unsigned fm = __ballot_sync(~0u, cls == 1);
            const unsigned pm = __ballot_sync(~0u, cls == 2);
            int fb = 0, pb = 0;
            if (lane == 0) {
                if (fm) fb = atomicAdd(&s_n[0], __popc(fm));
                if (pm) pb = atomicAdd(&s_n[1], __popc(pm));
            }
            fb = __shfl_sync(~0u, fb, 0);
            pb = __shfl_sync(~0u, pb, 0);
            const unsigned below = (1u << lane) - 1;
            if (cls == 1) {
                s_base[fb + __popc(fm & below)] = base;
            } else if (cls == 2) {
                const int s = SB - 1 - (pb + __popc(pm & below));
                s_base[s] = base;
                s_span[s] = make_uint2((unsigned)ilo | (unsigned)ni << 16,
                                       (unsigned)jlo | (unsigned)nj << 16);
            }
        }
        __syncthreads();
        const int nf = s_n[0], np = s_n[1];
#pragma unroll 4
        for (int k = warp; k < nf; k += W) {
            const int8_t* g = grid + s_base[k];
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[c] += __ldg(g + off[c]);
        }
#pragma unroll 2
        for (int k = warp; k < np; k += W) {
            const int s = SB - 1 - k;
            const int8_t* g = grid + s_base[s];
            const uint2 sp = s_span[s];
            const int ilo = sp.x & 0xffff, jlo = sp.y & 0xffff;
            const unsigned ni = sp.x >> 16, nj = sp.y >> 16;
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                if ((unsigned)(ci[c] - ilo) < ni &&
                    (unsigned)(cj[c] - jlo) < nj)
                    acc[c] += __ldg(g + off[c]);
        }
        __syncthreads();   // the next batch overwrites the lists
    }

    __syncthreads();   // s_sum's zeros, also when B is 0
#pragma unroll
    for (int c = 0; c < CPT; ++c) atomicAdd(&s_sum[c * 32 + lane], acc[c]);
    __syncthreads();
    int* o = out + (size_t)a * ncell + blockIdx.x * TILE;
    for (int k = threadIdx.x; k < TILE; k += NT) {
        if (blockIdx.x * TILE + k >= ncell) break;
        if (s_sum[k]) atomicAdd(o + k, s_sum[k]);
    }
}

// Every other form and geometry: kHead, the head form (tables formed in
// the block); kWide, 32-bit spans, 64-bit offsets and cell indices,
// headings from a0 on. The narrow table form is score_windows_kernel
// above, kept as its own function so that its code, and its time, stay
// what they were (this template's table instantiation measured about 3%
// slower on the H100 at the loop geometry, its SASS the same but for
// scheduling).
template <bool kHead, bool kWide>
__global__ void __launch_bounds__(NT) score_windows_any_kernel(
    const int8_t* __restrict__ grid, int G, const int2* __restrict__ d,
    const int* __restrict__ cand_x0, const int* __restrict__ cand_y0,
    const float* __restrict__ center_off, const float* __restrict__ local,
    int lstride, const float* __restrict__ x_off,
    const float* __restrict__ y_off, float scale, float angle_offset,
    float angle_res, float* __restrict__ ang, int B, int chunk, int ny,
    int nx, int a0, const uint8_t* __restrict__ finite,
    int* __restrict__ out) {
    using Off = typename std::conditional<kWide, long long, int>::type;
    using Span = typename std::conditional<kWide, int4, uint2>::type;
    __shared__ Off s_base[SB];     // full beams from the front, partial
    __shared__ Span s_span[SB];    // from the back
    __shared__ int s_sum[TILE];
    __shared__ int s_n[2];
    const int a = kWide ? a0 + (int)blockIdx.y : (int)blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int W = NT / 32;
    const Off ncell = (Off)ny * nx;
    long long cx = 0, cy = 0;
    float hc = 0.0f, hs = 0.0f;
    __shared__ float s_rot[2];
    __shared__ int s_c0[2];
    if (kHead) {
        // thread 0 forms the heading's terms and the origin, published by
        // the first batch's barrier
        if (threadIdx.x == 0) {
            const float h = (center_off[2] - angle_offset)
                            + angle_res * (float)a;
            s_rot[0] = cosf(h);
            s_rot[1] = sinf(h);
            s_c0[0] = (int)round_half_away(
                ((center_off[0] + x_off[0]) - center_off[3]) * scale);
            s_c0[1] = (int)round_half_away(
                ((center_off[1] + y_off[0]) - center_off[4]) * scale);
            if (blockIdx.x == 0 && blockIdx.z == 0) ang[a] = h;
        }
    } else {
        cx = cand_x0[0];
        cy = cand_y0[0];
    }

    // this thread's cells; a cell past the lattice reads cell 0's offset
    // (valid for any beam that reads it) and is never stored
    int ci[CPT], cj[CPT], acc[CPT];
    Off off[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        Off cell = (Off)blockIdx.x * TILE + c * 32 + lane;
        cell = cell < ncell ? cell : 0;
        ci[c] = (int)(cell / nx);
        cj[c] = (int)(cell - (Off)ci[c] * nx);
        off[c] = 2 * ((Off)ci[c] * G + cj[c]);
        acc[c] = 0;
    }
    for (int k = threadIdx.x; k < TILE; k += NT) s_sum[k] = 0;

    const int b_end = min(B, (int)blockIdx.z * chunk + chunk);
    for (int b0 = blockIdx.z * chunk; b0 < b_end; b0 += SB) {
        const int nb = min(SB, b_end - b0);
        // head form: the first round's flag and local point in flight
        // across the barrier
        bool f1 = false;
        float lx1 = 0.0f, ly1 = 0.0f;
        if (kHead && threadIdx.x < nb) {
            const float* l = local + (long long)(b0 + threadIdx.x) * lstride;
            f1 = finite[b0 + threadIdx.x];
            lx1 = l[0];
            ly1 = l[1];
        }
        if (threadIdx.x == 0) s_n[0] = s_n[1] = 0;
        __syncthreads();
        if (kHead) {
            hc = s_rot[0];
            hs = s_rot[1];
            cx = s_c0[0];
            cy = s_c0[1];
        }
        for (int k0 = 0; k0 < nb; k0 += NT) {   // uniform trip count
            const int k = k0 + threadIdx.x;
            int cls = 0, ilo = 0, jlo = 0, ni = 0, nj = 0;
            Off base = 0;
            bool fin;
            float lx = 0.0f, ly = 0.0f;
            if (kHead) {
                fin = f1;
                lx = lx1;
                ly = ly1;
                if (k0 > 0) {
                    fin = false;
                    if (k < nb) {
                        const float* l = local + (long long)(b0 + k) * lstride;
                        fin = finite[b0 + k];
                        lx = l[0];
                        ly = l[1];
                    }
                }
            } else {
                fin = k < nb && finite[b0 + k];
            }
            if (fin) {
                int2 t;
                if (kHead) {
                    t.x = (int)round_half_away((hc * lx - hs * ly) * scale);
                    t.y = (int)round_half_away((hs * lx + hc * ly) * scale);
                } else {
                    t = d[(size_t)a * B + b0 + k];
                }
                const long long y0 = cy + t.y, x0 = cx + t.x;
                ni = lattice_span(y0, G, ny, &ilo);
                nj = lattice_span(x0, G, nx, &jlo);
                if (ni && nj) {
                    cls = ni == ny && nj == nx ? 1 : 2;
                    base = (Off)(y0 * G + x0);
                }
            }
            const unsigned fm = __ballot_sync(~0u, cls == 1);
            const unsigned pm = __ballot_sync(~0u, cls == 2);
            int fb = 0, pb = 0;
            if (lane == 0) {
                if (fm) fb = atomicAdd(&s_n[0], __popc(fm));
                if (pm) pb = atomicAdd(&s_n[1], __popc(pm));
            }
            fb = __shfl_sync(~0u, fb, 0);
            pb = __shfl_sync(~0u, pb, 0);
            const unsigned below = (1u << lane) - 1;
            if (cls == 1) {
                s_base[fb + __popc(fm & below)] = base;
            } else if (cls == 2) {
                const int s = SB - 1 - (pb + __popc(pm & below));
                s_base[s] = base;
                put_span(&s_span[s], ilo, ni, jlo, nj);
            }
        }
        __syncthreads();
        const int nf = s_n[0], np = s_n[1];
#pragma unroll 4
        for (int k = warp; k < nf; k += W) {
            const int8_t* g = grid + s_base[k];
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[c] += __ldg(g + off[c]);
        }
#pragma unroll 2
        for (int k = warp; k < np; k += W) {
            const int s = SB - 1 - k;
            const int8_t* g = grid + s_base[s];
            int ilo, jlo;
            unsigned ni, nj;
            get_span(s_span[s], &ilo, &ni, &jlo, &nj);
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                if ((unsigned)(ci[c] - ilo) < ni &&
                    (unsigned)(cj[c] - jlo) < nj)
                    acc[c] += __ldg(g + off[c]);
        }
        __syncthreads();   // the next batch overwrites the lists
    }

    __syncthreads();   // s_sum's zeros, also when B is 0
#pragma unroll
    for (int c = 0; c < CPT; ++c) atomicAdd(&s_sum[c * 32 + lane], acc[c]);
    __syncthreads();
    int* o = out + (size_t)a * ncell + (size_t)blockIdx.x * TILE;
    for (int k = threadIdx.x; k < TILE; k += NT) {
        if ((Off)blockIdx.x * TILE + k >= ncell) break;
        if (s_sum[k]) atomicAdd(o + k, s_sum[k]);
    }
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

// the narrow instantiation takes the geometry: 16-bit span fields; int32
// raster offsets, the lattice's reach included; headings in one launch
bool narrow(int G, int na, int ny, int nx) {
    return na <= kMaxGridY && ny <= 0xffff && nx <= 0xffff &&
           (long long)(G + 2LL * (ny + nx)) * (G + 2LL * (ny + nx)) < INT_MAX;
}

// the arguments both entry points share; the launcher picks the form's
// narrow or wide instantiation
struct Launch {
    const int8_t* grid;
    int G;
    const int2* d;
    const int* cand_x0;
    const int* cand_y0;
    const float* center_off;
    const float* local;
    int lstride;
    const float* x_off;
    const float* y_off;
    float scale, angle_offset, angle_res;
    float* ang;
    int na, B, ny, nx;
    const uint8_t* finite;
    int* out;
};

template <bool kHead, bool kWide>
void launch_headings(const Launch& p, dim3 grid, int chunk, int a0,
                     cudaStream_t st) {
    if constexpr (!kHead && !kWide) {
        score_windows_kernel<<<grid, NT, 0, st>>>(
            p.grid, p.G, p.d, p.cand_x0, p.cand_y0, p.B, chunk, p.ny, p.nx,
            p.finite, p.out);
    } else {
        score_windows_any_kernel<kHead, kWide><<<grid, NT, 0, st>>>(
            p.grid, p.G, p.d, p.cand_x0, p.cand_y0, p.center_off, p.local,
            p.lstride, p.x_off, p.y_off, p.scale, p.angle_offset,
            p.angle_res, p.ang, p.B, chunk, p.ny, p.nx, a0, p.finite, p.out);
    }
}

template <bool kHead>
int launch(const Launch& p, cudaStream_t st) {
    if (p.na <= 0 || p.ny <= 0 || p.nx <= 0) return 0;
    const long long ncell = (long long)p.ny * p.nx;
    const long long tiles = (ncell + TILE - 1) / TILE;
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemsetAsync(
        p.out, 0, (size_t)p.na * ncell * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    if (p.B == 0 && !kHead) return (int)cudaGetLastError();
    const bool wide = !narrow(p.G, p.na, p.ny, p.nx);
    const long long base_blocks = std::min<long long>(p.na, kMaxGridY)
                                  * tiles;
    // about two blocks of NT threads per SM, chunks of 32 beams at least
    long long nch = (2LL * sm_count() + base_blocks - 1) / base_blocks;
    nch = std::max(1LL, std::min(nch, (long long)(p.B + 31) / 32));
    const int chunk = (int)((p.B + nch - 1) / nch);
    nch = chunk > 0 ? (p.B + chunk - 1) / chunk : 1;
    for (int a0 = 0; a0 < p.na; a0 += kMaxGridY) {
        const dim3 grid((unsigned)tiles, std::min(p.na - a0, kMaxGridY),
                        (unsigned)nch);
        if (wide)
            launch_headings<kHead, true>(p, grid, chunk, a0, st);
        else
            launch_headings<kHead, false>(p, grid, chunk, a0, st);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // namespace

// The table form: out (na, ny, nx) int32 from d (na, B, 2) int32 and the
// lattice origin cand_x0 / cand_y0 (one int32 each, on the device).
extern "C" int score_windows(
    const void* grid, int G, const void* d, const void* cand_x0,
    const void* cand_y0, int na, int B, int ny, int nx, const void* finite,
    void* out, void* stream) {
    Launch p{(const int8_t*)grid, G, (const int2*)d, (const int*)cand_x0,
             (const int*)cand_y0, nullptr, nullptr, 0, nullptr, nullptr,
             0.0f, 0.0f, 0.0f, nullptr, na, B, ny, nx,
             (const uint8_t*)finite, (int*)out};
    return launch<false>(p, (cudaStream_t)stream);
}

// The head form: out (na, ny, nx) int32 and ang (na,) f32 from
// center_off (5,) f32, local (B, 2) f32 with row stride lstride, the
// coarse offsets x_off (nx,) / y_off (ny,) f32 and the headings' offset
// and step.
extern "C" int score_windows_head(
    const void* grid, int G, const float* center_off, const float* local,
    int lstride, const float* x_off, const float* y_off, float scale,
    float angle_offset, float angle_res, int na, int B, int ny, int nx,
    const void* finite, void* out, float* ang, void* stream) {
    Launch p{(const int8_t*)grid, G, nullptr, nullptr, nullptr, center_off,
             local, lstride, x_off, y_off, scale, angle_offset, angle_res,
             ang, na, B, ny, nx, (const uint8_t*)finite, (int*)out};
    return launch<true>(p, (cudaStream_t)stream);
}
