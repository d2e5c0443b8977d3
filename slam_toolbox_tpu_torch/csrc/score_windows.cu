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
// What bounds it on the H100: not bytes (the raster, 4.2 MB at G 2051,
// sits in the 50 MB L2) but the instructions executed per gathered byte
// and the loads in flight: 21 x 1081 x 676 = 15.3 M one-byte gathers at
// the bench geometry, each needing its cell's coordinates, a bounds test
// and an address if done per cell.
//
// The design:
// - Per-beam lattice spans. For each (heading, beam) the block computes
//   once, in 64-bit with floor division, the lattice rows [i_lo, i_hi)
//   and columns [j_lo, j_hi) whose cells fall inside the grid, and an
//   int32 base offset (cand_y0 + dy) * G + cand_x0 + dx. A non-finite
//   beam, or one whose span is empty (the INT_MIN and 1 << 28 entries of
//   NaN beams included), is dropped; a beam that covers the whole lattice
//   is full; the rest are partial. Full and partial beams are staged in
//   shared memory in two lists.
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
// int32 sums of int8 values are exact in any order, so the result equals
// the plain version's bit for bit.
#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPT = 4;            // lattice cells per thread
constexpr int TILE = 32 * CPT;    // lattice cells per block
constexpr int NT = 256;           // threads per block
constexpr int SB = 1152;          // beams staged in shared memory at a time

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

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
}

bool fits(int G, int ny, int nx) {
    // 16-bit span fields; int32 raster offsets, the lattice's reach included
    return ny <= 0xffff && nx <= 0xffff &&
           (long long)(G + 2LL * (ny + nx)) * (G + 2LL * (ny + nx)) < INT_MAX;
}

}  // namespace

extern "C" int score_windows(
    const void* grid, int G, const void* d, const void* cand_x0,
    const void* cand_y0, int na, int B, int ny, int nx, const void* finite,
    void* out, void* stream) {
    if (na <= 0 || ny <= 0 || nx <= 0) return 0;
    if (!fits(G, ny, nx)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int tiles = (ny * nx + TILE - 1) / TILE;
    cudaMemsetAsync(out, 0, (size_t)na * ny * nx * sizeof(int), st);
    if (B > 0) {
        const int base_blocks = na * tiles;
        // about two blocks of NT threads per SM, chunks of 32 beams at least
        int nch = (2 * sm_count() + base_blocks - 1) / base_blocks;
        nch = std::max(1, std::min(nch, (B + 31) / 32));
        const int chunk = (B + nch - 1) / nch;
        nch = (B + chunk - 1) / chunk;
        score_windows_kernel<<<dim3(tiles, na, nch), NT, 0, st>>>(
            (const int8_t*)grid, G, (const int2*)d, (const int*)cand_x0,
            (const int*)cand_y0, B, chunk, ny, nx, (const uint8_t*)finite,
            (int*)out);
    }
    return (int)cudaGetLastError();
}
