// The window-score ceiling: score_windows.cu's data path with the
// per-beam table replaced by compile-time offsets.
//
// Replaces the Pallas kernel scripts/exp_roofline.py mk_ceil.kern
// (pallas_call at :123), the roofline measurement's ceiling for the
// coarse window score. Beam slot s = a * B + b (heading a, beam b) reads
// the raster at offset CEIL_OFFSET(s mod 8), as mk_ceil cycles
// BEAM_UNROLL = 8 static offsets, and every beam counts (no finite mask).
// Output (ny, nx) int32: for lattice cell (i, j) the sum over all slots of
//   raster[cand_y0 + 2i + dy(s mod 8), cand_x0 + 2j + dx(s mod 8)],
// cells outside the G x G grid adding 0. That is score_windows on a table
// tiling the 8 offsets with every beam finite, summed over headings.
//
// What bounds it on the H100 is what bounds score_windows: the one-byte
// gathers (21 x 1081 x 676 at the bench geometry) through L1, where a
// warp's load of 32 lattice cells touches two raster rows, and the fixed
// cost of the fill, the launch and the set-up. The design is
// score_windows' with the table taken out, so that the two differ by the
// table alone:
// - Spans per offset. Lane l of each warp computes the lattice span of
//   offset l mod 8 with score_windows' lattice_span (64-bit, floor
//   division by shift) and its int32 base offset, and shuffles broadcast
//   them; an offset is full, partial or empty, the same in every thread,
//   so the branches on the class are uniform. What goes is score_windows'
//   staging: no table loads, no shared-memory lists, no ballots, no
//   __syncthreads before the epilogue.
// - Slots, not headings: the sum runs over headings, so slots [0, na B)
//   form one range, cut into chunks whose starts are multiples of 8. A
//   warp takes every W-th group of 8 slots of its block's chunk, so slot
//   s takes offset u = s mod 8, and the loop over u (unrolled, u a
//   compile-time constant) runs outside the loop over the warp's slots of
//   offset u; the range's ragged last group needs no test of its own.
// - Four cells per thread, the per-cell offset 2 (i G + j) precomputed:
//   each slot feeds four independent loads. Full offsets load with no
//   test, partial ones only the cells inside (two unsigned compares per
//   cell, once per offset), empty ones issue no load.
// - One load per (slot, cell). The addresses of an offset do not change
//   from slot to slot, and ptxas hoists a read-only (ld.global.nc) load
//   out of the loop even from a volatile asm; a relaxed load at CTA scope
//   stays where it is. chip_smoke counts the loads inside loops in the
//   SASS.
// - Exit as score_windows: a block sums its warps in shared memory and
//   adds each cell's sum with one int32 atomicAdd; the launcher zero-fills
//   the output with cudaMemsetAsync on the caller's stream, so a call
//   makes no PyTorch launch, and sizes the chunks from na B, the cell
//   tiles and the SM count (about two blocks of 256 threads per SM).
// int32 sums of int8 values are exact in any order, so the result equals
// the plain version's bit for bit.
#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

// (dx, dy) in cells; tests/test_torch_match_kernels.py holds these
// against match_cuda.CEIL_OFFSETS.
#define CEIL_OFFSETS_DX {612, -480, 133, -57, 890, -821, 305, -214}
#define CEIL_OFFSETS_DY {-35, 271, 702, -655, 404, -230, -877, 515}

namespace {

constexpr int CPT = 4;            // lattice cells per thread
constexpr int TILE = 32 * CPT;    // lattice cells per block
constexpr int NT = 256;           // threads per block
constexpr int W = NT / 32;        // warps per block
constexpr int U = 8;              // offsets, slots per group

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

// One signed byte by a relaxed load at CTA scope (LDG.STRONG.SM, which
// times like a read-only load, so L1 serves it): a memory-model operation
// that neither NVVM nor ptxas hoists out of the slot loop or merges with
// the next slot's.
__device__ __forceinline__ int load_s8(const int8_t* p) {
    int v;
    asm volatile("ld.relaxed.cta.global.s8 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

__global__ void __launch_bounds__(NT) score_ceiling_kernel(
    const int8_t* __restrict__ grid, int G, const int* __restrict__ cand_x0,
    const int* __restrict__ cand_y0, int S, int chunk, int ny, int nx,
    int* __restrict__ out) {
    constexpr int kDx[U] = CEIL_OFFSETS_DX;
    constexpr int kDy[U] = CEIL_OFFSETS_DY;
    __shared__ int s_sum[TILE];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ncell = ny * nx;
    const long long cx = cand_x0[0], cy = cand_y0[0];

    // this thread's cells; a cell past the lattice reads cell 0's offset
    // (valid for any offset that reads it) and is never stored
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

    // The offsets' spans, one offset per lane (lane & 7) and broadcast by
    // shuffles: ilo | ni << 16 over the rows, the same over the columns,
    // and the int32 base offset; ni or nj 0 makes the offset empty.
    unsigned my_si, my_sj;
    int my_base;
    {
        const int u = lane & (U - 1);
        const long long y0 = cy + kDy[u], x0 = cx + kDx[u];
        int ilo, jlo;
        const int ni = lattice_span(y0, G, ny, &ilo);
        const int nj = lattice_span(x0, G, nx, &jlo);
        my_si = (unsigned)ilo | (unsigned)ni << 16;
        my_sj = (unsigned)jlo | (unsigned)nj << 16;
        my_base = ni && nj ? (int)(y0 * G + x0) : 0;
    }

    // This warp's slots of offset u are s_first + u + k U W, k >= 0: the
    // warp takes every W-th group of 8 slots of the block's chunk, whose
    // start is a multiple of 8, and the last group may be ragged.
    const int s_first = blockIdx.y * chunk + U * warp;
    const int s_end =
        (int)min((long long)S, (long long)blockIdx.y * chunk + chunk);
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const unsigned si = __shfl_sync(~0u, my_si, u);
        const unsigned sj = __shfl_sync(~0u, my_sj, u);
        const int base = __shfl_sync(~0u, my_base, u);
        const int ilo = si & 0xffff, jlo = sj & 0xffff;
        const unsigned ni = si >> 16, nj = sj >> 16;
        if (ni == 0 || nj == 0) continue;   // empty: no load
        const int8_t* p[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) p[c] = grid + (base + off[c]);
        if (ni == (unsigned)ny && nj == (unsigned)nx) {   // full: no test
#pragma unroll 2
            for (int s = s_first + u; s < s_end; s += U * W)
#pragma unroll
                for (int c = 0; c < CPT; ++c) acc[c] += load_s8(p[c]);
        } else {                            // partial: the cells inside
            bool in[CPT];
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                in[c] = (unsigned)(ci[c] - ilo) < ni &&
                        (unsigned)(cj[c] - jlo) < nj;
#pragma unroll 2
            for (int s = s_first + u; s < s_end; s += U * W)
#pragma unroll
                for (int c = 0; c < CPT; ++c)
                    if (in[c]) acc[c] += load_s8(p[c]);
        }
    }

    __syncthreads();   // s_sum's zeros
#pragma unroll
    for (int c = 0; c < CPT; ++c) atomicAdd(&s_sum[c * 32 + lane], acc[c]);
    __syncthreads();
    int* o = out + blockIdx.x * TILE;
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

bool fits(int G, int ny, int nx, long long S) {
    // 16-bit span fields; int32 raster offsets, the lattice's reach
    // included; int32 slots
    return ny <= 0xffff && nx <= 0xffff &&
           (long long)(G + 2LL * (ny + nx)) * (G + 2LL * (ny + nx)) <
               INT_MAX &&
           S <= INT_MAX - U * NT;
}

}  // namespace

extern "C" int score_ceiling(
    const void* grid, int G, const void* cand_x0, const void* cand_y0,
    int na, int B, int ny, int nx, void* out, void* stream) {
    if (ny <= 0 || nx <= 0) return 0;
    const long long S = na > 0 && B > 0 ? (long long)na * B : 0;
    if (!fits(G, ny, nx, S)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e =
        cudaMemsetAsync(out, 0, (size_t)ny * nx * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    if (S > 0) {
        const int slots = (int)S;
        const int tiles = (ny * nx + TILE - 1) / TILE;
        // about two blocks of NT threads per SM, a group per warp at least
        int nch = (2 * sm_count() + tiles - 1) / tiles;
        nch = std::max(1, std::min(nch, (slots + U * W - 1) / (U * W)));
        int chunk = (slots + nch - 1) / nch;
        chunk = (chunk + U - 1) / U * U;   // chunks start on a group
        nch = (slots + chunk - 1) / chunk;
        score_ceiling_kernel<<<dim3(tiles, nch), NT, 0, st>>>(
            (const int8_t*)grid, G, (const int*)cand_x0,
            (const int*)cand_y0, slots, chunk, ny, nx, (int*)out);
    }
    return (int)cudaGetLastError();
}
