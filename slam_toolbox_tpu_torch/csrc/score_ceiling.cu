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
// Block and thread layout are score_windows.cu's (one thread per
// candidate cell, one block per (64-beam chunk, heading, 256-cell tile),
// int32 atomicAdd of the chunk sums); what goes is the shared-memory
// table staging and its loads, the finite test and the table's scattered
// raster reads. The TPU version's parity split, row phases and bit-roll
// are Mosaic layout devices and are not carried over. Bound on the H100:
// the gathered int32 adds (21 x 1081 x 676 at the bench geometry); the
// eight offsets keep each thread's reads in eight cache lines.
#include <cuda_runtime.h>
#include <stdint.h>

// (dx, dy) in cells; tests/test_torch_match_kernels.py holds these
// against match_cuda.CEIL_OFFSETS.
#define CEIL_OFFSETS_DX {612, -480, 133, -57, 890, -821, 305, -214}
#define CEIL_OFFSETS_DY {-35, 271, 702, -655, 404, -230, -877, 515}

namespace {

constexpr int NT = 256;   // candidate cells per block
constexpr int BCH = 64;   // beams per block
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(NT) score_ceiling_kernel(
    const int8_t* __restrict__ grid, int G, const int* __restrict__ cand_x0,
    const int* __restrict__ cand_y0, int B, int ny, int nx,
    int* __restrict__ out) {
    constexpr int kDx[UNROLL] = CEIL_OFFSETS_DX;
    constexpr int kDy[UNROLL] = CEIL_OFFSETS_DY;
    const int a = blockIdx.y;
    const int b0 = blockIdx.x * BCH;
    const int nb = min(BCH, B - b0);
    const int c = blockIdx.z * NT + threadIdx.x;
    if (c >= ny * nx) return;
    const int i = c / nx, j = c - i * nx;
    const long long by = (long long)cand_y0[0] + 2 * i;
    const long long bx = (long long)cand_x0[0] + 2 * j;
    // slot a * B + b0 + k uses offset (phase + k) mod 8; starting k at
    // -phase makes the unrolled u the offset index, a compile-time constant
    const int phase = (int)(((long long)a * B + b0) % UNROLL);
    int acc = 0;
    for (int k0 = -phase; k0 < nb; k0 += UNROLL) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int k = k0 + u;
            if (k < 0 || k >= nb) continue;
            const long long y = by + kDy[u], x = bx + kDx[u];
            if (y >= 0 && y < G && x >= 0 && x < G) acc += grid[y * G + x];
        }
    }
    if (acc) atomicAdd(out + (size_t)i * nx + j, acc);
}

}  // namespace

extern "C" int score_ceiling(
    const void* grid, int G, const void* cand_x0, const void* cand_y0,
    int na, int B, int ny, int nx, void* out, void* stream) {
    if (na > 0 && B > 0 && ny > 0 && nx > 0) {
        const dim3 blocks((B + BCH - 1) / BCH, na, (ny * nx + NT - 1) / NT);
        score_ceiling_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
            (const int8_t*)grid, G, (const int*)cand_x0,
            (const int*)cand_y0, B, ny, nx, (int*)out);
    }
    return (int)cudaGetLastError();
}
