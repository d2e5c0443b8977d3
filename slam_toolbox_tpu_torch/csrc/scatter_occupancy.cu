// Binary occupancy stamp of the correlation raster's base-scan points,
// written as bits packed along axis 0.
//
// Replaces the Pallas kernel slam_toolbox_tpu/kernels/match_pallas.py
// _scatter_bits (_make_bit_scatter_kernel.kern; pallas_call at :234). The
// TPU version sorts the points by row band and ORs one-hot bits into
// register tiles, because the TPU serialises scattered stores. On Hopper
// a scattered 32-bit atomic OR is cheap, so this kernel runs one thread
// per point and ORs the point's bit into its word: no sort.
//
// Layout (the smear kernel's input, csrc/smear_quantize.cu): a
// (ceil(G/32), G) array of 32-bit words; word (iy >> 5, ix) holds rows
// 32 (iy >> 5) .. +31 of column ix, bit iy & 31 for row iy. At G = 2051
// that is 533,260 bytes against the 4.2 MB of a byte grid.
//
// Bound on the H100: bytes. The function reads 9 bytes per point and
// writes the packed words once. The launcher zero-fills the words with
// cudaMemsetAsync on the caller's stream, so one call from the wrapper
// is one host crossing, records into a CUDA graph, and never syncs.
//
// Contention: a wall along axis 0 puts up to 32 consecutive beams on one
// word. Merging one warp's ORs to a word before the atomic
// (__match_any_sync + __reduce_or_sync) was measured slower on the main
// path's rings and chains (chip_smoke.py, PERF.md), so each point issues
// its own atomic.
//
// Exactness: the cell is round_half_away((p - offset) * scale) in f32, as
// in slam_toolbox_tpu/kernels/rasterize.py. The _rn intrinsics keep nvcc
// from contracting the arithmetic into an FMA, and the in-grid test runs
// on the floats before any float->int conversion (padding points sit at
// -1e9, far outside int range after scaling).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_half_away(float x) {
    return x >= 0.f ? floorf(__fadd_rn(x, 0.5f)) : ceilf(__fsub_rn(x, 0.5f));
}

__global__ void scatter_occupancy_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ valid,
    const float* __restrict__ offset, float scale, int G, int P,
    uint32_t* __restrict__ words) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= P || !valid[i]) return;
    const float fx = round_half_away(
        __fmul_rn(__fsub_rn(pts[2 * i], offset[0]), scale));
    const float fy = round_half_away(
        __fmul_rn(__fsub_rn(pts[2 * i + 1], offset[1]), scale));
    const float g = (float)G;
    // NaN fails every comparison, so it is dropped here too
    if (!(fx >= 0.f && fx < g && fy >= 0.f && fy < g)) return;
    const int ix = (int)fx, iy = (int)fy;
    atomicOr(words + (size_t)(iy >> 5) * G + ix, 1u << (iy & 31));
}

}  // namespace

extern "C" int scatter_occupancy(
    const void* pts, const void* valid, const void* offset, float scale,
    int G, int P, void* words, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const size_t nbytes = (size_t)((G + 31) / 32) * G * sizeof(uint32_t);
    cudaError_t e = cudaMemsetAsync(words, 0, nbytes, s);
    if (e != cudaSuccess) return (int)e;
    if (P > 0) {
        const int threads = 256;
        scatter_occupancy_kernel<<<(P + threads - 1) / threads, threads, 0,
                                   s>>>(
            (const float*)pts, (const uint8_t*)valid, (const float*)offset,
            scale, G, P, (uint32_t*)words);
    }
    return (int)cudaGetLastError();
}
