// score_head: the coarse pass's preamble of a match: the headings, their
// rotated beam tables and the lattice origin that score_windows takes.
//
// Replaces no Pallas kernel. It stands for the XLA-fused tensor code at
// the head of the JAX package's _score_impl (slam_toolbox_tpu/kernels/
// match.py:717-758: ang_c, _rotated_tables at :612, cand_x / cand_y); in
// the port the plain version is kernels/step_cuda.py score_head_plain.
//
//   center_off (5,) f32 [x, y, heading, offset x, offset y], local (B, 2)
//   f32 with row stride lstride, x_off / y_off (n,) f32 ->
//   ang (na,) f32: (heading - coarse_angle_offset) + coarse_angle_res * a;
//   d (na, B, 2) int32: round_half_away(((c lx - s ly) scale,
//                                        (s lx + c ly) scale));
//   cand0 (2,) int32: round_half_away(((x + x_off[0]) - offset x) scale)
//                     and the same in y.
//
// Bound: bytes. It writes 8 bytes a (heading, beam) pair and reads 8 a
// beam: at the bench geometry (21 x 1081) about 0.2 MB, 0.06 us at 3.35
// TB/s, and about 20 operations a pair; a launch costs its fixed time.
// Design: one thread per (heading, beam) pair, flat, so the table is
// written with neighbouring threads on neighbouring pairs; the heading's
// cosf / sinf are taken per pair, which costs less than a second pass.
//
// Numerics: built with --fmad=false, the plain version's f32 operations in
// its order, cosf / sinf without fast math, round half away from zero as
// rasterize.round_half_away (floor(x + 0.5) or ceil(x - 0.5)) and the
// cast to int32 that PyTorch's .to(int32) makes: the outputs equal the
// plain version's on the card bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_half_away(float x) {
    return x >= 0.0f ? floorf(x + 0.5f) : ceilf(x - 0.5f);
}

__global__ void __launch_bounds__(kThreads)
score_head_kernel(const float* center_off, const float* local, int lstride,
                  int B, const float* x_off, const float* y_off, float scale,
                  float angle_offset, float angle_res, int na, float* ang,
                  int* d, int* cand0) {
    const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (idx == 0) {
        cand0[0] = (int)round_half_away(
            ((center_off[0] + x_off[0]) - center_off[3]) * scale);
        cand0[1] = (int)round_half_away(
            ((center_off[1] + y_off[0]) - center_off[4]) * scale);
    }
    if (idx >= (long long)na * B) return;
    const int a = (int)(idx / B);
    const int b = (int)(idx - (long long)a * B);
    const float h = (center_off[2] - angle_offset) + angle_res * (float)a;
    const float c = cosf(h), s = sinf(h);
    const float lx = local[(long long)b * lstride];
    const float ly = local[(long long)b * lstride + 1];
    const float rx = (c * lx - s * ly) * scale;
    const float ry = (s * lx + c * ly) * scale;
    d[2 * idx] = (int)round_half_away(rx);
    d[2 * idx + 1] = (int)round_half_away(ry);
    if (b == 0) ang[a] = h;
}

}  // namespace

extern "C" int score_head(const float* center_off, const float* local,
                          int lstride, int B, const float* x_off,
                          const float* y_off, float scale,
                          float angle_offset, float angle_res, int na,
                          float* ang, int* d, int* cand0,
                          cudaStream_t stream) {
    if (na < 1 || B < 1) return (int)cudaErrorInvalidValue;
    long long n = (long long)na * B;
    unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    score_head_kernel<<<blocks, kThreads, 0, stream>>>(
        center_off, local, lstride, B, x_off, y_off, scale, angle_offset,
        angle_res, na, ang, d, cand0);
    return (int)cudaGetLastError();
}
