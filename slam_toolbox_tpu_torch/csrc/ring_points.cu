// ring_points: the world points and device FindValidPoints of a ring (or a
// chain) of scan packs, and in step mode the drain step's prologue.
//
// Replaces no Pallas kernel. It stands for the XLA-fused tensor code of
// the JAX package's drain step before its raster (slam_toolbox_tpu/
// mapper/streaming.py _stream_raster_impl, with _transform_between and
// _compose) and of its chain rasters (kernels/loop_verify.py
// _chain_raster); in the port, the plain version is
// kernels/step_cuda.py ring_points_plain / ring_points_step_plain.
//
//   chain mode: packs (C, B, 8) f32 [local xy, anchor xy, current xy,
//     next_delim, flags], poses (C, 3) f32 with row stride pose_stride,
//     slot_valid (C,) bool or null, viewpoint (2,) f32 on the device ->
//     pts (C*B, 2) f32, valid (C*B,) bool.
//   step mode (step != null): the batch row r = *step; prior =
//     transform_between(last_odom, last_corrected, batch_odoms[r]),
//     center = compose(prior, offset_pose), center_off = [center, center.xy
//     - half_span]; the viewpoint is center.xy; block C writes center_off,
//     prior, scan_pack = batch_packs[r], scan_odom = batch_odoms[r] and
//     scan_finite = flags & 1.
//
// Bound: bytes. It reads each pack once (32 bytes a beam) and writes 9
// bytes a beam; at the bench geometry (12 slots x 1081 beams) that is
// about 0.5 MB, 0.15 us at 3.35 TB/s, so a launch costs its fixed time.
// Design: one block per scan, so the keep_run gather through next_delim
// (which stays within a scan) reads shared memory, and each block forms
// the viewpoint itself (a few trig calls) instead of a second launch.
//
// Numerics: built with --fmad=false, every f32 operation in the plain
// version's order (no contraction may flip the side test ss >= 0 or move a
// point across a cell edge), cosf / sinf / atan2f without fast math: the
// outputs equal the plain version's on the card bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct StepArgs {
    const long long* step;
    const float* batch_packs;
    const float* batch_odoms;
    const float* last_odom;
    const float* last_corrected;
    const float* offset_pose;
    float half_span;
    float* center_off;
    float* prior;
    float* scan_pack;
    float* scan_odom;
    bool* scan_finite;
};

// streaming._transform_between, term by term
__device__ void transform_between(const float* p1, const float* p2,
                                  const float* p, float* out) {
    float dh = p2[2] - p1[2];
    float c = cosf(dh), s = sinf(dh);
    float tx = p2[0] - (c * p1[0] - s * p1[1]);
    float ty = p2[1] - (s * p1[0] + c * p1[1]);
    float h = p[2] + dh;
    out[0] = tx + c * p[0] - s * p[1];
    out[1] = ty + s * p[0] + c * p[1];
    out[2] = atan2f(sinf(h), cosf(h));
}

// streaming._compose, term by term
__device__ void compose(const float* a, const float* b, float* out) {
    float ca = cosf(a[2]), sa = sinf(a[2]);
    float h = a[2] + b[2];
    out[0] = a[0] + ca * b[0] - sa * b[1];
    out[1] = a[1] + sa * b[0] + ca * b[1];
    out[2] = atan2f(sinf(h), cosf(h));
}

__global__ void __launch_bounds__(kThreads)
ring_points_kernel(const float* packs, const float* poses, int pose_stride,
                   const bool* slot_valid, const float* viewpoint, int C,
                   int B, StepArgs st, float* pts, bool* valid) {
    extern __shared__ unsigned char keep_run[];   // B flags of this scan
    __shared__ float vp[2];
    __shared__ long long row;
    const int c = blockIdx.x;
    const int tid = threadIdx.x;

    if (tid == 0) {
        if (st.step != nullptr) {
            row = *st.step;
            const float* odom = st.batch_odoms + 3 * row;
            float prior[3], center[3];
            transform_between(st.last_odom, st.last_corrected, odom, prior);
            compose(prior, st.offset_pose, center);
            vp[0] = center[0];
            vp[1] = center[1];
            if (c == C) {
                for (int k = 0; k < 3; ++k) {
                    st.center_off[k] = center[k];
                    st.prior[k] = prior[k];
                    st.scan_odom[k] = odom[k];
                }
                st.center_off[3] = center[0] - st.half_span;
                st.center_off[4] = center[1] - st.half_span;
            }
        } else {
            vp[0] = viewpoint[0];
            vp[1] = viewpoint[1];
        }
    }
    __syncthreads();

    if (c == C) {   // step mode's last block: the scan's own buffers
        const float* src = st.batch_packs + row * (long long)B * 8;
        for (int i = tid; i < B * 8; i += kThreads) st.scan_pack[i] = src[i];
        for (int b = tid; b < B; b += kThreads)
            st.scan_finite[b] = (((int)src[8 * b + 7]) & 1) > 0;
        return;
    }

    const float px = poses[(long long)c * pose_stride];
    const float py = poses[(long long)c * pose_stride + 1];
    const float ph = poses[(long long)c * pose_stride + 2];
    const float cs = cosf(ph), sn = sinf(ph);
    const float dvx = vp[0] - px;
    const float dvy = vp[1] - py;
    const float vxl = cs * dvx + sn * dvy;
    const float vyl = -sn * dvx + cs * dvy;
    const float* scan = packs + (long long)c * B * 8;

    for (int b = tid; b < B; b += kThreads) {
        const float* q = scan + 8 * b;
        float ax = q[2], ay = q[3];
        float a = vyl - ay;
        float bb = ax - vxl;
        float cc = ay * vxl - ax * vyl;
        float ss = q[4] * a + q[5] * bb + cc;
        int flags = (int)q[7];
        keep_run[b] = (ss >= 0.0f) && ((flags & 2) > 0);
    }
    __syncthreads();

    const bool slot = slot_valid == nullptr || slot_valid[c];
    for (int b = tid; b < B; b += kThreads) {
        const float* q = scan + 8 * b;
        float lx = q[0], ly = q[1];
        long long o = (long long)c * B + b;
        pts[2 * o] = px + cs * lx - sn * ly;
        pts[2 * o + 1] = py + sn * lx + cs * ly;
        long long nxt = (long long)q[6];
        int flags = (int)q[7];
        // next_delim indexes a delimiter slot of the same scan; the clamp
        // to the scan keeps a malformed pack inside shared memory
        long long k = nxt < 0 ? 0 : (nxt >= B ? B - 1 : nxt);
        valid[o] = nxt >= 0 && keep_run[k] && ((flags & 1) > 0) && slot;
    }
}

}  // namespace

extern "C" int ring_points(
    const float* packs, const float* poses, int pose_stride,
    const bool* slot_valid, const float* viewpoint, int C, int B,
    const long long* step, const float* batch_packs,
    const float* batch_odoms, const float* last_odom,
    const float* last_corrected, const float* offset_pose, float half_span,
    float* center_off, float* prior, float* scan_pack, float* scan_odom,
    bool* scan_finite, float* pts, bool* valid, cudaStream_t stream) {
    if (C < 1 || B < 1 || (step == nullptr && viewpoint == nullptr))
        return (int)cudaErrorInvalidValue;
    StepArgs st{step, batch_packs, batch_odoms, last_odom, last_corrected,
                offset_pose, half_span, center_off, prior, scan_pack,
                scan_odom, scan_finite};
    int blocks = C + (step != nullptr ? 1 : 0);
    ring_points_kernel<<<blocks, kThreads, B, stream>>>(
        packs, poses, pose_stride, slot_valid, viewpoint, C, B, st, pts,
        valid);
    return (int)cudaGetLastError();
}
