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
// about 0.5 MB, 0.15 us at 3.35 TB/s, so a launch costs its latency
// chain. Design: one block per scan, so the keep_run gather through
// next_delim (which stays within a scan) reads shared memory. A block has
// threads enough for two beams each (up to 1,024): every thread first
// starts the two 16-byte loads of each of its beams' rows and keeps them
// in registers across the keep_run barrier, so a row is read once (past
// 2,048 beams the earlier rounds are read again). In step mode the first
// thread of every block forms the viewpoint (transform_between, compose)
// while those loads are in flight; in chain mode every thread reads it.
// Step mode's last block copies the scan's pack with pack_copy.cuh's
// vector copy on warps 1.., which needs only the batch row, while its
// first thread forms and writes the prior.
//
// Geometry: a block's keep_run flags (a byte a beam) are its dynamic
// shared memory, opted in past 48 KB, up to its 227 KB less the static
// part (about 232,000 beams); past that the
// global instantiation keeps them in a scratch buffer the wrapper
// allocates, a scan's B bytes a block, written and read by that block
// across the same barrier. The arithmetic is the same in both, so any B
// runs on the kernel with the same outputs.
//
// Numerics: built with --fmad=false, every f32 operation in the plain
// version's order (no contraction may flip the side test ss >= 0 or move a
// point across a cell edge), cosf / sinf / atan2f without fast math: the
// outputs equal the plain version's on the card bit for bit.
#include <cuda_runtime.h>
#include <math.h>

#include "pack_copy.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kRows = 2;   // beams a thread holds in registers

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

// the step's prior and sensor pose from batch row `row`
__device__ void step_prior(const StepArgs& st, long long row, float* prior,
                           float* center) {
    transform_between(st.last_odom, st.last_corrected,
                      st.batch_odoms + 3 * row, prior);
    compose(prior, st.offset_pose, center);
}

// the rows of beams base + tid + k * T (k < kRows) into registers
__device__ __forceinline__ void load_rows(const float4* __restrict__ scan,
                                          int base, int B, float4* lo,
                                          float4* hi) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int b = base + threadIdx.x + k * blockDim.x;
        if (b < B) {
            lo[k] = scan[2 * b];
            hi[k] = scan[2 * b + 1];
        }
    }
}

// kGlobal: the keep_run flags in `flags` (B bytes a block) in place of
// dynamic shared memory
template <bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
ring_points_kernel(const float4* __restrict__ packs,
                   const float* __restrict__ poses, int pose_stride,
                   const bool* __restrict__ slot_valid,
                   const float* __restrict__ viewpoint, int C, int B,
                   StepArgs st, float2* __restrict__ pts,
                   bool* __restrict__ valid, unsigned char* flags) {
    extern __shared__ unsigned char s_keep[];
    __shared__ float vp[2];
    const int c = blockIdx.x;
    // B flags of this scan
    unsigned char* keep_run = kGlobal ? flags + (size_t)c * B : s_keep;
    const int tid = threadIdx.x, T = blockDim.x;
    const bool step_mode = st.step != nullptr;

    if (c == C) {   // step mode's last block: the scan's own buffers
        const long long row = *st.step;
        if (tid < 32) {
            if (tid == 0) {
                float prior[3], center[3];
                step_prior(st, row, prior, center);
                for (int k = 0; k < 3; ++k) {
                    st.center_off[k] = center[k];
                    st.prior[k] = prior[k];
                    st.scan_odom[k] = st.batch_odoms[3 * row + k];
                }
                st.center_off[3] = center[0] - st.half_span;
                st.center_off[4] = center[1] - st.half_span;
            }
        } else {
            pack_copy::copy_pack<8>(
                reinterpret_cast<float4*>(st.scan_pack),
                reinterpret_cast<const float4*>(st.batch_packs)
                    + row * 2LL * B,
                2 * B, tid - 32, T - 32, st.scan_finite);
        }
        return;
    }

    // this scan's rows, in flight while the viewpoint is formed
    const float4* scan = packs + (long long)c * B * 2;
    float4 lo[kRows], hi[kRows];
    load_rows(scan, 0, B, lo, hi);
    const float px = poses[(long long)c * pose_stride];
    const float py = poses[(long long)c * pose_stride + 1];
    const float ph = poses[(long long)c * pose_stride + 2];
    const bool slot = slot_valid == nullptr || slot_valid[c];
    float vx, vy;
    if (step_mode) {
        if (tid == 0) {
            float prior[3], center[3];
            step_prior(st, *st.step, prior, center);
            vp[0] = center[0];
            vp[1] = center[1];
        }
        __syncthreads();
        vx = vp[0];
        vy = vp[1];
    } else {
        vx = viewpoint[0];
        vy = viewpoint[1];
    }
    const float cs = cosf(ph), sn = sinf(ph);
    const float dvx = vx - px;
    const float dvy = vy - py;
    const float vxl = cs * dvx + sn * dvy;
    const float vyl = -sn * dvx + cs * dvy;

    // keep_run of every beam; the last round's rows stay in registers
    const int per_round = kRows * T;
    const int last = ((B - 1) / per_round) * per_round;
    for (int base = 0;; base += per_round) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const int b = base + tid + k * T;
            if (b < B) {
                const float ax = lo[k].z, ay = lo[k].w;
                const float a = vyl - ay;
                const float bb = ax - vxl;
                const float cc = ay * vxl - ax * vyl;
                const float ss = hi[k].x * a + hi[k].y * bb + cc;
                const int flags = (int)hi[k].w;
                keep_run[b] = (ss >= 0.0f) && ((flags & 2) > 0);
            }
        }
        if (base == last) break;
        load_rows(scan, base + per_round, B, lo, hi);
    }
    __syncthreads();

    // points and validity: the last round from registers, then any
    // earlier round read again
    for (int base = last;;) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const int b = base + tid + k * T;
            if (b < B) {
                const float lx = lo[k].x, ly = lo[k].y;
                const long long o = (long long)c * B + b;
                pts[o] = make_float2(px + cs * lx - sn * ly,
                                     py + sn * lx + cs * ly);
                const long long nxt = (long long)hi[k].z;
                const int flags = (int)hi[k].w;
                // next_delim indexes a delimiter slot of the same scan;
                // the clamp to the scan keeps a malformed pack inside
                // shared memory
                const long long j = nxt < 0 ? 0 : (nxt >= B ? B - 1 : nxt);
                valid[o] = nxt >= 0 && keep_run[j] && ((flags & 1) > 0)
                           && slot;
            }
        }
        base = base == last ? 0 : base + per_round;
        if (base >= last) break;
        load_rows(scan, base, B, lo, hi);
    }
}

// the dynamic shared bytes a block of the shared instantiation may take
int max_flags() {
    static int n = -1;
    if (n < 0) {
        int dev = 0, optin = 0;
        cudaFuncAttributes fa;
        if (cudaGetDevice(&dev) != cudaSuccess
                || cudaDeviceGetAttribute(
                       &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                       dev) != cudaSuccess
                || cudaFuncGetAttributes(
                       &fa, (const void*)ring_points_kernel<false>)
                       != cudaSuccess)
            return 0;
        n = optin - (int)fa.sharedSizeBytes;
    }
    return n;
}

}  // namespace

// The scratch bytes ring_points needs for C scans of B beams: 0 where a
// block's flags fit its shared memory, else B bytes a scan.
extern "C" long long ring_points_scratch_bytes(int C, int B) {
    return B <= max_flags() ? 0 : (long long)C * B;
}

extern "C" int ring_points(
    const float* packs, const float* poses, int pose_stride,
    const bool* slot_valid, const float* viewpoint, int C, int B,
    const long long* step, const float* batch_packs,
    const float* batch_odoms, const float* last_odom,
    const float* last_corrected, const float* offset_pose, float half_span,
    float* center_off, float* prior, float* scan_pack, float* scan_odom,
    bool* scan_finite, float* pts, bool* valid, unsigned char* flags,
    cudaStream_t stream) {
    if (C < 1 || B < 1 || (step == nullptr && viewpoint == nullptr)
            || reinterpret_cast<size_t>(packs) % 16 != 0
            || (step != nullptr
                && (reinterpret_cast<size_t>(batch_packs) % 16 != 0
                    || reinterpret_cast<size_t>(scan_pack) % 16 != 0))
            || reinterpret_cast<size_t>(pts) % 8 != 0)
        return (int)cudaErrorInvalidValue;
    StepArgs st{step, batch_packs, batch_odoms, last_odom, last_corrected,
                offset_pose, half_span, center_off, prior, scan_pack,
                scan_odom, scan_finite};
    // two beams a thread, whole warps, at least two of them (the step
    // block's first warp forms the prior, the others copy)
    int threads = ((B + kRows - 1) / kRows + 31) / 32 * 32;
    threads = threads < 64 ? 64 : (threads > kMaxThreads ? kMaxThreads
                                                         : threads);
    int blocks = C + (step != nullptr ? 1 : 0);
    if (flags != nullptr) {
        ring_points_kernel<true><<<blocks, threads, 0, stream>>>(
            reinterpret_cast<const float4*>(packs), poses, pose_stride,
            slot_valid, viewpoint, C, B, st, reinterpret_cast<float2*>(pts),
            valid, flags);
        return (int)cudaGetLastError();
    }
    if (B > max_flags()) return (int)cudaErrorInvalidValue;
    if (B > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            (const void*)ring_points_kernel<false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, B);
        if (e != cudaSuccess) return (int)e;
    }
    ring_points_kernel<false><<<blocks, threads, B, stream>>>(
        reinterpret_cast<const float4*>(packs), poses, pose_stride,
        slot_valid, viewpoint, C, B, st, reinterpret_cast<float2*>(pts),
        valid, nullptr);
    return (int)cudaGetLastError();
}
