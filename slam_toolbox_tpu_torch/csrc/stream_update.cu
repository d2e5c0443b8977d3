// stream_update: the drain step's state update after its match: the
// first scan's selection, the corrected pose, the ring push, the eviction,
// the state's scalars and the result row.
//
// Replaces no Pallas kernel. It stands for the XLA-fused tensor code of
// the JAX package's _stream_update_impl after _score_impl (slam_toolbox_
// tpu/mapper/streaming.py:223, with _corrected_at and the eviction's
// while_loop); in the port the plain version is kernels/step_cuda.py
// stream_update_plain. Every tensor is updated in place:
//
//   is_first = count == 0; mean = is_first ? center : packed[1:4];
//   response = is_first ? 0 : packed[0]; cov = is_first ? I : packed[4:13];
//   corrected = corrected_at(mean, offset_pose);
//   idx = (head + count) % K: ring_pack[idx] = pack, ring_pose[idx] = mean,
//   ring_slot_valid[idx] = true;
//   n_ev = the leading run of cond(e) = ct > 1 && (ct > run_buffer_size ||
//   |ring_pose[(head + e) % K] - mean|^2 > max_sq), ct = count + 1 - e;
//   head = (head + n_ev) % K, count = count + 1 - n_ev;
//   last_odom = odom, last_corrected = corrected;
//   results[ridx] = [response, mean, cov], ridx = (ridx + 1) % R;
//   step += 1.
//
// Bound: bytes. The push copies one pack (32 bytes a beam: 35 KB at 1081
// beams), about 0.02 us at 3.35 TB/s; the rest is a few hundred bytes, so
// a launch costs its latency chain. Design: one block of 1,024 threads
// with no barrier before its last. Every thread reads head and count and
// forms the push slot and the pushed pose itself. Warp 0's first lane runs
// the pose chain (corrected_at, the ring pose, the result row, ridx and
// step) while warps 1-31 copy the pack (pack_copy.cuh: each thread's
// loads all in flight before its stores) and test the eviction slots, a
// warp's 32 at once, in rounds of the 31 warps' 992 slots until the
// warp's first false flag or K (so any K runs on the one block):
// __ballot_sync of the flags, the first false one by __ffs, and after the
// one barrier the first lane takes the minimum over the warps: the
// leading run. The back scan of the test is the pushed one, so its pose
// is `mean` itself, from registers.
//
// Numerics: built with --fmad=false, corrected_at's f32 operations in the
// plain version's order with sqrtf, cosf, sinf and atan2f without fast
// math: the ring pose, the corrected pose, the row and the indices equal
// the plain version's on the card bit for bit.
#include <cuda_runtime.h>
#include <math.h>

#include "pack_copy.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// streaming._corrected_at, term by term
__device__ void corrected_at(const float* m, const float* off, float* out) {
    float ox = off[0], oy = off[1], oh = off[2];
    float length = sqrtf(ox * ox + oy * oy);
    float alpha = atan2f(oy, ox);
    float hs = atan2f(sinf(m[2]), cosf(m[2]));
    float wx = length * cosf(hs + alpha - oh);
    float wy = length * sinf(hs + alpha - oh);
    float h = hs - oh;
    out[0] = m[0] - wx;
    out[1] = m[1] - wy;
    out[2] = atan2f(sinf(h), cosf(h));
}

__global__ void __launch_bounds__(kThreads)
stream_update_kernel(const float* __restrict__ packed,
                     const float* __restrict__ center_off,
                     const float4* __restrict__ pack,
                     const float* __restrict__ odom,
                     const float* __restrict__ offset_pose,
                     float4* __restrict__ ring_pack,
                     float* __restrict__ ring_pose,
                     bool* __restrict__ ring_slot_valid,
                     long long* __restrict__ head_p,
                     long long* __restrict__ count_p,
                     float* __restrict__ last_odom,
                     float* __restrict__ last_corrected,
                     float* __restrict__ results,
                     long long* __restrict__ ridx_p,
                     long long* __restrict__ step_p, int K, int B, int R,
                     int run_buffer_size, float max_sq) {
    __shared__ int first_false[kWarps];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // every thread: the scalars, the push slot and the pushed pose
    const long long head = *head_p, count = *count_p;
    const long long idx = (head + count) % K;
    const bool is_first = count == 0;
    const float mx = is_first ? center_off[0] : packed[1];
    const float my = is_first ? center_off[1] : packed[2];
    const long long ct0 = count + 1;

    if (warp == 0) {
        // the pose chain
        if (lane == 0) {
            const float mean[3] = {mx, my,
                                   is_first ? center_off[2] : packed[3]};
            float corrected[3];
            corrected_at(mean, offset_pose, corrected);
            const long long ridx = *ridx_p;
            float* row = results + 13 * ridx;
            row[0] = is_first ? 0.0f : packed[0];
            for (int k = 0; k < 9; ++k)
                row[4 + k] = is_first ? (k % 4 == 0 ? 1.0f : 0.0f)
                                      : packed[4 + k];
            for (int k = 0; k < 3; ++k) {
                ring_pose[3 * idx + k] = mean[k];
                row[1 + k] = mean[k];
                last_odom[k] = odom[k];
                last_corrected[k] = corrected[k];
            }
            ring_slot_valid[idx] = true;
            *ridx_p = (ridx + 1) % R;
            *step_p = *step_p + 1;
            first_false[0] = K;   // warp 0 tests no slot
        }
    } else {
        // the push: warps 1-31 copy the pack
        pack_copy::copy_pack<4>(ring_pack + idx * 2LL * B, pack, 2 * B,
                                    tid - 32, kThreads - 32, nullptr);
        // the eviction test after e evictions, 32 slots a warp at once;
        // slots past K count as true (the run stops at K)
        const int h0 = (int)(head % K);
        int first = K;
        for (int e0 = (warp - 1) * 32; e0 < K; e0 += kThreads - 32) {
            const int e = e0 + lane;
            bool cond = true;
            if (e < K) {
                int slot = h0 + e;
                if (slot >= K) slot -= K;
                const float fx = slot == idx ? mx : ring_pose[3 * slot];
                const float fy = slot == idx ? my : ring_pose[3 * slot + 1];
                const float dx = fx - mx;
                const float dy = fy - my;
                const bool too_far = (dx * dx + dy * dy) > max_sq;
                const long long ct = ct0 - e;
                cond = ct > 1 && (ct > run_buffer_size || too_far);
            }
            const unsigned m = __ballot_sync(kFull, cond);
            if (m != kFull) {
                first = e0 + __ffs(~m) - 1;
                break;
            }
        }
        if (lane == 0) first_false[warp] = first;
    }
    __syncthreads();

    if (warp == 0) {
        int n_ev = first_false[lane];
        for (int o = 16; o > 0; o >>= 1)
            n_ev = min(n_ev, __shfl_down_sync(kFull, n_ev, o));
        if (lane == 0) {
            *head_p = (head + n_ev) % K;
            *count_p = ct0 - n_ev;
        }
    }
}

}  // namespace

extern "C" int stream_update(
    const float* packed, const float* center_off, const float* pack,
    const float* odom, const float* offset_pose, float* ring_pack,
    float* ring_pose, bool* ring_slot_valid, long long* head,
    long long* count, float* last_odom, float* last_corrected,
    float* results, long long* ridx, long long* step, int K, int B, int R,
    int run_buffer_size, float max_sq, cudaStream_t stream) {
    if (K < 1 || B < 1 || R < 1
            || reinterpret_cast<size_t>(pack) % 16 != 0
            || reinterpret_cast<size_t>(ring_pack) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    stream_update_kernel<<<1, kThreads, 0, stream>>>(
        packed, center_off, reinterpret_cast<const float4*>(pack), odom,
        offset_pose, reinterpret_cast<float4*>(ring_pack), ring_pose,
        ring_slot_valid, head, count, last_odom, last_corrected, results,
        ridx, step, K, B, R, run_buffer_size, max_sq);
    return (int)cudaGetLastError();
}
