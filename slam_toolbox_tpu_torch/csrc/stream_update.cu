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
// a launch costs its fixed time. Design: one block; thread 0 reads the
// state's scalars and writes the pose, the row and the scalars, all
// threads copy the pack and test one eviction slot each, and thread 0
// takes the leading run of the slots' flags from shared memory. The back
// scan of the eviction test is the pushed one, so its pose is `mean`
// itself, read from a register.
//
// Numerics: built with --fmad=false, corrected_at's f32 operations in the
// plain version's order with sqrtf, cosf, sinf and atan2f without fast
// math: the ring pose, the corrected pose, the row and the indices equal
// the plain version's on the card bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 4096;

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
stream_update_kernel(const float* packed, const float* center_off,
                     const float* pack, const float* odom,
                     const float* offset_pose, float* ring_pack,
                     float* ring_pose, bool* ring_slot_valid,
                     long long* head_p, long long* count_p, float* last_odom,
                     float* last_corrected, float* results, long long* ridx_p,
                     long long* step_p, int K, int B, int R,
                     int run_buffer_size, float max_sq) {
    __shared__ long long head, count, idx;
    __shared__ float mean[3];
    __shared__ unsigned char cond[kMaxSlots];
    const int tid = threadIdx.x;

    if (tid == 0) {
        head = *head_p;
        count = *count_p;
        idx = (head + count) % K;
        const bool is_first = count == 0;
        for (int k = 0; k < 3; ++k)
            mean[k] = is_first ? center_off[k] : packed[1 + k];
        float corrected[3];
        corrected_at(mean, offset_pose, corrected);
        for (int k = 0; k < 3; ++k) {
            ring_pose[3 * idx + k] = mean[k];
            last_odom[k] = odom[k];
            last_corrected[k] = corrected[k];
        }
        ring_slot_valid[idx] = true;
        const long long ridx = *ridx_p;
        float* row = results + 13 * ridx;
        row[0] = is_first ? 0.0f : packed[0];
        for (int k = 0; k < 3; ++k) row[1 + k] = mean[k];
        for (int k = 0; k < 9; ++k)
            row[4 + k] = is_first ? (k % 4 == 0 ? 1.0f : 0.0f)
                                  : packed[4 + k];
        *ridx_p = (ridx + 1) % R;
        *step_p = *step_p + 1;
    }
    __syncthreads();

    float* dst = ring_pack + idx * (long long)B * 8;
    for (int i = tid; i < B * 8; i += kThreads) dst[i] = pack[i];

    // the eviction test after e evictions; the back scan is the pushed one
    const long long ct0 = count + 1;
    for (int e = tid; e < K; e += kThreads) {
        long long slot = (head + e) % K;
        float fx = slot == idx ? mean[0] : ring_pose[3 * slot];
        float fy = slot == idx ? mean[1] : ring_pose[3 * slot + 1];
        float dx = fx - mean[0];
        float dy = fy - mean[1];
        bool too_far = (dx * dx + dy * dy) > max_sq;
        long long ct = ct0 - e;
        cond[e] = ct > 1 && (ct > run_buffer_size || too_far);
    }
    __syncthreads();

    if (tid == 0) {
        int n_ev = 0;
        while (n_ev < K && cond[n_ev]) ++n_ev;
        *head_p = (head + n_ev) % K;
        *count_p = ct0 - n_ev;
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
    if (K < 1 || K > kMaxSlots || B < 1 || R < 1)
        return (int)cudaErrorInvalidValue;
    stream_update_kernel<<<1, kThreads, 0, stream>>>(
        packed, center_off, pack, odom, offset_pose, ring_pack, ring_pose,
        ring_slot_valid, head, count, last_odom, last_corrected, results,
        ridx, step, K, B, R, run_buffer_size, max_sq);
    return (int)cudaGetLastError();
}
