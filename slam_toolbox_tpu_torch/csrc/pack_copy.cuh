// pack_copy.cuh: the copy of one scan pack (B beams x 32 bytes) that
// stream_update.cu (the ring push) and ring_points.cu (the step's scan
// buffers) make: the threads of a block each load up to kPer 16-byte
// vectors, all before their first store, then store them (ld.global.nc
// through __restrict__), optionally writing each beam's finite flag
// (flags & 1) from the vector that holds it. A pack's row stride is
// B * 32 bytes, so every pack of a 16-byte aligned buffer is 16-byte
// aligned; the launches check the buffers.
#pragma once

#include <cuda_runtime.h>

namespace pack_copy {

// n4 vectors from src to dst by the threads t = 0..nt-1 (the caller's
// numbering); finite, if not null, gets ((int)flags & 1) > 0 of each beam
// (its flags are the .w of its second vector)
template <int kPer>
__device__ __forceinline__ void copy_pack(float4* __restrict__ dst,
                                              const float4* __restrict__ src,
                                              int n4, int t, int nt,
                                              bool* __restrict__ finite) {
    for (int base = t; base < n4; base += kPer * nt) {
        float4 v[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const int i = base + k * nt;
            if (i < n4) v[k] = src[i];
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            const int i = base + k * nt;
            if (i < n4) {
                dst[i] = v[k];
                if (finite != nullptr && (i & 1))
                    finite[i >> 1] = (((int)v[k].w) & 1) > 0;
            }
        }
    }
}

}  // namespace pack_copy
