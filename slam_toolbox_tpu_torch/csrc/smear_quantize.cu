// Separable Gaussian max-times smear of the bit-packed binary occupancy,
// quantized to the int8 correlation raster.
//
// Replaces the Pallas kernel slam_toolbox_tpu/kernels/match_pallas.py
// smear_quantize_parity (_make_smear_kernel.kern; pallas_call at :394),
// which reads the scatter's bit planes directly and pairs the symmetric
// taps; this kernel does both in a layout made for Hopper. It reads the
// (ceil(G/32), G) words of csrc/scatter_occupancy.cu (word (q, c) holds
// rows 32q .. 32q+31 of column c, bit r & 31 for row r) and writes the
// flat (G*G + 1,) raster with its zero sink cell.
//
// Taps: w (2*hk+1 floats) must be finite, non-negative, symmetric and
// non-increasing outward from the centre (rasterize.smear_weights' taps;
// Matcher.__init__ checks them on the host before upload). Then:
//  - Row pass (axis 0), a[r][c] = max_j w_j occ[r+j][c] on a 0/1
//    occupancy, is exactly the tap at the nearest occupied offset:
//    a = w[hk + min(d_up, d_down)], or 0 when no bit is set within +-hk.
//    A thread owns a half strip of one column (16 rows of a 32-row word
//    row) and keeps that column's words q-1, q, q+1 in registers. It
//    finds the nearest set row above and below the half with __clzll /
//    __ffsll on two 64-bit windows (a larger hk than 32 walks further
//    words once per strip), then both distances of all 16 rows with one
//    sweep each way. Rows below 0 and at or beyond G count as empty.
//  - Column pass (axis 1) pairs the taps +-k, exact because w > 0 and a
//    round-to-nearest product is monotone:
//    m = max(m, fl(w[hk+k] * max(a[c-k], a[c+k]))). A thread computes 4
//    consecutive outputs from two 8-float register windows of the row
//    values, refilled with one 16-byte shared load each per 4 taps.
//  - Sparsity: a scan raster is mostly empty. A half strip with no set
//    row within reach writes zeros without the sweeps, and a tile row
//    whose row values are all 0 skips the column pass (its outputs are
//    0); the row pass marks the rows that got a value.
//  - Quantize as floor(fl(fl(100 m) + 0.5)) (m >= 0, round half away)
//    and store the 4 int8 outputs with one 32-bit store. Each shared row
//    is shifted by (y*G) mod 4, so a thread's 4 outputs sit on an aligned
//    word of the raster even at odd G; the ragged cells at tile and grid
//    edges go out byte by byte.
//
//  - Reach. A tap k >= G reads only cells outside the grid (0), so the
//    launcher clamps hk to G - 1 (the centre tap stays w's middle), which
//    changes no output. The row values and taps of a block (4 (hk / 4 + 1)
//    + 32 (TX + 8 (hk / 4 + 1) + 12) floats) live in shared memory up to
//    the opt-in 227 KB, about hk 823; past it the global instantiation
//    keeps the same layout in a scratch buffer the wrapper allocates, one
//    region a block (written and read by that block only, across the same
//    barriers), so any hk whose scratch the card holds runs on the kernel,
//    with the same arithmetic in the same order: the outputs are the
//    same bits.
//
// Bound on the H100: on a dense occupancy, operations: per output cell
// the column pass does 3 f32 operations for each tap k = 0 .. hk (63 at
// the bench's hk = 20; two of them are maxima), against 1 byte written
// and 1/8 byte of packed words read. On a scan raster, where most cells
// have no occupied cell within reach, bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TY = 32;            // output rows of a block: one word row
constexpr int TX = 124;           // output columns of a block
constexpr int NQ = TX / 4 + 1;    // 4-output groups per row (row shift)
constexpr int NT = 128;           // threads
constexpr int MIN_BLOCKS = 9;     // resident blocks per SM: G = 2051's
                                  // 1,105 blocks in one wave on 132 SMs
constexpr int FAR = 1 << 29;      // "no occupied row within reach"

static_assert(TX % 4 == 0 && NQ == 32, "a warp covers one shared row");

struct Geometry {
    int nch;   // column taps k = 0 .. hk in chunks of 4 (last partial)
    int sw;    // shared positions of a row (multiple of 4)
    int sws;   // shared row stride: sw plus 4 floats of slack each side
};

__host__ __device__ inline Geometry geometry(int hk) {
    const int nch = hk / 4 + 1;
    return {nch, TX + 8 * nch + 4, TX + 8 * nch + 12};
}

// Column taps k = 4j .. 4j+n-1 (weights wq, n <= 4) for a thread's 4
// outputs, from the windows R = r0|r1 (a at p0 + 4j + 0..7) and L = l0|l1
// (a at p0 - 4j - 4 + 0..7): output i takes the pair a[p0+i-k], a[p0+i+k].
__device__ __forceinline__ void taps(float (&m)[4], float4 wq, int n,
                                     float4 r0, float4 r1, float4 l0,
                                     float4 l1) {
    const float R[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const float L[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
    const float wk[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
        if (tt >= n) break;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            m[i] = fmaxf(m[i], __fmul_rn(wk[tt],
                                         fmaxf(L[i - tt + 4], R[i + tt])));
    }
}

// The column pass of a thread's 4 outputs at quad q0 of a shared row, in
// chunks of 4 taps. The chunks alternate which register quad is
// refilled, so the windows slide without moves; the last chunk runs its
// own n_last taps.
__device__ __forceinline__ void column_taps(float (&m)[4],
                                            const float4* row, int q0,
                                            const float4* w4, int nch,
                                            int n_last) {
    float4 ra = row[q0], rb = row[q0 + 1], la = row[q0 - 1], lb = row[q0];
    for (int j = 0;; ++j) {
        if (j == nch - 1) { taps(m, w4[j], n_last, ra, rb, la, lb); break; }
        taps(m, w4[j], 4, ra, rb, la, lb);
        ra = row[q0 + j + 2];
        lb = row[q0 - j - 2];
        if (++j == nch - 1) { taps(m, w4[j], n_last, rb, ra, lb, la); break; }
        taps(m, w4[j], 4, rb, ra, lb, la);
        rb = row[q0 + j + 2];
        la = row[q0 - j - 2];
    }
}

// kGlobal: the taps and row values in `scratch`, one region of
// 4 nch + TY sws floats a block, in place of dynamic shared memory
template <bool kGlobal>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) smear_quantize_kernel(
    const uint32_t* __restrict__ words, const float* __restrict__ w,
    int G, int hk, int8_t* __restrict__ out, float* scratch) {
    extern __shared__ float4 smem4[];
    __shared__ uint32_t s_rows;          // rows of the tile with a value > 0
    const Geometry geo = geometry(hk);
    const int nch = geo.nch, sw = geo.sw, sws = geo.sws;
    // 4*nch taps w[hk+k], 0 past hk
    float* s_w = kGlobal
        ? scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x)
                    * (4 * nch + (size_t)TY * sws)
        : (float*)smem4;
    float* s_a = s_w + 4 * nch;          // TY x sws row-pass values
    const int nwr = (G + 31) / 32;
    const int rb = blockIdx.y;           // the block's word row
    const int oy = 32 * rb, ox = blockIdx.x * TX;
    const int halo = 4 * nch;
    // position p of row r (at s_a + r*sws + 4 + p) holds column
    // p + ox - halo - shift(r), shift(r) = ((oy + r) * G) mod 4
    //                                    = (f0 + (r mod 16) * g3) mod 4
    const int f0 = (int)(((unsigned)oy * (unsigned)G) & 3u), g3 = G & 3;
    const uint32_t last_mask = (G & 31) ? (1u << (G & 31)) - 1u : ~0u;

    for (int k = threadIdx.x; k < 4 * nch; k += NT)
        s_w[k] = k <= hk ? w[hk + k] : 0.f;
    if (threadIdx.x == 0) s_rows = 0u;
    __syncthreads();

    // row pass: one item per (column strip, half of the word row): the
    // nearest set row below and above each of 16 rows by two sweeps
    const int ns = sw + 3;               // strips cover every row's shift
    for (int t = threadIdx.x; t < 2 * ns; t += NT) {
        const int s = t % ns, h = t / ns;
        const int c = ox - halo - 3 + s;
        const int y0 = oy + 16 * h;
        auto ld = [&](int q) -> uint32_t {
            if (q < 0 || q >= nwr) return 0u;
            const uint32_t v = words[(size_t)q * G + c];
            return q == nwr - 1 ? v & last_mask : v;
        };
        uint32_t hb = 0u;                // the half's 16 rows
        int before = -FAR, after = FAR;  // nearest set rows outside, - y0
        if (c >= 0 && c < G) {
            const uint32_t wm = ld(rb - 1), wc = ld(rb), wp = ld(rb + 1);
            hb = (wc >> (16 * h)) & 0xffffu;
            // rows 32 rb - 32 .. y0 - 1, row y0 - 1 at bit 63
            const unsigned long long lo =
                (((unsigned long long)wc << 32) | wm) << (32 - 16 * h);
            // rows y0 + 16 .. 32 rb + 63, row y0 + 16 at bit 0
            const unsigned long long hi =
                (((unsigned long long)wp << 32) | wc) >> (16 * h + 16);
            if (lo) {
                before = -1 - __clzll((long long)lo);
            } else {
                for (int q = rb - 2; q >= 0 && 32 * q + 31 >= y0 - hk; --q) {
                    const uint32_t v = ld(q);
                    if (v) { before = 32 * q + 31 - __clz(v) - y0; break; }
                }
            }
            if (hi) {
                after = 15 + __ffsll((long long)hi);
            } else {
                for (int q = rb + 2; q < nwr && 32 * q <= y0 + 15 + hk; ++q) {
                    const uint32_t v = ld(q);
                    if (v) { after = 32 * q + __ffs(v) - 1 - y0; break; }
                }
            }
        }
        float* dst = s_a + 16 * h * sws + 4 + (c - ox + halo);
        if (hb == 0u && before < -hk && after > 15 + hk) {
            // no set row within reach: the common case of a sparse scan
#pragma unroll
            for (int rr = 0; rr < 16; ++rr)
                dst[rr * sws + ((f0 + rr * g3) & 3)] = 0.f;
            continue;
        }
        int d_dn[16];
        int next = after;
#pragma unroll
        for (int rr = 15; rr >= 0; --rr) {
            if ((hb >> rr) & 1u) next = rr;
            d_dn[rr] = next - rr;
        }
        int last = before;
        uint32_t nz = 0u;                // rows given a value > 0
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
            if ((hb >> rr) & 1u) last = rr;
            const int d = min(rr - last, d_dn[rr]);
            const bool hit = d <= hk;
            nz |= (uint32_t)hit << rr;
            dst[rr * sws + ((f0 + rr * g3) & 3)] = hit ? s_w[d] : 0.f;
        }
        if (nz) atomicOr(&s_rows, nz << (16 * h));
    }
    __syncthreads();

    // column pass: one item per (row, group of 4 outputs); a warp is a row
    const float4* w4 = (const float4*)s_w;
    const int n_last = hk + 1 - 4 * (nch - 1);   // taps of the last chunk
    for (int t = threadIdx.x; t < TY * NQ; t += NT) {
        const int r = t / NQ, qi = t % NQ;
        const int y = oy + r;
        if (y >= G) break;               // rows only grow with t
        const float4* row = (const float4*)(s_a + r * sws + 4);
        const int q0 = nch + qi;         // the quad at p0 = halo + 4 qi
        uint32_t packed = 0u;            // 4 int8 outputs, little-endian
        // a row of zeros smears to zeros: skip it (uniform over the warp)
        if ((s_rows >> r) & 1u) {
            float m[4] = {0.f, 0.f, 0.f, 0.f};
            column_taps(m, row, q0, w4, nch, n_last);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int q = (int)floorf(
                    __fadd_rn(__fmul_rn(m[i], 100.f), 0.5f));
                packed |= ((uint32_t)q & 0xffu) << (8 * i);
            }
        }
        // outputs: columns c0 .. c0+3, of which the block owns
        // [ox, ox + TX) and the grid [0, G)
        const int c0 = ox + 4 * qi - ((f0 + (r & 15) * g3) & 3);
        const int c_end = min(ox + TX, G);   // the block's columns end
        int8_t* dst = out + ((long long)y * G + c0);
        if (c0 >= ox && c0 + 4 <= c_end) {
            *(uint32_t*)dst = packed;    // y*G + c0 is a multiple of 4
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int c = c0 + i;
                if (c >= ox && c < c_end)
                    dst[i] = (int8_t)(packed >> (8 * i));
            }
        }
    }
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
        out[(size_t)G * G] = 0;  // the sink cell invalid gathers read
}

// a block's taps and row values, bytes
long long smem_bytes(int hk) {
    const Geometry geo = geometry(hk);
    return (long long)sizeof(float) * (4 * geo.nch + (long long)TY * geo.sws);
}

// the half-width the kernel runs: taps past the grid add nothing
int reach(int G, int hk) { return hk < G - 1 ? hk : (G > 0 ? G - 1 : 0); }

dim3 grid_of(int G) { return dim3((G + TX - 1) / TX, (G + 31) / 32); }

// the dynamic shared bytes a block of the shared instantiation may take
int max_dynamic() {
    static int n = -1;
    if (n < 0) {
        int dev = 0, optin = 0;
        cudaFuncAttributes fa;
        if (cudaGetDevice(&dev) != cudaSuccess
                || cudaDeviceGetAttribute(
                       &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                       dev) != cudaSuccess
                || cudaFuncGetAttributes(
                       &fa, (const void*)smear_quantize_kernel<false>)
                       != cudaSuccess)
            return 0;
        n = optin - (int)fa.sharedSizeBytes;
    }
    return n;
}

}  // namespace

// The scratch bytes smear_quantize needs at (G, hk): 0 where a block's
// taps and row values fit its shared memory, else one region a block.
extern "C" long long smear_scratch_bytes(int G, int hk) {
    const long long smem = smem_bytes(reach(G, hk));
    if (smem <= max_dynamic()) return 0;
    const dim3 g = grid_of(G);
    return smem * g.x * g.y;
}

extern "C" int smear_quantize(
    const void* words, const void* w, int G, int hk, void* out,
    void* scratch, void* stream) {
    if (G < 1 || hk < 0) return (int)cudaErrorInvalidValue;
    // the centre tap stays w[hk]: w + (hk - h) holds it at h
    const int h = reach(G, hk);
    const float* wc = (const float*)w + (hk - h);
    const long long smem = smem_bytes(h);
    const dim3 grid = grid_of(G);
    const cudaStream_t st = (cudaStream_t)stream;
    if (scratch != nullptr) {
        smear_quantize_kernel<true><<<grid, NT, 0, st>>>(
            (const uint32_t*)words, wc, G, h, (int8_t*)out,
            (float*)scratch);
        return (int)cudaGetLastError();
    }
    if (smem > max_dynamic()) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            (const void*)smear_quantize_kernel<false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    smear_quantize_kernel<false><<<grid, NT, (size_t)smem, st>>>(
        (const uint32_t*)words, wc, G, h, (int8_t*)out, nullptr);
    return (int)cudaGetLastError();
}
