// K3: the RawNet front end, sinc conv + |.| + MaxPool3, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel adfmsl/ops/pallas/sinc_fused.py:sinc_abs_pool_fused (:81;
// its body is _kernel, :59-78). Function, per batch row b, pooled row p < T3 and
// channel c, with T' = T-K+1 and T3 = T'//3 (the T' % 3 tail is dropped):
//   out[b, p, c] = max_{j<3} | sum_{k<K} bf16(x[b, 3p+j+k]) * bf16(f[c, k]) |
// Rounding points, held exactly as in the Pallas kernel and in the plain version
// (ops/sinc_fused.py:sinc_abs_pool_plain): x and the filters are rounded to bf16, the
// products accumulate in f32, |.| and the max act on the f32 sums, out is f32.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at batch 128, cut 64600,
// C 128 and K 251 the correlation is 2*B*T'*C*K = 529 GFLOP (0.54 ms) against 33 MB
// of x in and 1.41 GB of f32 out (0.42 ms): bound by tensor-core operations, with
// the bytes close behind. chip_smoke.py recomputes the bound from each case's shapes.
// The first form of this kernel (an R = 48-row im2col tile in shared memory, wmma
// 16x16x16, the max through an f32 stage, no overlap) took 0.868 ms at batch 16 and
// 6.52 ms at batch 128 on an H100 80GB HBM3 at 700 W, 7.7-8.2 % of the bound; this one
// takes 0.203 and 1.183 ms (chip_smoke.py, the same card).
//
// The design (the tile engine of csrc/sinc_abs_pool_bwd.cu, in bf16):
// 1. Pool-major rows. A CTA tile is 128 pooled rows (384 conv rows) of one batch row;
//    warpgroup w owns pooled rows 64w .. 64w+63 and walks the 64-channel tiles. Its
//    three wgmma m64n64k16 accumulators j = 0, 1, 2 hold conv rows 3i + j, so the max
//    over a pool triple is taken in registers across the three and only pooled rows
//    exist: no f32 stage.
// 2. A from registers, no im2col: A_j[i][k] = bf16(x[t0 + 3i + j + k]). The tile's x
//    window is kept in shared memory twice in bf16, E[m] = x[t0 + m] and O[m] =
//    x[t0 + m + 1], so every (x[s], x[s+1]) pair of the m16n8k16 fragment is one aligned
//    32-bit load (from E for even s, from O for odd s). O starts 64 bytes off E's bank
//    alignment, so the two halves of a warp (either parity) hit disjoint banks.
// 3. B, the filters, comes from shared memory through a descriptor:
//    ops/sinc_fused.py:kernel_filter_layout lays them out once per call in bf16, in the
//    no-swizzle K-major core-matrix layout (8 channels x 8 taps, 128 B), and each
//    persistent CTA bulk-copies all channel tiles once (cp.async.bulk, mbarrier; 64 KB
//    at C 128, K 251).
// 4. The next tile's x window is loaded into registers (3 samples a thread) under the
//    current tile's products, then rounded and stored.
// 5. The output is written straight from the accumulator layout: each thread stores
//    two adjacent channels (8 bytes), a quad 32 contiguous bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NC = 64;          // channels of a tile: the wgmma N
constexpr int PR = 128;         // pooled rows of a CTA tile: 64 a warpgroup
constexpr int CR = 3 * PR;      // conv rows of a CTA tile
constexpr int THREADS = 256;    // two warpgroups
constexpr int MAX_C = 256;
constexpr int MAX_K = 256;
constexpr int XPT = 3;          // x window samples a thread stages: (CR + 256) / THREADS
constexpr int WIN = CR + MAX_K + 8;     // bf16 elements of one window copy
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ inline int kpad(int k) { return (k + 15) / 16 * 16; }
__host__ __device__ inline int align128(int v) { return (v + 127) & ~127; }

struct Smem {
    int e, o, w, total;         // byte offsets: window E, window O, filters; barrier at 0
};

__host__ __device__ inline Smem smem_layout(int c, int k) {
    Smem s;
    s.e = 128;
    s.o = align128(s.e + WIN * 2) + 64;
    s.w = align128(s.o + WIN * 2);
    s.total = align128(s.w + ((c + NC - 1) / NC) * NC * kpad(k) * 2);
    return s;
}

// Persistent grid of CTAs of THREADS threads walking the items (batch row, tile of
// 128 pooled rows) in order; wl holds every channel tile's bf16 filters.
__global__ void __launch_bounds__(THREADS, 1)
sinc_abs_pool_kernel(const float* __restrict__ x, const uint16_t* __restrict__ wl,
                     float* __restrict__ out, int T, int C, int K, int t3, int n_tiles,
                     int items) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int kp = kpad(K), n_ct = (C + NC - 1) / NC, xwin = CR + kp;
    const Smem L = smem_layout(C, K);
    const uint32_t sbase = smem_u32(smem), bar = sbase, wsm = sbase + L.w;
    __nv_bfloat16* we = reinterpret_cast<__nv_bfloat16*>(smem + L.e);
    __nv_bfloat16* wo = reinterpret_cast<__nv_bfloat16*>(smem + L.o);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2, wi = warp & 3, gq = lane >> 2, tq = lane & 3;
    const int ct_bytes = NC * kp * 2;

    if (tid == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {                             // every channel tile's filters, once
        mbar_expect_tx(bar, n_ct * ct_bytes);
        for (int ct = 0; ct < n_ct; ++ct)
            bulk_g2s(wsm + ct * ct_bytes, wl + size_t(ct) * NC * kp, ct_bytes, bar);
    }

    float xv[XPT];
    auto fetch = [&](int item) {                // the item's x window, zero past T
        const int b = item / n_tiles, t0 = (item - b * n_tiles) * CR;
        const float* xb = x + size_t(b) * T;
#pragma unroll
        for (int q = 0; q < XPT; ++q) {
            const int i = tid + q * THREADS;
            xv[q] = i < xwin && t0 + i < T ? xb[t0 + i] : 0.f;
        }
    };
    if (blockIdx.x < items) fetch(blockIdx.x);
    mbar_wait(bar, 0);

    // This thread's rows of the A fragment: pooled rows i and i + 8 of the tile
    // (the latter 24 samples on); the pair (x[s], x[s+1]) for s = 3i + j + 2t + kc
    // comes from E (s even) or O (s odd) as one 32-bit word.
    const int arow = wg * 64 + wi * 16 + gq;
    const uint32_t* pw[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const int s0 = 3 * arow + j + 2 * tq, par = s0 & 1;
        pw[j] = reinterpret_cast<const uint32_t*>((par ? wo : we) + (s0 - par));
    }

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / n_tiles, tile = item - b * n_tiles;
        __syncthreads();                        // the last tile's readers of the window are done
#pragma unroll
        for (int q = 0; q < XPT; ++q) {
            const int i = tid + q * THREADS;
            if (i < xwin) {
                const __nv_bfloat16 v = __float2bfloat16(xv[q]);
                we[i] = v;
                if (i > 0) wo[i - 1] = v;
            }
        }
        __syncthreads();
        if (item + int(gridDim.x) < items) fetch(item + gridDim.x);

        for (int ct = 0; ct < n_ct; ++ct) {
            float acc[3][32];
#pragma unroll
            for (int j = 0; j < 3; ++j)
#pragma unroll
                for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
            const uint32_t wct = wsm + ct * ct_bytes;
            for (int kc = 0; kc < kp; kc += 16) {     // no wgmma in a branch (ptxas C7520)
                uint32_t a[3][4];
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    const uint32_t* w = pw[j] + kc / 2;
                    a[j][0] = w[0];
                    a[j][1] = w[12];            // row + 8: 24 samples on
                    a[j][2] = w[4];             // k + 8
                    a[j][3] = w[16];
                }
                wgmma_fence();
                const uint64_t db = b_desc(wct + kc * 16, kp * 16);
#pragma unroll
                for (int j = 0; j < 3; ++j) wgmma_rs_n64(acc[j], a[j], db);
                wgmma_commit();
                wgmma_wait_all();
            }
            // ---- max over the triple of |z|, straight from the accumulators
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int p = tile * PR + arow + 8 * hf;
                if (p >= t3) continue;
                float* op = out + (size_t(b) * t3 + p) * C + ct * NC + 2 * tq;
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                    if (ct * NC + 8 * jj >= C) continue;
                    float v[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int idx = 4 * jj + 2 * hf + e;
                        v[e] = fmaxf(fmaxf(fabsf(acc[0][idx]), fabsf(acc[1][idx])),
                                     fabsf(acc[2][idx]));
                    }
                    *reinterpret_cast<float2*>(op + 8 * jj) = make_float2(v[0], v[1]);
                }
            }
        }
    }
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError(). x (B, T) f32; wl the filters in
// ops/sinc_fused.py:kernel_filter_layout's bf16 layout; out (B, (T-K+1)//3, C) f32.
// C a multiple of 16, at most 256; K at most 256; T-K+1 >= 3. device = the CUDA device
// index.
extern "C" int sinc_abs_pool_launch(const void* x, const void* wl, void* out,
                                    int bsz, int T, int C, int K, int device,
                                    void* stream) {
    if (bsz <= 0 || K <= 0 || K > MAX_K || C <= 0 || C % 16 || C > MAX_C ||
        T - K + 1 < 3)
        return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const Smem L = smem_layout(C, K);
    if (L.total > SMEM_LIMIT) return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(sinc_abs_pool_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return int(err);
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinc_abs_pool_kernel,
                                                        THREADS, L.total);
    if (err != cudaSuccess) return int(err);
    if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
    const int t3 = (T - K + 1) / 3;
    const int n_tiles = (t3 + PR - 1) / PR;
    const long long items = (long long)bsz * n_tiles;
    if (items > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    const long long slots = (long long)n_sm * per_sm;
    const int grid = int(items < slots ? items : slots);
    sinc_abs_pool_kernel<<<grid, THREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const uint16_t*>(wl),
        static_cast<float*>(out), T, C, K, t3, n_tiles, int(items));
    return int(cudaGetLastError());
}
