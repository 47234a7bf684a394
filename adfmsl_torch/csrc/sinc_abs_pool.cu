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
// of x in and 1.41 GB of f32 out (0.43 ms): bound by tensor-core operations, with
// the bytes close behind. chip_smoke.py recomputes the bound from each case's shapes.
//
// What this design does about it: the correlation runs on the tensor cores as an
// implicit GEMM, (conv positions x K) by (K x C), and the conv output (3x the pooled
// one) never reaches device memory: only the pooled f32 rows are written. The TPU
// kernel's block-Toeplitz layout (128-sample rows, nj shifted 128x128 matrices, 1.5x
// redundant products) exists for the TPU's 128x128 MXU and is not carried over.
// Work items are (batch row, tile of R = 48 conv positions): whole pool groups and
// whole 16-row fragments. A persistent grid of as many CTAs as fit on the card walks
// them in order; each CTA stages the bf16 filters once, transposed to (K, C) and
// zero-padded to KP = 16*ceil(K/16) taps. Per tile it stages the x window
// [t0, t0+R+KP-1) in bf16, builds the im2col tile A[r][k] = x[t0+r+k] (R x KP) in
// shared memory, and runs bf16 16x16x16 wmma fragments with f32 accumulators, each
// warp owning 16-column tiles of C. The accumulators then go through a per-warp f32
// stage (in the im2col region, which is free by then), where the max of |.| over each
// row triple is taken and written. There is no TMA, wgmma or pipelining yet: this is
// the simple, correct first form, not a fast one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int R = 48;                        // conv positions per tile: 16 pooled rows
constexpr int MT = R / 16;                   // 16-row fragments per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_C = 256;
constexpr int MAX_K = 256;
constexpr int MAX_NT = MAX_C / 16 / WARPS;   // 16-column tiles per warp, at most

__host__ __device__ inline int kpad(int k) { return (k + 15) / 16 * 16; }

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

struct Layout {
    size_t ws, as, xs, total;
};

// Row pitches are multiples of 16 elements, so every row starts 32-byte aligned as
// wmma loads require, with 16 elements of skew across banks. The im2col region also
// holds the per-warp f32 stage (R x 16 each) once the products are done.
__host__ __device__ inline Layout layout(int c, int k) {
    const int kp = kpad(k);
    size_t a_bytes = size_t(R) * (kp + 16) * sizeof(bf16);
    const size_t stage_bytes = size_t(WARPS) * R * 16 * sizeof(float);
    if (stage_bytes > a_bytes) a_bytes = stage_bytes;
    Layout L;
    size_t off = 0;
    L.ws = off;
    off = align128(off + size_t(kp) * (c + 16) * sizeof(bf16));
    L.as = off;
    off = align128(off + a_bytes);
    L.xs = off;
    off = align128(off + size_t(R + kp) * sizeof(bf16));
    L.total = off;
    return L;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(THREADS)
sinc_abs_pool_kernel(const float* __restrict__ x, const float* __restrict__ filt,
                     float* __restrict__ out, int T, int C, int K, int t3,
                     int n_tiles, long long n_items) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int kp = kpad(K);
    const Layout L = layout(C, K);
    bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
    bf16* as = reinterpret_cast<bf16*>(smem + L.as);
    bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* stage = reinterpret_cast<float*>(smem + L.as) + warp * (R * 16);
    const int ldw = C + 16, lda = kp + 16;
    const int n_col_tiles = C / 16;

    // ---- filters -> ws[k][c] = bf16(f[c, k]), zero for the padded taps k >= K.
    for (int idx = threadIdx.x; idx < kp * C; idx += THREADS) {
        const int k = idx / C, c = idx - k * C;
        ws[k * ldw + c] = __float2bfloat16(k < K ? filt[size_t(c) * K + k] : 0.f);
    }

    for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int b = int(item / n_tiles), tile = int(item - (long long)b * n_tiles);
        const int t0 = tile * R;
        const float* xb = x + size_t(b) * T;
        __syncthreads();   // the filters are staged; the last tile's stage is consumed

        // ---- x window [t0, t0+R+KP-1) in bf16, zero past T (those taps meet zero
        // ---- weights, or feed conv rows past T' that the pool drops).
        for (int i = threadIdx.x; i < R + kp - 1; i += THREADS) {
            const int g = t0 + i;
            xs[i] = __float2bfloat16(g < T ? xb[g] : 0.f);
        }
        __syncthreads();

        // ---- im2col: A[r][k] = xs[r + k], eight taps (16 bytes) per store.
        const int chunks = kp / 8;
        for (int idx = threadIdx.x; idx < R * chunks; idx += THREADS) {
            const int r = idx / chunks, k0 = (idx - r * chunks) * 8;
            uint32_t w[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const uint32_t lo = __bfloat16_as_ushort(xs[r + k0 + 2 * q]);
                const uint32_t hi = __bfloat16_as_ushort(xs[r + k0 + 2 * q + 1]);
                w[q] = lo | (hi << 16);
            }
            *reinterpret_cast<uint4*>(as + r * lda + k0) = make_uint4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();

        // ---- conv rows [t0, t0+R) x this warp's column tiles, f32 accumulation.
        FragC acc[MAX_NT][MT];
#pragma unroll
        for (int j = 0; j < MAX_NT; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m) wmma::fill_fragment(acc[j][m], 0.f);
        for (int kc = 0; kc < kp; kc += 16) {
            FragA af[MT];
#pragma unroll
            for (int m = 0; m < MT; ++m)
                wmma::load_matrix_sync(af[m], as + (m * 16) * lda + kc, lda);
#pragma unroll
            for (int j = 0; j < MAX_NT; ++j) {
                const int nt = warp + j * WARPS;
                if (nt < n_col_tiles) {
                    FragB wf;
                    wmma::load_matrix_sync(wf, ws + kc * ldw + nt * 16, ldw);
#pragma unroll
                    for (int m = 0; m < MT; ++m) wmma::mma_sync(acc[j][m], af[m], wf, acc[j][m]);
                }
            }
        }
        __syncthreads();   // every warp is done with the im2col tile: it becomes the stage

        // ---- |.|, max over row triples, write the pooled rows below T3.
#pragma unroll
        for (int j = 0; j < MAX_NT; ++j) {
            const int nt = warp + j * WARPS;
            if (nt >= n_col_tiles) continue;
#pragma unroll
            for (int m = 0; m < MT; ++m)
                wmma::store_matrix_sync(stage + m * 256, acc[j][m], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < (R / 3) * 16; e += 32) {
                const int p = e >> 4, c = e & 15;
                const int gp = t0 / 3 + p;
                if (gp < t3) {
                    const float v = fmaxf(fmaxf(fabsf(stage[(3 * p) * 16 + c]),
                                                fabsf(stage[(3 * p + 1) * 16 + c])),
                                          fabsf(stage[(3 * p + 2) * 16 + c]));
                    out[(size_t(b) * t3 + gp) * C + nt * 16 + c] = v;
                }
            }
            __syncwarp();
        }
    }
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError(). x (B, T) f32; filters (C, K)
// f32; out (B, (T-K+1)//3, C) f32. C a multiple of 16, at most 256; K at most 256;
// T-K+1 >= 3. device = the CUDA device index.
extern "C" int sinc_abs_pool_launch(const void* x, const void* filters, void* out,
                                    int bsz, int T, int C, int K, int device,
                                    void* stream) {
    if (bsz <= 0 || K <= 0 || K > MAX_K || C <= 0 || C % 16 || C > MAX_C ||
        T - K + 1 < 3)
        return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const Layout L = layout(C, K);
    err = cudaFuncSetAttribute(sinc_abs_pool_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (err != cudaSuccess) return int(err);
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinc_abs_pool_kernel,
                                                        THREADS, L.total);
    if (err != cudaSuccess) return int(err);
    if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
    const int t3 = (T - K + 1) / 3;
    const int n_tiles = (t3 + R / 3 - 1) / (R / 3);
    const long long n_items = (long long)bsz * n_tiles;
    const long long slots = (long long)n_sm * per_sm;
    const int grid = int(n_items < slots ? n_items : slots);
    sinc_abs_pool_kernel<<<grid, THREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(filters),
        static_cast<float*>(out), T, C, K, t3, n_tiles, n_items);
    return int(cudaGetLastError());
}
