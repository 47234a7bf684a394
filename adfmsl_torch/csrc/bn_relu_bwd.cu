// K2: the backward of relu(BatchNorm_train(x)), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of adfmsl/ops/pallas/bn_relu_bwd.py:bn_relu_train (:100):
// _reduce_kernel (:39-63) and _dx_kernel (:66-88), launched by _bwd (:115-159). Over
// the flattened (N, C) input, N = B*T, with the forward's per-channel mu and rstd:
//   x^ = (x - mu) * rstd,  y = gamma * x^ + beta,  dy = dz * [y > 0]
//   pass 1: per tile of TILE_ROWS rows, the partials sum(dy * x^) and sum(dy) (f32)
//   (the caller sums the partials over the tiles in a fixed order: dgamma, dbeta)
//   pass 2: dx = (gamma * rstd / N) * (N * dy - dbeta - x^ * dgamma), in x's dtype
// Rounding points, held as in the Pallas kernels and in the plain version
// (ops/bn_relu_bwd.py:bn_relu_bwd_plain): x and dz (already cast to x's dtype by the
// caller) are read and widened to f32, x^ and the ReLU mask are recomputed in f32 from
// the saved x, sums accumulate in f32, dx is rounded once to x's dtype. x^, y and dx
// use round-to-nearest intrinsics so that no multiply-add is contracted: the mask
// y > 0 is then decided exactly as the plain version decides it.
//
// Bound on an H100 SXM (3.35 TB/s): the function must read x and dz once and write dx
// once, 6 bytes an element in bf16 (12 in f32); at maze5's block0 at batch 16
// ((16, 64350, 128) bf16) that is 0.79 GB, 0.236 ms. The elementwise f32 work (about
// 20 operations an element) is far below the card's f32 rate, so bytes bound it.
// chip_smoke.py recomputes both bounds from each case's shapes.
//
// What this design does about it: two passes, as the TPU kernel has (10 bytes an
// element in bf16: x and dz read twice, dx written once), since dx needs the sums over
// every row. Each thread reads 16 bytes of a row (8 bf16 or 4 f32 channels) per load,
// with C across the threads of a block; every block of pass 1 owns TILE_ROWS rows and
// writes its own partials, reduced across its row groups through shared memory in a
// fixed order, so the result does not depend on how blocks are scheduled. Pass 2 is a
// grid-stride elementwise pass with the per-channel constants staged in shared memory.
// There is no overlap of the two passes and no reuse of x between them through L2
// beyond what the cache gives: this is the simple, correct first form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ROWS = 512;
constexpr int MAX_C = 256;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
    static constexpr int N = 4;
};
template <>
struct Vec<bf16> {
    static constexpr int N = 8;
};

__device__ inline void load16(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
}

__device__ inline void load16(const bf16* p, float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ inline void store16(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ inline void store16(bf16* p, const float (&v)[8]) {
    uint4 q;
    bf16* h = reinterpret_cast<bf16*>(&q);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<uint4*>(p) = q;
}

// stats: (4, C) f32 rows gamma, beta, mu, rstd. partials: (tiles, 2, C) f32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bn_relu_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                      const float* __restrict__ stats, float* __restrict__ partials,
                      long long n_rows, int C) {
    constexpr int V = Vec<T>::N;
    __shared__ float red[2][THREADS * V];   // [stat][row group * C + channel]
    const int vecs = C / V;                 // 16-byte vectors in a row
    const int groups = THREADS / vecs;      // rows in flight in the block
    const int g = threadIdx.x / vecs;
    const int c0 = (threadIdx.x - g * vecs) * V;
    float ga[V], be[V], mu[V], rs[V], sg[V], sb[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        ga[k] = stats[c0 + k];
        be[k] = stats[C + c0 + k];
        mu[k] = stats[2 * C + c0 + k];
        rs[k] = stats[3 * C + c0 + k];
        sg[k] = 0.f;
        sb[k] = 0.f;
    }
    const long long r0 = (long long)blockIdx.x * TILE_ROWS;
    const long long r1 = r0 + TILE_ROWS < n_rows ? r0 + TILE_ROWS : n_rows;
    for (long long r = r0 + g; r < r1; r += groups) {
        float xv[V], dv[V];
        load16(x + r * C + c0, xv);
        load16(dz + r * C + c0, dv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const float xh = __fmul_rn(__fsub_rn(xv[k], mu[k]), rs[k]);
            const float y = __fadd_rn(__fmul_rn(ga[k], xh), be[k]);
            const float dy = y > 0.f ? dv[k] : 0.f;
            sg[k] += dy * xh;
            sb[k] += dy;
        }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
        red[0][g * C + c0 + k] = sg[k];
        red[1][g * C + c0 + k] = sb[k];
    }
    __syncthreads();
    float* out = partials + (size_t)blockIdx.x * 2 * C;
    for (int c = threadIdx.x; c < C; c += THREADS) {
        float a = 0.f, b = 0.f;
        for (int q = 0; q < groups; ++q) {   // row groups in order: deterministic
            a += red[0][q * C + c];
            b += red[1][q * C + c];
        }
        out[c] = a;
        out[C + c] = b;
    }
}

// sums: (2, C) f32 rows dgamma, dbeta. nf = N as f32, inv_n = f32(1/N).
template <typename T>
__global__ void __launch_bounds__(THREADS)
bn_relu_dx_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                  const float* __restrict__ stats, const float* __restrict__ sums,
                  T* __restrict__ dx, long long n_vecs, int C, float nf, float inv_n) {
    constexpr int V = Vec<T>::N;
    __shared__ float prm[6][MAX_C];         // gamma, beta, mu, rstd, dgamma, dbeta
    for (int c = threadIdx.x; c < C; c += THREADS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) prm[j][c] = stats[j * C + c];
        prm[4][c] = sums[c];
        prm[5][c] = sums[C + c];
    }
    __syncthreads();
    const int vecs = C / V;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n_vecs;
         i += (long long)gridDim.x * THREADS) {
        const int c0 = int(i % vecs) * V;
        float xv[V], dv[V], out[V];
        load16(x + i * V, xv);
        load16(dz + i * V, dv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const int c = c0 + k;
            const float ga = prm[0][c], rs = prm[3][c];
            const float xh = __fmul_rn(__fsub_rn(xv[k], prm[2][c]), rs);
            const float y = __fadd_rn(__fmul_rn(ga, xh), prm[1][c]);
            const float dy = y > 0.f ? dv[k] : 0.f;
            const float scale = __fmul_rn(__fmul_rn(ga, rs), inv_n);
            const float t = __fsub_rn(__fsub_rn(__fmul_rn(nf, dy), prm[5][c]),
                                      __fmul_rn(xh, prm[4][c]));
            out[k] = __fmul_rn(scale, t);
        }
        store16(dx + i * V, out);
    }
}

bool bad_shape(long long n_rows, int C, int dtype) {
    return n_rows <= 0 || (C != 128 && C != 256) || (dtype != 0 && dtype != 1);
}

}  // namespace

// Pass 1 on `stream`; returns cudaGetLastError(). x, dz: (n_rows, C) contiguous, f32
// (dtype 0) or bf16 (dtype 1), 16-byte aligned; stats (4, C) f32; partials
// (ceil(n_rows / 512), 2, C) f32. C is 128 or 256. device = the CUDA device index.
extern "C" int bn_relu_reduce_launch(const void* x, const void* dz, const void* stats,
                                     void* partials, long long n_rows, int C, int dtype,
                                     int device, void* stream) {
    if (bad_shape(n_rows, C, dtype)) return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const long long tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
    if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* st = static_cast<const float*>(stats);
    float* part = static_cast<float*>(partials);
    if (dtype == 0)
        bn_relu_reduce_kernel<float><<<int(tiles), THREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(dz), st, part, n_rows, C);
    else
        bn_relu_reduce_kernel<bf16><<<int(tiles), THREADS, 0, s>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(dz), st, part, n_rows, C);
    return int(cudaGetLastError());
}

// Pass 2 on `stream`; returns cudaGetLastError(). sums (2, C) f32 = dgamma, dbeta;
// dx (n_rows, C) in x's dtype; other arguments as for pass 1.
extern "C" int bn_relu_dx_launch(const void* x, const void* dz, const void* stats,
                                 const void* sums, void* dx, long long n_rows, int C,
                                 int dtype, int device, void* stream) {
    if (bad_shape(n_rows, C, dtype)) return int(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    int n_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return int(err);
    const int v = dtype == 0 ? Vec<float>::N : Vec<bf16>::N;
    const long long n_vecs = n_rows * C / v;
    long long blocks = (n_vecs + THREADS - 1) / THREADS;
    const long long cap = (long long)n_sm * 8;   // grid-stride beyond 8 blocks an SM
    if (blocks > cap) blocks = cap;
    const float nf = float(n_rows);
    const float inv_n = float(1.0 / double(n_rows));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* st = static_cast<const float*>(stats);
    const float* sm = static_cast<const float*>(sums);
    if (dtype == 0)
        bn_relu_dx_kernel<float><<<int(blocks), THREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(dz), st, sm,
            static_cast<float*>(dx), n_vecs, C, nf, inv_n);
    else
        bn_relu_dx_kernel<bf16><<<int(blocks), THREADS, 0, s>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(dz), st, sm,
            static_cast<bf16*>(dx), n_vecs, C, nf, inv_n);
    return int(cudaGetLastError());
}
