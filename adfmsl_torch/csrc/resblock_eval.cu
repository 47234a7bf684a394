// K1: the folded eval-mode SE-ResBlock body, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel adfmsl/ops/pallas/resblock_fused.py:resblock_eval_fused
// (its body is _kernel, :69-136). Function, per batch row b and time row t:
//   h   = act(x*a1 + c1), or h = x at the stack head; zero outside [0, T)
//   y1  = act(conv3(h) . w1 + b1);                        zero outside [0, T)
//   out = conv3(y1) . w2 + bt + skip,  skip = x (identity) or x . skw (1x1 conv)
//   y   = bf16(out) or bf16(MaxPool3 VALID(out));  sums = f32 sum of the valid rows
// act is ReLU or LeakyReLU(0.3). Rounding points, held exactly as in the Pallas
// kernel and in the plain version (ops/resblock_fused.py:resblock_eval_plain):
// h and y1 are rounded to bf16, both convs take bf16 operands and accumulate in
// f32, out / the pool / the sums are f32, y is out rounded to bf16.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at maze5's block0,
// batch 128, T 64350, 128 -> 128 channels, the two k3 convs are 1.62 TFLOP
// (1.64 ms) against 4.2 GB of bf16 x in and y out (1.26 ms): the block is bound
// by tensor-core operations, and the later blocks (T halves, bytes halve with
// it) are too. chip_smoke.py recomputes the bound per block from the shapes.
//
// What this design does about it: everything between the two convs stays on
// chip. One CTA owns R = 48 output rows of one batch row; it stages x rows
// [r0-2, r0+R+16) in shared memory, computes h there, runs conv1 into a bf16 y1
// tile of R+16 rows in shared memory, then conv2 (+ the 1x1 skip) into f32 and
// writes only y and one row of per-tile channel sums, so device memory sees x
// once and y once. Products go through the tensor cores as bf16 16x16x16 wmma
// fragments with f32 accumulation: each warp owns 16 output channels, keeps the
// accumulators of all its row tiles in registers, and loads each weight
// fragment once per CTA (from L2; the folded weights are at most 384 KB). The
// halo recomputes 16 of every 64 conv1 rows, and there is no TMA, wgmma or
// pipelining yet: this is the simple, correct first form, not a fast one.
// Blocks run in no order, so the channel sums are not carried across tiles as
// the Pallas grid does: each CTA writes its partial sums to a (B, n_tiles,
// Cout) scratch and a second launch reduces them in a fixed order, which keeps
// the result deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int R = 48;               // output rows per tile: a multiple of 16 and of 3
constexpr int Y1_ROWS = R + 16;     // conv1 rows: global r0-1 .. r0+R+14
constexpr int X_ROWS = R + 18;      // input rows: global r0-2 .. r0+R+15
constexpr int MT1 = Y1_ROWS / 16;   // 16-row fragments of y1
constexpr int MT2 = R / 16;         // 16-row fragments of out
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_C = 256;

// Shared-memory row pitch in elements: a multiple of 16, so every row starts
// 32-byte aligned as wmma loads require, and 16 elements of skew across banks.
__host__ __device__ inline int pitch(int c) { return c + 16; }

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

struct Layout {
    size_t xs, hs, y1s, stage, total;
};

__host__ __device__ inline Layout layout(int cin, int cout) {
    Layout L;
    size_t off = 0;
    L.xs = off;
    off = align128(off + size_t(X_ROWS) * pitch(cin) * sizeof(bf16));
    L.hs = off;
    off = align128(off + size_t(X_ROWS) * pitch(cin) * sizeof(bf16));
    L.y1s = off;
    off = align128(off + size_t(Y1_ROWS) * pitch(cout) * sizeof(bf16));
    L.stage = off;                  // per warp: R x 16 f32
    off = align128(off + size_t(WARPS) * R * 16 * sizeof(float));
    L.total = off;
    return L;
}

__device__ __forceinline__ float act_fn(float v, int act) {
    return act == 0 ? fmaxf(v, 0.f) : fmaxf(v, __fmul_rn(0.3f, v));
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(THREADS)
resblock_eval_kernel(const bf16* __restrict__ x, const float* __restrict__ pre,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const float* __restrict__ bt,
                     const bf16* __restrict__ skw, bf16* __restrict__ y,
                     float* __restrict__ partial, int T, int cin, int cout,
                     int act, int pool) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L = layout(cin, cout);
    bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
    bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
    bf16* y1s = reinterpret_cast<bf16*>(smem + L.y1s);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* stage = reinterpret_cast<float*>(smem + L.stage) + warp * (R * 16);
    const int ldx = pitch(cin), ldy = pitch(cout);
    const int tile = blockIdx.x, n_tiles = gridDim.x, b = blockIdx.y;
    const int r0 = tile * R;
    const bf16* xb = x + size_t(b) * T * cin;

    // ---- x rows [r0-2, r0+R+16) -> xs (raw, zero outside [0,T)) and hs = h.
    const int chunks = cin / 8;                     // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < X_ROWS * chunks; idx += THREADS) {
        const int k = idx / chunks, ch = idx - k * chunks;
        const int g = r0 - 2 + k;
        const bool valid = g >= 0 && g < T;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (valid) raw = *reinterpret_cast<const uint4*>(xb + size_t(g) * cin + ch * 8);
        *reinterpret_cast<uint4*>(xs + k * ldx + ch * 8) = raw;
        const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&in[q]);
            float f0 = __low2float(p), f1 = __high2float(p);
            if (pre != nullptr) {
                const int c = ch * 8 + 2 * q;
                f0 = act_fn(__fadd_rn(__fmul_rn(f0, pre[c]), pre[cin + c]), act);
                f1 = act_fn(__fadd_rn(__fmul_rn(f1, pre[c + 1]), pre[cin + c + 1]), act);
            }
            if (!valid) f0 = f1 = 0.f;             // SAME padding after the activation
            __nv_bfloat162 h2 = __floats2bfloat162_rn(f0, f1);
            out[q] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        *reinterpret_cast<uint4*>(hs + k * ldx + ch * 8) =
            make_uint4(out[0], out[1], out[2], out[3]);
    }
    __syncthreads();

    // ---- y1 row j is global r0-1+j and reads h rows j, j+1, j+2 (taps 0..2).
    const int n_col_tiles = cout / 16;
    for (int nt = warp; nt < n_col_tiles; nt += WARPS) {
        const int n0 = nt * 16;
        FragC acc[MT1];
#pragma unroll
        for (int m = 0; m < MT1; ++m) wmma::fill_fragment(acc[m], 0.f);
        for (int d = 0; d < 3; ++d) {
            for (int kc = 0; kc < cin; kc += 16) {
                FragB wf;
                wmma::load_matrix_sync(wf, w1 + (size_t(d) * cin + kc) * cout + n0, cout);
#pragma unroll
                for (int m = 0; m < MT1; ++m) {
                    FragA af;
                    wmma::load_matrix_sync(af, hs + (m * 16 + d) * ldx + kc, ldx);
                    wmma::mma_sync(acc[m], af, wf, acc[m]);
                }
            }
        }
#pragma unroll
        for (int m = 0; m < MT1; ++m) {
            wmma::store_matrix_sync(stage, acc[m], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int j = m * 16 + (e >> 4), c = n0 + (e & 15);
                const int g = r0 - 1 + j;
                const float v = act_fn(__fadd_rn(stage[e], b1[c]), act);
                y1s[j * ldy + c] = __float2bfloat16(g >= 0 && g < T ? v : 0.f);
            }
            __syncwarp();
        }
    }
    __syncthreads();

    // ---- out row i is global r0+i and reads y1 rows i, i+1, i+2; the 1x1 skip
    // ---- reads x row i (xs row i+2) and accumulates into the same fragments.
    const bool identity = skw == nullptr;
    const int t_out = T / pool;
    for (int nt = warp; nt < n_col_tiles; nt += WARPS) {
        const int n0 = nt * 16;
        FragC acc[MT2];
#pragma unroll
        for (int m = 0; m < MT2; ++m) wmma::fill_fragment(acc[m], 0.f);
        for (int d = 0; d < 3; ++d) {
            for (int kc = 0; kc < cout; kc += 16) {
                FragB wf;
                wmma::load_matrix_sync(wf, w2 + (size_t(d) * cout + kc) * cout + n0, cout);
#pragma unroll
                for (int m = 0; m < MT2; ++m) {
                    FragA af;
                    wmma::load_matrix_sync(af, y1s + (m * 16 + d) * ldy + kc, ldy);
                    wmma::mma_sync(acc[m], af, wf, acc[m]);
                }
            }
        }
        if (!identity) {
            for (int kc = 0; kc < cin; kc += 16) {
                FragB wf;
                wmma::load_matrix_sync(wf, skw + size_t(kc) * cout + n0, cout);
#pragma unroll
                for (int m = 0; m < MT2; ++m) {
                    FragA af;
                    wmma::load_matrix_sync(af, xs + (2 + m * 16) * ldx + kc, ldx);
                    wmma::mma_sync(acc[m], af, wf, acc[m]);
                }
            }
        }
#pragma unroll
        for (int m = 0; m < MT2; ++m)
            wmma::store_matrix_sync(stage + m * 256, acc[m], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < R * 16; e += 32) {        // out = acc + bt + skip
            const int i = e >> 4, c = n0 + (e & 15);
            float v = __fadd_rn(stage[e], bt[c]);
            if (identity) v = __fadd_rn(v, __bfloat162float(xs[(2 + i) * ldx + c]));
            stage[e] = v;
        }
        __syncwarp();
        // Each lane keeps one column (lane & 15) and every other row; the two
        // halves meet in one shuffle, so the per-tile sum has a fixed order.
        float s = 0.f;
        if (pool == 1) {
            for (int e = lane; e < R * 16; e += 32) {
                const int g = r0 + (e >> 4);
                if (g < T) {
                    const float v = stage[e];
                    y[(size_t(b) * t_out + g) * cout + n0 + (e & 15)] = __float2bfloat16(v);
                    s += v;
                }
            }
        } else {
            for (int e = lane; e < (R / 3) * 16; e += 32) {
                const int p = e >> 4, c = e & 15;
                const int gp = r0 / 3 + p;                // valid iff gp < T/3
                if (gp < t_out) {
                    const float v = fmaxf(fmaxf(stage[(3 * p) * 16 + c],
                                                stage[(3 * p + 1) * 16 + c]),
                                          stage[(3 * p + 2) * 16 + c]);
                    y[(size_t(b) * t_out + gp) * cout + n0 + c] = __float2bfloat16(v);
                    s += v;
                }
            }
        }
        s += __shfl_down_sync(0xffffffffu, s, 16);
        if (lane < 16) partial[(size_t(b) * n_tiles + tile) * cout + n0 + lane] = s;
        __syncwarp();
    }
}

// sums[b, c] = sum over tiles of partial[b, tile, c], tiles in order.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ sums, int bsz,
                                       int n_tiles, int cout) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= bsz * cout) return;
    const int b = idx / cout, c = idx - b * cout;
    const float* p = partial + size_t(b) * n_tiles * cout + c;
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += p[size_t(t) * cout];
    sums[idx] = s;
}

}  // namespace

extern "C" int resblock_eval_rows(void) { return R; }

// Launches K1 and its sum reduction on `stream`; returns cudaGetLastError().
// x (B,T,Cin) bf16; pre (2,Cin) f32 or null; w1 (3,Cin,Cout), w2 (3,Cout,Cout)
// bf16; b1, bt (Cout) f32; skw (Cin,Cout) bf16 or null (then Cin == Cout);
// y (B,T/pool,Cout) bf16; partial (B,ceil(T/R),Cout) f32 scratch; sums (B,Cout)
// f32. act 0 = ReLU, 1 = LeakyReLU(0.3); pool 1 or 3; device = the CUDA device index.
extern "C" int resblock_eval_launch(const void* x, const void* pre, const void* w1,
                                    const void* b1, const void* w2, const void* bt,
                                    const void* skw, void* y, void* partial, void* sums,
                                    int bsz, int T, int cin, int cout, int act,
                                    int pool, int device, void* stream) {
    if (bsz <= 0 || T < pool || cin % 16 || cout % 16 || cin > MAX_C || cout > MAX_C ||
        (pool != 1 && pool != 3) || (act != 0 && act != 1) ||
        (skw == nullptr && cin != cout) || bsz > 65535)
        return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const Layout L = layout(cin, cout);
    err = cudaFuncSetAttribute(
        resblock_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
    if (err != cudaSuccess) return int(err);
    const int n_tiles = (T + R - 1) / R;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    resblock_eval_kernel<<<dim3(n_tiles, bsz), THREADS, L.total, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(pre),
        static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(bt),
        static_cast<const bf16*>(skw), static_cast<bf16*>(y),
        static_cast<float*>(partial), T, cin, cout, act, pool);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    const int n = bsz * cout;
    reduce_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(sums), bsz, n_tiles, cout);
    return int(cudaGetLastError());
}
