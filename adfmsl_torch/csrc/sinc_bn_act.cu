// K5: maze5's eval front end (the TF32 sinc conv, first_bn and SELU), hand-written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: adfmsl runs this front end as an XLA conv
// (adfmsl/ops/sinc.py:sinc_conv_nhc, :147) and elementwise ops. It is the port's own:
// on the H100 cuDNN's TF32 implicit GEMM for this one-channel, 251-tap conv and the five
// elementwise passes after it (layout, bf16 cast, BatchNorm, cast, SELU) took 84 of a
// maze5_fmsl eval batch's 127 device ms at batch 128. Function, per batch row b, conv
// row t < T' = T-K+1 and channel c:
//   z            = sum_{k<K} tf32(x[b, t+k]) * tf32(f[c, k])     f32 accumulation
//   y            = bf16((bf16(z) - mean[c]) * mul[c] + bias[c])  f32, no FMA contraction
//   out[b, t, c] = bf16(selu(y))                                 f32, as torch's elu kernel
// tf32() rounds to nearest, ties away (cvt.rna; ops/sinc_fused.py:tf32_round). These are
// the rounding points of the composition it stands in for (models/mazes.py:_frontend: the
// cuDNN TF32 conv, .to(bf16), ops/norm.py:_normalize, F.selu on bf16) and of its plain
// version (ops/sinc_bn_act.py:sinc_bn_act_plain); out is the trunk's contiguous
// (B, T', C) bf16 input.
//
// Bound on an H100 SXM (495 TFLOP/s dense TF32, 3.35 TB/s): at batch 128, cut 64600,
// C 128 and K 251 the correlation is 2*B*T'*C*K = 529 GFLOP (1.07 ms) against 33 MB of x
// in and 2.11 GB of bf16 out (0.64 ms): bound by tensor-core operations, with the bytes
// and the epilogue's CUDA-core work not far behind. chip_smoke.py recomputes the bound
// from each case's shapes. The first form of this kernel (SELU through expm1f, 4-byte
// stores straight from the accumulators) took 4.33 ms at batch 128 on an H100 80GB HBM3
// at 700 W: its products alone took 1.25 ms, expm1f's ~20 instructions and branches an
// output 2.1 ms more and the scattered stores 0.9 ms.
//
// The design:
// 1. Conv-row-major tiles. A warpgroup's tile is 64 conv rows of one batch row and the
//    128 channels of its CTA's channel tile: one wgmma m64n128k8 tf32 accumulator, 64
//    registers a thread, so each x fragment feeds every channel. The three warpgroups of
//    a CTA walk their own tiles, each with its own x window and named barrier, so one's
//    epilogue runs under another's products.
// 2. A from registers, no im2col: A[i][k] = x[t0 + i + k]. Each 8-tap k-step's m16n8k8
//    fragment is four 32-bit loads from the tile's x window in shared memory (rounded to
//    TF32 once when staged); lane (g, t) reads word g + t (+4, +8, +12), so the words of a
//    warp are distinct banks or the same word.
// 3. B, the filters, from shared memory through a descriptor: ops/sinc_bn_act.py lays them
//    out once a call in ops/sinc_fused.py:kernel_filter_layout's TF32 core-matrix form
//    (taps zero-padded to a multiple of 32, channels to a multiple of 128), and each
//    persistent CTA bulk-copies its channel tile once (cp.async.bulk, mbarrier; 128 KB at
//    K 251) beside the tile's BN operands.
// 4. The next tile's x window is loaded into registers (3 samples a thread) under the
//    current tile's products.
// 5. The epilogue acts on the accumulators in registers. SELU's negative branch is a
//    table: its output is a bf16 function of the bf16 y, so ops/sinc_bn_act.py computes
//    it once with torch's own F.selu for every negative bf16 down to -8 (below -8 every
//    y rounds to the same output, -1.7578125), and each CTA bulk-copies the table (33 KB)
//    beside the filters; y >= +0 takes y * scale. No expm1f, no branch.
// 6. The bf16 results go through shared memory: stmatrix writes the accumulator layout as
//    rows (a 272-byte pitch, so the eight rows of a matrix hit distinct banks), then each
//    thread stores 16-byte chunks, a warp 512 contiguous bytes. Rows past T' (T' % 64
//    tails) and channels past C are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int ROWS = 64;                 // conv rows of a tile: the wgmma M
constexpr int NC = 128;                  // channels of a tile: the wgmma N
constexpr int NWG = 3;                   // warpgroups of a CTA
constexpr int THREADS = 128 * NWG;
constexpr int MAX_C = 256;
constexpr int MAX_K = 256;
constexpr int KB = 4;                    // 8-tap k-steps a wgmma commit group
constexpr int TAP_STEP = 8 * KB;         // the filters' taps are padded to a multiple
constexpr int XWIN = ROWS + MAX_K;       // x window samples of a tile
constexpr int XPT = (XWIN + 127) / 128;  // x window samples a thread stages
constexpr int SMEM_LIMIT = 232448;
constexpr int LUT_LAST = 0x4100;         // magnitude bits of bf16 8.0: the table's last entry
constexpr int LUT_BYTES = 33296;         // (LUT_LAST + 1) u16, padded to 16 bytes
constexpr int PITCH = NC * 2 + 16;       // bytes between rows of the output stage

__host__ __device__ inline int kpad(int k) { return (k + TAP_STEP - 1) / TAP_STEP * TAP_STEP; }
__host__ __device__ inline int align128(int v) { return (v + 127) & ~127; }

struct Smem {
    // byte offsets: BN operands, SELU table, filters, x windows, output stages; barrier at 0
    int p, lut, w, xw, st, total;
};

__host__ __device__ inline Smem smem_layout(int kp) {
    Smem s;
    s.p = 128;
    s.lut = align128(s.p + 3 * NC * 4);
    s.w = align128(s.lut + LUT_BYTES);
    s.xw = align128(s.w + NC * kp * 4);
    s.st = align128(s.xw + NWG * XWIN * 4);
    s.total = align128(s.st + NWG * ROWS * PITCH);
    return s;
}

__device__ __forceinline__ float tf32_rna(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return __uint_as_float(r);
}

// Two f32 as bf16, rounded to nearest even, in one word (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// SELU of one bf16 y (its bits h, in the low 16 bits), as a bf16: torch's elu kernel on
// a bf16 input computes y > 0 ? y * scale : expm1(y) * alpha * scale in f32 and rounds.
// p is bf16(y * scale); a negative y (down to -inf; a NaN keeps p) reads the table.
__device__ __forceinline__ uint32_t selu_half(uint32_t h, uint32_t p, const uint16_t* lut) {
    const uint32_t mag = h & 0x7fffu;
    const uint32_t t = lut[min(mag, uint32_t(LUT_LAST))];
    return (h & 0x8000u) && mag <= 0x7f80u ? t : p;
}

// first_bn's eval affine, then SELU, for two channels of one row, at the composition's
// rounding points: bf16(z), the f32 affine of ops/norm.py:affine (three separate
// roundings: torch runs three kernels), bf16(y), SELU, bf16. Returns the bf16 pair.
__device__ __forceinline__ uint32_t bn_selu2(float z0, float z1, float2 m, float2 u, float2 v,
                                             float pos, const uint16_t* lut) {
    const uint32_t zw = pack_bf16(z0, z1);
    const uint32_t yw = pack_bf16(__fadd_rn(__fmul_rn(__fsub_rn(lo_f(zw), m.x), u.x), v.x),
                                  __fadd_rn(__fmul_rn(__fsub_rn(hi_f(zw), m.y), u.y), v.y));
    const uint32_t pw = pack_bf16(__fmul_rn(lo_f(yw), pos), __fmul_rn(hi_f(yw), pos));
    return selu_half(yw & 0xffffu, pw & 0xffffu, lut) |
           (selu_half(yw >> 16, pw >> 16, lut) << 16);
}

// Four 8 x 8 b16 matrices in the mma accumulator layout (register i: this thread's pair
// of matrix i) to shared memory; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
                 :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// D (64 x 128, f32, registers) += A (64 x 8 tf32, registers: this warp's m16n8k8 A
// fragment) * B (8 x 128 tf32, shared memory, descriptor).
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Grid: n_ct * ctas_per_ct CTAs of THREADS threads. CTA (ct, r) owns channels
// ct*128 .. ct*128+127; its warpgroup w walks the items g, g + stride, ... of (batch row,
// 64-row tile), g = r * NWG + w, stride = ctas_per_ct * NWG.
__global__ void __launch_bounds__(THREADS, 1)
sinc_bn_act_kernel(const float* __restrict__ x, const float* __restrict__ wl,
                   const float* __restrict__ mean, const float* __restrict__ mul,
                   const float* __restrict__ bias, const uint16_t* __restrict__ lut_g,
                   __nv_bfloat16* __restrict__ out, int T, int C, int kp, int t_out,
                   int n_tiles, int items, int ctas_per_ct, float pos) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Smem L = smem_layout(kp);
    const uint32_t sbase = smem_u32(smem), bar = sbase, wsm = sbase + L.w;
    float* prm = reinterpret_cast<float*>(smem + L.p);      // mean, mul, bias: NC each
    const uint16_t* lut = reinterpret_cast<const uint16_t*>(smem + L.lut);
    const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
    const int wi = wt >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
    const int ct = blockIdx.x / ctas_per_ct, r = blockIdx.x - ct * ctas_per_ct;
    float* xs = reinterpret_cast<float*>(smem + L.xw) + wg * XWIN;
    const uint32_t stage = sbase + L.st + wg * ROWS * PITCH;

    if (tid == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    for (int i = tid; i < NC; i += THREADS) {
        const int c = ct * NC + i;
        const bool in = c < C;
        prm[i] = in ? mean[c] : 0.f;
        prm[NC + i] = in ? mul[c] : 0.f;
        prm[2 * NC + i] = in ? bias[c] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                             // this channel tile's filters and the table, once
        const int half = (NC / 2) * kp * 4;     // two bulk copies of 64 channels
        mbar_expect_tx(bar, 2 * half + LUT_BYTES);
        for (int h = 0; h < 2; ++h)
            bulk_g2s(wsm + h * half, wl + (size_t(ct) * NC + h * (NC / 2)) * kp, half, bar);
        bulk_g2s(sbase + L.lut, lut_g, LUT_BYTES, bar);
    }

    const int gw = r * NWG + wg, stride = ctas_per_ct * NWG, win = ROWS + kp;
    float xv[XPT];
    auto fetch = [&](int item) {                // the item's x window, zero past T
        const int b = item / n_tiles, t0 = (item - b * n_tiles) * ROWS;
        const float* xb = x + size_t(b) * T;
#pragma unroll
        for (int q = 0; q < XPT; ++q) {
            const int i = wt + q * 128;
            xv[q] = i < win && t0 + i < T ? xb[t0 + i] : 0.f;
        }
    };
    if (gw < items) fetch(gw);
    mbar_wait(bar, 0);

    // this thread's A element (row g, tap t) of a k-step; (g + 8, t) is 8 samples on,
    // (g, t + 4) 4 samples on
    const float* xa = xs + wi * 16 + gq + tq;
    for (int item = gw; item < items; item += stride) {
        const int b = item / n_tiles, t0 = (item - b * n_tiles) * ROWS;
        bar_sync_count(1 + wg, 128);            // the last tile's readers of xs and stage are done
#pragma unroll
        for (int q = 0; q < XPT; ++q) {
            const int i = wt + q * 128;
            if (i < win) xs[i] = tf32_rna(xv[q]);
        }
        bar_sync_count(1 + wg, 128);
        if (item + stride < items) fetch(item + stride);

        float acc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = 0.f;
        for (int kc = 0; kc < kp; kc += TAP_STEP) {     // no wgmma in a branch (ptxas C7520)
            uint32_t a[KB][4];
#pragma unroll
            for (int kb = 0; kb < KB; ++kb) {
                const float* w = xa + kc + 8 * kb;
                a[kb][0] = __float_as_uint(w[0]);
                a[kb][1] = __float_as_uint(w[8]);
                a[kb][2] = __float_as_uint(w[4]);
                a[kb][3] = __float_as_uint(w[12]);
            }
            wgmma_fence();
#pragma unroll
            for (int kb = 0; kb < KB; ++kb)
                wgmma_tf32_n128(acc, a[kb], b_desc(wsm + (kc + 8 * kb) * 32, kp * 32));
            wgmma_commit();
            wgmma_wait_all();
        }

        // ---- first_bn and SELU on the accumulators: element 4jj + 2hf + e is (row 16wi +
        // ---- g + 8hf, channel 8jj + 2t + e); the bf16 pairs of matrices (hf, jj) and
        // ---- (hf, jj + 1) go to the stage by one stmatrix
        const int mi = lane >> 3;               // the matrix whose row this lane addresses
        const uint32_t srow = stage + (wi * 16 + (mi & 1) * 8 + (lane & 7)) * PITCH +
                              (mi >> 1) * 16;
#pragma unroll
        for (int jp = 0; jp < NC / 16; ++jp) {
            uint32_t r[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int jj = 2 * jp + (q >> 1), hf = q & 1;
                const int c = 8 * jj + 2 * tq, idx = 4 * jj + 2 * hf;
                r[q] = bn_selu2(acc[idx], acc[idx + 1],
                                *reinterpret_cast<const float2*>(prm + c),
                                *reinterpret_cast<const float2*>(prm + NC + c),
                                *reinterpret_cast<const float2*>(prm + 2 * NC + c), pos, lut);
            }
            stmatrix_x4(srow + jp * 32, r[0], r[1], r[2], r[3]);
        }
        bar_sync_count(1 + wg, 128);            // the stage is whole
        // ---- 16-byte chunks of the stage's rows to out: 8 channels a chunk
        const int rows = min(ROWS, t_out - t0), chunks = min(NC, C - ct * NC) / 8;
        __nv_bfloat16* ob = out + (size_t(b) * t_out + t0) * C + ct * NC;
#pragma unroll
        for (int q = wt; q < ROWS * (NC / 8); q += 128) {
            const int row = q / (NC / 8), ch = q % (NC / 8);
            if (row < rows && ch < chunks)
                st_global_cs16(ob + size_t(row) * C + ch * 8,
                               ld_shared16(stage + row * PITCH + ch * 16));
        }
    }
}

}  // namespace

// Launches K5 on `stream`; returns cudaGetLastError(). x (B, T) f32; wl the filters in
// ops/sinc_bn_act.py:kernel_filters's TF32 layout (channels padded to a multiple of 128,
// taps to a multiple of 32); mean, mul, bias (C,) f32; lut ops/sinc_bn_act.py:selu_table's
// LUT_BYTES; out (B, T-K+1, C) bf16; pos SELU's scale in f32. C a multiple of 16, at most
// 256; K at most 256; T >= K. device = the CUDA device index.
extern "C" int sinc_bn_act_launch(const void* x, const void* wl, const void* mean,
                                  const void* mul, const void* bias, const void* lut,
                                  void* out, int bsz, int T, int C, int K, float pos,
                                  int device, void* stream) {
    if (bsz <= 0 || K <= 0 || K > MAX_K || C <= 0 || C % 16 || C > MAX_C || T < K)
        return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int kp = kpad(K);
    const Smem L = smem_layout(kp);
    if (L.total > SMEM_LIMIT) return int(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(sinc_bn_act_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return int(err);
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return int(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinc_bn_act_kernel,
                                                        THREADS, L.total);
    if (err != cudaSuccess) return int(err);
    if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
    const int n_ct = (C + NC - 1) / NC, t_out = T - K + 1;
    const int n_tiles = (t_out + ROWS - 1) / ROWS;
    const long long items = (long long)bsz * n_tiles;
    if (items > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    long long per_ct = (long long)n_sm * per_sm / n_ct;
    const long long need = (items + NWG - 1) / NWG;     // no CTA without an item
    if (per_ct > need) per_ct = need;
    if (per_ct < 1) per_ct = 1;
    sinc_bn_act_kernel<<<int(n_ct * per_ct), THREADS, L.total,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(wl),
        static_cast<const float*>(mean), static_cast<const float*>(mul),
        static_cast<const float*>(bias), static_cast<const uint16_t*>(lut),
        static_cast<__nv_bfloat16*>(out), T, C, kp, t_out, n_tiles, int(items), int(per_ct),
        pos);
    return int(cudaGetLastError());
}
