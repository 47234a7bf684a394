// The filters' gradient of K3's trainable form, hand-written for Hopper (sm_90a).
//
// Replaces the backward of adfmsl/ops/pallas/sinc_fused.py:sinc_abs_pool (the custom
// VJP, _sap_bwd :152), which recomputes the f32 composition max_pool3(|conv(x, f)|)
// (ops/sinc.py:293) and takes its VJP. Function, with T' = T-K+1, T3 = T'//3, for the
// cotangent g (B, T3, C) f32:
//   z[b, t, c]   = sum_{k<K} x[b, t+k] * f[c, k]                       (the recompute)
//   G[b, 3p+j, c] = g[b, p, c] / n * s(z) where |z[b, 3p+j, c]| is the max of its
//                  triple (n of the three tie at the max), else 0;
//                  s(z) = +1 for z >= 0, -1 for z < 0 (jnp.abs's VJP)   (the routing)
//   df[c, k]     = sum_{b, t} G[b, t, c] * x[b, t+k]                   (the weight gradient)
// Precision (ops/sinc_fused.py:sinc_abs_pool_bwd): PASSES = 1 runs both products as one
// TF32 pass (operands rounded by cvt.rna.tf32.f32, as cuDNN's TF32 convs round them);
// PASSES = 3 as three, big*big + big*small + small*big with small = tf32(v - tf32(v)),
// which is f32 accuracy. Accumulation is f32.
//
// Bound on an H100 SXM (495 TFLOP/s dense TF32, 3.35 TB/s): at batch 12, cut 64600,
// C 128, K 251, the recompute and the weight gradient are 2 * 2*B*T'*C*K = 99.2 GFLOP
// (0.200 ms) against 3.1 MB of x and 132 MB of g in (0.04 ms): bound by tensor-core
// operations; three passes triple the products. chip_smoke.py recomputes it.
//
// The design:
// 1. Pool-major rows. A CTA tile is 128 pooled rows (384 conv rows) of one batch row
//    and 64 channels; warpgroup w owns pooled rows 64w .. 64w+63. Its three wgmma
//    accumulators j = 0, 1, 2 hold conv rows 3i + j, so the three members of a pool
//    triple sit in the same thread and the same register of the three accumulators:
//    |z|, the max, the tie count and the slope are register arithmetic, and the routed
//    G overwrites z in place.
// 2. The Toeplitz operand comes from registers, with no im2col: the recompute is
//    z_j = A_j * F^T, wgmma m64n64k8 tf32, with A_j[i][k] = x[t0 + 3i + j + k] loaded by
//    32-bit ld.shared straight from the tile's x window (640 samples, rounded to
//    TF32 once when staged). In the m16n8k8 fragment (row lane/4, column lane%4) the
//    words 3*(lane/4) + lane%4 are distinct banks or the same word. B, the filters,
//    comes from shared memory through a descriptor: ops/sinc_fused.py:
//    kernel_filter_layout lays them out once per call in the no-swizzle K-major
//    core-matrix layout (8 channels x 4 taps, 128 B), and each persistent CTA bulk-copies
//    its 64-channel tile once (cp.async.bulk, mbarrier). TF32 wgmma takes no transpose;
//    both operands are K-major here.
// 3. The weight gradient is dF^T (KM x 64) += sum_j A'_j * G_j with A'_j[k][i] =
//    x[t0 + 3i + j + k], again from registers and from the same window. G_j (128 x 64)
//    goes from the routed accumulators into shared memory as a K-major B operand
//    (pooled rows contiguous), then fence.proxy.async and a barrier hand it to wgmma.
//    Warpgroup w keeps the 64-tap M-blocks w and w + 2 of dF^T (KM = 256 taps, whatever
//    K: a wgmma in a branch serialises every wgmma of the kernel, ptxas C7520) in
//    registers over FLUSH = 4 of the tiles its CTA walks, then writes them as a partial
//    and starts again from zero; a second launch sums the partials in a fixed order
//    (deterministic, no float atomics). Taps past K are dropped there. The flush keeps
//    the long sums out of the tensor cores' accumulation, which rounds toward zero: a
//    build that summed all of a CTA's ~30 tiles there showed a negative bias against
//    an f64 reference at three passes (chip_smoke.py reports the error and bias of
//    this form at batch 12).
// 4. Channel tiles of 64 across CTAs: a full 256 x 128 f32 dF^T (32,768 registers) and
//    the three accumulators would not fit an SM's 65,536 registers. The grid is
//    (channel tile) x (persistent CTAs walking (batch row, time tile) items); channels
//    past C are zero filters, so they route zero gradient and are not written.
// 5. The next tile's x window is loaded into registers (3 a thread) under the current
//    tile's products. Shared memory: filters 64 KB a pass-part, x windows 2.5 KB, G_j
//    32 KB a pass-part; at most 197 KB (three passes, K 256), one CTA an SM.
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
constexpr int KM = 256;         // taps of dF^T: four 64-tap M-blocks, two a warpgroup
constexpr int XWIN = CR + KM;   // x window samples of a tile (the recompute reads fewer)
constexpr int XPT = (XWIN + THREADS - 1) / THREADS;   // x window samples a thread stages
constexpr int FLUSH = 4;        // tiles a partial sums in the wgmma accumulators
constexpr int SMEM_LIMIT = 232448;
constexpr int G_SBO = (PR / 4) * 128;   // bytes between 8-channel groups of G_j

__host__ __device__ inline int kpad(int k) { return (k + 15) / 16 * 16; }    // recompute taps
__host__ __device__ inline int align128(int v) { return (v + 127) & ~127; }

struct Smem {
    int w, xw, gs, total;       // byte offsets: filters, x windows, G_j; the barrier at 0
};

__host__ __device__ inline Smem smem_layout(int k, int passes) {
    const int parts = passes == 1 ? 1 : 2;
    Smem s;
    s.w = 128;
    s.xw = align128(s.w + parts * NC * kpad(k) * 4);
    s.gs = align128(s.xw + parts * XWIN * 4);
    s.total = align128(s.gs + parts * PR * NC * 4);
    return s;
}

__device__ __forceinline__ float tf32_rna(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return __uint_as_float(r);
}

// D (64 x 64, f32, registers) += A (64 x 8 tf32, registers: this warp's m16n8k8 A
// fragment) * B (8 x 64 tf32, shared memory, descriptor).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// An m16n8k8 tf32 A fragment whose element (row r, column c) is w[r * rs + c * cs]:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); `w` points at (g, t).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* w, int rs, int cs) {
    a[0] = __float_as_uint(w[0]);
    a[1] = __float_as_uint(w[8 * rs]);
    a[2] = __float_as_uint(w[4 * cs]);
    a[3] = __float_as_uint(w[8 * rs + 4 * cs]);
}

// Grid: n_ct * ctas_per_ct CTAs of THREADS threads. CTA (ct, r) owns channels
// ct*64 .. ct*64+63 and walks the items r, r + ctas_per_ct, ... of (batch row,
// 128-pooled-row tile); it writes its dF^T partial (KM x 64) once at the end.
template <int PASSES>
__global__ void __launch_bounds__(THREADS, 1)
sinc_bwd_kernel(const float* __restrict__ x, const float* __restrict__ wl,
                const float* __restrict__ g, float* __restrict__ partial,
                int T, int C, int K, int t3, int n_tiles, int items, int ctas_per_ct) {
    constexpr int PARTS = PASSES == 1 ? 1 : 2;
    constexpr int KB = PASSES == 1 ? 2 : 1;     // 8-deep k-steps a wgmma group
    extern __shared__ __align__(128) unsigned char smem[];
    const int kp = kpad(K);
    const Smem L = smem_layout(K, PASSES);
    const uint32_t sbase = smem_u32(smem), bar = sbase;
    const uint32_t wsm = sbase + L.w, gsm = sbase + L.gs;
    const int w_part = NC * kp * 4;             // bytes of one filter part
    float* xs = reinterpret_cast<float*>(smem + L.xw);
    float* gs = reinterpret_cast<float*>(smem + L.gs);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2, wi = warp & 3, gq = lane >> 2, tq = lane & 3;
    const int ct = blockIdx.x / ctas_per_ct, r = blockIdx.x - ct * ctas_per_ct;

    if (tid == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {                             // this channel tile's filters, once
        mbar_expect_tx(bar, PARTS * w_part);
        for (int p = 0; p < PARTS; ++p)
            bulk_g2s(wsm + p * w_part, wl + (size_t(ct) * PARTS + p) * (NC * kp), w_part,
                     bar);
    }

    float xv[XPT];
    auto fetch = [&](int item) {                // the item's x window, zero past T
        const int b = item / n_tiles, t0 = (item - b * n_tiles) * CR;
        const float* xb = x + size_t(b) * T;
#pragma unroll
        for (int q = 0; q < XPT; ++q) {
            const int i = tid + q * THREADS;
            xv[q] = i < XWIN && t0 + i < T ? xb[t0 + i] : 0.f;
        }
    };

    float dw[2][32];                            // dF^T M-blocks wg and wg + 2
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 32; ++e) dw[q][e] = 0.f;

    if (r < items) fetch(r);
    mbar_wait(bar, 0);

    const int n_mine = r < items ? (items - r + ctas_per_ct - 1) / ctas_per_ct : 0;
    const int slots = (((items + ctas_per_ct - 1) / ctas_per_ct) + FLUSH - 1) / FLUSH;
    int item = r;
    for (int slot = 0; slot * FLUSH < n_mine; ++slot) {
        for (int n = 0; n < FLUSH && item < items; ++n, item += ctas_per_ct) {
            const int b = item / n_tiles, tile = item - b * n_tiles;
            __syncthreads();                        // the last tile's readers of xs are done
#pragma unroll
            for (int q = 0; q < XPT; ++q) {
                const int i = tid + q * THREADS;
                if (i < XWIN) {
                    const float big = tf32_rna(xv[q]);
                    xs[i] = big;
                    if (PASSES == 3) xs[XWIN + i] = tf32_rna(xv[q] - big);
                }
            }
            __syncthreads();
            if (item + ctas_per_ct < items) fetch(item + ctas_per_ct);

            // ---- recompute: acc[j] = conv rows 3i + j of this warpgroup's 64 pooled rows
            float acc[3][32];
#pragma unroll
            for (int j = 0; j < 3; ++j)
#pragma unroll
                for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
            const int arow = wg * 64 + wi * 16 + gq;          // pooled row of a0
            const float* xa = xs + 3 * arow + tq;
            for (int kc = 0; kc < kp; kc += 8 * KB) {
                uint32_t a[KB][3][4], as[PASSES == 3 ? KB : 1][3][4];
#pragma unroll
                for (int kb = 0; kb < KB; ++kb)
#pragma unroll
                    for (int j = 0; j < 3; ++j) {
                        load_a(a[kb][j], xa + j + kc + 8 * kb, 3, 1);
                        if (PASSES == 3) load_a(as[kb][j], xa + XWIN + j + kc + 8 * kb, 3, 1);
                    }
                wgmma_fence();
#pragma unroll
                for (int kb = 0; kb < KB; ++kb) {
                    const uint32_t off = (kc + 8 * kb) * 32;  // two core matrices a k-step
                    const uint64_t db = b_desc(wsm + off, kp * 32);
#pragma unroll
                    for (int j = 0; j < 3; ++j) {
                        wgmma_tf32(acc[j], a[kb][j], db);
                        if (PASSES == 3) {
                            wgmma_tf32(acc[j], a[kb][j], b_desc(wsm + w_part + off, kp * 32));
                            wgmma_tf32(acc[j], as[kb][j], db);
                        }
                    }
                }
                wgmma_commit();
                wgmma_wait_all();
            }

            // ---- routing, in place: acc[j] becomes G_j
            const float* gb = g + size_t(b) * t3 * C + ct * NC;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int p = tile * PR + arow + 8 * hf;
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                    const int c = 8 * jj + 2 * tq;
                    float2 gv = make_float2(0.f, 0.f);
                    if (p < t3 && ct * NC + c < C)
                        gv = *reinterpret_cast<const float2*>(gb + size_t(p) * C + c);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int idx = 4 * jj + 2 * hf + e;
                        const float z0 = acc[0][idx], z1 = acc[1][idx], z2 = acc[2][idx];
                        const float m0 = fabsf(z0), m1 = fabsf(z1), m2 = fabsf(z2);
                        const float m = fmaxf(fmaxf(m0, m1), m2);
                        const float n = float(m0 == m) + float(m1 == m) + float(m2 == m);
                        const float s = __fdiv_rn(e ? gv.y : gv.x, n);
                        auto route = [&](float z, float mz) {
                            return mz == m ? (z >= 0.f ? s : -s) : 0.f;
                        };
                        acc[0][idx] = route(z0, m0);
                        acc[1][idx] = route(z1, m1);
                        acc[2][idx] = route(z2, m2);
                    }
                }
            }

            // ---- weight gradient: dF^T += A'_j * G_j, one j at a time through shared memory
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                __syncthreads();                    // the last G_j's wgmmas have completed
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int i = arow + 8 * hf, c = 8 * jj + 2 * tq + e;
                            const int at = ((c >> 3) * (PR / 4) + (i >> 2)) * 32 + (c & 7) * 4 + (i & 3);
                            const float v = acc[j][4 * jj + 2 * hf + e];
                            const float big = tf32_rna(v);
                            gs[at] = big;
                            if (PASSES == 3) gs[PR * NC + at] = tf32_rna(v - big);
                        }
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                __syncthreads();
                constexpr int IB = PASSES == 1 ? 2 : 1;         // 8-row i-steps a group
                for (int ic = 0; ic < PR; ic += 8 * IB) {
                    uint32_t a[2][IB][4], as[2][PASSES == 3 ? IB : 1][4];
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        // A'_j[k][i] = x[3i + j + k]: row k = mb*64 + 16*wi + g, column i
                        const float* xp = xs + j + (wg + 2 * q) * 64 + wi * 16 + gq + 3 * (ic + tq);
#pragma unroll
                        for (int ib = 0; ib < IB; ++ib) {
                            load_a(a[q][ib], xp + 24 * ib, 1, 3);
                            if (PASSES == 3) load_a(as[q][ib], xp + XWIN + 24 * ib, 1, 3);
                        }
                    }
                    wgmma_fence();
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
#pragma unroll
                        for (int ib = 0; ib < IB; ++ib) {
                            const uint32_t off = (ic + 8 * ib) * 32;
                            const uint64_t db = b_desc(gsm + off, G_SBO);
                            wgmma_tf32(dw[q], a[q][ib], db);
                            if (PASSES == 3) {
                                wgmma_tf32(dw[q], a[q][ib], b_desc(gsm + PR * NC * 4 + off, G_SBO));
                                wgmma_tf32(dw[q], as[q][ib], db);
                            }
                        }
                    }
                    wgmma_commit();
                    wgmma_wait_all();
                }
            }
        }

        // ---- this slot's partial: dF^T rows k (taps) x 64 channels, float2 a thread;
        // ---- the accumulators start again from zero
        float* pp = partial + ((size_t(ct) * slots + slot) * ctas_per_ct + r) * KM * NC;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int mb = wg + 2 * q;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int k = mb * 64 + wi * 16 + gq + 8 * hf, c = 8 * jj + 2 * tq;
                    *reinterpret_cast<float2*>(pp + size_t(k) * NC + c) =
                        make_float2(dw[q][4 * jj + 2 * hf], dw[q][4 * jj + 2 * hf + 1]);
                }
#pragma unroll
            for (int e = 0; e < 32; ++e) dw[q][e] = 0.f;
        }
    }
}

// df[c, k] = the sum, slot by slot and CTA by CTA in order, of partial[ct, slot, r, k,
// c % 64] over the slots CTA r wrote.
__global__ void reduce_dw_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                 int C, int K, int ctas_per_ct, int items) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;   // (ct, k, c % 64), c fastest
    const int n_ct = (C + NC - 1) / NC;
    if (idx >= n_ct * K * NC) return;
    const int cl = idx % NC, k = (idx / NC) % K, ct = idx / (NC * K);
    const int c = ct * NC + cl;
    if (c >= C) return;
    const int slots = (((items + ctas_per_ct - 1) / ctas_per_ct) + FLUSH - 1) / FLUSH;
    const float* p = partial + (size_t(ct) * slots * ctas_per_ct * KM + k) * NC + cl;
    float s = 0.f;
    for (int slot = 0; slot < slots; ++slot)
        for (int r = 0; r < ctas_per_ct; ++r) {
            const int n_mine = r < items ? (items - r + ctas_per_ct - 1) / ctas_per_ct : 0;
            if (slot * FLUSH < n_mine)
                s += p[(size_t(slot) * ctas_per_ct + r) * KM * NC];
        }
    dw[size_t(c) * K + k] = s;
}

template <int PASSES>
cudaError_t set_smem(int bytes) {
    return cudaFuncSetAttribute(sinc_bwd_kernel<PASSES>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool shape_ok(int bsz, int T, int C, int K, int passes) {
    return bsz > 0 && K > 0 && K <= MAX_K && C > 0 && C % 16 == 0 && C <= MAX_C &&
           T - K + 1 >= 3 && (passes == 1 || passes == 3);
}

// info: CTAs per channel tile, shared memory a CTA, threads, CTAs an SM, pooled rows a
// tile, taps of a partial (KM), partial slots a CTA (one per FLUSH tiles it walks).
cudaError_t config(int bsz, int T, int C, int K, int passes, int device, int* info) {
    const Smem L = smem_layout(K, passes);
    if (L.total > SMEM_LIMIT) return cudaErrorInvalidValue;
    cudaError_t err = passes == 1 ? set_smem<1>(L.total) : set_smem<3>(L.total);
    if (err != cudaSuccess) return err;
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = passes == 1
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinc_bwd_kernel<1>, THREADS, L.total)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinc_bwd_kernel<3>, THREADS, L.total);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int n_ct = (C + NC - 1) / NC;
    const int t3 = (T - K + 1) / 3;
    const long long items = (long long)bsz * ((t3 + PR - 1) / PR);
    long long per_ct = (long long)n_sm * per_sm / n_ct;
    if (per_ct > items) per_ct = items;
    if (per_ct < 1) per_ct = 1;
    info[0] = int(per_ct);
    info[1] = L.total;
    info[2] = THREADS;
    info[3] = per_sm;
    info[4] = PR;
    info[5] = KM;
    info[6] = int(((items + per_ct - 1) / per_ct + FLUSH - 1) / FLUSH);
    return cudaSuccess;
}

}  // namespace

// Fills info[0..6] (see config) for a call at these shapes on `device`; returns a
// CUDA error code (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int sinc_abs_pool_bwd_config(int bsz, int T, int C, int K, int passes,
                                        int device, int* info) {
    if (!shape_ok(bsz, T, C, K, passes)) return int(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    return int(config(bsz, T, C, K, passes, device, info));
}

// Launches the backward and its partial sum on `stream`; returns cudaGetLastError().
// x (B, T) f32; wl the filters in ops/sinc_fused.py:kernel_filter_layout's TF32 layout,
// per 64-channel tile PASSES == 1 ? [big] : [big, small]; g (B, (T-K+1)//3, C) f32;
// partial (ceil(C/64), slots, ctas_per_ct, KM, 64) f32 scratch; df (C, K) f32. C a multiple
// of 16, at most 256; K at most 256; ctas_per_ct as sinc_abs_pool_bwd_config gives it.
extern "C" int sinc_abs_pool_bwd_launch(const void* x, const void* wl, const void* g,
                                        void* partial, void* df, int bsz, int T, int C,
                                        int K, int passes, int ctas_per_ct, int device,
                                        void* stream) {
    if (!shape_ok(bsz, T, C, K, passes) || ctas_per_ct < 1)
        return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const Smem L = smem_layout(K, passes);
    if (L.total > SMEM_LIMIT) return int(cudaErrorInvalidValue);
    err = passes == 1 ? set_smem<1>(L.total) : set_smem<3>(L.total);
    if (err != cudaSuccess) return int(err);
    const int n_ct = (C + NC - 1) / NC, t3 = (T - K + 1) / 3;
    const int n_tiles = (t3 + PR - 1) / PR;
    const long long items = (long long)bsz * n_tiles;
    if (items > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(n_ct * ctas_per_ct);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(wl);
    const float* gf = static_cast<const float*>(g);
    float* pf = static_cast<float*>(partial);
    if (passes == 1)
        sinc_bwd_kernel<1><<<grid, THREADS, L.total, s>>>(xf, wf, gf, pf, T, C, K, t3,
                                                          n_tiles, int(items), ctas_per_ct);
    else
        sinc_bwd_kernel<3><<<grid, THREADS, L.total, s>>>(xf, wf, gf, pf, T, C, K, t3,
                                                          n_tiles, int(items), ctas_per_ct);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    const int n = n_ct * K * NC;
    reduce_dw_kernel<<<(n + 255) / 256, 256, 0, s>>>(pf, static_cast<float*>(df), C, K,
                                                     ctas_per_ct, int(items));
    return int(cudaGetLastError());
}
