// K2: the backward of relu(BatchNorm_train(x)), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of adfmsl/ops/pallas/bn_relu_bwd.py:bn_relu_train (:100):
// _reduce_kernel (:39-63) and _dx_kernel (:66-88), launched by _bwd (:115-159). Over
// the flattened (N, C) input, N = B*T, with the forward's per-channel mu and rstd:
//   x^ = (x - mu) * rstd,  y = gamma * x^ + beta,  dy = dz * [y > 0]
//   pass 1: dgamma = sum(dy * x^), dbeta = sum(dy) over the N rows (f32)
//   pass 2: dx = (gamma * rstd / N) * (N * dy - dbeta - x^ * dgamma), in x's dtype
// Rounding points, held as in the Pallas kernels and in the plain version
// (ops/bn_relu_bwd.py:bn_relu_bwd_plain): x and dz (already cast to x's dtype by the
// caller) are read and widened to f32, x^ and the ReLU mask are recomputed in f32 from
// the saved x, sums accumulate in f32, dx is rounded once to x's dtype. x^, y and dx
// use round-to-nearest intrinsics so that no multiply-add is contracted: the mask
// y > 0 is then decided exactly as the plain version decides it.
//
// Bound on an H100 SXM (3.35 TB/s): the function must read x and dz once and write dx
// once, 6 bytes an element in bf16 (12 in f32). The elementwise f32 work (about 20
// operations an element) is far below the card's f32 rate, so bytes bound it.
// chip_smoke.py computes the bound from each case's shapes.
//
// Design: one cooperative launch, every CTA resident at once (the grid is at most the
// occupancy calculator's CTAs an SM times the SMs, and at most one CTA a stage).
// - The rows are cut into stages of ROWS rows, 32 KB of x and dz together; each CTA
//   owns a contiguous range of stages, the counts differing by at most one between
//   CTAs (ops/bn_relu_bwd.py:kernel_config mirrors this layout).
// - A producer warp (lane 0) bulk-copies each stage's x rows and the same dz rows
//   (cp.async.bulk, a ragged last stage only its rows) into a ring of STAGES slots
//   with full and empty mbarriers; the 16 consumer warps never issue a global load
//   of x or dz, so the copies in flight, not occupancy, keep HBM busy. The producer
//   is a warp of its own because no register budget forces it into a consumer warp
//   (unlike K1), and then no consumer waits on a refill.
// - Each consumer thread owns 16 bytes of a row (8 bf16 or 4 f32 channels) at a
//   fixed place, so gamma, beta, mu, rstd and later the dx constants stay in
//   registers; it reads two rows of every stage, 16 bytes at a time from shared
//   memory, a warp's 32 loads on 512 contiguous bytes.
// - Pass 1 sums in registers, reduces across the CTA's row groups in a fixed order
//   through shared memory, and writes the CTA's (2, C) partial. After the grid
//   barrier every CTA sums all the partials in CTA order, so dgamma and dbeta are
//   the same in every CTA and bitwise the same from run to run; CTA 0 writes them.
// - Pass 2 walks the CTA's stages in reverse: the last STAGES stages of pass 1 are
//   still in the ring and are used without a copy, and the stages before them were
//   read last, so they are the likeliest to still be in L2. dx leaves in 16-byte
//   streaming stores (st.global.cs) that do not push those lines out. An L2
//   evict_last policy on the copies of those stages measured no faster, so the
//   copies carry no cache hint.
// A slot's uses alternate with its fills, so the phase of every wait follows from
// the stage index alone (fill_index below).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int CONSUMERS = 512;             // 16 consumer warps
constexpr int THREADS = CONSUMERS + 32;    // and the producer warp
constexpr int STAGE_BYTES = 32768;         // a stage's x rows, then its dz rows
constexpr int SMEM_LIMIT = 232448;         // shared memory a CTA may use on sm_90
constexpr int MAX_DEVICES = 64;

template <typename T, int C>
struct Cfg {
    static constexpr int V = 16 / int(sizeof(T));            // channels a thread owns
    static constexpr int VECS = C / V;                       // threads across a row
    static constexpr int GROUPS = CONSUMERS / VECS;          // rows read side by side
    static constexpr int ROW_BYTES = C * int(sizeof(T));
    static constexpr int ROWS = STAGE_BYTES / (2 * ROW_BYTES);
    static constexpr int RED_BYTES = 2 * CONSUMERS * V * 4;  // [2][GROUPS][C] f32
    static constexpr int STAGES = (SMEM_LIMIT - RED_BYTES) / (STAGE_BYTES + 16);
    static constexpr int SMEM = STAGES * STAGE_BYTES + RED_BYTES + 16 * STAGES;
    static_assert(ROWS == 2 * GROUPS, "a consumer thread reads two rows a stage");
    static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "the ring must fit");
};

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
    const bf16* h = reinterpret_cast<const bf16*>(&q);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint4 q;
    bf16* h = reinterpret_cast<bf16*>(&q);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
    return q;
}

// Stages i < x with i % S == s.
__device__ __forceinline__ int count_below(int x, int s, int S) {
    return x > s ? (x - s - 1) / S + 1 : 0;
}

// The fill of slot i % S that brings local stage i in pass 2 (i < k - S), counted
// from 0 over both passes: the slot's pass-1 fills, then the pass-2 fills of the
// stages above i (pass 2 walks down).
__device__ __forceinline__ int fill_index(int i, int k, int S) {
    const int s = i % S;
    return count_below(k, s, S) + count_below(k - S, s, S) - count_below(i + 1, s, S);
}

// x, dz, dx: (n_rows, C) in T; gamma, beta, mean, rstd: (C,) f32; partials:
// (gridDim.x, 2, C) f32 scratch; sums: (2, C) f32, dgamma then dbeta.
template <typename T, int C>
__global__ void __launch_bounds__(THREADS, 1)
bn_relu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   float* __restrict__ partials, float* __restrict__ sums,
                   T* __restrict__ dx, long long n_rows, float nf, float inv_n) {
    using K = Cfg<T, C>;
    constexpr int S = K::STAGES, V = K::V, HALF = STAGE_BYTES / 2;
    extern __shared__ __align__(128) unsigned char smem[];
    float* red = reinterpret_cast<float*>(smem + S * STAGE_BYTES);
    const uint32_t ring = smem_u32(smem);
    const uint32_t full0 = smem_u32(smem + S * STAGE_BYTES + K::RED_BYTES);
    const uint32_t empty0 = full0 + 8 * S;
    const int tid = threadIdx.x, lane = tid & 31;

    // this CTA's stages [first, first + k); stages below k - S leave the ring
    const long long n_st = (n_rows + K::ROWS - 1) / K::ROWS;
    const long long per = n_st / gridDim.x, extra = n_st % gridDim.x;
    const long long first = blockIdx.x * per + (blockIdx.x < extra ? blockIdx.x : extra);
    const int k = int(per + (blockIdx.x < extra ? 1 : 0));
    auto stage_rows = [&](int i) {
        const long long left = n_rows - (first + i) * K::ROWS;
        return left < K::ROWS ? int(left) : K::ROWS;
    };

    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(full0 + 8 * s, 1);                    // the producer's expect_tx
            mbar_init(empty0 + 8 * s, CONSUMERS / 32);      // one arrive a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    cg::grid_group grid = cg::this_grid();

    if (tid >= CONSUMERS) {
        // ---- the producer warp: stage i into slot i % S once the slot's last use
        // ---- is released; pass 1 upward, then pass 2's refills downward
        auto issue = [&](int i) {
            const int slot = i % S;
            const uint32_t bytes = uint32_t(stage_rows(i)) * K::ROW_BYTES;
            const size_t off = size_t(first + i) * K::ROWS * C;
            mbar_expect_tx(full0 + 8 * slot, 2 * bytes);
            bulk_g2s(ring + slot * STAGE_BYTES, x + off, bytes, full0 + 8 * slot);
            bulk_g2s(ring + slot * STAGE_BYTES + HALF, dz + off, bytes, full0 + 8 * slot);
        };
        if (lane == 0)
            for (int i = 0; i < k; ++i) {
                if (i >= S) mbar_wait(empty0 + 8 * (i % S), (i / S - 1) & 1);
                issue(i);
            }
        __syncwarp();
        grid.sync();
        if (lane == 0)
            for (int i = k - S - 1; i >= 0; --i) {
                mbar_wait(empty0 + 8 * (i % S), (fill_index(i, k, S) - 1) & 1);
                issue(i);
            }
        return;
    }

    // ---- the consumers: 16 bytes of rows g and g + GROUPS of every stage
    const int g = tid / K::VECS, c0 = (tid % K::VECS) * V;
    const uint32_t my = (g * C + c0) * int(sizeof(T));
    float ga[V], be[V], mu[V], rs[V], sg[V], sb[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        ga[j] = gamma[c0 + j];
        be[j] = beta[c0 + j];
        mu[j] = mean[c0 + j];
        rs[j] = rstd[c0 + j];
        sg[j] = 0.f;
        sb[j] = 0.f;
    }

    for (int i = 0; i < k; ++i) {
        const int slot = i % S, rows = stage_rows(i);
        mbar_wait(full0 + 8 * slot, (i / S) & 1);
        const uint32_t base = ring + slot * STAGE_BYTES + my;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (g + h * K::GROUPS >= rows) break;
            const uint32_t a = base + h * K::GROUPS * K::ROW_BYTES;
            float xv[V], dv[V];
            unpack(ld_shared16(a), xv);
            unpack(ld_shared16(a + HALF), dv);
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float xh = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
                const float y = __fadd_rn(__fmul_rn(ga[j], xh), be[j]);
                const float dy = y > 0.f ? dv[j] : 0.f;
                sg[j] += dy * xh;
                sb[j] += dy;
            }
        }
        if (i < k - S) {                 // stage i + S refills this slot in pass 1
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * slot);
        }
    }

    // ---- the CTA's partial: row groups summed in order
#pragma unroll
    for (int j = 0; j < V; ++j) {
        red[g * C + c0 + j] = sg[j];
        red[CONSUMERS * V + g * C + c0 + j] = sb[j];
    }
    bar_sync_count(1, CONSUMERS);
    float* part = partials + size_t(blockIdx.x) * 2 * C;
    for (int t = tid; t < 2 * C; t += CONSUMERS) {
        const float* r = red + (t / C) * CONSUMERS * V + t % C;
        float acc = 0.f;
        for (int q = 0; q < K::GROUPS; ++q) acc += r[q * C];
        part[t] = acc;
    }
    grid.sync();

    // ---- dgamma, dbeta: every CTA's partial in CTA order, the same sum everywhere;
    // ---- the loads go out BATCH at a time, so the sum waits on L2 a few times only
    constexpr int BATCH = 32;
    for (int t = tid; t < 2 * C; t += CONSUMERS) {
        float acc = 0.f;
        for (int b0 = 0; b0 < int(gridDim.x); b0 += BATCH) {
            const int nb = min(BATCH, int(gridDim.x) - b0);
            float v[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                v[u] = u < nb ? __ldcg(partials + size_t(b0 + u) * 2 * C + t) : 0.f;
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
                if (u < nb) acc += v[u];
        }
        red[t] = acc;
        if (blockIdx.x == 0) sums[t] = acc;
    }
    bar_sync_count(1, CONSUMERS);
    float dg[V], db[V], sc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
        dg[j] = red[c0 + j];
        db[j] = red[C + c0 + j];
        sc[j] = __fmul_rn(__fmul_rn(ga[j], rs[j]), inv_n);
    }

    // ---- pass 2, the stages in reverse: the last S are still in the ring
    for (int i = k - 1; i >= 0; --i) {
        const int slot = i % S, rows = stage_rows(i);
        if (i < k - S) mbar_wait(full0 + 8 * slot, fill_index(i, k, S) & 1);
        const uint32_t base = ring + slot * STAGE_BYTES + my;
        T* out = dx + (size_t(first + i) * K::ROWS + g) * C + c0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (g + h * K::GROUPS >= rows) break;
            const uint32_t a = base + h * K::GROUPS * K::ROW_BYTES;
            float xv[V], dv[V], o[V];
            unpack(ld_shared16(a), xv);
            unpack(ld_shared16(a + HALF), dv);
#pragma unroll
            for (int j = 0; j < V; ++j) {
                const float xh = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
                const float y = __fadd_rn(__fmul_rn(ga[j], xh), be[j]);
                const float dy = y > 0.f ? dv[j] : 0.f;
                const float t = __fsub_rn(__fsub_rn(__fmul_rn(nf, dy), db[j]),
                                          __fmul_rn(xh, dg[j]));
                o[j] = __fmul_rn(sc[j], t);
            }
            st_global_cs16(out + size_t(h) * K::GROUPS * C, pack(o));
        }
        if (i >= S) {                    // stage i - S refills this slot in pass 2
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * slot);
        }
    }
}

bool bad_shape(long long n_rows, int C, int dtype) {
    return n_rows <= 0 || (C != 128 && C != 256) || (dtype != 0 && dtype != 1);
}

template <typename T, int C>
cudaError_t prepare(int* ctas_per_sm) {
    const void* k = reinterpret_cast<const void*>(bn_relu_bwd_kernel<T, C>);
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Cfg<T, C>::SMEM);
    if (err == cudaSuccess && ctas_per_sm)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, k, THREADS,
                                                            Cfg<T, C>::SMEM);
    return err;
}

template <typename T, int C>
cudaError_t query(int device, int* info) {
    using K = Cfg<T, C>;
    info[0] = K::ROWS;
    info[1] = K::STAGES;
    info[2] = K::SMEM;
    info[3] = THREADS;
    cudaError_t err = prepare<T, C>(&info[4]);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&info[5], cudaDevAttrMultiProcessorCount, device);
    return err;
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* dz, const void* const* stats, void* partials,
                   void* sums, void* dx, long long n_rows, int ctas, int device,
                   cudaStream_t s) {
    // the shared-memory attribute is set once per device (a launch is host-bound at
    // small N, so the attribute call is not repeated)
    static bool ready[MAX_DEVICES] = {};
    if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!ready[device]) {
        cudaError_t err = prepare<T, C>(nullptr);
        if (err != cudaSuccess) return err;
        ready[device] = true;
    }
    const T* xp = static_cast<const T*>(x);
    const T* dzp = static_cast<const T*>(dz);
    const float* g = static_cast<const float*>(stats[0]);
    const float* b = static_cast<const float*>(stats[1]);
    const float* m = static_cast<const float*>(stats[2]);
    const float* r = static_cast<const float*>(stats[3]);
    float* part = static_cast<float*>(partials);
    float* out = static_cast<float*>(sums);
    T* dxp = static_cast<T*>(dx);
    float nf = float(n_rows);
    float inv_n = float(1.0 / double(n_rows));
    void* args[] = {&xp, &dzp, &g, &b, &m, &r, &part, &out, &dxp, &n_rows, &nf, &inv_n};
    cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(bn_relu_bwd_kernel<T, C>), dim3(ctas), dim3(THREADS),
        args, Cfg<T, C>::SMEM, s);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The layout of C (128 or 256) and dtype (0 f32, 1 bf16) on `device`: info[0] rows a
// stage, [1] ring stages, [2] shared memory a CTA, [3] threads a CTA, [4] CTAs an SM
// (the occupancy calculator), [5] SMs. Returns a CUDA error code.
extern "C" int bn_relu_bwd_query(int C, int dtype, int device, int* info) {
    if (bad_shape(1, C, dtype)) return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    if (dtype == 0) err = C == 128 ? query<float, 128>(device, info) : query<float, 256>(device, info);
    else err = C == 128 ? query<bf16, 128>(device, info) : query<bf16, 256>(device, info);
    return int(err);
}

// One cooperative launch of `ctas` CTAs on `stream` (ops/bn_relu_bwd.py:kernel_config
// gives the count: at most the CTAs that fit at once and at most one a stage); returns
// a CUDA error code. x, dz, dx: (n_rows, C) contiguous, f32 (dtype 0) or bf16 (dtype
// 1), 16-byte aligned; gamma, beta, mean, rstd (C,) f32; partials (ctas, 2, C) f32
// scratch; sums (2, C) f32 receives dgamma and dbeta. device = the CUDA device index.
extern "C" int bn_relu_bwd_launch(const void* x, const void* dz, const void* gamma,
                                  const void* beta, const void* mean, const void* rstd,
                                  void* partials, void* sums, void* dx, long long n_rows,
                                  int C, int dtype, int ctas, int device, void* stream) {
    if (bad_shape(n_rows, C, dtype) || ctas <= 0) return int(cudaErrorInvalidValue);
    const int rows = (dtype == 0 ? Cfg<float, 128>::ROWS : Cfg<bf16, 128>::ROWS) * 128 / C;
    if (ctas > (n_rows + rows - 1) / rows) return int(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const void* stats[4] = {gamma, beta, mean, rstd};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        err = C == 128
                  ? launch<float, 128>(x, dz, stats, partials, sums, dx, n_rows, ctas, device, s)
                  : launch<float, 256>(x, dz, stats, partials, sums, dx, n_rows, ctas, device, s);
    else
        err = C == 128
                  ? launch<bf16, 128>(x, dz, stats, partials, sums, dx, n_rows, ctas, device, s)
                  : launch<bf16, 256>(x, dz, stats, partials, sums, dx, n_rows, ctas, device, s);
    return int(err);
}
