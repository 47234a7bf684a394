// K6: WavLM's gated relative-position self-attention at eval, from q, k, v to the
// weighted sum, hand-written for Hopper (sm_90a). No (B, H, T, T) tensor is written.
//
// Replaces no TPU kernel: adfmsl has no WavLM, and computes attention outside any Pallas
// kernel. It is the port's own, for the composition in models/w2v2.py
// (SelfAttention.forward, WavLM's branch), which wrote the (B, H, T, T) scores to memory
// and passed over them five times a layer (the bf16 scores, their f32 copy, the gated
// bias added by addcmul, the f32 softmax, the weights' bf16 copy). Function, per batch
// row b, head h, query frame i < T and head-dim column c < 64, with q' = bf16(q / sqrt(64))
// (the composition's division, here as q's fragments are loaded):
//   s[j]   = float(bf16(sum_c q'[b,i,h,c] * k[b,j,h,c]))     f32 accumulation, rounded
//   x[j]   = fma(g[b,h,i], r[h, T-1 + j-i], s[j])            f32; r the per-distance row
//   m, l   = max_j x[j], sum_j exp(x[j] - m)                 f32, online over key tiles
//   o[c]   = bf16(sum_j bf16(exp(x[j] - m)) * v[b,j,h,c] / l)
// The composition's rounding points are kept (q.k rounded to bf16; the bias, the gate,
// their sum and the softmax in f32; the weights rounded to bf16 for the weighted sum);
// the weights are rounded before the division by l instead of after it, and the sums
// run in another order. ops/wavlm_attention.py:wavlm_attention_plain is the composition
// at this interface.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the products q.k and w.v,
// 4*B*H*T^2*64 a layer, at the bf16 peak (benchmark/benchlib/attention_roofline.py): at
// B 16, H 16, T 1,499 that is 147 GFLOP, 0.149 ms; q, k, v and o in bf16 are 196 MB,
// 0.059 ms. Besides the products each score costs CUDA-core work the tensor cores do not
// do: its bf16 rounding, the bias's load and fma, the row max, exp and sum, and the bf16
// rounding of its weight, about nine instructions and one MUFU exp2 a score. At a head
// dim of 64 that work is as large as the products' (an SM retires 16 exp2 a clock and
// the products of 16 scores a clock), and a warpgroup's tile runs products, then that
// work, then products again: the design keeps the work short and runs three warpgroups
// an SM, so one's products overlap the others' softmax. On an H100 80GB HBM3 at 700 W
// it takes 0.46-0.48 ms a layer at the cell's shape (about 31 % of the bound): two
// warpgroups and a producer warp took 0.58; issuing each tile's q.k^T with the last
// tile's P.V in one warpgroup (two S accumulators' worth of registers) 0.62; three
// warpgroups capped at 128 registers a thread, without setmaxnreg, spilled and took
// 0.54; the row max and sum as single dependent chains added 7 %.
//
// The design:
// 1. A persistent grid, one CTA an SM; a CTA's item is 192 query rows of one (b, h),
//    items in (b, h)-major order so the CTAs at work share K and V in L2. Three consumer
//    warpgroups take 64 rows each; one thread of a producer warpgroup keeps K and V
//    tiles of 128 keys in flight through a ring of STAGES stages (TMA 4-d tiles with the
//    128-byte swizzle, read from the projections' (B, T, H*64) outputs by their strides;
//    an mbarrier pair a stage). Keys past T arrive as zeros (TMA's out-of-bounds fill).
//    The producer warpgroup gives up its registers (setmaxnreg) so that the consumers
//    hold 160 a thread.
// 2. S = q.k^T: wgmma m64n128k16 with q as the register A operand (loaded once an item
//    from global memory in the fragment layout and divided by 8 there, exactly as the
//    composition divides it) and the K tile as the K-major B operand.
// 3. The bias needs g[i] * r[T-1 + j-i]. Each warpgroup copies the window of r that its
//    64 rows reach in a key tile (BM + BN distances, zero outside the row) into shared
//    memory, as pairs (r[m], r[m+1]), so an accumulator pair's two biases are one 8-byte
//    load; a thread's row g + 8 needs the pair its row g needed 8 columns before, so a
//    tile's 64 scores take 17 loads. The windows are double-buffered: tile kt + 1's is
//    read from L2 while tile kt's q.k^T runs and stored after it, and a barrier of the
//    warpgroup at the end of each tile hands it over, so shared memory does not grow
//    with T and K6 takes any T.
// 4. Online softmax in f32 with exp2 (x * log2 e - m * log2 e as one fma), the tile's
//    row max and sum over four independent chains; the row sum stays per thread until
//    the item's end. Keys past T are set to -inf in the last key tile only (an ALU
//    branch; no wgmma sits in a branch: ptxas C7520).
// 5. P (bf16) goes straight from the S accumulators into the A fragments of
//    O += P.V (wgmma m64n64k16, V the MN-major B operand of the same swizzled tile).
// 6. o / l is rounded to bf16, staged through shared memory by stmatrix (in the
//    warpgroup's window, whose key tiles are done) and written in 16-byte chunks of the
//    (B, T, H*64) output rows that the out projection reads; query rows past T are not
//    stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;                    // head dim: q, k, v rows of 128 bytes
constexpr int BM = 64;                   // query rows of a consumer warpgroup
constexpr int NWG = 3;                   // consumer warpgroups of a CTA
constexpr int QROWS = BM * NWG;          // query rows of an item
constexpr int BN = 128;                  // keys of a tile
constexpr int STAGES = 3;                // K / V ring depth
constexpr int THREADS = 128 * (NWG + 1); // the consumers, then the producer warpgroup
// registers a thread after setmaxnreg: the producer's warpgroup hands its registers to
// the consumers (128 * 24 + 384 * 160 <= 65,536), which need about 150
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
constexpr int TILE_BYTES = BN * D * 2;   // one K or V tile
constexpr int PITCH = D * 2 + 16;        // bytes between rows of the output stage
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int key_tiles(int T) { return (T + BN - 1) / BN; }
// pairs of a warpgroup's bias window of one key tile: the distances of its 64 rows to the
// tile's 128 keys, and the pair's second entry (a thread reads pairs 0 .. BM + BN - 3)
constexpr int WIN = BN + BM;

struct Smem {
    // byte offsets from the 1024-aligned base: K and V stages, a region a consumer
    // warpgroup (its two bias windows during the key tiles, then its output stage),
    // barriers (full[STAGES], empty[STAGES])
    int k, v, w, wg_bytes, bar, total;
};

__host__ __device__ constexpr Smem smem_layout() {
    Smem s{};
    s.k = 0;
    s.v = STAGES * TILE_BYTES;
    s.w = 2 * STAGES * TILE_BYTES;
    s.wg_bytes = 2 * WIN * 8 > BM * PITCH ? 2 * WIN * 8 : BM * PITCH;
    s.bar = s.w + NWG * s.wg_bytes;
    s.total = s.bar + 2 * STAGES * 8 + 1024;    // + the base's alignment slack
    return s;
}
static_assert(smem_layout().total <= SMEM_LIMIT, "K6's shared memory exceeds a CTA's");

// This thread's pairs m = wt and wt + 128 (below WIN) of the window starting at r[a0],
// read now and stored by window_store; r is 0 outside [0, last].
__device__ __forceinline__ void window_load(const float* __restrict__ rh, int a0, int last,
                                            int wt, float (&w)[4]) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const int a = a0 + wt + 128 * p;
        const bool in = wt + 128 * p < WIN;
        w[2 * p] = in && a >= 0 && a <= last ? __ldg(rh + a) : 0.f;
        w[2 * p + 1] = in && a + 1 >= 0 && a + 1 <= last ? __ldg(rh + a + 1) : 0.f;
    }
}
__device__ __forceinline__ void window_store(float2* win, int wt, const float (&w)[4]) {
    win[wt] = make_float2(w[0], w[1]);
    if (wt + 128 < WIN) win[wt + 128] = make_float2(w[2], w[3]);
}

// Two f32 as bf16, rounded to nearest even, in one word (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Registers an asynchronous wgmma reads or writes: after the wait that completes it, this
// makes each one look written here, so the compiler neither moves their uses above the
// wait nor reuses them while the wgmma is in flight.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Four 8 x 8 b16 matrices in the mma accumulator layout to shared memory; lane l gives
// the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
                 :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// 4-d TMA tile (c0 fastest) into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
    asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%2, %3, %4, %5}], [%6];"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                    "r"(c2), "r"(c3), "r"(bar) : "memory");
}

// Descriptor of a tile of 128-byte rows in TMA's 128-byte swizzle (8-row groups of 1024
// bytes). K-major (the K tile as the B of q.k^T, k = head dim): a k-step of 16 starts
// 32 bytes on; MN-major (the V tile as the B of P.V, k = key): a k-step of 16 starts 16
// rows on, and LBO (the next 64 columns) is never reached at n 64.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
           (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// D (64 x 128, f32) = (acc ? D : 0) + A (64 x 16 bf16, registers) * B (16 x 128, K-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// D (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major).
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Grid: persistent CTAs of THREADS threads; CTA c takes the items c, c + gridDim.x, ...
// of (b * H + h) * n_qt + query tile. q and out are addressed by their (batch, row)
// strides in elements, head h at column h * 64; g is (B, H, T) f32, r (H, 2T - 1) f32.
__global__ void __launch_bounds__(THREADS, 1)
wavlm_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __nv_bfloat16* __restrict__ q, const float* __restrict__ g,
                       const float* __restrict__ r, __nv_bfloat16* __restrict__ out,
                       int H, int T, long long sqb, long long sqt, long long sob,
                       long long sot, int n_qt, int items) {
    extern __shared__ unsigned char smem_raw[];
    constexpr Smem L = smem_layout();
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* smem = smem_raw + (base - raw);
    const uint32_t full = base + L.bar, empty = full + STAGES * 8;
    const int tid = threadIdx.x, n_kt = key_tiles(T);

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, NWG * 4);      // one arrival a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= 128 * NWG) {                         // ---- the producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
        if (tid != 128 * NWG) return;
        asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&kmap))
                     : "memory");
        asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&vmap))
                     : "memory");
        int it = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            const int bh = item / n_qt, b = bh / H, h = bh - b * H;
            for (int kt = 0; kt < n_kt; ++kt, ++it) {
                const int s = it % STAGES, n = it / STAGES;
                if (n > 0) mbar_wait(empty + 8 * s, (n - 1) & 1);
                mbar_expect_tx(full + 8 * s, 2 * TILE_BYTES);
                tma_load_4d(base + L.k + s * TILE_BYTES, &kmap, 0, h, kt * BN, b, full + 8 * s);
                tma_load_4d(base + L.v + s * TILE_BYTES, &vmap, 0, h, kt * BN, b, full + 8 * s);
            }
        }
        return;
    }

    // ---- the consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int wg = tid >> 7, wt = tid & 127, wi = wt >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;
    // the windows of even and odd key tiles; the output stage reuses them once the
    // warpgroup's key tiles are done
    float2* win = reinterpret_cast<float2*>(smem + L.w + wg * L.wg_bytes);
    const uint32_t stage = base + L.w + wg * L.wg_bytes;
    const int last = 2 * T - 2;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int bh = item / n_qt, qt = item - bh * n_qt, b = bh / H, h = bh - b * H;
        const int i0 = qt * QROWS + wg * BM;        // this warpgroup's first query row
        bar_sync_count(1 + wg, 128);                // the last item's windows and stage are free
        // key tile kt's window: win[(kt & 1) * WIN + m] = (r[lo + kt BN + m], r[.. + 1]),
        // lo = T - 1 - (i0 + 63); r is 0 outside [0, 2T - 2]
        const float* rh = r + size_t(h) * (2 * T - 1);
        const int lo = T - 1 - (i0 + BM - 1);
        float nxt[4];
        window_load(rh, lo, last, wt, nxt);
        window_store(win, wt, nxt);
        // q's A fragments, divided by 8 (k-step kk: rows gq, gq + 8 of this warp's 16,
        // columns 16kk + 2tq (+1) and + 8) and the gates of the two rows; rows past T read 0
        const int row0 = i0 + wi * 16 + gq;
        uint32_t qa[4][4];
        float gate[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int i = row0 + 8 * hf;
            const bool in = i < T;
            const uint32_t* qr = reinterpret_cast<const uint32_t*>(
                q + b * sqb + (long long)(in ? i : 0) * sqt + h * D + 2 * tq);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t a = in ? qr[8 * kk] : 0u, c = in ? qr[8 * kk + 4] : 0u;
                qa[kk][hf] = pack_bf16(lo_f(a) * 0.125f, hi_f(a) * 0.125f);
                qa[kk][2 + hf] = pack_bf16(lo_f(c) * 0.125f, hi_f(c) * 0.125f);
            }
            gate[hf] = in ? g[(size_t(b) * H + h) * T + i] : 0.f;
        }
        bar_sync_count(1 + wg, 128);                // tile 0's window is whole

        float o[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) o[e] = 0.f;
        float mrow[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.f, 0.f};
        // this thread's pair index of (row gq, key column 2tq) at key tile 0
        const int mb = 2 * tq - wi * 16 - gq + BM - 1;
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(full + 8 * s, (it / STAGES) & 1);
            const uint32_t ks = base + L.k + s * TILE_BYTES, vs = base + L.v + s * TILE_BYTES;
            float sc[64];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs_n128(sc, qa[kk], sw128_desc(ks + kk * 32, 16), kk);
            wgmma_commit();
            const bool more = kt + 1 < n_kt;
            if (more) window_load(rh, lo + (kt + 1) * BN, last, wt, nxt);
            wgmma_wait_all();
            keep(sc);
            keep(qa);
            // tile kt - 1, which read the other window, ended at a barrier
            if (more) window_store(win + ((kt + 1) & 1) * WIN, wt, nxt);

            // ---- scores: element 4jj + 2hf + e is (row gq + 8hf, key kt*BN + 8jj + 2tq + e)
            const float2* wp = win + (kt & 1) * WIN + mb;
#pragma unroll
            for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const float2 rb = wp[8 * (jj - hf)];
                    const int e0 = 4 * jj + 2 * hf;
                    const uint32_t w = pack_bf16(sc[e0], sc[e0 + 1]);
                    sc[e0] = fmaf(gate[hf], rb.x, lo_f(w));
                    sc[e0 + 1] = fmaf(gate[hf], rb.y, hi_f(w));
                }
            }
            if (kt * BN + BN > T) {                 // keys past T: -inf
                const int lim = T - kt * BN - 2 * tq;
#pragma unroll
                for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (8 * jj + (e & 1) >= lim) sc[4 * jj + e] = -INFINITY;
            }
            // the row max over four independent chains a row
            float part[4][2];
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                    part[c][hf] = fmaxf(sc[4 * c + 2 * hf], sc[4 * c + 2 * hf + 1]);
#pragma unroll
            for (int jj = 4; jj < BN / 8; ++jj)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                    part[jj & 3][hf] = fmaxf(part[jj & 3][hf],
                                             fmaxf(sc[4 * jj + 2 * hf], sc[4 * jj + 2 * hf + 1]));
            float tmax[2], scale[2], ml[2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
                tmax[hf] = fmaxf(fmaxf(part[0][hf], part[1][hf]), fmaxf(part[2][hf], part[3][hf]));
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                tmax[hf] = fmaxf(tmax[hf], __shfl_xor_sync(0xffffffffu, tmax[hf], 1));
                tmax[hf] = fmaxf(tmax[hf], __shfl_xor_sync(0xffffffffu, tmax[hf], 2));
                const float mn = fmaxf(mrow[hf], tmax[hf]);
                scale[hf] = exp2_approx((mrow[hf] - mn) * LOG2E);
                mrow[hf] = mn;
                ml[hf] = mn * LOG2E;
                lsum[hf] *= scale[hf];
            }
            // ---- P = bf16(exp(x - m)) as the A fragments of P.V: k-step kk is keys
            // ---- 16kk .. 16kk + 15, i.e. the accumulator columns of jj = 2kk, 2kk + 1;
            // ---- the row sum over four independent chains a row
            uint32_t pa[BN / 16][4];
            float psum[4][2] = {};
#pragma unroll
            for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int e0 = 4 * jj + 2 * hf;
                    const float p0 = exp2_approx(fmaf(sc[e0], LOG2E, -ml[hf]));
                    const float p1 = exp2_approx(fmaf(sc[e0 + 1], LOG2E, -ml[hf]));
                    psum[jj & 3][hf] += p0 + p1;
                    pa[jj >> 1][2 * (jj & 1) + hf] = pack_bf16(p0, p1);
                }
            }
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
                lsum[hf] += (psum[0][hf] + psum[1][hf]) + (psum[2][hf] + psum[3][hf]);
#pragma unroll
            for (int e = 0; e < 32; ++e) o[e] *= scale[(e >> 1) & 1];
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk)
                wgmma_rs_n64_mn(o, pa[kk], sw128_desc(vs + kk * 16 * 128, TILE_BYTES));
            wgmma_commit();
            wgmma_wait_all();
            keep(o);
            keep(pa);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
            bar_sync_count(1 + wg, 128);            // this tile's window is read, the next stored
        }

        // ---- o / l in bf16 through the stage: element 4jd + 2hf + e is (row gq + 8hf,
        // ---- column 8jd + 2tq + e)
        float inv[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            float l = lsum[hf];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            inv[hf] = l;
        }
        const int mi = lane >> 3;
        const uint32_t srow = stage + (wi * 16 + (mi & 1) * 8 + (lane & 7)) * PITCH +
                              (mi >> 1) * 16;
#pragma unroll
        for (int jp = 0; jp < D / 16; ++jp) {
            uint32_t rr[4];
#pragma unroll
            for (int qd = 0; qd < 4; ++qd) {
                const int jd = 2 * jp + (qd >> 1), hf = qd & 1, e0 = 4 * jd + 2 * hf;
                rr[qd] = pack_bf16(__fdiv_rn(o[e0], inv[hf]), __fdiv_rn(o[e0 + 1], inv[hf]));
            }
            stmatrix_x4(srow + jp * 32, rr[0], rr[1], rr[2], rr[3]);
        }
        bar_sync_count(1 + wg, 128);                // the stage is whole
        const int rows = min(BM, T - i0);
#pragma unroll
        for (int c = wt; c < BM * (D / 8); c += 128) {
            const int row = c / (D / 8), ch = c % (D / 8);
            if (row < rows)
                *reinterpret_cast<uint4*>(out + b * sob + (long long)(i0 + row) * sot +
                                          h * D + ch * 8) =
                    ld_shared16(stage + row * PITCH + ch * 16);
        }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &res);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
        if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// (B, T, H, 64) bf16 at `ptr` with batch and row strides in elements, as 4-d tiles of
// (64, 1, BN, 1) in the 128-byte swizzle; 0 on success.
int encode_kv(CUtensorMap* map, const void* ptr, int B, int H, int T, long long sb,
              long long st) {
    EncodeTiled fn = encode_tiled();
    if (!fn) return 1;
    const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T), cuuint64_t(B)};
    const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(st) * 2, cuuint64_t(sb) * 2};
    const cuuint32_t box[4] = {D, 1, BN, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res != CUDA_SUCCESS;
}

}  // namespace

// Launches K6 on `stream`; returns cudaGetLastError() (or cudaErrorInvalidValue for
// shapes it does not take). q, k, v (B, T, H*64) bf16 by their batch and row strides in
// elements (multiples of 8; 16-byte aligned bases), g (B, H, T) f32, r (H, 2T - 1) f32,
// out (B, T, H*64) bf16 by its strides. device = the CUDA device index.
extern "C" int wavlm_attention_launch(const void* q, const void* k, const void* v,
                                      const void* g, const void* r, void* out, int B, int H,
                                      int T, long long sqb, long long sqt, long long skb,
                                      long long skt, long long svb, long long svt,
                                      long long sob, long long sot, int device, void* stream) {
    if (B <= 0 || H <= 0 || T <= 0 || T > (1 << 30))
        return int(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);   // this library links its own CUDA runtime
    if (err != cudaSuccess) return int(err);
    CUtensorMap kmap, vmap;
    if (encode_kv(&kmap, k, B, H, T, skb, skt) || encode_kv(&vmap, v, B, H, T, svb, svt))
        return int(cudaErrorInvalidValue);
    constexpr Smem L = smem_layout();
    err = cudaFuncSetAttribute(wavlm_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return int(err);
    int n_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return int(err);
    const int n_qt = (T + QROWS - 1) / QROWS;
    const long long items = (long long)B * H * n_qt;
    if (items > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    const int grid = int(items < n_sm ? items : n_sm);
    wavlm_attention_kernel<<<grid, THREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
        kmap, vmap, static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(g),
        static_cast<const float*>(r), static_cast<__nv_bfloat16*>(out), H, T, sqb, sqt, sob,
        sot, n_qt, int(items));
    return int(cudaGetLastError());
}
