// K4: raw audio -> LFCC in one kernel, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel adfmsl/ops/pallas/lfcc_fused.py:lfcc_fused (:94; its body is
// _kernel, :64-87, with the bf16x3 product _dot3, :50-61). Function, per batch row b
// and frame t < n_frames = 1 + T//hop (centre padding by win/2):
//   xp        = reflect_pad(x[b], win/2)                         (edge sample excluded)
//   re, im    = xp[t*hop : t*hop+win] @ [Cre | Cim]             (Hann folded into the DFT)
//   power[k]  = re[k]^2 + im[k]^2                                (k < n_bins = n_fft/2+1)
//   out[b, t] = log(max(power @ fb, eps)) @ dct                  (fb (n_bins, nf), dct (nf, nl))
// Rounding points, held exactly as in the Pallas kernel and in the plain version
// (ops/lfcc_fused.py:lfcc_fused_plain):
//   'high'    the frame samples and the DFT matrix are split into bf16 hi and lo
//             (hi = bf16_rn(v), lo = bf16_rn(v - hi)); hi*hi + hi*lo + lo*hi accumulate
//             in f32 on the tensor cores;
//   'default' one bf16 pass: bf16_rn of both operands, f32 accumulation;
//   'highest' exact f32 products on the CUDA cores (FFMA).
// The power is two rounded products and a rounded add (no FMA contraction, as the
// plain version's three tensor ops); the filterbank, the log and the DCT are f32.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 67 TFLOP/s f32, 3.35 TB/s): at batch 128
// and cut 64600 (51,712 frames) the DFT at 'high' is 3 x 51,712 x 400 x 514 x 2 = 63.8
// GFLOP (0.065 ms), the filterbank and DCT 2.3 GFLOP of f32 (0.034 ms), against 33 MB
// in and 12 MB out (0.014 ms): bound by operations. chip_smoke.py recomputes the bound
// from each case's shapes; python -m adfmsl_torch.measure_lfcc_stages splits a CTA's
// cycles by phase from a build with -DLFCC_STAGE_STAMPS (STAMP below).
//
// 'high' and 'default' run on the tensor-core engine below (lfcc_tc_kernel):
// 1. Frames are the A operand, from registers, with no im2col. Each warpgroup stages
//    its tile's reflect-padded samples as rows of `hop` samples, the TPU kernel's own
//    layout: frame f's tap k sits at row f + k/hop, column k%hop. A row keeps its
//    first min(hop, kp) columns, the ones a tap reaches (kp, the taps padded to a
//    multiple of 80), at a pitch P of that width or 8 more, whichever makes P/8 odd.
//    hop % 8 == 0, so each 8-tap half of a k16 step lies in one row and ldmatrix.x4
//    takes each lane's row address straight from the buffer; eight consecutive frames
//    fall on eight distinct 16-byte bank groups, so the loads are free of bank
//    conflicts. bf16 hi (and lo at 'high') planes.
// 2. W is the B operand, from shared memory by descriptor. A CTA has two consumer
//    warpgroups (one where two tiles do not fit shared memory), each owning one
//    64-frame tile (consecutive entries of the flat (batch row, frame tile) list, so a
//    CTA may span two batch rows); they read the same W stream. W streams as (chunk,
//    80-tap k-slice) stages, hi then lo, through an mbarrier ring by cp.async.bulk,
//    laid out by the wrapper in the no-swizzle K-major core-matrix layout
//    (ops/lfcc_fused.py:kernel_operands). A warp after the consumers is the producer:
//    it refills a stage once every consumer warp has released it, so no consumer
//    thread waits for the other warpgroup (thread 0 as the producer stalled its
//    warpgroup on every refill until the other had caught up; at one CTA an SM the
//    extra warp costs no registers that matter).
// 3. A chunk is 32 bins, N = 64 columns with re and im of a bin adjacent, so the
//    m64n64k16 accumulator holds (re, im) of one bin in d[4j], d[4j+1] (row g) and
//    d[4j+2], d[4j+3] (row g + 8): the power is register arithmetic, with no f32
//    stage for the DFT. At 'high' each k16 step issues hi*hi, hi*lo and lo*hi into
//    the same accumulators, reusing the hi fragment.
// 4. The chunks cover only the bins up to the last one the filterbank reads (8
//    chunks, bins 0-255, at the model's n_fft 512 and 70 filters, where bin 256
//    feeds no filter): the plain version multiplies the skipped bins by zero weights,
//    which only a power that overflowed to inf there could tell (0 * inf).
// 5. The filterbank is sparse, summed in a fixed order, with no float atomics: after
//    each chunk the warpgroup writes its 64 x 32 powers to its f32 stage, syncs on its
//    named barrier, and each thread takes one row and half of the filters that touch
//    the chunk, adds each filter's partial sum (its CSR run of bins, in bin order) to
//    that row's energy in shared memory. That pass for chunk c-1 runs while the tensor
//    cores take chunk c's first stage. The CSR tables are copied into shared memory
//    once: read from global memory they miss the L1 that 200 KB of shared memory
//    leaves, and every filter waits on L2. After the last chunk: log(max(e, eps))
//    that keeps NaN; the DCT on the CUDA cores from a copy of the DCT matrix in the
//    dead W ring (in slabs of rows where it does not fit; for the same reason as the
//    CSR tables), 16 coefficients of a row a pass from 16-byte loads, into an output
//    tile over the dead frame buffer; the tile's valid rows written as one block with
//    16-byte stores.
// 6. Shared memory (tc_layout, the same formula as ops/lfcc_fused.py:tc_smem_layout,
//    which refuses a shape it does not fit before any build): about 202 KB a CTA at
//    the model's shape (two 44 KB frame buffers, a 3-stage ring of 20 KB stages, two
//    8 KB power stages, two 18 KB energy tiles, 3 KB of CSR tables). Where that does
//    not fit, the ring drops to 2 stages (nf = 128), then the CTA to one warpgroup
//    (at the model's win 400 and 'high': a hop of 256 or more). A row holds at most kp
//    columns, so a hop past kp costs no more shared memory than hop = kp.
// 'highest' keeps its CUDA-core kernel (lfcc_highest_kernel) with
// its own operands: no model runs that tier, and its exact-f32 products gain nothing
// from the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

enum Mode { MODE_DEFAULT = 0, MODE_HIGH = 1, MODE_HIGHEST = 2 };

constexpr int MAX_NF = 128;           // filters
constexpr int MAX_NL = 128;           // coefficients
constexpr int SMEM_LIMIT = 232448;    // 227 KB: the most a CTA may take on an H100

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int align128(int v) { return (v + 127) & ~127; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// ---------------------------------------------------------------------------
// The tensor-core engine ('high', 'default').

constexpr int TF = 64;                // frames a warpgroup tile
constexpr int TC_THREADS = 2 * 128 + 32;   // at most: two consumer warpgroups, a producer
constexpr int CB = 32;                // bins a chunk
constexpr int NCOL = 2 * CB;          // W columns a chunk: re, im of a bin adjacent
constexpr int KS = 80;                // DFT taps a W stage
constexpr int KSTEPS = KS / 16;       // k16 steps a stage
constexpr int SLICE_BYTES = NCOL * KS * 2;
constexpr int SBO = KS / 8 * 128;     // B descriptor: the next 8 columns
constexpr int PSP = CB + 1;           // f32 power stage pitch: 32 rows on 32 banks
constexpr int BAR_BYTES = 128;        // full and empty mbarriers of up to 3 stages

// Byte offsets and sizes of one CTA's shared memory: barriers; the CSR tables
// (fb_words 32-bit words: the filterbank's int index, then its f32 weights); per
// warpgroup its frame buffer (planes x rows x P bf16, a row's first `cols` samples;
// after the products the TF x nl f32 output tile), its power stage (TF x PSP f32) and
// its energies (TF x EP f32, EP odd); then the W ring, which holds the DCT matrix
// after the products. ops/lfcc_fused.py:tc_smem_layout is the same formula.
struct TcLayout {
    int cols, P, kp, rows, planes, plane_bytes, xs_bytes, pst_bytes, ep, en_bytes;
    int stage_bytes, wgs, stages, fbt, xs, pst, en, ring, total;
};

__host__ __device__ constexpr TcLayout tc_layout_of(int mode, int hop, int win, int nf,
                                                     int nl, int fb_words, int wgs,
                                                     int stages) {
    TcLayout L{};
    L.kp = round_up(win, KS);
    L.cols = hop < L.kp ? hop : L.kp;
    L.P = (L.cols / 8) % 2 ? L.cols : L.cols + 8;
    L.rows = TF + (L.kp + hop - 1) / hop - 1;
    L.planes = mode == MODE_HIGH ? 2 : 1;
    L.plane_bytes = align128(L.rows * L.P * 2);
    L.xs_bytes = align128(imax(L.planes * L.plane_bytes, TF * nl * 4));
    L.pst_bytes = align128(TF * PSP * 4);
    L.ep = nf | 1;
    L.en_bytes = align128(TF * L.ep * 4);
    L.stage_bytes = L.planes * SLICE_BYTES;
    L.wgs = wgs;
    L.stages = stages;
    L.fbt = BAR_BYTES;
    L.xs = align128(L.fbt + fb_words * 4);
    L.pst = L.xs + wgs * L.xs_bytes;
    L.en = L.pst + wgs * L.pst_bytes;
    L.ring = L.en + wgs * L.en_bytes;
    L.total = L.ring + stages * L.stage_bytes;
    return L;
}

// The first that fits of: two warpgroups with a 3-stage ring, then 2 stages; one
// warpgroup with 3, then 2 (its total over SMEM_LIMIT where none fits).
__host__ __device__ constexpr TcLayout tc_layout(int mode, int hop, int win, int nf,
                                                  int nl, int fb_words) {
    for (int wgs = 2; wgs >= 1; --wgs)
        for (int stages = 3; stages >= 2; --stages) {
            const TcLayout L = tc_layout_of(mode, hop, win, nf, nl, fb_words, wgs, stages);
            if (L.total <= SMEM_LIMIT) return L;
        }
    return tc_layout_of(mode, hop, win, nf, nl, fb_words, 1, 2);
}

// The model's shape (hop 160, win 400, 70 filters of 504 weights over 8 chunks, 60
// coefficients) at 'high'; the widest filterbank there (each bin feeds at most two
// triangular filters).
static_assert(tc_layout(MODE_HIGH, 160, 400, 70, 60, 3 * 70 + 2 * 8 + 504).wgs == 2 &&
                  tc_layout(MODE_HIGH, 160, 400, 70, 60, 3 * 70 + 2 * 8 + 504).stages == 3 &&
                  tc_layout(MODE_HIGH, 160, 400, 70, 60, 3 * 70 + 2 * 8 + 504).total <=
                      SMEM_LIMIT,
              "the model's shape takes two warpgroups and a 3-stage ring within 227 KB");
static_assert(tc_layout(MODE_HIGH, 160, 400, MAX_NF, MAX_NL, 3 * MAX_NF + 2 * 8 + 2 * 257)
                      .wgs == 2 &&
                  tc_layout(MODE_HIGH, 160, 400, MAX_NF, MAX_NL, 3 * MAX_NF + 2 * 8 + 2 * 257)
                          .total <= SMEM_LIMIT,
              "the widest filterbank fits two warpgroups at the model's hop");
static_assert(2 * 3 * 8 <= BAR_BYTES, "barriers fit their slot");

// STAMP(i): at a diagnostic build (-DLFCC_STAGE_STAMPS, measure_lfcc_stages.py),
// thread 0 of each warpgroup that owns a tile writes clock64() into slot i of its
// tile's row of g_stamps; otherwise nothing. Slots: 0 start, 1 samples staged, 2 last
// filterbank pass, 3 log, 4 the DCT's first CTA barrier, 5 its second, 6 DCT products,
// 7 store; 8 + 2c chunk c's products (with chunk c-1's filterbank pass), 9 + 2c its
// power stage, for c < 16.
#ifdef LFCC_STAGE_STAMPS
constexpr int STAMP_SLOTS = 40, STAMP_TILES = 65536;
__device__ long long g_stamps[STAMP_TILES * STAMP_SLOTS];
#define STAMP_SETUP(tile, on)                                                       \
    long long* const stamp_row_ = g_stamps + size_t(tile) * STAMP_SLOTS;          \
    const bool stamp_on_ = (on) && (tile) < STAMP_TILES;
#define STAMP(i)                                                                    \
    do {                                                                            \
        if (stamp_on_ && (i) < STAMP_SLOTS) stamp_row_[i] = clock64();              \
    } while (0)
#else
#define STAMP_SETUP(tile, on)
#define STAMP(i) do { } while (0)
#endif

__device__ __forceinline__ void named_bar(int id) {
    asm volatile("bar.sync %0, 128;" :: "r"(id) : "memory");
}

// Eight f32 samples -> eight bf16 (hi), and at 'high' the eight residuals' bf16 (lo).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Grid ceil(n_tiles / wgs), 128*wgs + 32 threads (wgs = tc_layout's warpgroups a CTA):
// warpgroup wg (warps 4wg .. 4wg+3) owns tile wgs*blockIdx.x + wg of the flat (batch
// row, 64-frame tile) list; warp 4*wgs issues the W stages. fbi: first bin (nf), last
// bin (nf), offset into fbw (nf) of each filter's run of bins; first filter touching
// chunk c (n_chunks), one past the last (n_chunks).
template <int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1)
lfcc_tc_kernel(const float* __restrict__ x, const unsigned char* __restrict__ w,
               const float* __restrict__ fbw, const int* __restrict__ fbi,
               const float* __restrict__ dct, float* __restrict__ out, int T, int hop,
               int win, int n_chunks, int nf, int nl, int fb_nnz, int n_frames,
               int tiles_per_row, int n_tiles, float log_eps) {
    constexpr bool HIGH = MODE == MODE_HIGH;
    extern __shared__ __align__(128) unsigned char smem[];
    const int n_idx = 3 * nf + 2 * n_chunks;
    const TcLayout L = tc_layout(MODE, hop, win, nf, nl, n_idx + fb_nnz);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2, wi = warp & 3, ltid = tid & 127;
    const int producer = 4 * L.wgs, tile = L.wgs * blockIdx.x + wg;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t sbase = smem_u32(smem);
    const uint32_t full0 = sbase, empty0 = sbase + 8 * L.stages;
    const uint32_t ring = sbase + L.ring;
    const int n_slices = L.kp / KS, n_total = n_chunks * n_slices;
    int* fbi_s = reinterpret_cast<int*>(smem + L.fbt);
    const float* fbw_s = reinterpret_cast<const float*>(fbi_s + n_idx);
    // the thread's energy row and share in the filterbank, log and DCT passes
    const int row = ltid & 63, half = ltid >> 6;
    STAMP_SETUP(tile, ltid == 0 && warp < producer && tile < n_tiles)
    STAMP(0);

    if (tid == 0) {
        for (int s = 0; s < L.stages; ++s) {
            mbar_init(full0 + 8 * s, 1);                   // the producer's expect_tx
            mbar_init(empty0 + 8 * s, 4 * L.wgs);          // one arrive a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    for (int k = tid; k < n_idx + fb_nnz; k += blockDim.x)
        fbi_s[k] = k < n_idx ? __ldg(fbi + k) : __float_as_int(__ldg(fbw + k - n_idx));
    __syncthreads();

    if (warp == producer) {
        // ---- W stage i (chunk i / n_slices, k-slice i % n_slices) into slot
        // ---- i % stages, once every warpgroup has released that slot's last use.
        if (lane == 0)
            for (int i = 0; i < n_total; ++i) {
                const int slot = i % L.stages;
                if (i >= L.stages) mbar_wait(empty0 + 8 * slot, (i / L.stages - 1) & 1);
                mbar_expect_tx(full0 + 8 * slot, L.stage_bytes);
                bulk_g2s(ring + slot * L.stage_bytes, w + size_t(i) * L.stage_bytes,
                         L.stage_bytes, full0 + 8 * slot);
            }
    } else {
        // This warpgroup's tile; a warpgroup past the last tile computes on zeros and
        // writes nothing (it still releases every stage).
        const bool valid = tile < n_tiles;
        const int b = valid ? tile / tiles_per_row : 0;
        const int f0 = valid ? (tile % tiles_per_row) * TF : 0;
        unsigned char* xs = smem + L.xs + wg * L.xs_bytes;
        float* pst = reinterpret_cast<float*>(smem + L.pst + wg * L.pst_bytes);
        float* en = reinterpret_cast<float*>(smem + L.en + wg * L.en_bytes);
        const int bar_id = 1 + wg;

        // ---- the tile's padded samples: row r holds [(f0 + r)*hop, + cols) at pitch
        // ---- P, in groups of 8; zero past the padded end (those meet zero DFT taps or
        // ---- feed frames >= n_frames, which are not written).
        // ---- Groups of 8 go 4 a thread at a time, all loads first: the loads wait on
        // ---- device memory, so each thread keeps 32 of them in flight.
        {
            const int pad = win / 2, tp = T + 2 * pad, g8 = L.cols / 8, n_groups = L.rows * g8;
            const float* xb = x + size_t(b) * T;
            for (int g0 = ltid; g0 < n_groups; g0 += 4 * 128) {
                float v[4][8];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int gi = g0 + 128 * u, r = gi / g8;
                    const int p0 = (f0 + r) * hop + (gi - r * g8) * 8, s0 = p0 - pad;
                    const float* src = xb + s0;
                    if (valid && gi < n_groups && s0 >= 0 && s0 + 8 <= T &&
                        (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
                        const float4 a = __ldg(reinterpret_cast<const float4*>(src));
                        const float4 c = __ldg(reinterpret_cast<const float4*>(src) + 1);
                        v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
                        v[u][4] = c.x; v[u][5] = c.y; v[u][6] = c.z; v[u][7] = c.w;
                    } else {
#pragma unroll
                        for (int e = 0; e < 8; ++e) {
                            const int p = p0 + e;
                            v[u][e] = 0.f;
                            if (valid && gi < n_groups && p < tp) {
                                int s = p - pad;
                                if (s < 0) s = -s;
                                else if (s >= T) s = 2 * (T - 1) - s;
                                v[u][e] = __ldg(xb + s);
                            }
                        }
                    }
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int gi = g0 + 128 * u, r = gi / g8;
                    if (gi >= n_groups) break;
                    uint32_t h[4], l[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        h[q] = pack_bf16x2(v[u][2 * q], v[u][2 * q + 1]);
                        if constexpr (HIGH)
                            l[q] = pack_bf16x2(v[u][2 * q] - bf16_lo(h[q]),
                                               v[u][2 * q + 1] - bf16_hi(h[q]));
                    }
                    const int off = (r * L.P + (gi - r * g8) * 8) * 2;
                    *reinterpret_cast<uint4*>(xs + off) = make_uint4(h[0], h[1], h[2], h[3]);
                    if constexpr (HIGH)
                        *reinterpret_cast<uint4*>(xs + L.plane_bytes + off) =
                            make_uint4(l[0], l[1], l[2], l[3]);
                }
            }
            for (int i = ltid; i < TF * L.ep; i += 128) en[i] = 0.f;
        }
        named_bar(bar_id);
        STAMP(1);

        // ---- each filter touching chunk c: its partial sum over the chunk's bins, in
        // ---- bin order, added to the row's energy.
        auto filterbank = [&](int c) {
            const int jlo = fbi_s[3 * nf + c], jhi = fbi_s[3 * nf + n_chunks + c];
            const int jm = (jlo + jhi + 1) / 2;
            const int c0 = c * CB;
            const float* prow = pst + row * PSP;
            for (int j = half ? jm : jlo; j < (half ? jhi : jm); ++j) {
                const int first = fbi_s[j], last = fbi_s[nf + j];
                const float* wj = fbw_s + fbi_s[2 * nf + j];
                const int k1 = min(last, c0 + CB - 1);
                float sum = 0.f;
                for (int k = max(first, c0); k <= k1; ++k)
                    sum = fmaf(wj[k - first], prow[k - c0], sum);
                en[row * L.ep + j] += sum;
            }
        };

        // This lane's ldmatrix row: frame 16*wi + lane%16, k half (lane/16)*8.
        const uint32_t xa = smem_u32(xs) + (16 * wi + (lane & 15)) * L.P * 2;
        int i = 0;                                  // running stage, the producer's order
        for (int c = 0; c < n_chunks; ++c) {
            float acc[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[e] = 0.f;
            int kr = 0, kc = (lane >> 4) * 8;       // tap k = kr*hop + kc of this lane
            while (kc >= hop) { kc -= hop; ++kr; }
            for (int s = 0; s < n_slices; ++s, ++i) {
                const int slot = i % L.stages;
                uint32_t ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
                for (int ks = 0; ks < KSTEPS; ++ks) {
                    const uint32_t addr = xa + (kr * L.P + kc) * 2;
                    ldmatrix_x4(ah[ks], addr);
                    if constexpr (HIGH) ldmatrix_x4(al[ks], addr + L.plane_bytes);
                    kc += 16;
                    while (kc >= hop) { kc -= hop; ++kr; }
                }
                mbar_wait(full0 + 8 * slot, (i / L.stages) & 1);
                wgmma_fence();
                const uint32_t sl = ring + slot * L.stage_bytes;
                const uint64_t dh = b_desc(sl, SBO);
#pragma unroll
                for (int ks = 0; ks < KSTEPS; ++ks) {   // 16 taps = two core matrices = 256 B
                    wgmma_rs_n64(acc, ah[ks], dh + 16 * ks);
                    if constexpr (HIGH) {
                        const uint64_t dl = b_desc(sl + SLICE_BYTES, SBO);
                        wgmma_rs_n64(acc, ah[ks], dl + 16 * ks);
                        wgmma_rs_n64(acc, al[ks], dh + 16 * ks);
                    }
                }
                wgmma_commit();
                // the last chunk's filterbank pass on the CUDA cores while the tensor
                // cores run this chunk's first products (it reads the power stage only)
                if (s == 0 && c > 0) filterbank(c - 1);
                wgmma_wait_all();
                __syncwarp();
                if (lane == 0) mbar_arrive(empty0 + 8 * slot);
            }

            // ---- power of bin 4j + t (local) for rows g and g + 8 of this warp's 16.
            named_bar(bar_id);                      // the last chunk's pass read its powers
            STAMP(8 + 2 * c);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int r0 = 16 * wi + g, k = 4 * j + t;
                pst[r0 * PSP + k] = __fadd_rn(__fmul_rn(acc[4 * j], acc[4 * j]),
                                              __fmul_rn(acc[4 * j + 1], acc[4 * j + 1]));
                pst[(r0 + 8) * PSP + k] =
                    __fadd_rn(__fmul_rn(acc[4 * j + 2], acc[4 * j + 2]),
                              __fmul_rn(acc[4 * j + 3], acc[4 * j + 3]));
            }
            named_bar(bar_id);
            STAMP(9 + 2 * c);
        }
        filterbank(n_chunks - 1);
        named_bar(bar_id);
        STAMP(2);

        // ---- log energies in place: max(e, eps) that keeps a NaN, as jnp.maximum
        // ---- and torch.clamp do.
#pragma unroll 4
        for (int j = half; j < nf; j += 2) {
            const float e = en[row * L.ep + j];
            en[row * L.ep + j] = logf(e < log_eps ? log_eps : e);
        }
        STAMP(3);
    }

    // ---- DCT-II on the CUDA cores from the DCT matrix copied into the dead W ring
    // ---- (every stage has been consumed once all threads pass the first barrier)
    // ---- at a row pitch of nlp = 16*ceil(nl/16), zero-padded, in slabs of rows that
    // ---- fit it; thread (row, half) takes coefficients [o0, o0 + nh) of its row in
    // ---- passes of 16, four from one 16-byte load, summed in filter order into the
    // ---- output tile over the frame buffer (no warp reads it since the last
    // ---- chunk's products).
    const int nlp = round_up(nl, 16), nh = round_up((nl + 1) / 2, 16), o0 = half * nh;
    float* dct_s = reinterpret_cast<float*>(smem + L.ring);
    const int slab = L.stages * L.stage_bytes / (nlp * 4);
    const float* en = reinterpret_cast<const float*>(smem + L.en + wg * L.en_bytes);
    float* ot = reinterpret_cast<float*>(smem + L.xs + wg * L.xs_bytes);
    for (int j0 = 0; j0 < nf; j0 += slab) {
        const int j1 = min(nf, j0 + slab), n_copy = (j1 - j0) * nlp;
        __syncthreads();                            // the ring, or the last slab, is free
        if (j0 == 0) STAMP(4);
#pragma unroll 4
        for (int k = tid; k < n_copy; k += blockDim.x) {
            const int jj = k / nlp, i = k - jj * nlp;
            dct_s[k] = i < nl ? __ldg(dct + size_t(j0 + jj) * nl + i) : 0.f;
        }
        __syncthreads();
        if (j0 == 0) STAMP(5);
        if (warp == producer) continue;
        for (int ob = o0; ob < o0 + nh && ob < nl; ob += 16) {
            float o[16];
#pragma unroll
            for (int q = 0; q < 16; ++q) o[q] = 0.f;
#pragma unroll 2
            for (int j = j0; j < j1; ++j) {
                const float l = en[row * L.ep + j];
                const float4* dj = reinterpret_cast<const float4*>(dct_s + (j - j0) * nlp + ob);
#pragma unroll
                for (int q4 = 0; q4 < 4; ++q4) {
                    const float4 d = dj[q4];
                    o[4 * q4] = fmaf(l, d.x, o[4 * q4]);
                    o[4 * q4 + 1] = fmaf(l, d.y, o[4 * q4 + 1]);
                    o[4 * q4 + 2] = fmaf(l, d.z, o[4 * q4 + 2]);
                    o[4 * q4 + 3] = fmaf(l, d.w, o[4 * q4 + 3]);
                }
            }
#pragma unroll
            for (int q = 0; q < 16; ++q)
                if (ob + q < nl) {
                    float* dst = ot + row * nl + ob + q;
                    *dst = j0 == 0 ? o[q] : *dst + o[q];
                }
        }
    }
    if (warp == producer) return;
    STAMP(6);

    // ---- the tile's valid rows: one contiguous block of out.
    named_bar(1 + wg);
    if (tile < n_tiles) {
        const int b = tile / tiles_per_row, f0 = (tile % tiles_per_row) * TF;
        const int rows = n_frames - f0 < TF ? n_frames - f0 : TF;
        const int n = rows * nl;
        float* ob = out + (size_t(b) * n_frames + f0) * nl;
        if ((reinterpret_cast<uintptr_t>(ob) & 15) == 0 && nl % 4 == 0) {
            const float4* src = reinterpret_cast<const float4*>(ot);
            float4* dst = reinterpret_cast<float4*>(ob);
            for (int idx = ltid; idx < n / 4; idx += 128) dst[idx] = src[idx];
        } else {
            for (int idx = ltid; idx < n; idx += 128) ob[idx] = ot[idx];
        }
    }
    STAMP(7);
}

// ---------------------------------------------------------------------------
// 'highest': exact f32 on the CUDA cores, a kernel of its own. A CTA owns F = 64
// frames of one batch row and stages the tile's (F-1)*hop + kp padded samples once;
// the DFT matrix streams in chunks of 16 bins (16 re + 16 im columns); per chunk each
// thread computes 8 columns of one frame by FFMA into an f32 stage, then squares and
// adds its frame's 16 bins and folds them into its share of the (F x nf) filterbank
// energies in registers. After the last chunk the energies' log, the DCT and the
// tile's (F x nl) coefficients as one block.

constexpr int F = 64;                 // frames per CTA
constexpr int HI_THREADS = 256;
constexpr int NB = 16;                // DFT bins per chunk
constexpr int WC = 2 * NB;            // W chunk columns: re then im
constexpr int SP = WC + 4;            // f32 stage pitch: the 8 frames of a warp hit 8 banks
constexpr int TPF = HI_THREADS / F;   // threads per frame
constexpr int EQ = MAX_NF / TPF;      // energies per thread, at most
constexpr int OQ = MAX_NL / TPF;      // coefficients per thread, at most

struct Layout {
    size_t xs, ws, stage, fbs, total;
};

// x region: the tile's ns f32 samples. W region: one chunk (kp x WC) f32; after the
// last chunk it holds the log energies (F x nfp) and the output tile (F x nl), f32.
__host__ __device__ inline Layout highest_layout(int hop, int kp, int nfp, int nl) {
    const size_t ns = size_t(F - 1) * hop + kp;
    Layout L;
    L.xs = 0;
    L.ws = align128(int(ns * 4));
    const size_t w_bytes = size_t(kp) * WC * 4;
    const size_t tail = size_t(F) * (nfp + nl) * 4;
    L.stage = align128(int(L.ws + (tail > w_bytes ? tail : w_bytes)));
    L.fbs = align128(int(L.stage + size_t(F) * SP * 4));
    L.total = align128(int(L.fbs + size_t(NB) * nfp * 4));
    return L;
}

__global__ void __launch_bounds__(HI_THREADS)
lfcc_highest_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ fb, const float* __restrict__ dct,
                    float* __restrict__ out, int T, int hop, int win, int kp, int n_chunks,
                    int nf, int nfp, int nl, int n_frames, float log_eps) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L = highest_layout(hop, kp, nfp, nl);
    const int ns = (F - 1) * hop + kp;
    const int tid = threadIdx.x;
    const int b = blockIdx.y, f0 = blockIdx.x * F;
    const int pad = win / 2, tp = T + 2 * pad;
    const float* xb = x + size_t(b) * T;
    float* xs = reinterpret_cast<float*>(smem + L.xs);
    float* ws = reinterpret_cast<float*>(smem + L.ws);
    float* stage = reinterpret_cast<float*>(smem + L.stage);
    float* fbs = reinterpret_cast<float*>(smem + L.fbs);

    // ---- the tile's padded samples [f0*hop, f0*hop + ns), zero past the padded end.
    for (int i = tid; i < ns; i += HI_THREADS) {
        const int p = f0 * hop + i;
        float v = 0.f;
        if (p < tp) {
            int s = p - pad;
            if (s < 0) s = -s;
            else if (s >= T) s = 2 * (T - 1) - s;
            v = xb[s];
        }
        xs[i] = v;
    }

    const int fr = tid / TPF, sub = tid % TPF;      // this thread's frame and share
    float e[EQ];
#pragma unroll
    for (int q = 0; q < EQ; ++q) e[q] = 0.f;

    const int n16 = kp * WC * 4 / 16;
    for (int c = 0; c < n_chunks; ++c) {
        __syncthreads();   // the samples are staged; the last chunk's W, stage, fb are consumed
        {
            uint4* d = reinterpret_cast<uint4*>(ws);
            const uint4* s = reinterpret_cast<const uint4*>(w) + size_t(c) * n16;
            for (int i = tid; i < n16; i += HI_THREADS) d[i] = s[i];
        }
        for (int i = tid; i < NB * nfp; i += HI_THREADS) fbs[i] = fb[size_t(c) * NB * nfp + i];
        __syncthreads();

        // ---- re | im of this chunk's 16 bins for the F frames -> stage (F x WC).
        {
            const int r = tid >> 2, c0 = (tid & 3) * 8;
            const float* xr = xs + r * hop;
            float acc[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] = 0.f;
            for (int k = 0; k < kp; ++k) {
                const float a = xr[k];
                const float4 w0 = *reinterpret_cast<const float4*>(ws + k * WC + c0);
                const float4 w1 = *reinterpret_cast<const float4*>(ws + k * WC + c0 + 4);
                acc[0] = fmaf(a, w0.x, acc[0]);
                acc[1] = fmaf(a, w0.y, acc[1]);
                acc[2] = fmaf(a, w0.z, acc[2]);
                acc[3] = fmaf(a, w0.w, acc[3]);
                acc[4] = fmaf(a, w1.x, acc[4]);
                acc[5] = fmaf(a, w1.y, acc[5]);
                acc[6] = fmaf(a, w1.z, acc[6]);
                acc[7] = fmaf(a, w1.w, acc[7]);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) stage[r * SP + c0 + j] = acc[j];
        }
        __syncthreads();

        // ---- power of this frame's 16 bins into its share of the filterbank energies.
        const float* st = stage + fr * SP;
#pragma unroll 4
        for (int k = 0; k < NB; ++k) {
            const float re = st[k], im = st[NB + k];
            const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
            const float* fk = fbs + k * nfp + sub;
#pragma unroll
            for (int q = 0; q < EQ; ++q)
                if (sub + TPF * q < nfp) e[q] = fmaf(p, fk[TPF * q], e[q]);
        }
    }

    // ---- log energies into the W region: every thread passed the barrier after the
    // ---- last chunk's products, so nothing reads W any more.
    float* loge = ws;
    float* otile = loge + F * nfp;
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
        const int j = sub + TPF * q;
        // max(e, eps) that keeps a NaN, as jnp.maximum and torch.clamp do
        if (j < nf) loge[fr * nfp + j] = logf(e[q] < log_eps ? log_eps : e[q]);
    }
    __syncthreads();

    // ---- DCT-II on the CUDA cores, then the tile's valid frames as one block.
    float o[OQ];
#pragma unroll
    for (int q = 0; q < OQ; ++q) o[q] = 0.f;
    for (int j = 0; j < nf; ++j) {
        const float l = loge[fr * nfp + j];
        const float* dj = dct + size_t(j) * nl + sub;
#pragma unroll
        for (int q = 0; q < OQ; ++q)
            if (sub + TPF * q < nl) o[q] = fmaf(l, __ldg(dj + TPF * q), o[q]);
    }
#pragma unroll
    for (int q = 0; q < OQ; ++q) {
        const int i = sub + TPF * q;
        if (i < nl) otile[fr * nl + i] = o[q];
    }
    __syncthreads();
    const int rows = n_frames - f0 < F ? n_frames - f0 : F;
    float* ob = out + (size_t(b) * n_frames + f0) * nl;
    for (int i = tid; i < rows * nl; i += HI_THREADS) ob[i] = otile[i];
}

typedef void (*TcKernel)(const float*, const unsigned char*, const float*, const int*,
                         const float*, float*, int, int, int, int, int, int, int, int, int,
                         int, float);

TcKernel tc_kernel(int mode) {
    return mode == MODE_HIGH ? lfcc_tc_kernel<MODE_HIGH> : lfcc_tc_kernel<MODE_DEFAULT>;
}

// fb_words: the CSR tables' 32-bit words, 3*nf + 2*n_chunks + the weights.
bool bad_shape(int hop, int win, int nf, int nl, int fb_words, int mode) {
    return hop <= 0 || hop % 8 || win <= 0 || nf <= 0 || nf > MAX_NF || nl <= 0 ||
           nl > MAX_NL || mode < MODE_DEFAULT || mode > MODE_HIGHEST || fb_words < 0 ||
           (mode != MODE_HIGHEST &&
            tc_layout(mode, hop, win, nf, nl, fb_words).total > SMEM_LIMIT);
}

}  // namespace

// The launch figures of a shape on `device` (fb_words: the CSR tables' 32-bit words
// at the tensor-core tiers): info[0] frames a warpgroup tile (the CTA's at
// 'highest'), [1] frames a CTA, [2] shared memory a CTA, [3] W ring stages (0 at
// 'highest'), [4] threads, [5] CTAs an SM (the occupancy calculator). Returns a CUDA
// error code (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int lfcc_fused_config(int mode, int hop, int win, int nf, int nl, int fb_words,
                                 int device, int* info) {
    if (bad_shape(hop, win, nf, nl, fb_words, mode)) return int(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    int ctas = 0;
    if (mode == MODE_HIGHEST) {
        const Layout L = highest_layout(hop, round_up(win, 16), round_up(nf, TPF), nl);
        err = cudaFuncSetAttribute(lfcc_highest_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, lfcc_highest_kernel,
                                                                HI_THREADS, L.total);
        info[0] = F; info[1] = F; info[2] = int(L.total); info[3] = 0;
        info[4] = HI_THREADS;
    } else {
        const TcLayout L = tc_layout(mode, hop, win, nf, nl, fb_words);
        const TcKernel k = tc_kernel(mode);
        err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, k, 128 * L.wgs + 32,
                                                                L.total);
        info[0] = TF; info[1] = L.wgs * TF; info[2] = L.total; info[3] = L.stages;
        info[4] = 128 * L.wgs + 32;
    }
    info[5] = ctas;
    return int(err);
}

// Launches K4 on `stream`; returns cudaGetLastError(). x (B, T) f32; out
// (B, 1 + (T + 2*(win/2) - win)//hop, nl) f32; dct (nf, nl) f32.
// mode 1 ('high') / 0 ('default'): w the DFT matrix as n_chunks x (80*ceil(win/80)/80)
// stages of bf16 hi (then lo at mode 1) 64 x 80 slices in the B descriptor's layout,
// fb the filterbank's fb_nnz CSR weights f32, fb_index its int32 index
// (ops/lfcc_fused.py:kernel_operands). mode 2 ('highest'): w the DFT matrix in
// n_chunks chunks of (16*ceil(win/16)) x 32 f32 columns (16 bins' re, then their im),
// fb (n_chunks*16, 4*ceil(nf/4)) f32 dense, fb_index unused. hop a multiple of 8;
// win/2 < T; nf and nl at most 128; the tensor-core modes within tc_layout's 227 KB.
// device = the CUDA device index.
extern "C" int lfcc_fused_launch(const void* x, const void* w, const void* fb,
                                 const void* fb_index, const void* dct, void* out, int bsz,
                                 int T, int hop, int win, int n_chunks, int nf, int nl,
                                 int fb_nnz, float log_eps, int mode, int device,
                                 void* stream) {
    const int fb_words = 3 * nf + 2 * n_chunks + fb_nnz;
    if (bsz <= 0 || bsz > 65535 || win / 2 >= T || n_chunks <= 0 || fb_nnz < 0 ||
        bad_shape(hop, win, nf, nl, fb_words, mode))
        return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int n_frames = 1 + (T + 2 * (win / 2) - win) / hop;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mode == MODE_HIGHEST) {
        const int kp = round_up(win, 16), nfp = round_up(nf, TPF);
        const Layout L = highest_layout(hop, kp, nfp, nl);
        err = cudaFuncSetAttribute(lfcc_highest_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.total));
        if (err != cudaSuccess) return int(err);
        lfcc_highest_kernel<<<dim3((n_frames + F - 1) / F, bsz), HI_THREADS, L.total, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w),
            static_cast<const float*>(fb), static_cast<const float*>(dct),
            static_cast<float*>(out), T, hop, win, kp, n_chunks, nf, nfp, nl, n_frames,
            log_eps);
        return int(cudaGetLastError());
    }
    const TcLayout L = tc_layout(mode, hop, win, nf, nl, fb_words);
    const TcKernel k = tc_kernel(mode);
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return int(err);
    const int tiles_per_row = (n_frames + TF - 1) / TF, n_tiles = bsz * tiles_per_row;
    k<<<(n_tiles + L.wgs - 1) / L.wgs, 128 * L.wgs + 32, L.total, s>>>(
        static_cast<const float*>(x), static_cast<const unsigned char*>(w),
        static_cast<const float*>(fb), static_cast<const int*>(fb_index),
        static_cast<const float*>(dct), static_cast<float*>(out), T, hop, win, n_chunks,
        nf, nl, fb_nnz, n_frames, tiles_per_row, n_tiles, log_eps);
    return int(cudaGetLastError());
}

#ifdef LFCC_STAGE_STAMPS
// The diagnostic build's stamps: the first n of g_stamps (tile-major, STAMP_SLOTS a tile).
extern "C" int lfcc_stamps(long long* host, int n) {
    return int(cudaMemcpyFromSymbol(host, g_stamps, size_t(n) * sizeof(long long)));
}
#endif
