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
// from each case's shapes.
//
// What this design does about it: nothing of the pipeline reaches device memory but
// the waveform in and the coefficients out. A CTA owns F = 64 frames of one batch
// row. It stages the tile's reflect-padded samples once ((F-1)*hop + win of them, in
// bf16 hi/lo or f32); frame f is the row starting at sample f*hop, so the frames are
// a strided view of that buffer (wmma row pitch = hop) and are never copied out. The
// DFT matrix (win x 514 hi+lo, about 0.8 MB) does not fit in shared memory, so it is
// streamed in chunks of 16 bins (16 re + 16 im columns, zero past bin 256): per chunk
// the 8 warps each compute one 16 x 16 wmma tile of re or im, the tile goes through a
// shared f32 stage, and every thread squares and adds its frame's 16 bins and folds
// them into its share of the (F x nf) filterbank energies, kept in registers (the
// filterbank is linear in the power, so the chunks sum). After the last chunk the
// energies' log goes to shared memory, the DCT runs on the CUDA cores, and the tile's
// (F x nl) coefficients are written as one contiguous block. The TPU layout's lane
// padding (hop rows to 256, bins to 384 columns, 60 outputs to 128) is not carried
// over. There is no TMA, wgmma or double buffering of the W chunks yet: this is the
// simple, correct first form, not a fast one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int F = 64;                 // frames per CTA
constexpr int WARPS = 8;              // (F/16) row tiles x {re, im}
constexpr int THREADS = WARPS * 32;
constexpr int NB = 16;                // DFT bins per chunk
constexpr int WC = 2 * NB;            // W chunk columns: re then im
constexpr int SP = WC + 4;            // f32 stage pitch: the 8 frames of a warp hit 8 banks
constexpr int TPF = THREADS / F;      // threads per frame
constexpr int MAX_NF = 128;           // filters
constexpr int MAX_NL = 128;           // coefficients
constexpr int EQ = MAX_NF / TPF;      // energies per thread, at most
constexpr int OQ = MAX_NL / TPF;      // coefficients per thread, at most

enum Mode { MODE_DEFAULT = 0, MODE_HIGH = 1, MODE_HIGHEST = 2 };

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

struct Layout {
    size_t xs, xs_lo, ws, ws_lo, stage, fbs, total;
};

// x region: the tile's ns samples, f32 ('highest') or bf16 hi then lo. W region: one
// chunk (kp x WC), f32 or bf16 hi then lo; after the last chunk it holds the log
// energies (F x nfp) and the output tile (F x nl), f32.
__host__ __device__ inline Layout layout(int mode, int hop, int kp, int nfp, int nl) {
    const size_t ns = size_t(F - 1) * hop + kp;
    Layout L;
    size_t off = 0;
    L.xs = off;
    if (mode == MODE_HIGHEST) {
        L.xs_lo = off;
        off = align128(off + ns * 4);
    } else {
        L.xs_lo = align128(off + ns * 2);
        off = mode == MODE_HIGH ? align128(L.xs_lo + ns * 2) : L.xs_lo;
    }
    L.ws = off;
    size_t w_bytes;
    if (mode == MODE_HIGHEST) {
        L.ws_lo = off;
        w_bytes = size_t(kp) * WC * 4;
    } else {
        L.ws_lo = off + align128(size_t(kp) * WC * 2);
        w_bytes = (L.ws_lo - off) * (mode == MODE_HIGH ? 2 : 1);
    }
    const size_t tail = size_t(F) * (nfp + nl) * 4;
    off = align128(off + (tail > w_bytes ? tail : w_bytes));
    L.stage = off;
    off = align128(off + size_t(F) * SP * 4);
    L.fbs = off;
    off = align128(off + size_t(NB) * nfp * 4);
    L.total = off;
    return L;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ inline void copy16(void* dst, const void* src, int n16) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < n16; i += THREADS) d[i] = s[i];
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
lfcc_fused_kernel(const float* __restrict__ x, const void* __restrict__ w_hi,
                  const void* __restrict__ w_lo, const float* __restrict__ fb,
                  const float* __restrict__ dct, float* __restrict__ out, int T, int hop,
                  int win, int kp, int n_chunks, int nf, int nfp, int nl, int n_frames,
                  float log_eps) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L = layout(MODE, hop, kp, nfp, nl);
    const int ns = (F - 1) * hop + kp;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int b = blockIdx.y, f0 = blockIdx.x * F;
    const int pad = win / 2, tp = T + 2 * pad;
    const float* xb = x + size_t(b) * T;
    float* stage = reinterpret_cast<float*>(smem + L.stage);
    float* fbs = reinterpret_cast<float*>(smem + L.fbs);

    // ---- the tile's padded samples [f0*hop, f0*hop + ns), zero past the padded end
    // ---- (they meet zero DFT rows or feed frames >= n_frames, which are not written).
    for (int i = tid; i < ns; i += THREADS) {
        const int p = f0 * hop + i;
        float v = 0.f;
        if (p < tp) {
            int s = p - pad;
            if (s < 0) s = -s;
            else if (s >= T) s = 2 * (T - 1) - s;
            v = xb[s];
        }
        if (MODE == MODE_HIGHEST) {
            reinterpret_cast<float*>(smem + L.xs)[i] = v;
        } else {
            const bf16 h = __float2bfloat16_rn(v);
            reinterpret_cast<bf16*>(smem + L.xs)[i] = h;
            if (MODE == MODE_HIGH)
                reinterpret_cast<bf16*>(smem + L.xs_lo)[i] =
                    __float2bfloat16_rn(v - __bfloat162float(h));
        }
    }

    const int fr = tid / TPF, sub = tid % TPF;      // this thread's frame and share
    float e[EQ];
#pragma unroll
    for (int q = 0; q < EQ; ++q) e[q] = 0.f;

    const int w_elem = MODE == MODE_HIGHEST ? 4 : 2;
    const int n16 = kp * WC * w_elem / 16;
    for (int c = 0; c < n_chunks; ++c) {
        __syncthreads();   // the samples are staged; the last chunk's W, stage, fb are consumed
        copy16(smem + L.ws, static_cast<const unsigned char*>(w_hi) + size_t(c) * n16 * 16,
               n16);
        if (MODE == MODE_HIGH)
            copy16(smem + L.ws_lo,
                   static_cast<const unsigned char*>(w_lo) + size_t(c) * n16 * 16, n16);
        for (int i = tid; i < NB * nfp; i += THREADS) fbs[i] = fb[size_t(c) * NB * nfp + i];
        __syncthreads();

        // ---- re | im of this chunk's 16 bins for the F frames -> stage (F x WC).
        if (MODE == MODE_HIGHEST) {
            const float* xs = reinterpret_cast<const float*>(smem + L.xs);
            const float* ws = reinterpret_cast<const float*>(smem + L.ws);
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
        } else {
            const bf16* xs = reinterpret_cast<const bf16*>(smem + L.xs);
            const bf16* xs_lo = reinterpret_cast<const bf16*>(smem + L.xs_lo);
            const bf16* ws = reinterpret_cast<const bf16*>(smem + L.ws);
            const bf16* ws_lo = reinterpret_cast<const bf16*>(smem + L.ws_lo);
            const int m = warp >> 1, n = warp & 1;   // 16 frames x 16 re or im columns
            FragC acc;
            wmma::fill_fragment(acc, 0.f);
            for (int kc = 0; kc < kp; kc += 16) {
                FragA ah;
                FragB bh;
                wmma::load_matrix_sync(ah, xs + (m * 16) * hop + kc, hop);
                wmma::load_matrix_sync(bh, ws + kc * WC + n * 16, WC);
                wmma::mma_sync(acc, ah, bh, acc);
                if (MODE == MODE_HIGH) {
                    FragA al;
                    FragB bl;
                    wmma::load_matrix_sync(bl, ws_lo + kc * WC + n * 16, WC);
                    wmma::mma_sync(acc, ah, bl, acc);
                    wmma::load_matrix_sync(al, xs_lo + (m * 16) * hop + kc, hop);
                    wmma::mma_sync(acc, al, bh, acc);
                }
            }
            wmma::store_matrix_sync(stage + (m * 16) * SP + n * 16, acc, SP,
                                    wmma::mem_row_major);
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
    float* loge = reinterpret_cast<float*>(smem + L.ws);
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
    for (int i = tid; i < rows * nl; i += THREADS) ob[i] = otile[i];
}

}  // namespace

// Launches K4 on `stream`; returns cudaGetLastError(). x (B, T) f32; out
// (B, 1 + (T + 2*(win/2) - win)//hop, nl) f32. w_hi / w_lo: the DFT matrix in n_chunks
// chunks of (kp = 16*ceil(win/16)) x 32 columns (16 bins' re, then their im; zero past
// win and past the last bin), bf16 hi and lo at mode 1 ('high'), bf16 at mode 0
// ('default', w_lo unused), f32 at mode 2 ('highest', w_lo unused). fb (n_chunks*16,
// nfp = 4*ceil(nf/4)) f32, zero past n_bins and nf; dct (nf, nl) f32. hop a multiple
// of 8; win/2 < T; nf and nl at most 128. device = the CUDA device index.
extern "C" int lfcc_fused_launch(const void* x, const void* w_hi, const void* w_lo,
                                 const void* fb, const void* dct, void* out, int bsz,
                                 int T, int hop, int win, int n_chunks, int nf, int nl,
                                 float log_eps, int mode, int device, void* stream) {
    if (bsz <= 0 || bsz > 65535 || hop <= 0 || hop % 8 || win <= 0 || win / 2 >= T ||
        n_chunks <= 0 || nf <= 0 || nf > MAX_NF || nl <= 0 || nl > MAX_NL ||
        mode < MODE_DEFAULT || mode > MODE_HIGHEST)
        return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    const int kp = round_up(win, 16), nfp = round_up(nf, TPF);
    const int n_frames = 1 + (T + 2 * (win / 2) - win) / hop;
    const Layout L = layout(mode, hop, kp, nfp, nl);
    void (*kern)(const float*, const void*, const void*, const float*, const float*,
                 float*, int, int, int, int, int, int, int, int, int, float) =
        mode == MODE_HIGH ? lfcc_fused_kernel<MODE_HIGH>
        : mode == MODE_DEFAULT ? lfcc_fused_kernel<MODE_DEFAULT>
                               : lfcc_fused_kernel<MODE_HIGHEST>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(L.total));
    if (err != cudaSuccess) return int(err);
    const dim3 grid((n_frames + F - 1) / F, bsz);
    kern<<<grid, THREADS, L.total, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), w_hi, w_lo, static_cast<const float*>(fb),
        static_cast<const float*>(dct), static_cast<float*>(out), T, hop, win, kp, n_chunks,
        nf, nfp, nl, n_frames, log_eps);
    return int(cudaGetLastError());
}
