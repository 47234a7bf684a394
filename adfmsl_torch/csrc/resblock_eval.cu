// K1: the folded eval-mode SE-ResBlock body, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel adfmsl/ops/pallas/resblock_fused.py:resblock_eval_fused
// (its body is _kernel, :69-136). Function, per batch row b and time row t:
//   x   = the block's input, or at stride 2 that input pooled over time by
//         AvgPool(3, 2, pad 1) counting the pads (T = ceil(T_in / 2); item 8)
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
// by tensor-core operations, and so are the other blocks of maze5 and main
// (chip_smoke.py:k1_bound recomputes it per block from the shapes). The earlier
// form of this kernel (wmma 16x16x16, R = 48 rows a CTA, weights read from L2
// inside the product loop) took 50.46 ms for maze5's five blocks at batch 128
// and 16.13 ms for main's six, 6.8 % and 6.5 % of the bound; this one takes
// 9.66 ms and 3.28 ms, 35 % and 31 % (chip_smoke.py, an H100 80GB HBM3 at 700 W).
//
// The design, and what it does about each limit of that first form:
// 1. Products are wgmma.mma_async m64nNk16 (N = Cout, 128 or 256) with f32
//    accumulators in registers and A in registers (the RS form). The three taps
//    of a conv are the same activation rows shifted by 0, 1 or 2; a shared-
//    memory descriptor for A cannot start one row into a layout atom, so each
//    warp loads its 16 x 16 A fragment with ldmatrix.x4 at the tap's row offset
//    (the RS form's A fragment is the m16n8k16 one that ldmatrix.x4 returns),
//    and B, the weights, comes from shared memory through a descriptor.
// 2. Weights are staged asynchronously: (tap, 64-deep k-chunk) x Cout slices
//    stream through a ring of STAGES buffers by cp.async.bulk with mbarrier
//    completion (full / empty barriers), ahead of the products. The wrapper
//    (ops/resblock_fused.py:kernel_weight_layout) lays each slice out once per
//    call in the no-swizzle K-major canonical layout of the B descriptor, so one
//    1-D bulk copy lands it: element (n, k) of a slice sits at
//    ((n/8)*8 + k/8)*64 + (n%8)*8 + k%8, i.e. 8 x 8 core matrices of 128
//    contiguous bytes, 128 B apart along k (LBO) and 1024 B apart along n (SBO).
//    No tensor map is needed. Thread 0 is the producer: it refills a stage once
//    all eight warps have released it. A separate producer warp costs more than
//    it gives: the register file is split among an SM's four schedulers, so at
//    two CTAs an SM a ninth warp leaves under 100 registers a thread, and the
//    128 -> 128 products need about 110 (with a producer warp ptxas gave it 94,
//    spilled and serialised the wgmmas; a producer warpgroup with setmaxnreg
//    does not build at two CTAs an SM). One CTA an SM instead loses the overlap
//    of item 6. A form of this design with a producer warp took 19.00 ms for
//    maze5's five blocks at batch 128 (chip_smoke.py, the same card).
// 3. Tiles are sized to wgmma's 64-row M: a CTA owns R = 126 output rows of one
//    batch row, and each weight slice feeds both warpgroups, 128 rows, so L2
//    weight reads fall from 4 KB to 1.56 KB per output row at 128 -> 128
//    (WEIGHT_BYTES / R).
// 4. The halo: conv1 computes 128 rows of y1 (global r0-1 .. r0+126) from 130
//    rows of x; conv2 computes 128 rows, keeps 126 and reads 2 zeroed spare y1
//    rows; 2 rows in 128 are wasted instead of 16 in 64. 126 is a multiple of 3,
//    so no MaxPool3 window crosses a tile (the Pallas kernel's quant rule,
//    resblock_fused.py:161). x rows [r0-2, r0+128) that lie in [0, T) are one
//    contiguous run of global memory and arrive by one bulk copy, dense, at the
//    end of their tile's region; the threads spread them to a pitch 16 B longer
//    than the data (which makes ldmatrix free of bank conflicts at any row
//    offset) through registers. Rows outside [0, T) are not copied and h is
//    zeroed there after the activation, since act(c1) != 0.
// 5. Epilogues work on the accumulator layout in registers: conv1's bias, act,
//    row mask and bf16 rounding go straight into the y1 tile; conv2's bias and
//    the 1x1 product (accumulated into the same registers) go to an f32 stage
//    in shared memory that conv2 no longer reads. From there each thread owns 8
//    channels of a set of rows: it adds the identity skip (x rows loaded from
//    global memory, where the tile's bulk copy has just brought them into L2,
//    all before the stage's barrier), takes MaxPool3 over the three rows of a
//    window, writes y as 16-byte vectors, and the per-tile channel sums are
//    reduced across threads in a fixed order. A second launch
//    (reduce_partials_kernel) adds the tiles' sums in tile order, so the
//    result is deterministic.
// 6. Shared memory (Cfg<>::TOTAL, checked against 227 KB at compile time): x is
//    turned into h in place when the skip is the identity, and y1 is written
//    over h once both warpgroups have retired their conv1 products (a barrier
//    of the CTA); only the 1x1-skip block keeps a separate x tile, which its
//    third product reads. The f32 stage and the sums' scratch alias the dead
//    tiles and the ring. At 128 -> 128 a CTA takes 101 KB and at most 128
//    registers a thread, so two CTAs share an SM and one's loads and epilogues
//    overlap the other's products; the wider blocks take about 200 KB and run
//    one CTA an SM.
// 7. The wide stack heads, maze2's 768 -> 128 and maze6's 1024 -> 128 with the
//    1x1 skip (Cfg::WIDE), take their own tile: a 126-row tile's skewed x alone
//    would be 130 x 1032 x 2 = 268 KB at Cin 1024. At the stack head h == x (no
//    bn1; the wrapper refuses `pre` and the pool there), so one x tile serves
//    conv1 and the skip and y1 gets a tile of its own; the tile is one 64-row
//    wgmma M (R = 62 output rows, 66 x rows: 136 KB at Cin 1024, 220 KB a CTA
//    with the ring), and the two warpgroups split N instead of M: each runs
//    m64n64k16 on its 64 columns of every weight slice (the slice's second half
//    starts 8 KB in). The x rows arrive by one bulk copy a row straight to the
//    skewed pitch, so no pass through registers spreads them.
// 8. Stride 2 (the 'tpu' blocks that downsample: maze5's blocks 1-4, the
//    Wav2Vec2 models' strided blocks) pools on load. The block's overlap avg
//    pool, which torch ran as a pass of its own at 9x its bytes (16.6 of
//    maze5's 39.4 device ms a batch of 128), happens as x is brought in. A
//    tile's 130 pooled rows need 261 raw rows, 66.8 KB at Cin 128: a dense run
//    of them would push a 128 -> 128 CTA past two an SM. So there is no bulk
//    copy of x at stride 2: the threads that spread x read the raw rows from
//    global memory, 16 bytes a thread, each thread a run of NJ pooled rows so
//    that every raw row is loaded once (pool_rows), pool them in registers
//    exactly as torch's avg_pool kernel does (the f32 sum in window order, over
//    3, rounded to bf16: the values of ops/resblock_fused.py:overlap_avg_pool),
//    and write h, and the 1x1 skip's x tile, as at stride 1. The identity skip of
//    the last pass needs the pooled rows again: the load phase writes the tile's
//    own R pooled rows into y, and the last pass reads them back from L2
//    (ld.global.cg) before it overwrites them. The pooled load is a template
//    parameter of the kernel, so a stride-1 call runs the code it ran before
//    (with a branch at run time instead, the stride-1 calls took 2-6 % longer
//    on an H100 80GB HBM3 at 700 W). The wide stack heads and MaxPool3
//    (RawNet) take stride 1 only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int KC = 64;              // k depth of one weight slice
constexpr int THREADS = 256;        // two warpgroups
constexpr int SMEM_LIMIT = 232448;  // 227 KB: the most a CTA may take on an H100
constexpr int SMEM_PER_SM = 233472; // 228 KB an SM, of which 1 KB a CTA is reserved

__host__ __device__ constexpr int align128(int v) { return (v + 127) & ~127; }

template <int CIN, int COUT>
struct Cfg {
    static constexpr bool SKIP = CIN != COUT;       // 1x1 skip, else identity
    // The wide stack-head blocks (768 or 1024 -> 128, 1x1 skip, no bn1: h == x):
    // one x tile serves conv1 and the skip, y1 has a tile of its own, the tile
    // is one 64-row wgmma M (a 128-row x tile would not fit 227 KB) and the two
    // warpgroups split N: each computes 64 rows x COUT/2 columns.
    static constexpr bool WIDE = CIN > 256;
    static constexpr int CIN_ = CIN;
    static constexpr int M_ROWS = WIDE ? 64 : 128;  // rows each conv computes
    static constexpr int R = M_ROWS - 2;            // output rows a tile (126: a multiple of 3)
    static constexpr int X_ROWS = M_ROWS + 2;       // x / h / y1 tile rows: global r0-2 ..
    static constexpr int NW = WIDE ? COUT / 2 : COUT;   // columns a warpgroup computes
    static constexpr int XP = CIN + 8;              // x / h row pitch, elements (16 B skew)
    static constexpr int YP = COUT + 8;             // y1 row pitch
    static constexpr int SP = COUT + 8;             // f32 stage row pitch
    static constexpr int SLICE_BYTES = COUT * KC * 2;
    static constexpr int N1 = 3 * CIN / KC;         // conv1 slices, tap-major
    static constexpr int N2 = 3 * COUT / KC;        // conv2 slices
    static constexpr int NSK = SKIP ? CIN / KC : 0; // 1x1 skip slices
    static constexpr int SLICES = N1 + N2 + NSK;
    static constexpr int WEIGHT_BYTES = SLICES * SLICE_BYTES;
    static constexpr int CTAS = COUT == 128 && !WIDE ? 2 : 1;   // CTAs an SM (launch bounds)
    static constexpr int STAGES = COUT == 128 ? 4 : (SKIP ? 3 : 4);   // weight ring
    static constexpr int CH = COUT / 8;             // 8-channel chunks of a row
    static constexpr int NRG = THREADS / CH;        // row groups of the last pass
    // byte offsets: barriers, [x tile], h / y1 tile, weight ring; the f32 stage
    // and the sums' scratch alias everything after the barriers. h lives in
    // the x tile when WIDE, else in the h / y1 tile.
    static constexpr int BARS = 0;
    static constexpr int XS = 256;
    static constexpr int HY = align128(XS + (SKIP ? X_ROWS * XP * 2 : 0));
    static constexpr int HY_BYTES = X_ROWS * (XP > YP && !WIDE ? XP : YP) * 2;
    static constexpr int H = WIDE ? XS : HY;
    static constexpr int RING = align128(HY + HY_BYTES);
    static constexpr int TOTAL = RING + STAGES * SLICE_BYTES;
    // x arrives dense (rows of CIN) at the end of the region its skewed tile
    // takes, and is spread out to the skewed pitch in registers (WIDE: one
    // bulk copy a row lands it at the pitch)
    static constexpr int XD = (SKIP ? XS + X_ROWS * XP * 2 : HY + HY_BYTES) - X_ROWS * CIN * 2;
    static constexpr int RPT = (R + NRG - 1) / NRG;       // last pass: rows a thread
    static constexpr int WPT = (R / 3 + NRG - 1) / NRG;   // MaxPool3 windows a thread
    static constexpr int STG = XS;
    static constexpr int RED = align128(STG + R * SP * 4);
    static_assert(CIN % KC == 0 && COUT % KC == 0, "channels are whole k-chunks");
    static_assert(!WIDE || (SKIP && COUT == 128), "a wide block is a 1x1-skip head to 128");
    static_assert((XP * 2) % 16 == 0, "a row bulk-copied at the pitch lands 16-byte aligned");
    static_assert(2 * STAGES + 1 <= 256 / 8, "barriers fit their slot");
    static_assert(RED + NRG * COUT * 4 <= TOTAL, "the f32 stage fits the dead tiles");
    static_assert(TOTAL <= SMEM_LIMIT, "shared memory of one CTA within 227 KB");
    static_assert(CTAS * (TOTAL + 1024) <= SMEM_PER_SM, "CTAS fit one SM");
    static_assert(RING % 16 == 0 && XD % 16 == 0, "bulk copies land 16-byte aligned");
};

// bf16 pairs in a 32-bit word: the low half is the lower channel.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// D (64 x 128, f32, registers) += A (64 x 16 bf16, registers: this warp's
// m16n8k16 A fragment) * B (16 x 128 bf16, shared memory, descriptor).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc) {
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D (64 x 256, f32, registers) += A (64 x 16 bf16, registers: this warp's
// m16n8k16 A fragment) * B (16 x 256 bf16, shared memory, descriptor).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                               uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ float act_fn(float v, int act) {
    return act == 0 ? fmaxf(v, 0.f) : fmaxf(v, __fmul_rn(0.3f, v));
}

// Eight f32 of the stage.
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// Adds v to the running sums and writes it as eight bf16 (one 16-byte store).
__device__ __forceinline__ void emit(const float (&v)[8], float (&s)[8], bf16* dst) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] += v[e];
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// One weight slice (64 k) against this warpgroup's 64 rows and N columns: four
// k16 products. `a_addr` is this lane's ldmatrix row address at the slice's
// first k, `b_addr` the slice's address at the warpgroup's first column.
template <int N>
__device__ __forceinline__ void slice_products(float (&acc)[N / 2], uint32_t a_addr,
                                               uint32_t b_addr) {
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ldmatrix_x4(a[ks], a_addr + ks * 32);
    wgmma_fence();
    const uint64_t desc = b_desc(b_addr, 1024);       // SBO: 8 n of a 64-deep slice
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {        // 16 k = two core matrices = 256 B
        if constexpr (N == 64) wgmma_rs_n64(acc, a[ks], desc + 16 * ks);
        else if constexpr (N == 128) wgmma_rs_n128(acc, a[ks], desc + 16 * ks);
        else wgmma_rs_n256(acc, a[ks], desc + 16 * ks);
    }
    wgmma_commit();
    wgmma_wait_all();
}

// The mean of three bf16 pairs, as torch's avg_pool kernel with count_include_pad
// forms it: the f32 sum in window order from 0, divided by 3 (IEEE division),
// rounded to bf16.
__device__ __forceinline__ uint32_t mean3_bf16x2(uint32_t a, uint32_t m, uint32_t c) {
    const float lo = __fadd_rn(__fadd_rn(__fadd_rn(0.f, bf16_lo(a)), bf16_lo(m)), bf16_lo(c));
    const float hi = __fadd_rn(__fadd_rn(__fadd_rn(0.f, bf16_hi(a)), bf16_hi(m)), bf16_hi(c));
    return pack_bf16x2(__fdiv_rn(lo, 3.f), __fdiv_rn(hi, 3.f));
}

// Stride 2: pooled rows p0 .. p0+NJ-1 (at the block's length T) of one batch
// row, 8 channels, as F.avg_pool1d(kernel 3, stride 2, pad 1, count_include_pad)
// gives them: row p is the mean of raw rows 2p-1, 2p, 2p+1, those outside
// [0, t_in) counted as zero. `xc` points at the 8 channels of raw row 0. Rows
// outside [0, T), and rows from the n-th on, are zero. Each raw row is loaded
// once, 16 bytes a thread: row 2p+1 ends window p and starts window p+1.
template <int CIN, int NJ>
__device__ __forceinline__ void pool_rows(uint4 (&v)[NJ], const bf16* xc, int t_in, int p0,
                                          int T, int n) {
    auto raw = [&](int r, bool want) {
        return want && r >= 0 && r < t_in
            ? __ldg(reinterpret_cast<const uint4*>(xc + size_t(r) * CIN))
            : make_uint4(0u, 0u, 0u, 0u);
    };
    uint4 a = raw(2 * p0 - 1, n > 0 && p0 < T);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        const int p = p0 + j;
        // false only on a prefix (p < 0: raw row 2p+1 < 0, so the carry stays
        // zero) or a suffix of the run
        const bool want = j < n && p >= 0 && p < T;
        const uint4 m = raw(2 * p, want), c = raw(2 * p + 1, want);
        v[j] = want ? make_uint4(mean3_bf16x2(a.x, m.x, c.x), mean3_bf16x2(a.y, m.y, c.y),
                                 mean3_bf16x2(a.z, m.z, c.z), mean3_bf16x2(a.w, m.w, c.w))
                    : make_uint4(0u, 0u, 0u, 0u);
        a = c;
    }
}

struct Weights {
    const bf16* w1;
    const bf16* w2;
    const bf16* skw;
};

// One thread: x rows [r0-2, r0+M_ROWS) that lie in [0, T), one contiguous run of
// global memory, in one bulk copy to dense tile rows 0.. at `dst`; WIDE: one
// bulk copy a row, straight to the skewed pitch of the x tile at `dst`.
template <class C>
__device__ __forceinline__ void issue_x(const bf16* x, int b, int T, int r0, uint32_t dst,
                                        uint32_t xbar) {
    constexpr int ROW_BYTES = C::CIN_ * 2;
    const int g0 = max(r0 - 2, 0), g1 = min(r0 + C::M_ROWS, T);
    const uint32_t bytes = uint32_t(g1 - g0) * ROW_BYTES;
    mbar_expect_tx(xbar, bytes);
    const bf16* src = x + (size_t(b) * T + g0) * C::CIN_;
    if constexpr (C::WIDE) {
        for (int k = g0 - (r0 - 2); k < g1 - (r0 - 2); ++k, src += C::CIN_)
            bulk_g2s(dst + uint32_t(k) * C::XP * 2, src, ROW_BYTES, xbar);
    } else {
        bulk_g2s(dst + uint32_t(g0 - (r0 - 2)) * ROW_BYTES, src, bytes, xbar);
    }
}

// One thread: weight slice i (conv1's, then conv2's, then the 1x1 skip's) into
// ring stage i % STAGES.
template <class C>
__device__ __forceinline__ void issue_slice(int i, const Weights& w, uint32_t ring,
                                            uint32_t full0) {
    const size_t slice_elems = size_t(C::SLICE_BYTES) / 2;
    const int s = i % C::STAGES;
    const bf16* src = i < C::N1 ? w.w1 + i * slice_elems
                    : i < C::N1 + C::N2 ? w.w2 + (i - C::N1) * slice_elems
                    : w.skw + (i - C::N1 - C::N2) * slice_elems;
    mbar_expect_tx(full0 + 8 * s, C::SLICE_BYTES);
    bulk_g2s(ring + s * C::SLICE_BYTES, src, C::SLICE_BYTES, full0 + 8 * s);
}

// Waits for the next weight slice, runs its products, hands the buffer back.
// `b_off`: the bytes from a slice's start to this warpgroup's first column.
template <class C, int N>
__device__ __forceinline__ void consume(float (&acc)[N], int& slice, uint32_t full0,
                                        uint32_t empty0, uint32_t ring, int tid,
                                        const Weights& w, uint32_t a_addr, uint32_t b_off) {
    const int s = slice % C::STAGES;
    mbar_wait(full0 + 8 * s, (slice / C::STAGES) & 1);
    slice_products<2 * N>(acc, a_addr, ring + s * C::SLICE_BYTES + b_off);
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * s);
    if (tid == 0 && slice + C::STAGES < C::SLICES) {   // refill: thread 0 is the producer
        mbar_wait(empty0 + 8 * s, (slice / C::STAGES) & 1);
        issue_slice<C>(slice + C::STAGES, w, ring, full0);
    }
    ++slice;
}

// Grid (n_tiles, B), THREADS threads: two warpgroups, rows 0-63 and 64-127 of
// both convs (WIDE: rows 0-63 of both, columns 0-63 and 64-127); thread 0 also
// issues the bulk copies.
template <int CIN, int COUT, bool POOLED>
__global__ void __launch_bounds__(THREADS, Cfg<CIN, COUT>::CTAS)
resblock_eval_kernel(const bf16* __restrict__ x, const float* __restrict__ pre,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const float* __restrict__ bt,
                     const bf16* __restrict__ skw, bf16* __restrict__ y,
                     float* __restrict__ partial, int T, int t_in, int act, int pool) {
    using C = Cfg<CIN, COUT>;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sbase = smem_u32(smem);
    const uint32_t full0 = sbase + C::BARS, empty0 = full0 + 8 * C::STAGES;
    const uint32_t xbar = empty0 + 8 * C::STAGES;
    const uint32_t ring = sbase + C::RING;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int tile = blockIdx.x, n_tiles = gridDim.x, b = blockIdx.y;
    const int r0 = tile * C::R;

    if (tid == 0) {
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);              // the producer's expect_tx
            mbar_init(empty0 + 8 * s, THREADS / 32);  // one arrive a warp
        }
        mbar_init(xbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const Weights wts{w1, w2, skw};
    if (tid == 0) {
        if constexpr (!POOLED) issue_x<C>(x, b, T, r0, sbase + (C::WIDE ? C::XS : C::XD), xbar);
        for (int i = 0; i < C::STAGES && i < C::SLICES; ++i)
            issue_slice<C>(i, wts, ring, full0);
    }
    const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
    bf16* hy = reinterpret_cast<bf16*>(smem + C::HY);
    const uint32_t hy_addr = sbase + C::HY, xs_addr = sbase + C::XS, h_addr = sbase + C::H;
    int slice = 0;                      // running slice index, in the producer's order

    if constexpr (C::WIDE) {
        // h = x (no bn1 at the stack head): the x tile's rows outside [0, T),
        // which no copy fills, are zeroed
        constexpr int CHX = CIN / 8;
        for (int idx = tid; idx < C::X_ROWS * CHX; idx += THREADS) {
            const int k = idx / CHX, gr = r0 - 2 + k;
            if (gr < 0 || gr >= T)
                *reinterpret_cast<uint4*>(smem + C::XS + (k * C::XP + (idx % CHX) * 8) * 2) =
                    make_uint4(0u, 0u, 0u, 0u);
        }
        mbar_wait(xbar, 0);
    } else {
        // h = act(x*a1 + c1) (or x), zero outside [0, T), rounded to bf16, written
        // over the dense x at the skewed pitch; the 1x1 skip also keeps raw x there.
        constexpr int X_ROWS = C::X_ROWS;
        constexpr int CHX = CIN / 8, RSTEP = THREADS / CHX;
        constexpr int NJ = (X_ROWS + RSTEP - 1) / RSTEP;
        static_assert(THREADS % CHX == 0, "a thread's chunk is fixed");
        const int ch = tid % CHX, k0 = tid / CHX;
        float a1[8], c1[8];             // this thread's 8 channels of the affine
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            a1[e] = pre != nullptr ? pre[ch * 8 + e] : 1.f;
            c1[e] = pre != nullptr ? pre[CIN + ch * 8 + e] : 0.f;
        }
        auto h2 = [&](uint32_t w, int e) {
            return pack_bf16x2(act_fn(__fadd_rn(__fmul_rn(bf16_lo(w), a1[e]), c1[e]), act),
                               act_fn(__fadd_rn(__fmul_rn(bf16_hi(w), a1[e + 1]),
                                                c1[e + 1]), act));
        };
        uint4 v[NJ];
        // v[j] holds tile row kbase + j * KSTEP: rows RSTEP apart, or a run
        const int kbase = POOLED ? k0 * NJ : k0;
        constexpr int KSTEP = POOLED ? 1 : RSTEP;
        if constexpr (!POOLED) {
            mbar_wait(xbar, 0);
            const bf16* xd = reinterpret_cast<const bf16*>(smem + C::XD);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int k = k0 + j * RSTEP, gr = r0 - 2 + k;
                v[j] = make_uint4(0u, 0u, 0u, 0u);
                if (k < X_ROWS && gr >= 0 && gr < T)
                    v[j] = *reinterpret_cast<const uint4*>(xd + k * CIN + ch * 8);
            }
            __syncthreads();            // dense x is read: the skewed tiles may overwrite it
        } else {                        // a run of NJ rows a thread, pooled from raw x
            pool_rows<CIN>(v, x + size_t(b) * t_in * CIN + ch * 8, t_in, r0 - 2 + kbase, T,
                           X_ROWS - kbase);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int k = kbase + j * KSTEP, gr = r0 - 2 + k;
            if (k < X_ROWS) {
                if constexpr (C::SKIP) {
                    *reinterpret_cast<uint4*>(smem + C::XS + (k * C::XP + ch * 8) * 2) = v[j];
                } else if constexpr (POOLED) {
                    // this tile's own rows of pooled x, for the identity skip of the
                    // last pass: kept in y, which the last pass overwrites
                    if (k >= 2 && k < C::R + 2 && gr < T)
                        *reinterpret_cast<uint4*>(y + (size_t(b) * T + gr) * COUT + ch * 8) =
                            v[j];
                }
                uint4 h = v[j];
                if (pre != nullptr && gr >= 0 && gr < T)
                    h = make_uint4(h2(h.x, 0), h2(h.y, 2), h2(h.z, 4), h2(h.w, 6));
                *reinterpret_cast<uint4*>(hy + k * C::XP + ch * 8) = h;
            }
        }
    }
    __syncthreads();

    // This warpgroup's first row and column, this lane's ldmatrix row (output
    // row of the warpgroup's 64) and k offset.
    constexpr int NW = C::NW;
    const int row0 = C::WIDE ? 0 : wg * 64, col0 = C::WIDE ? wg * NW : 0;
    const uint32_t b_off = uint32_t(col0) * KC * 2;    // (col0 / 8) core-matrix rows of 1 KB
    const int arow = row0 + wi * 16 + (lane & 15);
    const int acol = (lane >> 4) * 8;
    float acc[NW / 2];

    // ---- conv1: y1 row j (global r0-1+j) reads h rows j+d, d = 0..2.
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
    for (int d = 0; d < 3; ++d)
        for (int kc = 0; kc < CIN; kc += KC)
            consume<C>(acc, slice, full0, empty0, ring, tid, wts,
                       h_addr + ((arow + d) * C::XP + kc + acol) * 2, b_off);
    __syncthreads();                // every warp is done reading h: y1 may overwrite it
#pragma unroll
    for (int jj = 0; jj < NW / 8; ++jj) {
        const int col = col0 + jj * 8 + 2 * t;
        const float c0 = b1[col], c1 = b1[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int j = row0 + wi * 16 + g + 8 * hf;
            const int gr = r0 - 1 + j;
            float v0 = act_fn(__fadd_rn(acc[4 * jj + 2 * hf], c0), act);
            float v1 = act_fn(__fadd_rn(acc[4 * jj + 2 * hf + 1], c1), act);
            if (gr < 0 || gr >= T) v0 = v1 = 0.f;
            *reinterpret_cast<uint32_t*>(hy + j * C::YP + col) = pack_bf16x2(v0, v1);
        }
    }
    for (int idx = tid; idx < 2 * C::CH; idx += THREADS)     // spare rows M_ROWS, +1
        *reinterpret_cast<uint4*>(hy + (C::M_ROWS + idx / C::CH) * C::YP + (idx % C::CH) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();

    // ---- conv2: out row i (global r0+i) reads y1 rows i+d; the 1x1 skip reads
    // ---- x row i (tile row i+2) into the same accumulators.
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
    for (int d = 0; d < 3; ++d)
        for (int kc = 0; kc < COUT; kc += KC)
            consume<C>(acc, slice, full0, empty0, ring, tid, wts,
                       hy_addr + ((arow + d) * C::YP + kc + acol) * 2, b_off);
    if constexpr (C::SKIP)
        for (int kc = 0; kc < CIN; kc += KC)
            consume<C>(acc, slice, full0, empty0, ring, tid, wts,
                       xs_addr + ((arow + 2) * C::XP + kc + acol) * 2, b_off);
    __syncthreads();                // the tiles and the ring are dead: stage over them

    // acc + bt -> f32 stage, rows 0 .. R-1 (the identity skip is added below)
    float* stg = reinterpret_cast<float*>(smem + C::STG);
#pragma unroll
    for (int jj = 0; jj < NW / 8; ++jj) {
        const int col = col0 + jj * 8 + 2 * t;
        const float c0 = bt[col], c1 = bt[col + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int i = row0 + wi * 16 + g + 8 * hf;
            if (i < C::R)
                *reinterpret_cast<float2*>(stg + i * C::SP + col) =
                    make_float2(__fadd_rn(acc[4 * jj + 2 * hf], c0),
                                __fadd_rn(acc[4 * jj + 2 * hf + 1], c1));
        }
    }
    // ---- last pass: out = stage (+ x), MaxPool3 or not, y as 16-byte vectors
    // ---- and the tile's channel sums. Thread (rg, ch) owns channels ch*8 ..
    // ---- ch*8+7 of rows (or windows) rg, rg+NRG, ...; the identity skip's x
    // ---- rows (fetched into L2 by the tile's bulk copy) are loaded first.
    const int ch = tid % C::CH, rg = tid / C::CH;
    const int t_out = T / pool;
    constexpr int NXR = C::SKIP ? 1 : (C::RPT > 3 * C::WPT ? C::RPT : 3 * C::WPT);
    uint4 xr[NXR];
    if constexpr (!C::SKIP) {
        // pooled: the rows the load phase kept in y, read from L2
        const bf16* xb = (POOLED ? y : x) + (size_t(b) * T + r0) * CIN + ch * 8;
#pragma unroll
        for (int j = 0; j < NXR; ++j) {
            const int i = pool == 1 ? rg + j * C::NRG : 3 * (rg + (j / 3) * C::NRG) + j % 3;
            xr[j] = make_uint4(0u, 0u, 0u, 0u);
            if (i < C::R && r0 + i < T) {
                const uint4* src = reinterpret_cast<const uint4*>(xb + size_t(i) * CIN);
                xr[j] = POOLED ? __ldcg(src) : *src;
            }
        }
    }
    __syncthreads();
    bf16* yb = y + size_t(b) * t_out * COUT + ch * 8;
    auto out8 = [&](float (&v)[8], int i, const uint4& xv) {    // out row i of the tile
        load8(v, stg + i * C::SP + ch * 8);
        if constexpr (!C::SKIP) {
            const uint32_t w[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                v[2 * q] = __fadd_rn(v[2 * q], bf16_lo(w[q]));
                v[2 * q + 1] = __fadd_rn(v[2 * q + 1], bf16_hi(w[q]));
            }
        }
    };
    float s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = 0.f;
    if (pool == 1) {
#pragma unroll
        for (int j = 0; j < C::RPT; ++j) {
            const int i = rg + j * C::NRG;
            if (i < C::R && r0 + i < T) {
                float v[8];
                out8(v, i, xr[C::SKIP ? 0 : j]);
                emit(v, s, yb + size_t(r0 + i) * COUT);
            }
        }
    } else {                        // window p covers rows 3p .. 3p+2; r0 % 3 == 0
#pragma unroll
        for (int j = 0; j < C::WPT; ++j) {
            const int p = rg + j * C::NRG;
            if (p < C::R / 3 && r0 / 3 + p < t_out) {
                float v[8], u[8];
                out8(v, 3 * p, xr[C::SKIP ? 0 : 3 * j]);
                out8(u, 3 * p + 1, xr[C::SKIP ? 0 : 3 * j + 1]);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], u[e]);
                out8(u, 3 * p + 2, xr[C::SKIP ? 0 : 3 * j + 2]);
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], u[e]);
                emit(v, s, yb + size_t(r0 / 3 + p) * COUT);
            }
        }
    }
    float* red = reinterpret_cast<float*>(smem + C::RED);
#pragma unroll
    for (int e = 0; e < 8; ++e) red[rg * COUT + ch * 8 + e] = s[e];
    __syncthreads();
    if (tid < COUT) {               // row groups added in order: deterministic
        float sum = 0.f;
        for (int r = 0; r < C::NRG; ++r) sum += red[r * COUT + tid];
        partial[(size_t(b) * n_tiles + tile) * COUT + tid] = sum;
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

template <int CIN, int COUT, bool POOLED>
cudaError_t set_smem() {
    return cudaFuncSetAttribute(resblock_eval_kernel<CIN, COUT, POOLED>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Cfg<CIN, COUT>::TOTAL);
}

template <int CIN, int COUT, bool POOLED = false>
cudaError_t launch(const void* x, const void* pre, const void* w1, const void* b1,
                   const void* w2, const void* bt, const void* skw, void* y, void* partial,
                   int bsz, int T, int t_in, int stride, int act, int pool,
                   cudaStream_t s) {
    // stride 2 runs the instantiation that pools on load (no wide stack head does)
    if constexpr (!POOLED && !Cfg<CIN, COUT>::WIDE) {
        if (stride == 2)
            return launch<CIN, COUT, true>(x, pre, w1, b1, w2, bt, skw, y, partial, bsz, T,
                                           t_in, stride, act, pool, s);
    }
    cudaError_t err = set_smem<CIN, COUT, POOLED>();
    if (err != cudaSuccess) return err;
    resblock_eval_kernel<CIN, COUT, POOLED>
        <<<dim3((T + Cfg<CIN, COUT>::R - 1) / Cfg<CIN, COUT>::R, bsz), THREADS,
           Cfg<CIN, COUT>::TOTAL, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(pre),
        static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(bt),
        static_cast<const bf16*>(skw), static_cast<bf16*>(y),
        static_cast<float*>(partial), T, t_in, act, pool);
    return cudaGetLastError();
}

// The instantiation's figures: rows a tile, shared memory a CTA, threads, CTAs
// an SM (the occupancy calculator; the fewer of the two loads where the shape
// also pools on load), weight bytes a tile, ring stages.
template <int CIN, int COUT>
cudaError_t config(int* info) {
    using C = Cfg<CIN, COUT>;
    cudaError_t err = set_smem<CIN, COUT, false>();
    if (err != cudaSuccess) return err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, resblock_eval_kernel<CIN, COUT, false>, THREADS, C::TOTAL);
    if constexpr (!C::WIDE) {
        int pooled = 0;
        if (err == cudaSuccess) err = set_smem<CIN, COUT, true>();
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &pooled, resblock_eval_kernel<CIN, COUT, true>, THREADS, C::TOTAL);
        ctas = pooled < ctas ? pooled : ctas;
    }
    info[0] = C::R;
    info[1] = C::TOTAL;
    info[2] = THREADS;
    info[3] = ctas;
    info[4] = C::WEIGHT_BYTES;
    info[5] = C::STAGES;
    return err;
}

// The five (Cin, Cout, skip) the models use: 0 .. 4; -1 for anything else.
// 3 and 4 are the wide stack heads (maze2's 768 -> 128, maze6's 1024 -> 128).
int variant(int cin, int cout, bool skip) {
    if (cin == 128 && cout == 128 && !skip) return 0;
    if (cin == 128 && cout == 256 && skip) return 1;
    if (cin == 256 && cout == 256 && !skip) return 2;
    if (cin == 768 && cout == 128 && skip) return 3;
    if (cin == 1024 && cout == 128 && skip) return 4;
    return -1;
}

// Output rows a tile of each variant.
constexpr int ROWS[5] = {Cfg<128, 128>::R, Cfg<128, 256>::R, Cfg<256, 256>::R,
                         Cfg<768, 128>::R, Cfg<1024, 128>::R};

}  // namespace

// Output rows a tile of the (cin, cout, skip) instantiation; -1 if there is none.
extern "C" int resblock_eval_rows(int cin, int cout, int skip) {
    const int v = variant(cin, cout, skip != 0);
    return v < 0 ? -1 : ROWS[v];
}

// Fills info[0..5] (see config) for the (cin, cout, skip) instantiation on
// `device`; returns a CUDA error code (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int resblock_eval_config(int cin, int cout, int skip, int device, int* info) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    switch (variant(cin, cout, skip != 0)) {
        case 0: return int(config<128, 128>(info));
        case 1: return int(config<128, 256>(info));
        case 2: return int(config<256, 256>(info));
        case 3: return int(config<768, 128>(info));
        case 4: return int(config<1024, 128>(info));
        default: return int(cudaErrorInvalidValue);
    }
}

// Launches K1 and its sum reduction on `stream`; returns cudaGetLastError().
// x (B,T,Cin) bf16; pre (2,Cin) f32 or null; w1, w2 and skw bf16 in the
// kernel's slice layout (ops/resblock_fused.py:kernel_weight_layout) of
// (3,Cin,Cout), (3,Cout,Cout) and (Cin,Cout), skw null for the identity skip;
// b1, bt (Cout) f32; y (B,T'/pool,Cout) bf16; partial (B,ceil(T'/R),Cout) f32
// scratch; sums (B,Cout) f32, where T' = ceil(T/stride): at stride 2 the block
// body runs on x pooled by AvgPool(3, 2, pad 1), which the kernel forms as it
// loads x. (Cin, Cout, skip) is (128, 128, identity), (128, 256, 1x1),
// (256, 256, identity), or a stack head (768 or 1024, 128, 1x1) with pre null,
// pool 1 and stride 1. act 0 = ReLU, 1 = LeakyReLU(0.3); pool 1 or 3; stride 1,
// or 2 with pool 1; device = the CUDA device index.
extern "C" int resblock_eval_launch(const void* x, const void* pre, const void* w1,
                                    const void* b1, const void* w2, const void* bt,
                                    const void* skw, void* y, void* partial, void* sums,
                                    int bsz, int T, int cin, int cout, int act,
                                    int pool, int stride, int device, void* stream) {
    const int v = variant(cin, cout, skw != nullptr);
    if (v < 0 || bsz <= 0 || T < pool || (pool != 1 && pool != 3) ||
        (act != 0 && act != 1) || bsz > 65535 || (stride != 1 && stride != 2) ||
        (stride == 2 && pool != 1) ||
        (v >= 3 && (pre != nullptr || pool != 1 || stride != 1)))
        return int(cudaErrorInvalidValue);
    // this library links its own CUDA runtime: select the caller's device
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return int(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int tb = (T + stride - 1) / stride;     // the block's rows
    if (v == 0)
        err = launch<128, 128>(x, pre, w1, b1, w2, bt, skw, y, partial, bsz, tb, T, stride,
                               act, pool, s);
    else if (v == 1)
        err = launch<128, 256>(x, pre, w1, b1, w2, bt, skw, y, partial, bsz, tb, T, stride,
                               act, pool, s);
    else if (v == 2)
        err = launch<256, 256>(x, pre, w1, b1, w2, bt, skw, y, partial, bsz, tb, T, stride,
                               act, pool, s);
    else if (v == 3)
        err = launch<768, 128>(x, pre, w1, b1, w2, bt, skw, y, partial, bsz, tb, T, stride,
                               act, pool, s);
    else
        err = launch<1024, 128>(x, pre, w1, b1, w2, bt, skw, y, partial, bsz, tb, T, stride,
                                act, pool, s);
    if (err != cudaSuccess) return int(err);
    const int n_tiles = (tb + ROWS[v] - 1) / ROWS[v], n = bsz * cout;
    reduce_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(sums), bsz, n_tiles, cout);
    return int(cudaGetLastError());
}
