// Panel kernels of the right-looking blocked Cholesky factor (NB = 128), in
// place in a copy T of the matrix:
//
//   per panel k, o = k NB:
//     L_kk, W_k = diag_factor_inv(T[o:o+NB, o:o+NB])     factor_panels.cu, with
//                                                        the untransposed output
//     T[i, k]   = T[i, k] W_k^T           i > k          ipx_right_trsm
//     T[i, j]  -= T[i, k] T[j, k]^T       i >= j > k     ipx_right_update
//
// (tiles of NB x NB, T[i, j] the tile at rows i NB, columns j NB).  At the
// end T holds L with its strict upper triangle exactly zero, and W the
// inverses of L's diagonal blocks.
//
// Replaces the Pallas kernel _cholesky_panel_kernel of ipx/kernels/cholesky.py
// (entry cholesky_batched), a grid over panels whose body holds the diagonal
// chain, the panel TRSM as a product with W_k^T and the trailing update: here
// they are three launches a panel.
//
// Not kept from the TPU kernel: its update of whole column stripes (it cannot
// slice; here only the tiles on and below the block diagonal of the trailing
// matrix are updated, which halves the work), the chunking of the batch by
// fast-memory size, and the copy slots.
//
// Bound on this card: operations, m^3 / 6 FMAs an instance plus the block
// inverses, against the matrix read once and the factor written once; both
// operands are float32, so on the bf16 tensor cores an f32-faithful product
// takes six passes (0.56 ms at B = 256, m = 1024; 1.39 ms as float32 FMAs on
// the CUDA cores).
//
// Design.  Both launches run one body, tile_product below: one block of 8
// warps per 128 x 128 output tile, grid (tiles, instances), out = X Y^T with
// X and Y two row-major 128 x 128 float32 blocks (TRSM: T[i, k] and W_k;
// update: T[i, k] and T[j, k]).  The contraction runs in chunks of 16
// columns through a ring of two cp.async stages; at each chunk the block
// splits both raw operands exactly into hi + mid + lo bf16 tiles
// (mma_common.cuh) and the warps take six of the nine cross products
// (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid; the rest lie below 2^-24
// of the product) with mma.sync m16n8k16, ldmatrix-fed, as the prior-panel
// subtraction of fused_panel.cu does.  Warp (wm, wn) owns rows 32 wm .. +32
// and columns 64 wn .. +64 of the tile.  Two blocks share an SM (70 KB of
// shared memory and 128 registers a thread each, a few spilled), so one
// block's split, barriers and epilogue overlap the other's MMAs.  Measured
// on an H100 (probes/right_variants.py, PERF.md row 9), this shape beats one
// block an SM with 32-column chunks and three stages at 255 registers, whose
// time moved by a quarter with changes that left its instruction counts
// alone.
//
// Summation, part of the function (ROADMAP.md, "Rules").  Every MMA starts
// from a zero accumulator and sums only its own 16 products; its result is
// added to the tile's run with an IEEE add (mma_add), the run being the whole
// 128-term product.  The update subtracts the run from the tile once, so each
// trailing entry is rounded to float32 once per panel: that is the function.
// The diagonal of an update's diagonal tile (i == j) is a sum of squares,
// all of one sign, where the tensor cores' truncation towards zero inside
// each MMA adds up to a bias (PERF.md, row 4): those 128 entries are summed
// on the CUDA cores while the block splits its chunks (chains of 8 FMAs, a
// fixed tree over the 2 threads of a row, then the chunks in order) and
// subtracted in place of the tensor cores' value.  The TRSM's products have
// mixed signs and stay on the tensor cores; it zeroes the mirror tile
// T[k, i], so L's strict upper triangle is exactly 0.
//
// An instance gets the same bits at any B: nothing depends on B and there are
// no atomics.  Shapes: m a multiple of 128 (the caller pads).

#include "mma_common.cuh"
#include "panel_common.cuh"

namespace {

using namespace ipx_tile;   // TILE
using namespace ipx_mma;    // mma_add, the split, the ring

constexpr int RT = 256;             // threads: 8 warps, 4 (rows) x 2 (columns)
constexpr int RCK = 16;             // contraction chunk: 16 columns
constexpr int RLD = RCK + 8;        // bf16 row stride of a split tile
constexpr int RSTAGES = 2;          // raw stages in the ring
constexpr int RBLOCKS = 2;          // blocks an SM: 128 registers a thread
constexpr int GPR = RCK / 4;        // 16-byte granules of a raw operand row
constexpr int IPR = RCK / 8;        // threads splitting one row of a chunk

constexpr size_t RAW_B = size_t(TILE) * RCK * 4;               // one operand
constexpr size_t RSTAGE_B = 2 * RAW_B;                         // X and Y
constexpr size_t RSPLIT_B = size_t(TILE) * RLD * 2;            // one part
constexpr size_t RIGHT_SMEM = RSTAGES * RSTAGE_B + 6 * RSPLIT_B
    + TILE * sizeof(float);                                    // 70144
static_assert(TILE % RCK == 0 && RCK % 16 == 0,
              "the contraction is whole chunks of whole MMA steps");
static_assert(2 * TILE * RCK / 8 % RT == 0 && 32 % IPR == 0,
              "a chunk splits in whole passes, a row's threads in one warp");
static_assert(RBLOCKS * (RIGHT_SMEM + 1024) <= 228 * 1024,
              "the blocks an SM that the launch bounds count on fit");

// out = X Y^T over 128 terms on the tensor cores, into run (the warp's
// fragments); with DIAG, dsum[r] = sum_p X[r][p]^2 on the CUDA cores.  X and Y
// are row-major blocks with row strides ldx and ldy (floats, multiples of 4,
// 16-byte aligned).  All threads of the block call it; it ends after a
// barrier, so X and Y may be overwritten afterwards.
template <bool DIAG>
__device__ __forceinline__ void tile_product(
        const float* X, size_t ldx, const float* Y, size_t ldy,
        unsigned char* sm, float* dsum, Frag& run) {
    unsigned char* split = sm + RSTAGES * RSTAGE_B;
    const bf16* S = reinterpret_cast<const bf16*>(split);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 3, wn = warp >> 2;
    zero_frag(run);
    // entry r of dsum is only ever touched by the thread that converts row r
    // of X (tid / IPR + u RT / IPR, tid % IPR == 0)
    if (DIAG && tid % IPR == 0)
        for (int r = tid / IPR; r < TILE; r += RT / IPR) dsum[r] = 0.f;

    auto issue = [&](int c) {
        if (c < TILE / RCK) {
            float* rx = reinterpret_cast<float*>(sm + (c % RSTAGES) * RSTAGE_B);
            float* ry = rx + TILE * RCK;
            const int c0 = c * RCK;
            for (int e = tid; e < TILE * GPR; e += RT) {
                const int r = e / GPR, s4 = (e % GPR) * 4;
                cp16(rx + r * RCK + s4, X + size_t(r) * ldx + c0 + s4);
                cp16(ry + r * RCK + s4, Y + size_t(r) * ldy + c0 + s4);
            }
        }
        cp_commit();
    };
    auto convert = [&](int c) {
        const float* raw = reinterpret_cast<const float*>(
            sm + (c % RSTAGES) * RSTAGE_B);
        bf16* dst = reinterpret_cast<bf16*>(split);
        // operand u (0: X, 1: Y), split part s at dst + (3 u + s) tile
        for (int e = tid; e < 2 * TILE * RCK / 8; e += RT) {
            const int u = e / (TILE * RCK / 8), f = e % (TILE * RCK / 8);
            const int r = f / IPR, s8 = (f % IPR) * 8;
            const float* src = raw + u * TILE * RCK + r * RCK + s8;
            const float4 x0 = *reinterpret_cast<const float4*>(src);
            const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
            const float x[8] = {x0.x, x0.y, x0.z, x0.w,
                                x1.x, x1.y, x1.z, x1.w};
            if (DIAG && u == 0) {
                float dp = 0.f;
#pragma unroll
                for (int i = 0; i < 8; ++i) dp = __fmaf_rn(x[i], x[i], dp);
#pragma unroll
                for (int o = 1; o < IPR; o <<= 1)
                    dp = __fadd_rn(dp, __shfl_xor_sync(0xffffffffu, dp, o));
                if (tid % IPR == 0) dsum[r] = __fadd_rn(dsum[r], dp);
            }
            uint4 h, md, l;
            split8(x, h, md, l);
            bf16* at = dst + 3 * u * TILE * RLD + r * RLD + s8;
            *reinterpret_cast<uint4*>(at) = h;
            *reinterpret_cast<uint4*>(at + TILE * RLD) = md;
            *reinterpret_cast<uint4*>(at + 2 * TILE * RLD) = l;
        }
    };
    auto multiply = [&](int) {
#pragma unroll
        for (int kk = 0; kk < RCK; kk += 16) {
            unsigned a[3][2][4];
#pragma unroll
            for (int s = 0; s < 3; ++s)
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
                    ldm_x4<false>(a[s][mi],
                                  S + s * TILE * RLD
                                    + (wm * 32 + mi * 16 + (lane & 15)) * RLD
                                    + kk + (lane >> 4) * 8);
#pragma unroll
            for (int nj = 0; nj < 4; ++nj) {
                const bf16* yb = S + 3 * TILE * RLD
                    + (wn * 64 + nj * 16 + (lane & 7) + ((lane >> 4) << 3))
                      * RLD
                    + kk + ((lane >> 3) & 1) * 8;
                // Y's hi, mid, lo: with X's hi, mid, lo; hi, mid; hi
#pragma unroll
                for (int sy = 0; sy < 3; ++sy) {
                    unsigned bb[4];
                    ldm_x4<false>(bb, yb + sy * TILE * RLD);
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                        for (int sx = 0; sx < 3 - sy; ++sx)
#pragma unroll
                            for (int h = 0; h < 2; ++h)
                                mma_add(run[mi][2 * nj + h], a[sx][mi],
                                        bb[2 * h], bb[2 * h + 1]);
                }
            }
        }
    };
    ring<RSTAGES>(TILE / RCK, issue, convert, multiply);
}

// Block (x, b): row tile i = k + 1 + x of instance b.  T[i, k] = T[i, k] W_k^T
// in place, and the mirror tile T[k, i] above the block diagonal is zeroed.
__global__ void __launch_bounds__(RT, RBLOCKS)
trsm_cols_kernel(float* T, const float* __restrict__ W, int m, int k) {
    extern __shared__ __align__(128) unsigned char sm[];
    const int i = k + 1 + blockIdx.x;
    const size_t b = blockIdx.y;
    const int nb = m / TILE, tid = threadIdx.x, lane = tid & 31;
    const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, q = lane & 3;        // fragment row, column pair
    float* Tb = T + b * size_t(m) * m;
    float* tile = Tb + size_t(i) * TILE * m + size_t(k) * TILE;
    float* mirror = Tb + size_t(k) * TILE * m + size_t(i) * TILE;

    Frag run;
    // out[r][c] = sum_p T[r][p] W[c][p]
    tile_product<false>(tile, m, W + (b * nb + k) * size_t(TILE) * TILE,
                        TILE, sm, nullptr, run);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mi * 16 + g + 8 * h;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                const int c = wn * 64 + ni * 8 + 2 * q;
                *reinterpret_cast<float2*>(tile + size_t(r) * m + c) =
                    make_float2(run[mi][ni][2 * h], run[mi][ni][2 * h + 1]);
            }
        }
    for (int e = tid; e < TILE * TILE / 4; e += RT) {
        const int r = e >> 5, c4 = (e & 31) * 4;
        *reinterpret_cast<float4*>(mirror + size_t(r) * m + c4) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// Block (x, b): x counts the tiles on and below the block diagonal of the
// trailing matrix row by row, x = ii (ii + 1) / 2 + jj with ii >= jj;
// T[i, j] -= T[i, k] T[j, k]^T for i = k + 1 + ii, j = k + 1 + jj.
__global__ void __launch_bounds__(RT, RBLOCKS)
syrk_lower_kernel(float* T, int m, int k) {
    extern __shared__ __align__(128) unsigned char sm[];
    float* dsum = reinterpret_cast<float*>(sm + RSTAGES * RSTAGE_B
                                           + 6 * RSPLIT_B);
    int ii = 0;
    while ((ii + 1) * (ii + 2) / 2 <= int(blockIdx.x)) ++ii;
    const int jj = int(blockIdx.x) - ii * (ii + 1) / 2;
    const int i = k + 1 + ii, j = k + 1 + jj;
    const size_t b = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31;
    const int warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, q = lane & 3;        // fragment row, column pair
    float* Tb = T + b * size_t(m) * m;
    const float* Pi = Tb + size_t(i) * TILE * m + size_t(k) * TILE;
    const float* Pj = Tb + size_t(j) * TILE * m + size_t(k) * TILE;
    float* tile = Tb + size_t(i) * TILE * m + size_t(j) * TILE;

    Frag run;
    // out[r][c] = sum_p P_i[r][p] P_j[c][p]; on the diagonal from the CUDA
    // cores where i == j
    if (i == j)
        tile_product<true>(Pi, m, Pj, m, sm, dsum, run);
    else
        tile_product<false>(Pi, m, Pj, m, sm, nullptr, run);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mi * 16 + g + 8 * h;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                const int c = wn * 64 + ni * 8 + 2 * q;
                float2* at = reinterpret_cast<float2*>(tile + size_t(r) * m
                                                       + c);
                const float2 s = *at;
                float u0 = run[mi][ni][2 * h], u1 = run[mi][ni][2 * h + 1];
                if (i == j && r == c) u0 = dsum[r];
                if (i == j && r == c + 1) u1 = dsum[r];
                *at = make_float2(__fsub_rn(s.x, u0), __fsub_rn(s.y, u1));
            }
        }
}

bool args_ok(const float* T, int B, int m, int k) {
    return B >= 1 && B <= 65535 && m >= 2 * TILE && m % TILE == 0 && k >= 0
        && k < m / TILE - 1 && reinterpret_cast<uintptr_t>(T) % 16 == 0;
}

template <typename K>
cudaError_t allow_smem(K kern) {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(RIGHT_SMEM));
}

}  // namespace

// Panel k (not the last) of the right-looking factor in T (B, m, m) f32, whose
// tile (k, k) already holds L_kk: the tiles below it become T[i, k] W_k^T with
// W (B, m / 128, 128, 128), the tiles right of it zero.
// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int ipx_right_trsm(float* T, const float* W, int B, int m, int k,
                              void* stream) {
    if (!args_ok(T, B, m, k) || reinterpret_cast<uintptr_t>(W) % 16 != 0)
        return -1;
    cudaError_t err = allow_smem(trsm_cols_kernel);
    if (err != cudaSuccess) return int(err);
    dim3 grid(m / TILE - k - 1, B);
    trsm_cols_kernel<<<grid, RT, RIGHT_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(T, W, m, k);
    return int(cudaGetLastError());
}

// The trailing update of panel k (not the last): every tile (i, j), i >= j > k,
// less T[i, k] T[j, k]^T.
extern "C" int ipx_right_update(float* T, int B, int m, int k, void* stream) {
    if (!args_ok(T, B, m, k)) return -1;
    cudaError_t err = allow_smem(syrk_lower_kernel);
    if (err != cudaSuccess) return int(err);
    const int r = m / TILE - k - 1;
    dim3 grid(r * (r + 1) / 2, B);
    syrk_lower_kernel<<<grid, RT, RIGHT_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(T, m, k);
    return int(cudaGetLastError());
}
