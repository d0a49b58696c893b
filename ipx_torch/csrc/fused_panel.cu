// The panel stage of the fused assemble+factor (factor_fused_panels), on the
// tensor cores.  Per 128-row panel k of the left-looking factor it writes
//
//   C_k = J_r (A_k * d2) A_{k:}^T J_c  +  reg on the diagonal of its first tile
//         - sum_{j<k} P_j[:, lo : lo + NB]^T P_j[:, lo:],   lo = (k - j) NB,
//
// C_k (B, NB, m - k NB), from the bf16-stored A (B, m, n), d2 (B, n), the
// Jacobi scale j (B, m), reg (B,) and the k prior panels P_j (B, NB, m - j NB)
// f32.  The scaled, regularised normal matrix is never written.
//
// Replaces the Pallas kernel _fused_panel_kernel of ipx/kernels/cholesky.py
// (entry factor_fused_panels), whose assembly runs on the TPU's matrix unit
// with an exact 3-way bf16 split of the f32 row operand; this kernel does the
// same on Hopper's tensor cores (mma.sync m16n8k16, bf16 in, f32 sums).
//
// The split is exact.  The row operand x = f32(A_k * d2) is cut into
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which add up to x
// (three 8-bit significands with their signs cover float32's 24 bits).  The
// column operand is A's bf16 rows as stored, so every partial product
// hi * a, mid * a, lo * a is exact in float32: the products are those of the
// float32 FMAs the CUDA cores would do, and only the order of the sums is
// the tensor cores'.  The prior-panel subtraction has two f32 operands; each
// is split the same way and six of the nine cross products are taken
// (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid; the three left out are
// below 2^-24 of the product).
//
// Summation order, part of the function (ROADMAP.md, "Rules").  A tensor
// core aligns the products of one MMA to the largest and truncates what falls
// below, always towards zero, so every MMA here starts from a fresh (zero)
// accumulator and sums only its own 16 products; its result is added with an
// IEEE add.  The assembly adds them into a run per 64-column chunk (4 k-steps
// x 3 split passes, in that order) and the chunk runs into a float32 total,
// as the CUDA-core kernels do.  The subtraction adds them into a run per
// prior panel (128 terms: 8 k-steps x 6 products), the panel runs into a
// total of their own, and subtracts that total from the start tile once.
// Runs chained through the MMA accumulator instead (one per chunk, one per
// panel) lose a truncation on every MMA; on the subtraction that left 4 of 64
// lanes OPTIMAL in probes/norescue_gpu.py's batch (PERF.md, PR 4).
//
// Bound on this card: operations.  The assembly is m (m + 1) / 2 * n products
// an instance, three bf16 passes each at the tensor-core rate; the
// subtraction NB^3 sum_k k (nb - k), six passes.  Against that stand A's row
// blocks (block t is read once for every panel k <= t) and the prior panels.
//
// Design.  Grid (column tile t = k .. nb - 1, instance), one block of 8 warps
// per 128 x 128 tile of C_k; the blocks of one instance are adjacent, so the
// row block A_k that they all read comes from L2.  Warp (wm, wn) owns rows
// 32 wm .. +32 and columns 64 wn .. +64 of the tile: 2 x 8 MMA tiles, a chunk
// accumulator and a total in registers.  The operands pass through a ring of
// RSTAGES raw stages that cp.async fills three chunks ahead; at each chunk
// the block splits the raw row operand (or, in the subtraction, both raw f32
// operands) into bf16 tiles that ldmatrix reads without bank conflicts (rows
// padded by 16 bytes), then the warps multiply.  An instance gets the same
// bits alone as in a batch: nothing depends on B.
//
// Shapes: m and n multiples of 128, A, d2 and the panels 16-byte aligned.

#include "mma_common.cuh"
#include "panel_common.cuh"

namespace {

using namespace ipx_tile;
using namespace ipx_mma;   // mma_add, the split, the ring

constexpr int FT = 256;             // threads: 8 warps, 4 (rows) x 2 (columns)
constexpr int CK = KC;              // assembly chunk: 64 columns of A
constexpr int ALD = CK + 8;         // bf16 row stride of a [row][k] tile
constexpr int SK = 32;              // subtraction chunk: 32 rows of a panel
constexpr int SLD = TILE + 8;       // bf16 row stride of a [k][row] tile
constexpr int RSTAGES = 4;          // raw stages in the ring

constexpr size_t A_TILE_B = size_t(TILE) * ALD * 2;            // 18432
constexpr size_t RX_B = size_t(TILE) * CK * 2;                 // A_k chunk
constexpr size_t RSTAGE_B = RX_B + A_TILE_B + CK * 4;          // + Y + d2
constexpr size_t S_TILE_B = size_t(SK) * SLD * 2;              // 8704
static_assert(2 * size_t(SK) * TILE * 4 <= RSTAGE_B,
              "a raw stage holds a subtraction chunk");
static_assert(6 * S_TILE_B <= 3 * A_TILE_B,
              "the split tiles of both phases share one region");
static_assert(FT == 2 * TILE, "two threads a column of the diagonal");
constexpr size_t DIAG_B = size_t(FT) * 4;   // a diagonal's sums, two halves
constexpr size_t FUSED_SMEM = RSTAGES * RSTAGE_B + 3 * A_TILE_B
    + 2 * DIAG_B;                                      // 197632

__global__ void __launch_bounds__(FT, 1)
fused_panel_kernel(const bf16* __restrict__ A, const float* __restrict__ d2,
                   const float* __restrict__ jv, const float* __restrict__ reg,
                   PanelRows prior, float* C, int m, int n, int k) {
    extern __shared__ __align__(128) unsigned char sm[];
    unsigned char* split = sm + RSTAGES * RSTAGE_B;
    // the diagonal of the first tile (t == k) on the CUDA cores: the
    // assembly's (its second half zero) and the subtraction's in two halves
    float* dasm = reinterpret_cast<float*>(split + 3 * A_TILE_B);
    float* dsub = dasm + FT;

    const int t = k + blockIdx.x;                 // column tile of M
    const size_t b = blockIdx.y;
    const int o = k * TILE, w = m - o;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, q = lane & 3;        // fragment row, column pair
    float* Cb = C + b * size_t(TILE) * w + size_t(t - k) * TILE;

    const bool diag = t == k;
    Frag tot, run;
    zero_frag(tot);
    // entry r of dasm is only ever touched by the thread that converts row r
    // (tid / 8 + 32 u, tid % 8 == 0)
    if (diag && (tid & 7) == 0)
        for (int r = tid >> 3; r < TILE; r += FT / 8) {
            dasm[r] = 0.f;
            dasm[TILE + r] = 0.f;
        }

    // ---- assembly: sum_c x[r, c] a[col, c] over 64-column chunks ----------
    {
        const bf16* Xg = A + (b * m + o) * size_t(n);
        const bf16* Yg = A + (b * m + size_t(t) * TILE) * size_t(n);
        const float* d2b = d2 + b * size_t(n);
        const bf16* S = reinterpret_cast<const bf16*>(split);

        auto issue = [&](int c) {
            if (c < n / CK) {
                unsigned char* st = sm + (c % RSTAGES) * RSTAGE_B;
                bf16* rx = reinterpret_cast<bf16*>(st);
                bf16* ys = reinterpret_cast<bf16*>(st + RX_B);
                float* dd = reinterpret_cast<float*>(st + RX_B + A_TILE_B);
                const int c0 = c * CK;
                for (int e = tid; e < TILE * CK / 8; e += FT) {
                    const int r = e >> 3, s8 = (e & 7) * 8;
                    cp16(rx + r * CK + s8, Xg + size_t(r) * n + c0 + s8);
                    cp16(ys + r * ALD + s8, Yg + size_t(r) * n + c0 + s8);
                }
                if (tid < CK / 4) cp16(dd + tid * 4, d2b + c0 + tid * 4);
            }
            cp_commit();
        };
        auto convert = [&](int c) {
            const unsigned char* st = sm + (c % RSTAGES) * RSTAGE_B;
            const bf16* rx = reinterpret_cast<const bf16*>(st);
            const float* dd =
                reinterpret_cast<const float*>(st + RX_B + A_TILE_B);
            bf16* hi = reinterpret_cast<bf16*>(split);
            if (diag) {
                // (A_k d2 A_k^T)[r][r] from the raw chunk, in a pass of its
                // own (inside the split it slowed every block): a chain of 8
                // FMAs a thread, the row's 8 threads by a fixed tree, the
                // chunk into the total (as assemble_sym.cu)
                for (int e = tid; e < TILE * CK / 8; e += FT) {
                    const int r = e >> 3, s8 = (e & 7) * 8;
                    float a[8];
                    unpack8(*reinterpret_cast<const uint4*>(rx + r * CK + s8),
                            a);
                    float dp = 0.f;
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                        dp = __fmaf_rn(__fmul_rn(a[i], dd[s8 + i]), a[i], dp);
                    dp = __fadd_rn(dp, __shfl_xor_sync(0xffffffffu, dp, 1));
                    dp = __fadd_rn(dp, __shfl_xor_sync(0xffffffffu, dp, 2));
                    dp = __fadd_rn(dp, __shfl_xor_sync(0xffffffffu, dp, 4));
                    if ((tid & 7) == 0) dasm[r] = __fadd_rn(dasm[r], dp);
                }
            }
            for (int e = tid; e < TILE * CK / 8; e += FT) {
                const int r = e >> 3, s8 = (e & 7) * 8;
                float x[8];
                unpack8(*reinterpret_cast<const uint4*>(rx + r * CK + s8), x);
#pragma unroll
                for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(x[i], dd[s8 + i]);
                uint4 h, md, l;
                split8(x, h, md, l);
                bf16* at = hi + r * ALD + s8;
                *reinterpret_cast<uint4*>(at) = h;
                *reinterpret_cast<uint4*>(at + TILE * ALD) = md;
                *reinterpret_cast<uint4*>(at + 2 * TILE * ALD) = l;
            }
        };
        auto multiply = [&](int c) {
            const bf16* ys = reinterpret_cast<const bf16*>(
                sm + (c % RSTAGES) * RSTAGE_B + RX_B);
            zero_frag(run);                       // a fresh chunk
#pragma unroll
            for (int kk = 0; kk < CK; kk += 16) {
                unsigned a[3][2][4];
#pragma unroll
                for (int s = 0; s < 3; ++s)
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi)
                        ldm_x4<false>(a[s][mi],
                                      S + s * TILE * ALD
                                        + (wm * 32 + mi * 16 + (lane & 15)) * ALD
                                        + kk + (lane >> 4) * 8);
#pragma unroll
                for (int nj = 0; nj < 4; ++nj) {
                    unsigned bb[4];
                    ldm_x4<false>(bb, ys + (wn * 64 + nj * 16 + (lane & 7)
                                            + ((lane >> 4) << 3)) * ALD
                                         + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                        for (int h = 0; h < 2; ++h)
#pragma unroll
                            for (int s = 0; s < 3; ++s)
                                mma_add(run[mi][2 * nj + h], a[s][mi],
                                        bb[2 * h], bb[2 * h + 1]);
                }
            }
            add_frag(tot, run);
        };
        ring<RSTAGES>(n / CK, issue, convert, multiply);
    }
    // ---- start tile: J scaling, reg; parked in C ---------------------------
    {
        const float* jb = jv + b * size_t(m);
        const float rg = reg[b];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = wm * 32 + mi * 16 + g + 8 * h;
                const float jr = jb[o + r];
#pragma unroll
                for (int ni = 0; ni < 8; ++ni) {
                    const int c = wn * 64 + ni * 8 + 2 * q;
                    const float dr = diag ? __fadd_rn(dasm[r], dasm[TILE + r])
                                          : 0.f;
                    const float u0 = (diag && r == c) ? dr : tot[mi][ni][2 * h];
                    const float u1 = (diag && r == c + 1)
                        ? dr : tot[mi][ni][2 * h + 1];
                    float v0 = __fmul_rn(__fmul_rn(u0, jr), jb[t * TILE + c]);
                    float v1 = __fmul_rn(__fmul_rn(u1, jr),
                                         jb[t * TILE + c + 1]);
                    if (t == k && r == c) v0 = __fadd_rn(v0, rg);
                    if (t == k && r == c + 1) v1 = __fadd_rn(v1, rg);
                    *reinterpret_cast<float2*>(Cb + size_t(r) * w + c) =
                        make_float2(v0, v1);
                }
            }
    }
    if (k == 0) return;                           // nothing to subtract
    // ---- sum_{j<k} P_j[:, lo + r]^T P_j[:, (t - j) NB + c] ------------------
    // chunk c: panel c / 4, its rows 32 (c % 4) .. + 32
    zero_frag(tot);
    {
        const bf16* S = reinterpret_cast<const bf16*>(split);
        auto issue = [&](int c) {
            if (c < 4 * k) {
                const int jj = c >> 2, p0 = (c & 3) * SK;
                size_t ld;
                const float* P = prior.at(jj, b, m, ld);
                const float* xg = P + size_t(p0) * ld + (k - jj) * TILE;
                const float* yg = P + size_t(p0) * ld + (t - jj) * TILE;
                float* rx = reinterpret_cast<float*>(
                    sm + (c % RSTAGES) * RSTAGE_B);
                float* ry = rx + SK * TILE;
                for (int e = tid; e < SK * TILE / 4; e += FT) {
                    const int p = e >> 5, s4 = (e & 31) * 4;
                    cp16(rx + p * TILE + s4, xg + size_t(p) * ld + s4);
                    cp16(ry + p * TILE + s4, yg + size_t(p) * ld + s4);
                }
            }
            cp_commit();
        };
        auto convert = [&](int c) {
            const float* rx = reinterpret_cast<const float*>(
                sm + (c % RSTAGES) * RSTAGE_B);
            bf16* dst = reinterpret_cast<bf16*>(split);
            // operand u (0: X, 1: Y), split part s at dst + (3 u + s) tile
            for (int e = tid; e < 2 * SK * TILE / 8; e += FT) {
                const int u = e / (SK * TILE / 8), f = e % (SK * TILE / 8);
                const int p = f >> 4, s8 = (f & 15) * 8;
                const float* src = rx + u * SK * TILE + p * TILE + s8;
                const float4 x0 = *reinterpret_cast<const float4*>(src);
                const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
                const float x[8] = {x0.x, x0.y, x0.z, x0.w,
                                    x1.x, x1.y, x1.z, x1.w};
                uint4 h, md, l;
                split8(x, h, md, l);
                bf16* at = dst + 3 * u * SK * SLD + p * SLD + s8;
                *reinterpret_cast<uint4*>(at) = h;
                *reinterpret_cast<uint4*>(at + SK * SLD) = md;
                *reinterpret_cast<uint4*>(at + 2 * SK * SLD) = l;
            }
        };
        auto multiply = [&](int c) {
            if ((c & 3) == 0) zero_frag(run);     // a fresh prior panel
#pragma unroll
            for (int kk = 0; kk < SK; kk += 16) {
                unsigned a[3][2][4];
#pragma unroll
                for (int s = 0; s < 3; ++s)
#pragma unroll
                    for (int mi = 0; mi < 2; ++mi)
                        ldm_x4<true>(a[s][mi],
                                     S + s * SK * SLD
                                       + (kk + (lane & 7) + ((lane >> 4) << 3))
                                         * SLD
                                       + wm * 32 + mi * 16
                                       + ((lane >> 3) & 1) * 8);
#pragma unroll
                for (int nj = 0; nj < 4; ++nj) {
                    const bf16* yb = S + 3 * SK * SLD
                        + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * SLD
                        + wn * 64 + nj * 16 + (lane >> 4) * 8;
                    // Y's hi, mid, lo: with X's hi, mid, lo; hi, mid; hi
#pragma unroll
                    for (int sy = 0; sy < 3; ++sy) {
                        unsigned bb[4];
                        ldm_x4<true>(bb, yb + sy * SK * SLD);
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
            if ((c & 3) == 3) add_frag(tot, run);   // the panel is done
        };
        ring<RSTAGES>(4 * k, issue, convert, multiply);
    }
    if (diag) {
        // its diagonal, sum_j sum_p P_j[p][lo + r]^2, on the CUDA cores from
        // the prior panels again (L2 holds them): thread (h, r) takes column
        // r, rows 64 h .. +63 of each panel, in chains of 8 FMAs whose sums
        // make a panel's run and the runs a total; the halves are added in
        // the epilogue
        const int r = tid & (TILE - 1), h = tid / TILE;
        float total = 0.f;
        for (int jj = 0; jj < k; ++jj) {
            size_t ld;
            const float* col = prior.at(jj, b, m, ld) + size_t(64 * h) * ld
                               + (k - jj) * TILE + r;
            float v[64];                          // all loads in flight
#pragma unroll
            for (int p = 0; p < 64; ++p) v[p] = col[size_t(p) * ld];
            float prun = 0.f;
#pragma unroll
            for (int p0 = 0; p0 < 64; p0 += 8) {
                float ch = 0.f;
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    ch = __fmaf_rn(v[p0 + i], v[p0 + i], ch);
                prun = __fadd_rn(prun, ch);
            }
            total = __fadd_rn(total, prun);
        }
        dsub[h * TILE + r] = total;
        __syncthreads();
    }

    // ---- C = start - total, the one subtraction; each thread reads back what
    // it wrote ------------------------------------------------------------------
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mi * 16 + g + 8 * h;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                const int c = wn * 64 + ni * 8 + 2 * q;
                float2* at = reinterpret_cast<float2*>(Cb + size_t(r) * w + c);
                const float2 s = *at;
                const float dr = diag ? __fadd_rn(dsub[r], dsub[TILE + r])
                                      : 0.f;
                const float u0 = (diag && r == c) ? dr : tot[mi][ni][2 * h];
                const float u1 = (diag && r == c + 1) ? dr
                                                      : tot[mi][ni][2 * h + 1];
                *at = make_float2(__fsub_rn(s.x, u0), __fsub_rn(s.y, u1));
            }
        }
}

}  // namespace

// Panel k of the fused factor: C (B, NB, m - k NB) from A (B, m, n) bf16,
// d2 (B, n), j (B, m), reg (B,) and the k prior panels (host array of k
// device pointers, panel j being (B, NB, m - j NB) contiguous).
// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int ipx_fused_panel(const void* A, const float* d2, const float* jv,
                               const float* reg, const void* const* prior,
                               float* C, int B, int m, int n, int k,
                               void* stream) {
    if (B < 1 || B > 65535 || m < TILE || m % TILE || n < TILE || n % TILE)
        return -1;
    if (k < 0 || k >= m / TILE) return -1;
    if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(d2)
         | reinterpret_cast<uintptr_t>(C)) % 16 != 0)
        return -1;
    PanelRows pp;
    if (fill_panels(pp.panels, prior, k) != 0) return -1;
    cudaError_t err = cudaFuncSetAttribute(
        fused_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(FUSED_SMEM));
    if (err != cudaSuccess) return int(err);
    dim3 grid(m / TILE - k, B);
    fused_panel_kernel<<<grid, FT, FUSED_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(A), d2, jv, reg, pp, C, m, n, k);
    return int(cudaGetLastError());
}
