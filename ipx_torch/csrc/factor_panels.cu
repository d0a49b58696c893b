// Panel kernels of the left-looking blocked Cholesky factor (NB = 128), which
// emits the factor as suffix-only transposed row panels
//
//   panels[k]  (B, NB, m - k NB):  rows k NB .. (k+1) NB of L^T from the
//                                  diagonal on
//   W          (B, m / NB, NB, NB): inverses of the diagonal blocks of L
//
// or, for factor_lt_batched, as a full upper-triangular LT (B, m, m) whose
// rows k NB .. (k+1) NB are zeros, L_kk^T, W_k C_k[:, NB:].
//
// Per panel k the caller runs
//
//   C_k = (start tile row) - sum_{j<k} P_j[:, o-jNB : o-jNB+NB]^T P_j[:, o-jNB:]
//         accum_panel below (fused_panel.cu for a bf16 A), o = k NB
//   L_D^T, W_D = diag_factor_inv(C_k[:, :NB])
//   panels[k] = [L_D^T | W_D C_k[:, NB:]]        a library product outside
//
// accum_panel replaces _accum_panel_kernel of ipx/kernels/cholesky.py (entry
// factor_lt_panels): the start tile is read from an assembled, scaled,
// regularised matrix Ms.  (The fused form, which assembles the start tile
// from a bf16 A on the tensor cores, is fused_panel.cu.)
// The full-L^T factor replaces _factor_lt_kernel (entry factor_lt_batched),
// which keeps the diagonal chain and the panel TRSM inside its body: here
// accum_panel reads the prior rows from LT itself (the same kernel body over
// another address map, so its sums are those of factor_lt_panels),
// diag_factor_inv writes L_kk^T into LT's diagonal tile, and lt_rows_kernel
// writes the rest of the row panel: W_k C_k[:, NB:] right of the diagonal
// tile as a hand-written tile product, zeros left of it.
// diag_factor_inv has no TPU kernel behind it: there the 128 x 128 diagonal
// Cholesky and its inverse are an unrolled chain of XLA operations between
// the kernel calls (_factor_block_twolevel); run operation by operation from
// PyTorch that chain is some 1,800 tiny launches a panel, so here it is one
// kernel.
//
// Bound on this card: operations.  The subtraction is NB^3 sum_k k (nb - k)
// float32 FMAs an instance; against that stand the tile row of Ms and the
// prior panels read once each.  The design is the register-tiled product of
// panel_common.cuh: grid (column tile t = k..nb-1, instance), one block per
// 128 x 128 tile of C_k, so late panels with few tiles and a batch of one
// simply launch few blocks.  No TF32 anywhere.
//
// Summation.  The subtraction is summed in an accumulator of its own, each
// prior panel's 128 terms in registers and the panels' sums in shared memory,
// and the total is subtracted from the start tile once: up to (nb - 1) NB
// terms chained onto the start value in float32 would lose the digits the
// two-level assembly has just won.
//
// diag_factor_inv: one block of 256 threads per instance, blocked as the
// reference's _factor_block_twolevel is, over four leaves of 32 columns
// (left-looking, leaf j at columns J = 32 j .. 32 j + 31):
//   C[r][J]  = A[r][J] - sum_{p < 32 j} L[r][p] L[J][p]     rows r >= 32 j,
//                                                          all threads
//   L_jj     = chol(C_jj), W_jj = L_jj^-1                  one warp, a lane a
//                                                          row (a column)
//   L[r][J]  = C[r][J] L_jj^-T by substitution             a thread a row
// then, by distance d = i - j = 1, 2, 3 of the blocks below the diagonal,
//   W_ij     = -W_ii (sum_{p=j}^{i-1} L_ip W_pj)            all threads.
// Every dot product and update is accumulated in float64, and C of the
// current block column and the leaf's L stay float64 in shared memory; each
// entry of L and W is rounded to float32 once, and what later steps read of
// them is that float32 value, so W is the inverse of the L that is stored.
// The substitutions keep the column-by-column factor's formula within a row
// (each entry rounded before the next uses it, and scaled by its column's
// unrounded pivot 1 / sqrt(d_c)): a product with W_jj in its place rounds the
// 32 entries of a row independently and, measured against float64, came out
// up to 2.3x less accurate, and a division by the rounded diagonal entry
// 1.1x.  Only the lower triangle of the input is read, from device memory
// when its block column comes up.  A block that is not positive definite
// gets a non-positive or non-finite diagonal entry, which the caller's `ok`
// test catches; nothing traps.
// Bound on this card: bytes, 0.015 ms at B = 256 (the tile in, L and W out).
// The operations are NB^3 / 3 float64 FMAs an instance (NB^3 / 6 the factor,
// NB^3 / 6 the inverse), 0.005 ms at the float64 tensor-core rate and 0.011
// on the CUDA cores.  What a column-by-column design loses (two sequential
// chains of 128 dependent dot products, one block an SM in two waves at
// B = 256) this one shortens to 32-step chains (the leaves, the
// substitutions); the products between them run on all 256 threads, and the
// tile is kept as float32 (L in the lower triangle, W^T in the upper shifted
// by one column) so that 99,840 bytes of shared memory let two blocks share
// an SM and B = 256 runs in one wave.
//
// Shapes: m a multiple of 128 (the caller pads the assembled route).

#include "panel_common.cuh"

#include <float.h>

namespace {

using namespace ipx_tile;

// Prior: where the rows of the k prior panels lie (PanelRows or FullRows).
template <typename Prior>
__global__ void __launch_bounds__(THREADS)
panel_kernel(const float* __restrict__ Ms, Prior prior, float* C, int m,
             int k) {
    __shared__ __align__(16) float Xs[BK][LDS];
    __shared__ __align__(16) float Ys[BK][LDS];
    extern __shared__ float tot[];                // parked sums, TOT_BYTES

    const int t = k + blockIdx.x;                 // column tile of M
    const size_t b = blockIdx.y;
    const int o = k * TILE, w = m - o;
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    float* Cb = C + b * size_t(TILE) * w + size_t(t - k) * TILE;

    int ri[8], cj[8];                             // local row, local column
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        ri[e] = ty * 4 + tile_off(e);
        cj[e] = tx * 4 + tile_off(e);
    }

    // ---- sum_{j<k} P_j[:, (k-j) NB + r]^T P_j[:, (t-j) NB + c] --------------
    float acc[8][8];
    zero_total(tot, tid);
    for (int jj = 0; jj < k; ++jj) {
        size_t wj;                                // row stride of panel jj
        const float* P = prior.at(jj, b, m, wj);
        zero_acc(acc);
        for (int k0 = 0; k0 < TILE; k0 += BK) {
            stage_pass<false, false>(P + (k - jj) * TILE, wj,
                                     P + (t - jj) * TILE, wj, k0, Xs, Ys, tid);
            __syncthreads();
            mma_pass(Xs, Ys, tx, ty, acc);
            __syncthreads();
        }
        flush_acc(acc, tot, tid);                 // one prior panel is done
    }

    // ---- C = start - total, the one subtraction -----------------------------
    const float* Mrow = Ms + b * size_t(m) * m + size_t(o) * m
                        + size_t(t) * TILE;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            Cb[size_t(ri[i]) * w + cj[j]] = __fsub_rn(
                Mrow[size_t(ri[i]) * m + cj[j]],
                tot[(i * 8 + j) * THREADS + tid]);
}

template <typename Prior>
int launch_panel(const float* Ms, const Prior& prior, float* C, int B, int m,
                 int k, cudaStream_t stream) {
    auto kern = panel_kernel<Prior>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(TOT_BYTES));
    if (err != cudaSuccess) return int(err);
    dim3 grid(m / TILE - k, B);
    kern<<<grid, THREADS, TOT_BYTES, stream>>>(Ms, prior, C, m, k);
    return int(cudaGetLastError());
}

// Rows k NB .. (k+1) NB of a full L^T apart from the diagonal tile: block
// (t, b) writes tile t of the row panel, zeros for t < k and
// W_k C[:, (t - k) NB ...] for t > k, with C (B, NB, m - k NB) the accumulated
// panel.  The product is the panel TRSM as a product with the block inverse.
__global__ void __launch_bounds__(THREADS)
lt_rows_kernel(const float* __restrict__ W, const float* __restrict__ C,
               float* __restrict__ LT, int m, int k) {
    __shared__ __align__(16) float Xs[BK][LDS];
    __shared__ __align__(16) float Ys[BK][LDS];
    extern __shared__ float tot[];                // parked sums, TOT_BYTES

    const int t = blockIdx.x;
    if (t == k) return;                           // diag_factor_inv's tile
    const size_t b = blockIdx.y;
    const int o = k * TILE, w = m - o, nb = m / TILE;
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    float* out = LT + (b * size_t(m) + o) * m + size_t(t) * TILE;

    float acc[8][8];
    if (t < k) {
        zero_acc(acc);
    } else {
        product128<true, false>(W + (b * nb + k) * size_t(TILE) * TILE, TILE,
                                C + b * size_t(TILE) * w
                                  + size_t(t - k) * TILE, w,
                                Xs, Ys, tot, tid, acc);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            out[size_t(ty * 4 + tile_off(i)) * m + tx * 4 + tile_off(j)] =
                acc[i][j];
}

// ---------------------------------------------------------------------------
// diag_factor_inv
// ---------------------------------------------------------------------------

constexpr int DN = 128;             // the diagonal block's edge (= TILE)
constexpr int DL = 32;              // leaf edge: one warp, a lane a row
constexpr int NLEAF = DN / DL;
constexpr int DTHREADS = 256;
constexpr int DLD = DN + 1;         // float row stride of the tile: a row and
                                    // a column both read without bank
                                    // conflicts, and room for W^T (below)
constexpr int CLD = DL + 1;         // double row stride of C; column DL of
                                    // the leaf's rows holds its pivots
                                    // 1 / sqrt(d_c), unrounded
constexpr size_t DIAG_SMEM = size_t(DN) * DLD * sizeof(float)
    + size_t(DN) * CLD * sizeof(double);                 // 99840
static_assert(2 * (DIAG_SMEM + 1024) <= 228 * 1024,
              "two diagonal blocks share an SM");

// max(v, tiny) that lets a NaN through, as the reference's maximum does
__device__ __forceinline__ double guard_pivot(double v) {
    const double tiny = double(FLT_MIN);
    return (v >= tiny || v != v) ? v : tiny;
}

// the value a float32 store keeps, as a double
__device__ __forceinline__ double rnd32(double v) { return double(float(v)); }

// Leaf j, one warp: C_jj (Cs rows 0 .. 31, float64) -> L_jj, rounded to
// float32, into the tile and into Cs (in place), the pivots 1 / sqrt(d_c)
// into Cs's column DL, then W_jj = L_jj^-1 in float64, rounded, into the
// tile's W^T slots.  The factor runs down the columns with lane i owning row
// i in registers; the inverse runs down the rows with lane c owning column c.
// Each dot product is split over two chains.
__device__ __forceinline__ void leaf(float* Ls, double* Cs, int J0,
                                     int lane) {
    double a[DL];
#pragma unroll
    for (int c = 0; c < DL; ++c) a[c] = Cs[lane * CLD + c];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DL; ++j) {
        double s0 = a[j], s1 = 0.0;
#pragma unroll
        for (int p = 0; p < j; ++p) {
            const double ljp = Cs[j * CLD + p];
            if (p & 1) s1 = fma(-a[p], ljp, s1);
            else s0 = fma(-a[p], ljp, s0);
        }
        const double s = s0 + s1;
        const double dj = __shfl_sync(0xffffffffu, s, j);
        // row j's entry is d_j / sqrt(max(d_j, tiny)): not positive for a
        // block that is not positive definite
        const double piv = rsqrt(guard_pivot(dj));
        const double l = (lane >= j) ? rnd32(s * piv) : 0.0;
        a[j] = l;
        Cs[lane * CLD + j] = l;
        if (lane == j) Cs[j * CLD + DL] = piv;
        __syncwarp();
    }
#pragma unroll
    for (int c = 0; c < DL; ++c)
        if (c <= lane) Ls[(J0 + lane) * DLD + J0 + c] = float(a[c]);

    double w[DL];                       // w[r] = W_jj[r][lane]
#pragma unroll
    for (int r = 0; r < DL; ++r) {
        double s0 = (r == lane) ? 1.0 : 0.0, s1 = 0.0;
#pragma unroll
        for (int p = 0; p < r; ++p) {
            const double lrp = Cs[r * CLD + p];
            if (p & 1) s1 = fma(-lrp, w[p], s1);
            else s0 = fma(-lrp, w[p], s0);
        }
        w[r] = (r >= lane) ? (s0 + s1) / guard_pivot(Cs[r * CLD + r]) : 0.0;
    }
#pragma unroll
    for (int r = 0; r < DL; ++r)
        if (r >= lane) Ls[(J0 + lane) * DLD + J0 + r + 1] = float(w[r]);
}

// The tile in shared memory holds L[r][c] at (r, c), c <= r, and W[r][c] at
// (c, r + 1), r >= c: both float32, as stored.
__device__ __forceinline__ double wt(const float* Ls, int r, int c) {
    return double(Ls[c * DLD + r + 1]);
}

__global__ void __launch_bounds__(DTHREADS, 2)
diag_factor_inv_kernel(const float* C, long long c_bs, int c_rs, float* LT,
                       long long lt_bs, int lt_rs, float* W, long long w_bs,
                       int lower_out) {
    extern __shared__ __align__(16) unsigned char dsm[];
    float* Ls = reinterpret_cast<float*>(dsm);                // DN x DLD
    double* Cs = reinterpret_cast<double*>(
        dsm + size_t(DN) * DLD * sizeof(float));              // DN x CLD
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // the products' thread tile: columns 4 cg .. +3, rows rg + 32 k
    const int cg = tid & 7, rg = tid >> 3;
    const size_t b = blockIdx.x;
    const float* Cb = C + b * c_bs;

    for (int j = 0; j < NLEAF; ++j) {
        const int J0 = j * DL, nk = NLEAF - j;      // row blocks from J0 on
        // ---- C[r][J] = A[r][J] - sum_{p<J0} L[r][p] L[J][p], rows r >= J0
        {
            double acc[NLEAF][4] = {};
#pragma unroll 4
            for (int p = 0; p < J0; ++p) {
                double lc[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    lc[e] = double(Ls[(J0 + cg * 4 + e) * DLD + p]);
#pragma unroll
                for (int k = 0; k < NLEAF; ++k) {
                    if (k < nk) {
                        const double lr =
                            double(Ls[(J0 + rg + DL * k) * DLD + p]);
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[k][e] = fma(lr, lc[e], acc[k][e]);
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < NLEAF; ++k) {
                if (k < nk) {
                    const int r = rg + DL * k;
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int c = cg * 4 + e;
                        // the leaf's upper triangle is neither read nor used
                        Cs[r * CLD + c] = (r >= c)
                            ? double(Cb[size_t(J0 + r) * c_rs + J0 + c])
                              - acc[k][e]
                            : 0.0;
                    }
                }
            }
        }
        __syncthreads();
        if (warp == 0) leaf(Ls, Cs, J0, lane);
        __syncthreads();
        // ---- L[r][J] below the leaf, one thread a row, by substitution
        // against the rounded leaf: each entry is rounded before the next
        // of its row uses it, and is scaled by its column's unrounded pivot
        // 1 / sqrt(d_c), so each entry is the column-by-column factor's
        if (tid < DN - J0 - DL) {
            const int rl = DL + tid;                // its row of Cs
            double l[DL];
#pragma unroll
            for (int c = 0; c < DL; ++c) {
                double s0 = Cs[rl * CLD + c], s1 = 0.0;
#pragma unroll
                for (int q = 0; q < c; ++q) {
                    const double lcq = Cs[c * CLD + q];
                    if (q & 1) s1 = fma(-l[q], lcq, s1);
                    else s0 = fma(-l[q], lcq, s0);
                }
                l[c] = rnd32((s0 + s1) * Cs[c * CLD + DL]);
            }
#pragma unroll
            for (int c = 0; c < DL; ++c)
                Ls[(J0 + rl) * DLD + J0 + c] = float(l[c]);
        }
        __syncthreads();
    }

    // ---- W below the diagonal blocks, by distance d = i - j ---------------
    // 64 threads a 32 x 32 block, a 4 x 4 tile each; T parks in Cs
    for (int d = 1; d < NLEAF; ++d) {
        const int nblk = NLEAF - d;
        for (int it = tid; it < nblk * 64; it += DTHREADS) {
            const int j = it >> 6, i = j + d;
            const int r0 = ((it >> 3) & 7) * 4, c0 = (it & 7) * 4;
            // T = sum_{p=j}^{i-1} L_ip W_pj over kk = 32 j .. 32 i - 1
            double acc[4][4] = {};
            for (int kk = DL * j; kk < DL * i; ++kk) {
                double lr[4], wc[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    lr[e] = double(Ls[(DL * i + r0 + e) * DLD + kk]);
                    const int col = DL * j + c0 + e;
                    wc[e] = (kk >= col) ? wt(Ls, kk, col) : 0.0;
                }
#pragma unroll
                for (int x = 0; x < 4; ++x)
#pragma unroll
                    for (int y = 0; y < 4; ++y)
                        acc[x][y] = fma(lr[x], wc[y], acc[x][y]);
            }
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y)
                    Cs[(DL * j + r0 + x) * CLD + c0 + y] = acc[x][y];
        }
        __syncthreads();
        for (int it = tid; it < nblk * 64; it += DTHREADS) {
            const int j = it >> 6, i = j + d;
            const int r0 = ((it >> 3) & 7) * 4, c0 = (it & 7) * 4;
            // W_ij = -W_ii T, W_ii lower triangular
            double acc[4][4] = {};
            for (int q = 0; q < r0 + 4; ++q) {
                double wr[4], tc[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    wr[e] = (q <= r0 + e) ? wt(Ls, DL * i + r0 + e, DL * i + q)
                                          : 0.0;
                    tc[e] = Cs[(DL * j + q) * CLD + c0 + e];
                }
#pragma unroll
                for (int x = 0; x < 4; ++x)
#pragma unroll
                    for (int y = 0; y < 4; ++y)
                        acc[x][y] = fma(wr[x], tc[y], acc[x][y]);
            }
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y)
                    Ls[(DL * j + c0 + y) * DLD + DL * i + r0 + x + 1] =
                        float(-acc[x][y]);
        }
        __syncthreads();
    }

    // ---- L^T out: (r, c) = L[c][r] on and above the diagonal, else 0; or,
    // with lower_out, L itself; then W ---------------------------------------
    float* LTb = LT + b * lt_bs;
    for (int e = tid; e < DN * DN; e += DTHREADS) {
        const int r = e / DN, c = e % DN;
        const int hi = lower_out ? r : c, lo = lower_out ? c : r;
        LTb[size_t(r) * lt_rs + c] = (hi >= lo) ? Ls[hi * DLD + lo] : 0.f;
    }
    float* Wb = W + b * w_bs;
    for (int e = tid; e < DN * DN; e += DTHREADS) {
        const int r = e / DN, c = e % DN;
        Wb[size_t(r) * DN + c] = (r >= c) ? Ls[c * DLD + r + 1] : 0.f;
    }
}

}  // namespace

// Panel k from an assembled, scaled, regularised Ms (B, m, m) f32.
extern "C" int ipx_accum_panel(const float* Ms, const void* const* prior,
                               float* C, int B, int m, int k, void* stream) {
    if (B < 1 || B > 65535 || m < TILE || m % TILE) return -1;
    if (k < 0 || k >= m / TILE) return -1;
    PanelRows pp;
    if (fill_panels(pp.panels, prior, k) != 0) return -1;
    return launch_panel(Ms, pp, C, B, m, k,
                        static_cast<cudaStream_t>(stream));
}

// Panel k from Ms, the k prior panels being rows 0 .. k NB of the full
// LT (B, m, m) f32 (only their columns from k NB on are read).
extern "C" int ipx_accum_panel_lt(const float* Ms, const float* LT, float* C,
                                  int B, int m, int k, void* stream) {
    if (B < 1 || B > 65535 || m < TILE || m % TILE) return -1;
    if (k < 0 || k >= m / TILE) return -1;
    if (reinterpret_cast<uintptr_t>(LT) % 16 != 0) return -1;
    return launch_panel(Ms, FullRows{LT}, C, B, m, k,
                        static_cast<cudaStream_t>(stream));
}

// Rows k NB .. (k+1) NB of LT (B, m, m) outside the diagonal tile, from
// W (B, m / NB, NB, NB) and the accumulated panel C (B, NB, m - k NB):
// zeros to the left, W_k C[:, NB:] to the right.
extern "C" int ipx_lt_rows(const float* W, const float* C, float* LT, int B,
                           int m, int k, void* stream) {
    if (B < 1 || B > 65535 || m < TILE || m % TILE) return -1;
    if (k < 0 || k >= m / TILE) return -1;
    if ((reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(C)
         | reinterpret_cast<uintptr_t>(LT)) % 16 != 0)
        return -1;
    cudaError_t err = cudaFuncSetAttribute(
        lt_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(TOT_BYTES));
    if (err != cudaSuccess) return int(err);
    dim3 grid(m / TILE, B);
    lt_rows_kernel<<<grid, THREADS, TOT_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(W, C, LT, m, k);
    return int(cudaGetLastError());
}

// C: B tiles of 128 x 128 f32 (instance stride c_bs, row stride c_rs, in
// floats; lower triangle read) -> LT (instance stride lt_bs, row stride
// lt_rs) = L^T, or L itself if lower_out != 0, and W (instance stride w_bs,
// rows contiguous) = L^-1.  LT may be the memory of C: a block reads its
// whole tile before it writes.
extern "C" int ipx_diag_factor_inv(const float* C, long long c_bs, int c_rs,
                                   float* LT, long long lt_bs, int lt_rs,
                                   float* W, long long w_bs, int B,
                                   int lower_out, void* stream) {
    if (B < 1 || c_rs < DN || lt_rs < DN || w_bs < DN * DN) return -1;
    cudaError_t err = cudaFuncSetAttribute(
        diag_factor_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(DIAG_SMEM));
    if (err != cudaSuccess) return int(err);
    diag_factor_inv_kernel<<<B, DTHREADS, DIAG_SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
        C, c_bs, c_rs, LT, lt_bs, lt_rs, W, w_bs, lower_out);
    return int(cudaGetLastError());
}
