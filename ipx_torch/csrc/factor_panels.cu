// The diagonal kernel of the blocked Cholesky factors (NB = 128): the
// Cholesky factor of a 128 x 128 diagonal block and its inverse,
//
//   L_D^T, W_D = diag_factor_inv(C_k[:, :NB])
//
// between the panel launches of every W-carrying factor: the left-looking
// ones (fused_panel.cu for a bf16 A, accum_panel.cu from an assembled
// matrix; panels[k] = [L_D^T | W_D C_k[:, NB:]]) and the right-looking one
// (cholesky_right.cu, with the untransposed output).
// diag_factor_inv has no TPU kernel behind it: there the 128 x 128 diagonal
// Cholesky and its inverse are an unrolled chain of XLA operations between
// the kernel calls (_factor_block_twolevel of ipx/kernels/cholesky.py); run
// operation by operation from PyTorch that chain is some 1,800 tiny launches
// a panel, so here it is one kernel.
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
