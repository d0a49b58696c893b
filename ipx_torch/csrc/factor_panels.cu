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
// diag_factor_inv: one block per instance, the tile in shared memory.  The
// factor is the column-sequential left-looking form, four lanes owning row i:
//   L[i][j] = (a[i][j] - sum_{p<j} L[i][p] L[j][p]) / sqrt(max(d_j, tiny)),
//   d_j = a[j][j] - sum_{p<j} L[j][p]^2,
// the dot products accumulated in float64 and rounded once on store.  Only
// the lower triangle of the tile is used (the panel kernels do not
// symmetrise it).  A block that is not positive definite gets a non-positive
// or non-finite diagonal entry, which the caller's `ok` test catches; nothing
// traps.  The inverse W = L^-1 is forward substitution, four lanes owning
// column c, again float64 sums rounded once per entry.  Latency-bound: about
// NB^3 / 3 FMAs for each of the two.
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
constexpr int DQ = 4;               // threads that share one row's (column's)
                                    // dot product
constexpr int DTHREADS = DN * DQ;
constexpr int DLD = DN + 4;         // row stride in shared memory: four rows
                                    // times four neighbouring entries hit 16
                                    // different bank pairs, and the spare
                                    // columns make room for W (below)
constexpr size_t DIAG_SMEM = (size_t(DN) * DLD + DN) * sizeof(double);

// max(v, tiny) that lets a NaN through, as the reference's maximum does
__device__ __forceinline__ double guard_pivot(double v) {
    const double tiny = double(FLT_MIN);
    return (v >= tiny || v != v) ? v : tiny;
}

// the value a float32 store keeps, as a double
__device__ __forceinline__ double rnd32(double v) { return double(float(v)); }

// sum over the DQ neighbouring lanes that share a row; every lane of the warp
// must call it, and all DQ lanes get the same bits
__device__ __forceinline__ double quad_sum(double v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// Shared memory holds float32 values widened to double, so the inner loops
// are loads and float64 FMAs with no conversions (a float32-to-float64
// conversion costs a warp four times an FMA here).  L sits in the lower
// triangle of the DN x DLD array; W = L^-1, lower triangular too, goes
// transposed into the unused upper part shifted by one column:
// W[r][c] at (c, r + 1), r >= c.  Each dot product is split over DQ lanes
// (entries p = t, t + DQ, ...): the chains are sequential and short, and 16
// warps a block are what hides the latency of their loads.
__global__ void __launch_bounds__(DTHREADS)
diag_factor_inv_kernel(const float* C, long long c_bs, int c_rs, float* LT,
                       long long lt_bs, int lt_rs, float* W, long long w_bs,
                       int lower_out) {
    extern __shared__ double dsm[];
    double* Ls = dsm;                   // DN x DLD
    double* ad = dsm + DN * DLD;        // DN: the tile's own diagonal
    const int tid = threadIdx.x;
    const int i = tid / DQ, t = tid % DQ;       // row (column) and its lane
    const size_t b = blockIdx.x;
    const float* Cb = C + b * c_bs;

    for (int e = tid; e < DN * DN; e += DTHREADS) {
        const int r = e / DN, c = e % DN;
        const double v = double(Cb[size_t(r) * c_rs + c]);
        Ls[r * DLD + c] = v;            // only (r, c <= r) is read below
        if (r == c) ad[r] = v;
    }
    __syncthreads();

    // ---- Cholesky, column by column; DQ lanes own row i ---------------------
    const double* li = Ls + i * DLD;
    for (int j = 0; j < DN; ++j) {
        const double* lj = Ls + j * DLD;
        double s = 0.0, d = 0.0;
        const int end = (i >= j) ? j : 0;       // rows above the diagonal idle
        for (int p = t; p < end; p += DQ) {
            const double a = li[p], c = lj[p];
            s = fma(a, c, s);
            d = fma(c, c, d);
        }
        s = quad_sum(s);
        d = quad_sum(d);
        if (i >= j && t == 0) {
            const double dj = ad[j] - d;
            // row j's entry is d_j / sqrt(max(d_j, tiny)): not positive for a
            // block that is not positive definite
            Ls[i * DLD + j] = rnd32((li[j] - s) * rsqrt(guard_pivot(dj)));
        }
        __syncthreads();
    }

    // ---- L^T out: (r, c) = L[c][r] on and above the diagonal, else 0; or,
    // with lower_out, L itself ------------------------------------------------
    float* LTb = LT + b * lt_bs;
    for (int e = tid; e < DN * DN; e += DTHREADS) {
        const int r = e / DN, c = e % DN;
        const int hi = lower_out ? r : c, lo = lower_out ? c : r;
        LTb[size_t(r) * lt_rs + c] = (hi >= lo) ? float(Ls[hi * DLD + lo])
                                                : 0.f;
    }

    // ---- W = L^-1 by forward substitution; DQ lanes own column c ------------
    // The lanes of a warp walk the rows together from the warp's first
    // column, entries above a column's own diagonal counting as 0.
    const int c = i, c0 = (tid / 32) * (32 / DQ);
    double* wc = Ls + c * DLD + 1;      // wc[r] = W[r][c], r >= c
    for (int r = c0; r < DN; ++r) {
        const double* lr = Ls + r * DLD;
        double a = 0.0;
        for (int p = c0 + t; p < r; p += DQ)
            a = fma(-lr[p], (p >= c) ? wc[p] : 0.0, a);
        a = quad_sum(a);
        if (r >= c && t == 0)
            wc[r] = rnd32((a + ((r == c) ? 1.0 : 0.0)) / guard_pivot(lr[r]));
        __syncwarp();                   // wc[r] is read by the other lanes
    }
    __syncthreads();
    float* Wb = W + b * w_bs;
    for (int e = tid; e < DN * DN; e += DTHREADS) {
        const int r = e / DN, cc = e % DN;
        Wb[size_t(r) * DN + cc] =
            (r >= cc) ? float(Ls[cc * DLD + 1 + r]) : 0.f;
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
