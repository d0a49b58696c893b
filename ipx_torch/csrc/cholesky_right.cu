// Panel kernels of the right-looking blocked Cholesky factor (NB = 128), in
// place in a copy T of the matrix:
//
//   per panel k, o = k NB:
//     L_kk, W_k = diag_factor_inv(T[o:o+NB, o:o+NB])     factor_panels.cu, with
//                                                        the untransposed output
//     T[i, k]   = T[i, k] W_k^T           i > k          trsm_cols_kernel
//     T[i, j]  -= T[i, k] T[j, k]^T       i >= j > k     syrk_lower_kernel
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
// Bound on this card: operations, m^3 / 6 FMAs an instance plus the block
// inverses, against the matrix read once and the factor written once.  Both
// kernels are the register-tiled 128-term product of panel_common.cuh, one
// block per output tile, grid (tiles, instances): at the main path's batch
// even the last panels launch hundreds of blocks.
//
// Not kept from the TPU kernel: its update of whole column stripes (it cannot
// slice; here only the tiles on and below the block diagonal of the trailing
// matrix are updated, which halves the work), the chunking of the batch by
// fast-memory size, and the copy slots.
//
// Summation.  A right-looking factor rounds each trailing entry to float32
// once per panel: that is the function.  Each tile product is summed in two
// levels (64-term runs in registers, the runs' sums in shared memory) and
// subtracted from the tile once.  No TF32 anywhere.
//
// Shapes: m a multiple of 128 (the caller pads).

#include "panel_common.cuh"

namespace {

using namespace ipx_tile;

// Block (x, b): row tile i = k + 1 + x of instance b.  T[i, k] = T[i, k] W_k^T
// in place, and the mirror tile T[k, i] above the block diagonal is zeroed.
__global__ void __launch_bounds__(THREADS)
trsm_cols_kernel(float* T, const float* __restrict__ W, int m, int k) {
    __shared__ __align__(16) float Xs[BK][LDS];
    __shared__ __align__(16) float Ys[BK][LDS];
    extern __shared__ float tot[];                // parked sums, TOT_BYTES

    const int i = k + 1 + blockIdx.x;
    const size_t b = blockIdx.y;
    const int nb = m / TILE, tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    float* Tb = T + b * size_t(m) * m;
    float* tile = Tb + size_t(i) * TILE * m + size_t(k) * TILE;
    float* mirror = Tb + size_t(k) * TILE * m + size_t(i) * TILE;

    float acc[8][8];
    // out[r][c] = sum_p T[r][p] W[c][p]
    product128<true, true>(tile, m, W + (b * nb + k) * size_t(TILE) * TILE,
                           TILE, Xs, Ys, tot, tid, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const size_t at = size_t(ty * 4 + tile_off(r)) * m
                              + tx * 4 + tile_off(c);
            tile[at] = acc[r][c];
            mirror[at] = 0.f;
        }
}

// Block (x, b): x counts the tiles on and below the block diagonal of the
// trailing matrix row by row, x = ii (ii + 1) / 2 + jj with ii >= jj;
// T[i, j] -= T[i, k] T[j, k]^T for i = k + 1 + ii, j = k + 1 + jj.
__global__ void __launch_bounds__(THREADS)
syrk_lower_kernel(float* T, int m, int k) {
    __shared__ __align__(16) float Xs[BK][LDS];
    __shared__ __align__(16) float Ys[BK][LDS];
    extern __shared__ float tot[];                // parked sums, TOT_BYTES

    int ii = 0;
    while ((ii + 1) * (ii + 2) / 2 <= int(blockIdx.x)) ++ii;
    const int jj = int(blockIdx.x) - ii * (ii + 1) / 2;
    const int i = k + 1 + ii, j = k + 1 + jj;
    const size_t b = blockIdx.y;
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    float* Tb = T + b * size_t(m) * m;
    const float* Pi = Tb + size_t(i) * TILE * m + size_t(k) * TILE;
    const float* Pj = Tb + size_t(j) * TILE * m + size_t(k) * TILE;
    float* tile = Tb + size_t(i) * TILE * m + size_t(j) * TILE;

    float acc[8][8];
    // out[r][c] = sum_p P_i[r][p] P_j[c][p]
    product128<true, true>(Pi, m, Pj, m, Xs, Ys, tot, tid, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const size_t at = size_t(ty * 4 + tile_off(r)) * m
                              + tx * 4 + tile_off(c);
            tile[at] = __fsub_rn(tile[at], acc[r][c]);
        }
}

bool args_ok(const float* T, int B, int m, int k) {
    return B >= 1 && B <= 65535 && m >= 2 * TILE && m % TILE == 0 && k >= 0
        && k < m / TILE - 1 && reinterpret_cast<uintptr_t>(T) % 16 == 0;
}

template <typename K>
cudaError_t allow_tot(K kern) {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(TOT_BYTES));
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
    cudaError_t err = allow_tot(trsm_cols_kernel);
    if (err != cudaSuccess) return int(err);
    dim3 grid(m / TILE - k - 1, B);
    trsm_cols_kernel<<<grid, THREADS, TOT_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(T, W, m, k);
    return int(cudaGetLastError());
}

// The trailing update of panel k (not the last): every tile (i, j), i >= j > k,
// less T[i, k] T[j, k]^T.
extern "C" int ipx_right_update(float* T, int B, int m, int k, void* stream) {
    if (!args_ok(T, B, m, k)) return -1;
    cudaError_t err = allow_tot(syrk_lower_kernel);
    if (err != cudaSuccess) return int(err);
    const int r = m / TILE - k - 1;
    dim3 grid(r * (r + 1) / 2, B);
    syrk_lower_kernel<<<grid, THREADS, TOT_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(T, m, k);
    return int(cudaGetLastError());
}
