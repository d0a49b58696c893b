// Symmetric normal-matrix assembly, batched:
//
//   M[b] = (A[b] * d2[b]) @ A[b]^T      A (B, m, n) bf16 or f32, d2 (B, n) f32
//                                       M (B, m, m) f32, exactly symmetric
//
// Replaces the Pallas kernel _assemble_sym_kernel of ipx/kernels/cholesky.py
// (entry assemble_sym_batched).
//
// Bound on this card: operations.  Only the lower triangle of 128 x 128
// tiles is computed, about m*m*n/2 float32 FMAs per instance, against
// 2*m*n (bf16) bytes in and 4*m*m bytes out; at m = 1024, n = 2048 that is
// some 250 FMAs per byte, so the float32 FMA rate of the CUDA cores is the
// limit and the design is a register-tiled product: each block owns one
// lower-triangle tile of one instance, 256 threads hold an 8 x 8 block of
// sums each, the two 128 x 16 operand tiles pass through shared memory
// (stored k-major so that the inner loop reads float4s), and the next
// operand tiles are fetched from device memory into registers while the
// current ones are multiplied.
//
// What is kept from the TPU kernel is the FUNCTION, not its blocking: a
// diagonal tile is written as 0.5 * (T + T^T), an off-diagonal tile is
// written twice (as is, and transposed into the upper triangle).  Computing
// both triangles independently would round the two products differently and
// M would stop being exactly symmetric.  Not kept: the whole-A residency in
// fast memory and its shape gate, and the 3-term bf16 split of the f32
// operand.  The split exists because the TPU's matrix unit multiplies bf16
// only; here A is upcast in registers (a bf16 value is exact in float32),
// scaled by d2 in float32 and accumulated with float32 FMAs, which is the
// product the split emulates.  The kernel is therefore always f32-faithful:
// there is no counterpart of the 2-term "high" mode.  If this kernel ever
// moves to tensor cores the split has to come back.  No TF32 anywhere.
//
// Summation order.  One chain of n float32 FMAs per entry loses digits that
// the interior-point iteration above needs: with d2 = x/s spread over many
// decades, a 2048-term chain is 5e-6 of |M| off, the factor of that M is a
// worse preconditioner, and many lanes of a batch that converge with an
// exact M stall instead (PERF.md has the counts).  So the contraction is
// summed in two levels: chunks of KC = 64 columns in registers, the chunk
// sums added in a fixed order into a per-thread total kept in shared memory
// (64 KB a block; registers hold one 8 x 8 block only, and only one block
// fits an SM anyway).  The tile product lives in panel_common.cuh, shared with
// the panel kernels of the factor.  The error bound drops from n to KC + n / KC
// roundings.
//
// Shapes: any m, n >= 1; ragged edges are masked in the kernel.

#include "panel_common.cuh"

namespace {

using namespace ipx_tile;   // the tile product and its two-level sum

template <typename T>
__global__ void __launch_bounds__(THREADS)
assemble_sym_kernel(const T* __restrict__ A, const float* __restrict__ d2,
                    float* M, int m, int n, int vec_ok) {
    __shared__ __align__(16) float Xs[BK][LDS];   // (A_i * d2) tile, [k][row]
    __shared__ __align__(16) float Ys[BK][LDS];   // A_j tile,        [k][row]
    extern __shared__ float tot[];                // parked chunk sums

    // blockIdx.x -> lower-triangle tile (bi >= bj), p = bi (bi + 1) / 2 + bj
    const int p = blockIdx.x;
    int bi = int((sqrtf(8.f * float(p) + 1.f) - 1.f) * 0.5f);
    while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
    while (bi * (bi + 1) / 2 > p) --bi;
    const int bj = p - bi * (bi + 1) / 2;

    const size_t b = blockIdx.y;
    const T* Ab = A + b * size_t(m) * size_t(n);
    const float* d2b = d2 + b * size_t(n);
    float* Mb = M + b * size_t(m) * size_t(m);

    const int tid = threadIdx.x;
    // loader role: row lr of each operand tile
    const int lr = tid >> 1;
    const int xi = bi * TILE + lr, yj = bj * TILE + lr;
    const bool x_ok = xi < m, y_ok = yj < m;
    const T* xrow = Ab + size_t(x_ok ? xi : 0) * n;
    const T* yrow = Ab + size_t(y_ok ? yj : 0) * n;
    const int tx = tid & 15, ty = tid >> 4;

    float acc[8][8];
    assembly_tile(xrow, yrow, x_ok, y_ok, d2b, n, vec_ok != 0, Xs, Ys, tot,
                  tid, acc);

    int gi[8], gj[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        gi[e] = bi * TILE + ty * 4 + tile_off(e);
        gj[e] = bj * TILE + tx * 4 + tile_off(e);
    }

    if (bi != bj) {
        // off-diagonal tile: as is, and mirrored into the upper triangle
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (gi[i] < m && gj[j] < m) {
                    Mb[size_t(gi[i]) * m + gj[j]] = acc[i][j];
                    Mb[size_t(gj[j]) * m + gi[i]] = acc[i][j];
                }
        return;
    }

    // diagonal tile: 0.5 * (T + T^T).  The transposed entry lives in another
    // thread, so T goes through M itself (the block's own writes are visible
    // to it after the barrier); a + b is commutative, so entry (i, j) and
    // entry (j, i) get the same bits.
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (gi[i] < m && gj[j] < m)
                Mb[size_t(gi[i]) * m + gj[j]] = acc[i][j];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (gi[i] < m && gj[j] < m)
                acc[i][j] = 0.5f * (acc[i][j]
                                    + __ldcg(&Mb[size_t(gj[j]) * m + gi[i]]));
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (gi[i] < m && gj[j] < m)
                Mb[size_t(gi[i]) * m + gj[j]] = acc[i][j];
}

template <typename T>
int launch(const void* A, const float* d2, float* M, int B, int m, int n,
           cudaStream_t stream) {
    const int nt = (m + TILE - 1) / TILE;
    const int vec_ok = (n % 8 == 0)
                       && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
    dim3 grid(nt * (nt + 1) / 2, B);
    cudaError_t err = cudaFuncSetAttribute(
        assemble_sym_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(TOT_BYTES));
    if (err != cudaSuccess) return int(err);
    assemble_sym_kernel<T><<<grid, THREADS, TOT_BYTES, stream>>>(
        static_cast<const T*>(A), d2, M, m, n, vec_ok);
    return int(cudaGetLastError());
}

}  // namespace

// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int ipx_assemble_sym(const void* A, int a_is_bf16, const float* d2,
                                float* M, int B, int m, int n, void* stream) {
    if (B < 1 || m < 1 || n < 1 || B > 65535) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a_is_bf16) return launch<__nv_bfloat16>(A, d2, M, B, m, n, s);
    return launch<float>(A, d2, M, B, m, n, s);
}
