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
// fits an SM anyway).  The error bound drops from n to KC + n / KC
// roundings.
//
// Shapes: any m, n >= 1; ragged edges are masked in the kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;           // rows and columns of M per block
constexpr int BK = 16;              // contraction depth per shared-memory pass
constexpr int LDS = TILE + 4;       // shared row stride (floats), 16-byte rows
constexpr int THREADS = 256;        // 16 x 16 threads, 8 x 8 sums each
constexpr int KC = 64;              // columns per chunk of the two-level sum
static_assert(KC % BK == 0, "a chunk is a whole number of passes");
constexpr size_t TOT_BYTES = size_t(64) * THREADS * sizeof(float);

// load8: eight consecutive k-entries of one row of A, as floats, zero outside
__device__ __forceinline__ void unpack8(const uint4& q, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(p[e]);
        out[2 * e] = f.x;
        out[2 * e + 1] = f.y;
    }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int k, int n,
                                      bool row_ok, bool vec_ok, float* out) {
    if (row_ok && vec_ok && k + 8 <= n) {
        unpack8(*reinterpret_cast<const uint4*>(row + k), out);
        return;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
        out[e] = (row_ok && k + e < n) ? __bfloat162float(row[k + e]) : 0.f;
}

__device__ __forceinline__ void load8(const float* row, int k, int n,
                                      bool row_ok, bool vec_ok, float* out) {
    if (row_ok && vec_ok && k + 8 <= n) {
        const float4 a = *reinterpret_cast<const float4*>(row + k);
        const float4 c = *reinterpret_cast<const float4*>(row + k + 4);
        out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
        out[4] = c.x; out[5] = c.y; out[6] = c.z; out[7] = c.w;
        return;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
        out[e] = (row_ok && k + e < n) ? row[k + e] : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
assemble_sym_kernel(const T* __restrict__ A, const float* __restrict__ d2,
                    float* M, int m, int n, int vec_ok) {
    __shared__ __align__(16) float Xs[BK][LDS];   // (A_i * d2) tile, [k][row]
    __shared__ __align__(16) float Ys[BK][LDS];   // A_j tile,        [k][row]
    // running total of the finished chunks: entry e of thread t at
    // [e * THREADS + t], private to its thread, so no barrier guards it
    extern __shared__ float tot[];

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
    // loader role: row lr of each tile, k-entries lk .. lk + 7 of the pass
    const int lr = tid >> 1, lk = (tid & 1) * 8;
    const int xi = bi * TILE + lr, yj = bj * TILE + lr;
    const bool x_ok = xi < m, y_ok = yj < m;
    const T* xrow = Ab + size_t(x_ok ? xi : 0) * n;
    const T* yrow = Ab + size_t(y_ok ? yj : 0) * n;
    // compute role: rows ty*4..+3 and 64+ty*4..+3, columns likewise with tx
    const int tx = tid & 15, ty = tid >> 4;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            acc[i][j] = 0.f;
            tot[(i * 8 + j) * THREADS + tid] = 0.f;
        }

    float xr[8], yr[8];
    load8(xrow, lk, n, x_ok, vec_ok, xr);
    load8(yrow, lk, n, y_ok, vec_ok, yr);
#pragma unroll
    for (int e = 0; e < 8; ++e)
        xr[e] *= (lk + e < n) ? d2b[lk + e] : 0.f;

    for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            Xs[lk + e][lr] = xr[e];
            Ys[lk + e][lr] = yr[e];
        }
        __syncthreads();
        const int kn = k0 + BK + lk;         // this thread's next entries
        if (k0 + BK < n) {
            load8(xrow, kn, n, x_ok, vec_ok, xr);
            load8(yrow, kn, n, y_ok, vec_ok, yr);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                xr[e] *= (kn + e < n) ? d2b[kn + e] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&Xs[k][ty * 4]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&Xs[k][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Ys[k][tx * 4]);
            const float4 b1 =
                *reinterpret_cast<const float4*>(&Ys[k][64 + tx * 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float c[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
        }
        if ((k0 + BK) % KC == 0) {           // a chunk is complete
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    tot[(i * 8 + j) * THREADS + tid] += acc[i][j];
                    acc[i][j] = 0.f;
                }
        }
        __syncthreads();
    }
    // total = finished chunks + the ragged last chunk (zero if n % KC == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            acc[i][j] += tot[(i * 8 + j) * THREADS + tid];

    int gi[8], gj[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int off = (e < 4) ? e : 60 + e;          // 0..3, 64..67
        gi[e] = bi * TILE + ty * 4 + off;
        gj[e] = bj * TILE + tx * 4 + off;
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
