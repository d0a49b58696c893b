// One-stream matvecs against a batched dense A (row-major, (B, m, n), stored
// float32 or bfloat16):
//
//   MODE_ATA  t = A^T v,  y = A (alpha * (t + beta) + w)   one read of A
//   MODE_A    y = A w
//   MODE_AT   t = A^T v
//   MODE_A2   y = (A o A) w     the elementwise square of A, same stream as
//                               MODE_A: diag(A diag(w) A^T) without a squared
//                               copy of A in device memory
//
// Replaces the Pallas column-stripe kernels of ipx/kernels/fused.py:
// _ata_kernel (entry ata_apply), _a_kernel (a_matvec), _at_kernel (at_matvec).
//
// Bound on this card: bytes.  Each call does 2 (or 4, for ATA) flops per
// element of A, far below the flops-per-byte at which an H100 stops waiting
// for memory, so the least time is bytes(A) / memory rate, and the point of
// MODE_ATA is to pay it once where two dependent matvecs pay it twice.
//
// Design.  One block per (instance, column stripe of W columns).  The block
// copies its m x W stripe from device memory into shared memory ONCE, in the
// stored type.  t for a column needs all m rows of that column, so it is
// complete inside the block: a strided row reduction per thread, combined
// across thread groups through shared memory in a fixed order.  Then
// u = alpha * (t + beta) + w is formed for the W columns and the stripe is
// read AGAIN from shared memory for the block's partial y (one row per
// thread).  The partial y of every stripe goes to a (B, n_stripes, m) scratch
// and a second small kernel sums the stripes in a fixed order.  No atomics:
// the result is the same bit for bit from launch to launch, which the
// interior-point iteration above needs to be comparable with anything.
// The TPU kernel's sequential grid that accumulates y across stripes has no
// counterpart: blocks run in no order here.
//
// Two properties the caller relies on:
//   * (t + beta) is rounded as a float32 sum BEFORE it meets alpha
//     (alpha = x/s reaches 1e10 near convergence; t + beta is a difference
//     of O(1) quantities that cancels almost completely);
//   * the t written out is bit for bit the t that was used for y.
//
// A bf16 value is exact in float32, so the stripe is upcast in registers;
// the TPU kernel instead emulates the f32 x bf16 product with a 3-way bf16
// split of the vector because its matrix unit multiplies bf16 only.  If
// these kernels ever move to tensor cores the split has to come back.  No
// TF32 anywhere.
//
// Sums are accumulated in float64 and rounded to float32 once, at the end
// (the stripe partials of y stay float64 in the scratch).  The kernels wait
// for memory, and the card's float64 rate is far above what the stream
// needs, so this costs little; what it buys is residuals A x - b and
// A^T y + s - c that are correct to the last float32 bit where a float32
// chain of m or n terms leaves an error that the interior-point iteration
// cannot get under: measurably more lanes of a batch reach the tolerance.
//
// Shapes: any m, n >= 1 (ragged last stripe masked), as long as an m x 8
// stripe fits in shared memory; the wrapper picks W and refuses larger m.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MODE_ATA = 0, MODE_A = 1, MODE_AT = 2, MODE_A2 = 3;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ float
to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16
zero_of<__nv_bfloat16>() {
    return __float2bfloat16(0.f);
}

// dot of one shared-memory stripe row (W stored elements) with u (W doubles);
// SQ squares the row's entries first (exact in double)
template <bool SQ>
__device__ __forceinline__ double entry(float a) {
    const double d = double(a);
    return SQ ? d * d : d;
}
template <bool SQ>
__device__ __forceinline__ double row_dot(const float* row, const double* u,
                                          int W) {
    double acc = 0.0;
#pragma unroll 8
    for (int c = 0; c < W; ++c) acc = fma(entry<SQ>(row[c]), u[c], acc);
    return acc;
}
template <bool SQ>
__device__ __forceinline__ double row_dot(const __nv_bfloat16* row,
                                          const double* u, int W) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(row);
    double acc = 0.0;
#pragma unroll 8
    for (int c2 = 0; c2 < W / 2; ++c2) {
        float2 f = __bfloat1622float2(p[c2]);
        acc = fma(entry<SQ>(f.x), u[2 * c2], acc);
        acc = fma(entry<SQ>(f.y), u[2 * c2 + 1], acc);
    }
    return acc;
}

// Row stride of the staged stripe, in elements: W plus padding that makes
// the stride an ODD number of 32-bit words, so that the one-row-per-thread
// pass of phase 2 hits 32 different banks.
__host__ __device__ inline int stripe_ld(int W, int itemsize) {
    int words = (W * itemsize / 4) | 1;
    return words * 4 / itemsize;
}

inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

inline size_t stripe_smem_bytes(int m, int W, int itemsize) {
    return round16(size_t(m) * stripe_ld(W, itemsize) * itemsize)
           + size_t(THREADS + W) * sizeof(double) + size_t(m) * sizeof(float);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
stripe_kernel(const T* __restrict__ A, const float* __restrict__ v,
              const float* __restrict__ alpha, const float* __restrict__ beta,
              const float* __restrict__ w, float* __restrict__ t_out,
              double* __restrict__ ypart, int m, int n, int lw, int vec_ok,
              size_t as_bytes) {
    extern __shared__ uint4 smem_raw[];
    constexpr bool ONLY_A = MODE == MODE_A || MODE == MODE_A2;
    const int W = 1 << lw;
    const int ld = stripe_ld(W, int(sizeof(T)));
    T* As = reinterpret_cast<T*>(smem_raw);
    double* red = reinterpret_cast<double*>(
        reinterpret_cast<char*>(smem_raw) + as_bytes);     // THREADS
    double* us = red + THREADS;                            // W
    float* vs = reinterpret_cast<float*>(us + W);          // m

    const int tid = threadIdx.x;
    const int stripe = blockIdx.x;
    const int ns = gridDim.x;
    const size_t b = blockIdx.y;
    const int c0 = stripe << lw;
    const T* Ab = A + b * size_t(m) * size_t(n);

    // ---- phase 0: stage the stripe (and v, or u) in shared memory --------
    if (vec_ok) {
        constexpr int VEC = 16 / int(sizeof(T));
        const int cpr = W / VEC;                 // 16-byte chunks per row
        for (int idx = tid; idx < m * cpr; idx += THREADS) {
            const int r = idx / cpr, q = idx - r * cpr;
            const int col = c0 + q * VEC;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (col < n)     // n % VEC == 0: the chunk is all in or all out
                val = *reinterpret_cast<const uint4*>(Ab + size_t(r) * n + col);
            uint32_t* dst = reinterpret_cast<uint32_t*>(As + r * ld + q * VEC);
            dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
        }
    } else {
        for (int idx = tid; idx < (m << lw); idx += THREADS) {
            const int r = idx >> lw, c = idx & (W - 1);
            As[r * ld + c] = (c0 + c < n) ? Ab[size_t(r) * n + c0 + c]
                                          : zero_of<T>();
        }
    }
    if (!ONLY_A) {
        for (int i = tid; i < m; i += THREADS) vs[i] = v[b * m + i];
    } else if (tid < W) {
        us[tid] = (c0 + tid < n) ? double(w[b * n + c0 + tid]) : 0.0;
    }
    __syncthreads();

    // ---- phase 1: t = A_S^T v, complete inside the block -------------------
    if (!ONLY_A) {
        const int tx = tid & (W - 1), g = tid >> lw, R = THREADS >> lw;
        double acc = 0.0;
        for (int i = g; i < m; i += R)
            acc = fma(double(to_f32(As[i * ld + tx])), double(vs[i]), acc);
        red[tid] = acc;                          // tid == g * W + tx
        __syncthreads();
        if (tid < W) {
            double td = 0.0;
            for (int gg = 0; gg < R; ++gg) td += red[(gg << lw) + tid];
            const float t = float(td);           // the one rounding of t
            const int col = c0 + tid;
            const bool in = col < n;
            if (in) t_out[b * n + col] = t;
            if (MODE == MODE_ATA) {
                const size_t o = b * n + col;
                const float a = (alpha && in) ? alpha[o] : 0.f;
                const float be = (beta && in) ? beta[o] : 0.f;
                const float ww = (w && in) ? w[o] : 0.f;
                // (t + beta) rounded first; no contraction into an FMA, so
                // the plain version reproduces u exactly
                const float e = __fadd_rn(t, be);
                us[tid] = in ? double(__fadd_rn(__fmul_rn(a, e), ww)) : 0.0;
            }
        }
        __syncthreads();
    }

    // ---- phase 2: this stripe's share of y = A u ---------------------------
    if (MODE != MODE_AT) {
        double* yp = ypart + (b * ns + stripe) * size_t(m);
        for (int i = tid; i < m; i += THREADS)
            yp[i] = row_dot<MODE == MODE_A2>(As + i * ld, us, W);
    }
}

__global__ void __launch_bounds__(THREADS)
sum_stripes_kernel(const double* __restrict__ ypart, float* __restrict__ y,
                   int m, int ns) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const size_t b = blockIdx.y;
    if (i >= m) return;
    const double* p = ypart + b * ns * size_t(m) + i;
    double acc = 0.0;
    for (int s = 0; s < ns; ++s) acc += p[size_t(s) * m];   // fixed order
    y[b * m + i] = float(acc);                // the one rounding of y
}

template <typename T, int MODE>
int launch(const void* A, const float* v, const float* alpha,
           const float* beta, const float* w, float* y, float* t,
           double* ypart, int B, int m, int n, int W, cudaStream_t stream) {
    int lw = 0;
    while ((1 << lw) < W) ++lw;
    const size_t as_bytes =
        round16(size_t(m) * stripe_ld(W, int(sizeof(T))) * sizeof(T));
    const size_t smem = stripe_smem_bytes(m, W, int(sizeof(T)));
    auto kern = stripe_kernel<T, MODE>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    constexpr int VEC = 16 / int(sizeof(T));
    const int vec_ok = (n % VEC == 0) && (W % VEC == 0)
                       && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
    const int ns = (n + W - 1) / W;
    dim3 grid(ns, B);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(A), v, alpha, beta, w, t, ypart, m, n, lw,
        vec_ok, as_bytes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    if (MODE != MODE_AT) {
        dim3 g2((m + THREADS - 1) / THREADS, B);
        sum_stripes_kernel<<<g2, THREADS, 0, stream>>>(ypart, y, m, ns);
        err = cudaGetLastError();
    }
    return int(err);
}

template <typename T>
int dispatch(int mode, const void* A, const float* v, const float* alpha,
             const float* beta, const float* w, float* y, float* t,
             double* ypart, int B, int m, int n, int W, cudaStream_t s) {
    switch (mode) {
    case MODE_ATA:
        return launch<T, MODE_ATA>(A, v, alpha, beta, w, y, t, ypart, B, m, n,
                                   W, s);
    case MODE_A:
        return launch<T, MODE_A>(A, v, alpha, beta, w, y, t, ypart, B, m, n,
                                 W, s);
    case MODE_AT:
        return launch<T, MODE_AT>(A, v, alpha, beta, w, y, t, ypart, B, m, n,
                                  W, s);
    case MODE_A2:
        return launch<T, MODE_A2>(A, v, alpha, beta, w, y, t, ypart, B, m, n,
                                  W, s);
    }
    return -1;
}

}  // namespace

// mode: 0 ata (needs v; alpha/beta/w may be null = zeros; writes y, t),
//       1 a   (needs w; writes y),  2 at (needs v; writes t),
//       3 a squared (needs w; writes y = (A o A) w).
// ypart: (B, ceil(n / W), m) double scratch for modes 0 and 1.
// Returns 0, a cudaError_t, or -1 for arguments the kernels do not take.
extern "C" int ipx_fused_matvec(int mode, const void* A, int a_is_bf16,
                                const float* v, const float* alpha,
                                const float* beta, const float* w, float* y,
                                float* t, double* ypart, int B, int m, int n,
                                int W, void* stream) {
    if (B < 1 || m < 1 || n < 1 || B > 65535) return -1;
    if (W != 8 && W != 16 && W != 32 && W != 64) return -1;
    if (stripe_smem_bytes(m, W, a_is_bf16 ? 2 : 4) > 227u * 1024u) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a_is_bf16)
        return dispatch<__nv_bfloat16>(mode, A, v, alpha, beta, w, y, t,
                                       ypart, B, m, n, W, s);
    return dispatch<float>(mode, A, v, alpha, beta, w, y, t, ypart, B, m, n,
                           W, s);
}
