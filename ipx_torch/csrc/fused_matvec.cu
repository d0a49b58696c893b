// One-stream evaluation against a batched dense A (row-major, (B, m, n),
// stored float32 or bfloat16):
//
//   t = A^T v,  y = A (alpha * (t + beta) + w)   one read of A
//
// Replaces the Pallas column-stripe kernel of ipx/kernels/fused.py:
// _ata_kernel (entry ata_apply).  The two halves on their own (_a_kernel,
// _at_kernel) are the row streams of row_matvec.cu.
//
// Bound on this card: bytes.  Each call does 4 flops per element of A, far
// below the flops-per-byte at which an H100 stops waiting for memory, so the
// least time is bytes(A) / memory rate, and the point is to pay it once where
// two dependent matvecs pay it twice.
//
// Design.  One block per (instance, column stripe of W columns).  The block
// asks for its whole m x W stripe at once with asynchronous 16-byte copies
// (cp.async), in NCHUNK row chunks, each completing on its own mbarrier, and
// keeps it in shared memory in the stored type.  t for a column needs all m
// rows of that column, so it is complete inside the block: phase 1 consumes
// each chunk as it lands, each thread summing one 16-byte granule of columns
// over a strided set of rows, and the threads' sums are combined by a fixed
// shuffle tree and then across warps in order.  Then
// u = alpha * (t + beta) + w is formed for the W columns and the stripe is
// read AGAIN from shared memory for the block's partial y (one row per
// thread).  The blocks of CLUSTER = 2 neighbouring stripes form a
// thread-block cluster: each parks its partial y in shared memory, and block
// r of the cluster sums rows r m / 2 .. of both in rank order, reading the
// other's shared memory directly.  Those pair sums go to a
// (B, n_stripes / 2, m) scratch, half of one partial a stripe, and a second
// small kernel sums them in a fixed order.  (Clusters of four and eight
// stripes were slower on an H100; PERF.md.)
// No atomics: the result is the same bit for bit from launch to launch and at
// any B, which the interior-point iteration above needs to be comparable
// with anything.  The TPU kernel's sequential grid that
// accumulates y across stripes has no counterpart: blocks run in no order
// here.
//
// Conversions.  A float32-to-float64 conversion costs a warp four times an
// f64 FMA on this card, and one per element of A is the larger part of the
// kernel's arithmetic.  v is staged as double once per block, and each element
// of A is converted once per phase: twice in all.  bf16 -> float32 is a shift.
//
// Where n * itemsize is not a multiple of 16 bytes the rows are not 16-byte
// aligned and the stripe is staged element by element, synchronously; that
// depends on the shape only.
//
// Sums are accumulated in float64 and rounded to float32 once, at the end
// (the stripe partials of y stay float64 in the scratch).  The f64 FMAs cost
// little beside the stream; the conversions to f64 are what the sums cost
// (above).  What they buy is residuals A x - b and
// A^T y + s - c that are correct to the last float32 bit where a float32
// chain of m or n terms leaves an error that the interior-point iteration
// cannot get under: measurably more lanes of a batch reach the tolerance.
//
// Shapes: any m, n >= 1 (ragged last stripe masked), as long as an m x 8
// stripe fits in shared memory; the wrapper picks W and refuses larger m.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NCHUNK = 8;           // row chunks of the asynchronous copy
constexpr int CLUSTER = 2;          // stripes whose partial y a cluster sums
constexpr size_t SMEM_LIMIT = 227u * 1024u;

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16
zero_of<__nv_bfloat16>() {
    return __float2bfloat16(0.f);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return unsigned(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros where `bytes` is 0
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// the barrier completes once every thread's copies issued so far have landed
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// wait for the first phase of a barrier (each is used once)
__device__ __forceinline__ void bar_wait(uint64_t* bar) {
    unsigned done;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    } while (!done);
}

// The stripe is kept row by row, W elements a row, no padding, in 16-byte
// granules: granule q of row r sits at granule q ^ swz(r) of the row.  With
// G granules a row, 8 / G rows share 128 bytes (the 32 banks); the XOR
// spreads the rows that a quarter-warp's 16-byte loads touch together over
// distinct banks, for the one-row-per-thread pass of phase 2 and the
// one-column-per-thread pass of phase 1 alike.  (Padding the rows instead,
// as an odd stride would, breaks the 16-byte alignment cp.async needs.)
// (G = 2^lg granules a row; shifts, not divisions)
__device__ __forceinline__ int swz(int r, int lg) {
    return (r >> (lg >= 3 ? 0 : 3 - lg)) & ((1 << lg) - 1);
}

// entry c of row r (rows of 2^lw entries): its offset in elements from the
// stripe's start
template <typename T>
__device__ __forceinline__ int at_rc(int r, int c, int lw, int lg) {
    constexpr int VEC = 16 / int(sizeof(T));
    return (r << lw) + (((c / VEC) ^ swz(r, lg)) * VEC) + c % VEC;
}

// a granule's VEC entries as floats (bf16 -> float32 is exact)
__device__ __forceinline__ void unpack(const uint4& g, float (&f)[4]) {
    f[0] = __uint_as_float(g.x); f[1] = __uint_as_float(g.y);
    f[2] = __uint_as_float(g.z); f[3] = __uint_as_float(g.w);
}
__device__ __forceinline__ void unpack(const uint4& g, float (&f)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(p[e]);
        f[2 * e] = x.x;
        f[2 * e + 1] = x.y;
    }
}

// one stripe row (W stored elements) dotted with u (W doubles), read a
// granule at a time, the even and the odd entries in two chains that meet at
// the end
template <typename T>
__device__ __forceinline__ double row_dot(const T* row, int r, const double* u,
                                          int lg) {
    constexpr int VEC = 16 / int(sizeof(T));
    const uint4* q = reinterpret_cast<const uint4*>(row);
    const int s = swz(r, lg);
    double even = 0.0, odd = 0.0;
    for (int g = 0; g < (1 << lg); ++g) {
        float f[VEC];
        unpack(q[g ^ s], f);
#pragma unroll
        for (int e = 0; e < VEC; e += 2) {
            const double x0 = f[e], x1 = f[e + 1];
            even = fma(x0, u[g * VEC + e], even);
            odd = fma(x1, u[g * VEC + e + 1], odd);
        }
    }
    return even + odd;
}

inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

// The NCHUNK copy barriers (a region of their own: the memory of a live
// mbarrier is not reused), the stripe, the warps' phase-1 column sums
// (WARPS x W doubles), W doubles of u and m doubles of v.  Which m fits at
// all does not depend on the copy path.
constexpr int WARPS = THREADS / 32;
constexpr size_t BARS_BYTES = NCHUNK * sizeof(uint64_t);
inline size_t stripe_smem_bytes(int m, int W, int itemsize) {
    return BARS_BYTES + round16(size_t(m) * W * itemsize)
           + size_t(WARPS + 1) * W * sizeof(double) + size_t(m) * sizeof(double);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
stripe_kernel(const T* __restrict__ A, const float* __restrict__ v,
              const float* __restrict__ alpha, const float* __restrict__ beta,
              const float* __restrict__ w, float* __restrict__ t_out,
              double* __restrict__ ypart, int m, int n, int lw, int vec_ok,
              size_t as_bytes) {
    extern __shared__ uint4 smem_raw[];
    constexpr int VEC = 16 / int(sizeof(T));
    const int W = 1 << lw;
    const int lg = lw - (sizeof(T) == 2 ? 3 : 2);  // 16-byte granules a row
    const int G = 1 << lg;
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // NCHUNK
    T* As = reinterpret_cast<T*>(
        reinterpret_cast<char*>(smem_raw) + BARS_BYTES);
    double* red = reinterpret_cast<double*>(
        reinterpret_cast<char*>(As) + as_bytes);           // WARPS x W
    double* us = red + WARPS * W;                          // W
    double* vs = us + W;                                   // m

    const int tid = threadIdx.x;
    const int stripe = blockIdx.x;
    const size_t b = blockIdx.y;
    const int c0 = stripe << lw;
    const T* Ab = A + b * size_t(m) * size_t(n);
    const int rc = (m + NCHUNK - 1) / NCHUNK;      // rows of a copy chunk

    // ---- phase 0: ask for the stripe; stage v ------------------------------
    if (vec_ok) {
        if (tid == 0)
            for (int c = 0; c < NCHUNK; ++c) bar_init(bars + c, THREADS);
        __syncthreads();
        for (int c = 0; c < NCHUNK; ++c) {
            const int r0 = c * rc, r1 = min(m, r0 + rc);
            for (int idx = r0 * G + tid; idx < r1 * G; idx += THREADS) {
                const int r = idx / G, qq = idx - r * G;
                const int col = c0 + qq * VEC;
                // n % VEC == 0: the granule is all in or all out (zeros)
                const bool in = col < n;
                cp16(As + at_rc<T>(r, qq * VEC, lw, lg),
                     in ? Ab + size_t(r) * n + col : Ab, in ? 16 : 0);
            }
            cp_arrive(bars + c);
        }
    } else {
        for (int idx = tid; idx < (m << lw); idx += THREADS) {
            const int r = idx >> lw, c = idx & (W - 1);
            As[at_rc<T>(r, c, lw, lg)] = (c0 + c < n)
                ? Ab[size_t(r) * n + c0 + c] : zero_of<T>();
        }
    }
    for (int i = tid; i < m; i += THREADS) vs[i] = double(v[b * m + i]);
    __syncthreads();

    // ---- phase 1: t = A_S^T v, complete inside the block.  Thread (rg, q)
    // takes granule q (VEC columns) of rows rg, rg + RG, ... as they land,
    // one shared-memory load for VEC entries; the column sums go through a
    // fixed shuffle tree over the warp's lanes with the same q, then over
    // the warps in order --------------------------------------------------
    {
        const int q = tid & (G - 1), rg = tid >> lg, RG = THREADS >> lg;
        const int lane = tid & 31, warp = tid >> 5;
        double acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.0;
        int next = 0;                            // first chunk not waited for
        for (int i = rg; i < m; i += RG) {
            while (vec_ok && i >= next * rc) bar_wait(bars + next++);
            const double vi = vs[i];
            const uint4 g4 = *reinterpret_cast<const uint4*>(
                As + at_rc<T>(i, q * VEC, lw, lg));
            float f[VEC];
            unpack(g4, f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fma(double(f[e]), vi, acc[e]);
        }
#pragma unroll
        for (int off = G; off < 32; off <<= 1)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
        if (lane < G)
#pragma unroll
            for (int e = 0; e < VEC; ++e) red[warp * W + lane * VEC + e] = acc[e];
        __syncthreads();
        if (tid < W) {
            double td = 0.0;
            for (int wp = 0; wp < WARPS; ++wp) td += red[wp * W + tid];
            const float t = float(td);           // the one rounding of t
            const int col = c0 + tid;
            const bool in = col < n;
            if (in) t_out[b * n + col] = t;
            const size_t o = b * n + col;
            const float a = (alpha && in) ? alpha[o] : 0.f;
            const float be = (beta && in) ? beta[o] : 0.f;
            const float ww = (w && in) ? w[o] : 0.f;
            // (t + beta) rounded first; no contraction into an FMA, so the
            // plain version reproduces u exactly
            const float e = __fadd_rn(t, be);
            us[tid] = in ? double(__fadd_rn(__fmul_rn(a, e), ww)) : 0.0;
        }
        __syncthreads();
    }

    // ---- phase 2: this stripe's share of y = A u, parked in the first 8
    // bytes of the row's own stripe storage (only this thread reads the row
    // here, and the value depends on every entry it read) -------------------
    {
        for (int i = tid; i < m; i += THREADS) {
            const double y = row_dot(As + i * W, i, us, lg);
            *reinterpret_cast<double*>(As + i * W) = y;
        }
        // ---- the cluster's stripes: block r sums its share of the rows over
        // the cluster's blocks in rank order ---------------------------------
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        const int r = int(cl.block_rank());
        const int per = (m + CLUSTER - 1) / CLUSTER;
        double* yp = ypart
            + (b * (gridDim.x / CLUSTER) + stripe / CLUSTER) * size_t(m);
        for (int i = r * per + tid; i < min(m, (r + 1) * per); i += THREADS) {
            double acc = 0.0;
            for (int s = 0; s < CLUSTER; ++s)
                acc += *cl.map_shared_rank(
                    reinterpret_cast<double*>(As + i * W), s);
            yp[i] = acc;
        }
        cl.sync();                  // no block leaves while others read it
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

template <typename T>
int launch(const void* A, const float* v, const float* alpha,
           const float* beta, const float* w, float* y, float* t,
           double* ypart, int B, int m, int n, int W, cudaStream_t stream) {
    int lw = 0;
    while ((1 << lw) < W) ++lw;
    const size_t as_bytes = round16(size_t(m) * W * sizeof(T));
    const size_t smem = stripe_smem_bytes(m, W, int(sizeof(T)));
    auto kern = stripe_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    constexpr int VEC = 16 / int(sizeof(T));
    const int vec_ok = (n % VEC == 0) && (W % VEC == 0)
                       && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
    const int ns = (n + W - 1) / W;
    // the grid padded to whole pairs (a padding stripe is all columns past
    // n: its partial y is zeros)
    const int nsp = (ns + CLUSTER - 1) / CLUSTER * CLUSTER;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nsp, B);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(A), v, alpha,
                             beta, w, t, ypart, m, n, lw, vec_ok, as_bytes);
    if (err != cudaSuccess) return int(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    dim3 g2((m + THREADS - 1) / THREADS, B);
    sum_stripes_kernel<<<g2, THREADS, 0, stream>>>(ypart, y, m, nsp / CLUSTER);
    return int(cudaGetLastError());
}

}  // namespace

// v needed; alpha/beta/w may be null (zeros); writes y and t.
// ypart: (B, ceil(ceil(n / W) / 2), m) double scratch.
// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int ipx_ata_apply(const void* A, int a_is_bf16, const float* v,
                             const float* alpha, const float* beta,
                             const float* w, float* y, float* t,
                             double* ypart, int W, int B, int m, int n,
                             void* stream) {
    if (B < 1 || m < 1 || n < 1 || B > 65535) return -1;
    if (W != 8 && W != 16 && W != 32 && W != 64) return -1;
    if (stripe_smem_bytes(m, W, a_is_bf16 ? 2 : 4) > SMEM_LIMIT)
        return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a_is_bf16)
        return launch<__nv_bfloat16>(A, v, alpha, beta, w, y, t, ypart, B, m,
                                     n, W, s);
    return launch<float>(A, v, alpha, beta, w, y, t, ypart, B, m, n, W, s);
}
