// Row 2 (y = A w, or (A o A) w) fed by a ring of bulk copies, for
// probes/row_variants.py to compare with ipx_torch/csrc/row_matvec.cu's
// non-allocating 16-byte loads.  Not part of the package.
//
// One producer warp and CONSUMERS consumer warps a block.  The block takes
// ROWS rows of one instance over one span of columns, as rows_a_kernel does
// (ROWS_A = 32 rows there too).  Each step is one warp-width of granules
// (512 bytes) of each of the ROWS rows: the producer's lane r asks for row
// r's 512 bytes with one cp.async.bulk into the step's ring stage, which
// completes on the stage's full mbarrier; consumer warp c sums rows c RW ..
// c RW + RW - 1 from shared memory, each lane its granule, and arrives on
// the stage's empty mbarrier.  The arithmetic and its order are
// rows_a_kernel's (same columns a lane, the even and odd chains, the same
// shuffle tree), so y has its bits.  Rows must be 16-byte aligned (n *
// itemsize a multiple of 16); the entry refuses other shapes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 8;
constexpr int THREADS = 32 * (CONSUMERS + 1);
constexpr int RW = 4;
constexpr int ROWS = CONSUMERS * RW;           // 32
constexpr int STAGES = 4;
constexpr int STEP_BYTES = 512;                // a warp-width of granules
constexpr int STAGE_BYTES = ROWS * STEP_BYTES;
constexpr int SPAN_MAX = 4096;
constexpr size_t SMEM = size_t(SPAN_MAX) * 8 + size_t(STAGES) * STAGE_BYTES
                        + 2 * STAGES * 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return unsigned(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* b, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
    unsigned done;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void bulk(void* dst, const void* src,
                                     unsigned bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                    "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ unsigned word(const uint4& g, int i) {
    return i == 0 ? g.x : i == 1 ? g.y : i == 2 ? g.z : g.w;
}

template <typename T> __device__ __forceinline__ float at(const uint4&, int);
template <> __device__ __forceinline__ float at<float>(const uint4& g, int e) {
    return __uint_as_float(word(g, e));
}
template <> __device__ __forceinline__ float at<__nv_bfloat16>(const uint4& g,
                                                               int e) {
    const unsigned w = word(g, e >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <typename T, bool SQ>
__global__ void __launch_bounds__(THREADS)
bulk_a_kernel(const T* __restrict__ A, const float* __restrict__ w,
              float* __restrict__ y32, double* __restrict__ y64,
              double* __restrict__ part, int m, int n, int span, int nrb) {
    constexpr int VEC = 16 / int(sizeof(T));
    constexpr int CW = 32 * VEC;
    extern __shared__ uint4 smem[];
    double* wd = reinterpret_cast<double*>(smem);
    const double2* ws = reinterpret_cast<const double2*>(smem);
    char* ring = reinterpret_cast<char*>(smem) + SPAN_MAX * 8;
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int rb = blockIdx.x % nrb, sp = blockIdx.x / nrb;
    const size_t b = blockIdx.y;
    const int c0 = sp * span, cn = min(span, n - c0);
    const int r0 = rb * ROWS, live_rows = min(ROWS, m - r0);
    const int steps = (cn + CW - 1) / CW;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            bar_init(full + s, 1);
            bar_init(empty + s, CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    const float* wb = w + b * size_t(n) + c0;
    for (int c = tid; c < span; c += THREADS) {
        const int s = c / CW, q = c - s * CW, l = q / VEC, e = q - l * VEC;
        wd[s * CW + (e >> 1) * 64 + l * 2 + (e & 1)] =
            c < cn ? double(wb[c]) : 0.0;
    }
    __syncthreads();

    if (warp == CONSUMERS) {                    // the producer
        for (int s = 0; s < steps; ++s) {
            const int st = s % STAGES;
            if (s >= STAGES) bar_wait(empty + st, ((s / STAGES) - 1) & 1);
            const unsigned bytes = unsigned(
                min(CW, cn - s * CW) * int(sizeof(T)));
            if (lane == 0) bar_expect(full + st, bytes * live_rows);
            __syncwarp();
            if (lane < live_rows)
                bulk(ring + st * STAGE_BYTES + lane * STEP_BYTES,
                     A + (b * size_t(m) + size_t(r0 + lane)) * size_t(n) + c0
                         + size_t(s) * CW,
                     bytes, full + st);
        }
        return;
    }

    double even[RW], odd[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) even[r] = odd[r] = 0.0;
    const int row0 = warp * RW;
    for (int s = 0; s < steps; ++s) {
        const int st = s % STAGES;
        bar_wait(full + st, (s / STAGES) & 1);
        const int k = cn - (s * CW + lane * VEC);
        const double2* wp = ws + s * (CW / 2) + lane;
        uint4 g[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r)
            g[r] = (row0 + r < live_rows && k > 0)
                ? *reinterpret_cast<const uint4*>(
                      ring + st * STAGE_BYTES + (row0 + r) * STEP_BYTES
                      + lane * 16)
                : make_uint4(0u, 0u, 0u, 0u);
        __syncwarp();
        if (lane == 0) bar_arrive(empty + st);
#pragma unroll
        for (int p = 0; p < VEC / 2; ++p) {
            const double2 wv = wp[p * 32];
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                const double x0 = at<T>(g[r], 2 * p);
                const double x1 = at<T>(g[r], 2 * p + 1);
                even[r] = fma(SQ ? x0 * x0 : x0, wv.x, even[r]);
                odd[r] = fma(SQ ? x1 * x1 : x1, wv.y, odd[r]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        double sum = even[r] + odd[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0 && row0 + r < live_rows) {
            const size_t i = size_t(r0 + row0 + r);
            if (part)
                part[(b * (gridDim.x / nrb) + sp) * size_t(m) + i] = sum;
            else if (y64)
                y64[b * size_t(m) + i] = sum;
            else
                y32[b * size_t(m) + i] = float(sum);
        }
    }
}

__global__ void sum_parts_kernel(const double* __restrict__ part,
                                 float* __restrict__ o32,
                                 double* __restrict__ o64, int len,
                                 int parts) {
    const int i = blockIdx.x * 256 + threadIdx.x;
    const size_t b = blockIdx.y;
    if (i >= len) return;
    const double* p = part + b * size_t(parts) * size_t(len) + i;
    double acc = 0.0;
    for (int s = 0; s < parts; ++s) acc += p[size_t(s) * len];
    if (o64)
        o64[b * size_t(len) + i] = acc;
    else
        o32[b * size_t(len) + i] = float(acc);
}

template <typename T, bool SQ>
int launch(const void* A, const float* w, float* y32, double* y64,
           double* part, int span, int B, int m, int n, cudaStream_t s) {
    auto kern = bulk_a_kernel<T, SQ>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
    if (err != cudaSuccess) return int(err);
    const int nrb = (m + ROWS - 1) / ROWS, ns = (n + span - 1) / span;
    kern<<<dim3(nrb * ns, B), THREADS, SMEM, s>>>(
        static_cast<const T*>(A), w, y32, y64, ns > 1 ? part : nullptr, m, n,
        span, nrb);
    err = cudaGetLastError();
    if (err != cudaSuccess || ns == 1) return int(err);
    sum_parts_kernel<<<dim3((m + 255) / 256, B), 256, 0, s>>>(part, y32, y64,
                                                             m, ns);
    return int(cudaGetLastError());
}

}  // namespace

// ipx_rows_a's arguments; -1 where rows are not 16-byte aligned
extern "C" int ipx_rows_a(const void* A, int a_is_bf16, const float* w,
                          int square, float* y32, double* y64, double* part,
                          int span, int B, int m, int n, void* stream) {
    const int isz = a_is_bf16 ? 2 : 4, cw = 32 * (16 / isz);
    if (n % (16 / isz) != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0)
        return -1;
    if (span < cw || span > SPAN_MAX || span % cw != 0 || B < 1 || B > 65535)
        return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a_is_bf16)
        return square ? launch<__nv_bfloat16, true>(A, w, y32, y64, part,
                                                     span, B, m, n, s)
                      : launch<__nv_bfloat16, false>(A, w, y32, y64, part,
                                                      span, B, m, n, s);
    return square ? launch<float, true>(A, w, y32, y64, part, span, B, m, n, s)
                  : launch<float, false>(A, w, y32, y64, part, span, B, m, n,
                                         s);
}
