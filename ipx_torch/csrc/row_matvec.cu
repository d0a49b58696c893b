// Row-tiled streams of a batched dense A (row-major, (B, m, n), stored
// float32 or bfloat16) with float32 vectors:
//
//   rows_a_kernel    y = A w,  or  y = (A o A) w  (SQ: diag(A diag(w) A^T),
//                    the Jacobi diagonal, without a squared copy of A)
//   rows_at_kernel   t = A^T v
//
// Replace the Pallas column-stripe kernels of ipx/kernels/fused.py:
// _a_kernel (entry a_matvec) and _at_kernel (entry at_matvec).
//
// Bound on this card: bytes.  Two flops an element of A and no element read
// twice, so the least time is bytes(A) / memory rate, and the design keeps
// enough 16-byte loads in flight on every SM to run at that rate: nothing of
// A is staged in shared memory, so no m or n is too large.
//
// Row 2 (y = A w).  A's rows are contiguous: a warp streams RW rows side by
// side, its lanes on neighbouring 16-byte granules of each, the next step's
// RW granules loaded before this step's are summed (2 RW loads in flight a
// thread).  A block walks ROWS_A rows of one instance over one span of
// columns; w's span is staged once as doubles in shared memory, laid out so
// that a warp's reads of it are conflict-free, and serves all of those rows.
// A lane sums its columns of a row in two chains (even and odd entries), the
// lanes meet in a fixed shuffle tree.  Where n fits one span (SPAN_MAX
// columns, 32 KB of doubles) y is rounded and written at once; past it each
// span writes a float64 partial y and a second launch sums the spans in
// order.
//
// Row 3 (t = A^T v).  A block takes a tile of TILE_BYTES / itemsize rows by
// one warp-width of granules (32 x 16 bytes of each row); its warps take
// rows, the next UNROLL rows' granules loaded before this UNROLL's are
// summed (2 UNROLL loads in flight a thread), and each thread keeps float64
// sums of its granule's columns over the warp's rows in order.  The warps'
// sums meet in shared memory in warp order; each tile writes a float64
// partial t, a second launch sums the tiles in order (none when one tile
// covers m, as at m = 1024).  The partials are 8 / TILE_BYTES of A's bytes,
// written once and read once.  (On an H100, tiles of 512 bytes a column,
// whose partials were 1.6% of A, took 0.730 ms at B = 256, m = 1024, n =
// 2048, f32 A, against 0.674 now: probes/row_variants.py.)
//
// Sums are float64, rounded to float32 once at the end or handed out
// unrounded (y64, t64).  Each element of A is converted to float64 once: a
// float32-to-float64 conversion costs a warp four f64 FMAs on this card and
// is the kernels' main arithmetic, which has to hide under the stream.  bf16
// -> float32 is a shift.
//
// No atomics, and the tiling depends on (m, n, the stored type) only: a lane's
// result is the same bits at any B and from launch to launch.  Rows that are
// not 16-byte aligned (n * itemsize not a multiple of 16, or A's data off a
// 16-byte boundary) are read element by element into the same granules, so
// both paths give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPAN_MAX = 4096;    // row 2: most columns of w a block stages
constexpr int ROWS_A = 32;        // row 2: rows of A a block walks
constexpr int RW = 4;             // row 2: rows a warp streams side by side
constexpr int TILE_BYTES = 4096;  // row 3: rows of a tile x itemsize
constexpr int TILE_MAX = TILE_BYTES / 2;
constexpr int UNROLL = 4;         // row 3: rows a thread loads at once

// 16 bytes of A, not kept in L1: nothing of A is read twice
__device__ __forceinline__ uint4 ld_stream(const void* p) {
    uint4 r;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
    return r;
}

__device__ __forceinline__ unsigned word(const uint4& g, int i) {
    return i == 0 ? g.x : i == 1 ? g.y : i == 2 ? g.z : g.w;
}

template <typename T> struct Elem;

template <> struct Elem<float> {
    static constexpr int VEC = 4;
    // entry e of a granule (e known at compile time after unrolling)
    static __device__ __forceinline__ float at(const uint4& g, int e) {
        return __uint_as_float(word(g, e));
    }
    // the first k (< VEC) entries at p, read one by one; zeros after
    static __device__ __forceinline__ uint4 gather(const float* p, int k) {
        unsigned x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (e < k) x[e] = __float_as_uint(p[e]);
        return make_uint4(x[0], x[1], x[2], x[3]);
    }
};

template <> struct Elem<__nv_bfloat16> {
    static constexpr int VEC = 8;
    static __device__ __forceinline__ float at(const uint4& g, int e) {
        const unsigned w = word(g, e >> 1);
        return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    }
    static __device__ __forceinline__ uint4 gather(const __nv_bfloat16* p, int k) {
        const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
        unsigned x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
            if (e < k) x[e >> 1] |= unsigned(q[e]) << ((e & 1) * 16);
        return make_uint4(x[0], x[1], x[2], x[3]);
    }
};

// the granule at p with k of its VEC entries inside the row (k <= 0: none,
// zeros).  VEC_OK: rows 16-byte aligned and n % VEC == 0, so a granule is
// all in or all out
template <typename T, bool VEC_OK>
__device__ __forceinline__ uint4 granule(const T* p, int k) {
    if (k <= 0) return make_uint4(0u, 0u, 0u, 0u);
    if (VEC_OK || k >= Elem<T>::VEC) {
        if (VEC_OK) return ld_stream(p);
        return Elem<T>::gather(p, Elem<T>::VEC);
    }
    return Elem<T>::gather(p, k);
}

template <typename T, bool SQ, bool VEC_OK>
__global__ void __launch_bounds__(THREADS)
rows_a_kernel(const T* __restrict__ A, const float* __restrict__ w,
              float* __restrict__ y32, double* __restrict__ y64,
              double* __restrict__ part, int m, int n, int span, int nrb) {
    using E = Elem<T>;
    constexpr int VEC = E::VEC;
    constexpr int CW = 32 * VEC;          // columns a warp covers in a step
    __shared__ double2 ws[SPAN_MAX / 2];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int rb = blockIdx.x % nrb, sp = blockIdx.x / nrb;
    const size_t b = blockIdx.y;
    const int c0 = sp * span, cn = min(span, n - c0);

    // w's span as doubles, in the order the lanes read it: in step s, lane
    // l's entries 2p and 2p+1 are the double2 at s * CW / 2 + p * 32 + l
    const float* wb = w + b * size_t(n) + c0;
    double* wd = reinterpret_cast<double*>(ws);
    for (int c = tid; c < span; c += THREADS) {
        const int s = c / CW, q = c - s * CW, l = q / VEC, e = q - l * VEC;
        wd[s * CW + (e >> 1) * 64 + l * 2 + (e & 1)] =
            c < cn ? double(wb[c]) : 0.0;
    }
    __syncthreads();

    const int steps = (cn + CW - 1) / CW;
    const int r_end = min(m, (rb + 1) * ROWS_A);
    for (int r0 = rb * ROWS_A + warp * RW; r0 < r_end; r0 += WARPS * RW) {
        const T* row[RW];
        bool live[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            live[r] = r0 + r < r_end;
            row[r] = A + (b * size_t(m) + size_t(live[r] ? r0 + r : r0))
                             * size_t(n) + c0 + lane * VEC;
        }
        double even[RW], odd[RW];
        uint4 g[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            even[r] = odd[r] = 0.0;
            g[r] = live[r] ? granule<T, VEC_OK>(row[r], cn - lane * VEC)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
        for (int s = 0; s < steps; ++s) {
            // the next step's granules first: 2 RW loads in flight
            uint4 nx[RW];
            const int col = (s + 1) * CW + lane * VEC;
#pragma unroll
            for (int r = 0; r < RW; ++r)
                nx[r] = (live[r] && s + 1 < steps)
                    ? granule<T, VEC_OK>(row[r] + (s + 1) * CW, cn - col)
                    : make_uint4(0u, 0u, 0u, 0u);
            const double2* wp = ws + s * (CW / 2) + lane;
#pragma unroll
            for (int p = 0; p < VEC / 2; ++p) {
                const double2 wv = wp[p * 32];
#pragma unroll
                for (int r = 0; r < RW; ++r) {
                    const double x0 = E::at(g[r], 2 * p);
                    const double x1 = E::at(g[r], 2 * p + 1);
                    even[r] = fma(SQ ? x0 * x0 : x0, wv.x, even[r]);
                    odd[r] = fma(SQ ? x1 * x1 : x1, wv.y, odd[r]);
                }
            }
#pragma unroll
            for (int r = 0; r < RW; ++r) g[r] = nx[r];
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            double sum = even[r] + odd[r];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0 && live[r]) {
                const size_t i = size_t(r0 + r);
                if (part)
                    part[(b * (gridDim.x / nrb) + sp) * size_t(m) + i] = sum;
                else if (y64)
                    y64[b * size_t(m) + i] = sum;
                else
                    y32[b * size_t(m) + i] = float(sum);   // the one rounding
            }
        }
    }
}

template <typename T, bool VEC_OK>
__global__ void __launch_bounds__(THREADS)
rows_at_kernel(const T* __restrict__ A, const float* __restrict__ v,
               float* __restrict__ t32, double* __restrict__ t64,
               double* __restrict__ part, int m, int n, int tile, int nch) {
    using E = Elem<T>;
    constexpr int VEC = E::VEC;
    constexpr int CW = 32 * VEC;          // columns of a block
    __shared__ double vs[TILE_MAX];
    __shared__ double red[WARPS * CW];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ch = blockIdx.x % nch, tl = blockIdx.x / nch;
    const size_t b = blockIdx.y;
    const int r0 = tl * tile, rn = min(tile, m - r0);
    const int col = ch * CW + lane * VEC, k = n - col;
    for (int i = tid; i < rn; i += THREADS)
        vs[i] = double(v[b * size_t(m) + r0 + i]);
    __syncthreads();

    const T* base = A + (b * size_t(m) + size_t(r0)) * size_t(n) + col;
    double acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0;
    // warp w sums rows w, w + WARPS, w + 2 WARPS, ... of the tile in order
    uint4 g[UNROLL];
    auto load = [&](uint4 (&dst)[UNROLL], int i0) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * WARPS;
            dst[u] = i < rn ? granule<T, VEC_OK>(base + size_t(i) * n, k)
                            : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    load(g, warp);
    for (int i0 = warp; i0 < rn; i0 += WARPS * UNROLL) {
        // the next UNROLL rows first (zeros past the tile): 2 UNROLL loads
        // in flight
        uint4 nx[UNROLL];
        load(nx, i0 + WARPS * UNROLL);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * WARPS;
            if (i < rn) {                 // the same for the whole warp
                const double vi = vs[i];
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    acc[e] = fma(double(E::at(g[u], e)), vi, acc[e]);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) g[u] = nx[u];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[warp * CW + lane * VEC + e] = acc[e];
    __syncthreads();
    for (int c = tid; c < CW; c += THREADS) {
        const int gc = ch * CW + c;
        if (gc >= n) continue;
        double s = 0.0;
        for (int wp = 0; wp < WARPS; ++wp) s += red[wp * CW + c];   // in order
        if (part)
            part[(b * (gridDim.x / nch) + tl) * size_t(n) + gc] = s;
        else if (t64)
            t64[b * size_t(n) + gc] = s;
        else
            t32[b * size_t(n) + gc] = float(s);          // the one rounding
    }
}

// out[b, i] = sum over s of part[b, s, i], s in order, rounded once (o32)
// or not (o64)
__global__ void __launch_bounds__(THREADS)
sum_parts_kernel(const double* __restrict__ part, float* __restrict__ o32,
                 double* __restrict__ o64, int len, int parts) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
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

int sum_parts(const double* part, float* o32, double* o64, int B, int len,
              int parts, cudaStream_t s) {
    sum_parts_kernel<<<dim3((len + THREADS - 1) / THREADS, B), THREADS, 0,
                       s>>>(part, o32, o64, len, parts);
    return int(cudaGetLastError());
}

template <typename T, bool SQ>
int launch_a(const void* A, const float* w, float* y32, double* y64,
             double* part, int B, int m, int n, int span, bool vec_ok,
             cudaStream_t s) {
    const int nrb = (m + ROWS_A - 1) / ROWS_A, ns = (n + span - 1) / span;
    const dim3 grid(nrb * ns, B);
    double* p = ns > 1 ? part : nullptr;
    const T* a = static_cast<const T*>(A);
    if (vec_ok)
        rows_a_kernel<T, SQ, true><<<grid, THREADS, 0, s>>>(
            a, w, y32, y64, p, m, n, span, nrb);
    else
        rows_a_kernel<T, SQ, false><<<grid, THREADS, 0, s>>>(
            a, w, y32, y64, p, m, n, span, nrb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || ns == 1) return int(err);
    return sum_parts(part, y32, y64, B, m, ns, s);
}

template <typename T>
int launch_at(const void* A, const float* v, float* t32, double* t64,
              double* part, int B, int m, int n, int tile, bool vec_ok,
              cudaStream_t s) {
    constexpr int CW = 32 * Elem<T>::VEC;
    const int nch = (n + CW - 1) / CW, nt = (m + tile - 1) / tile;
    const dim3 grid(nch * nt, B);
    double* p = nt > 1 ? part : nullptr;
    const T* a = static_cast<const T*>(A);
    if (vec_ok)
        rows_at_kernel<T, true><<<grid, THREADS, 0, s>>>(
            a, v, t32, t64, p, m, n, tile, nch);
    else
        rows_at_kernel<T, false><<<grid, THREADS, 0, s>>>(
            a, v, t32, t64, p, m, n, tile, nch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || nt == 1) return int(err);
    return sum_parts(part, t32, t64, B, n, nt, s);
}

bool args_ok(int B, int m, int n, const float* y32, const double* y64,
             long long blocks) {
    return B >= 1 && B <= 65535 && m >= 1 && n >= 1
           && (y32 == nullptr) != (y64 == nullptr) && blocks <= 0x7fffffffLL;
}

bool aligned(const void* A, int n, int itemsize) {
    return n % (16 / itemsize) == 0
           && reinterpret_cast<uintptr_t>(A) % 16 == 0;
}

}  // namespace

// y = A w, or (A o A) w with `square`, into y32 (rounded once) or y64 (the
// float64 sums).  span: the columns of w a block stages, a multiple of 32
// granules (256 bf16, 128 f32 columns) and at most SPAN_MAX; part: (B,
// ceil(n / span), m) doubles when that is more than one span, else unused.
// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int ipx_rows_a(const void* A, int a_is_bf16, const float* w,
                          int square, float* y32, double* y64, double* part,
                          int span, int B, int m, int n, void* stream) {
    const int isz = a_is_bf16 ? 2 : 4, cw = 32 * (16 / isz);
    const long long ns = (n + (long long)span - 1) / (span > 0 ? span : 1);
    if (span < cw || span > SPAN_MAX || span % cw != 0) return -1;
    if (!args_ok(B, m, n, y32, y64, ns * ((m + ROWS_A - 1) / ROWS_A)))
        return -1;
    if (ns > 1 && part == nullptr) return -1;
    const bool vec = aligned(A, n, isz);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a_is_bf16)
        return square ? launch_a<__nv_bfloat16, true>(A, w, y32, y64, part, B,
                                                       m, n, span, vec, s)
                      : launch_a<__nv_bfloat16, false>(A, w, y32, y64, part,
                                                        B, m, n, span, vec, s);
    return square ? launch_a<float, true>(A, w, y32, y64, part, B, m, n, span,
                                          vec, s)
                  : launch_a<float, false>(A, w, y32, y64, part, B, m, n,
                                           span, vec, s);
}

// t = A^T v into t32 (rounded once) or t64 (the float64 sums).  tile: rows
// of a block, 1 .. TILE_BYTES / itemsize; part: (B, ceil(m / tile), n)
// doubles when that is more than one tile, else unused.  Returns as above.
extern "C" int ipx_rows_at(const void* A, int a_is_bf16, const float* v,
                           float* t32, double* t64, double* part, int tile,
                           int B, int m, int n, void* stream) {
    const int isz = a_is_bf16 ? 2 : 4, cw = 32 * (16 / isz);
    if (tile < 1 || tile > TILE_BYTES / isz) return -1;
    const long long nt = (m + (long long)tile - 1) / tile;
    if (!args_ok(B, m, n, t32, t64, nt * ((n + cw - 1) / cw))) return -1;
    if (nt > 1 && part == nullptr) return -1;
    const bool vec = aligned(A, n, isz);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a_is_bf16)
        return launch_at<__nv_bfloat16>(A, v, t32, t64, part, B, m, n, tile,
                                         vec, s);
    return launch_at<float>(A, v, t32, t64, part, B, m, n, tile, vec, s);
}
