// What the panel kernels share: the tile edge, the largest m of the panel
// route, where a factor's prior rows lie (PanelRows, FullRows), and the
// register-tiled 128 x 128 float32 tile product of the normal-matrix assembly
// of a float32 A (assemble_sym.cu).
//
// The product: one block of 256 threads owns one 128 x 128 output tile.
// Thread (ty, tx) of the 16 x 16 arrangement holds an 8 x 8 block of sums:
// rows ty*4..+3 and 64+ty*4..+3, columns likewise with tx.  The two 128 x 16
// operand tiles of a pass go through shared memory stored k-major, so the
// inner loop reads float4s.  Sums are taken in two levels: a short run in
// registers, then the runs added in a fixed order into a per-thread total
// parked in shared memory (entry e of thread t at [e * THREADS + t], private
// to its thread, so no barrier guards it).  One chain of thousands of float32
// FMAs loses digits the interior-point iteration needs (PERF.md,
// "Summation").

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ipx_tile {

constexpr int TILE = 128;           // rows and columns of an output tile
constexpr int BK = 16;              // contraction depth per shared-memory pass
constexpr int LDS = TILE + 4;       // shared row stride (floats), 16-byte rows
constexpr int THREADS = 256;        // 16 x 16 threads, 8 x 8 sums each
constexpr int KC = 64;              // columns per chunk of the two-level sum
static_assert(KC % BK == 0, "a chunk is a whole number of passes");
// one parked 8 x 8 block per thread
constexpr size_t TOT_BYTES = size_t(64) * THREADS * sizeof(float);

// Largest m of the panel-major factor and solve, given by the build
// (-DIPX_PANEL_MAX_M, the one value the Python wrappers check m against).
#ifndef IPX_PANEL_MAX_M
#error "compile with -DIPX_PANEL_MAX_M=<largest m of the panel route>"
#endif
static_assert(IPX_PANEL_MAX_M >= TILE && IPX_PANEL_MAX_M % TILE == 0,
              "the panel route's largest m is a multiple of the tile");

// The factor's panels, passed to a kernel by value: panel j is a contiguous
// (B, TILE, m - j TILE) float32 array.
constexpr int MAX_PANELS = IPX_PANEL_MAX_M / TILE;

struct PanelPtrs {
    const float* p[MAX_PANELS];
};

// Where the rows of L^T that a prior panel j holds start for instance b, from
// the diagonal on (local column 0 is global column j TILE), and their row
// stride in floats: in the panel-major factor, or in a full (B, m, m) L^T.
struct PanelRows {
    PanelPtrs panels;
    __device__ __forceinline__ const float* at(int j, size_t b, int m,
                                               size_t& ld) const {
        ld = size_t(m - j * TILE);
        return panels.p[j] + b * size_t(TILE) * ld;
    }
};

struct FullRows {
    const float* LT;
    __device__ __forceinline__ const float* at(int j, size_t b, int m,
                                               size_t& ld) const {
        ld = size_t(m);
        return LT + (b * size_t(m) + size_t(j) * TILE) * ld + size_t(j) * TILE;
    }
};

// Copies k device pointers (16-byte aligned, not null) from a host array.
inline int fill_panels(PanelPtrs& out, const void* const* src, int k) {
    if (k < 0 || k > MAX_PANELS) return -1;
    for (int j = 0; j < MAX_PANELS; ++j) out.p[j] = nullptr;
    for (int j = 0; j < k; ++j) {
        if (src[j] == nullptr || reinterpret_cast<uintptr_t>(src[j]) % 16 != 0)
            return -1;
        out.p[j] = static_cast<const float*>(src[j]);
    }
    return 0;
}

// local row (or column) of entry e of a thread's 8 x 8 block: 0..3, 64..67
// from the thread's base ty*4 (or tx*4)
__device__ __forceinline__ int tile_off(int e) { return (e < 4) ? e : 60 + e; }

// eight bf16 values (16 bytes) as floats
__device__ __forceinline__ void unpack8(const uint4& q, float* out) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(p[e]);
        out[2 * e] = f.x;
        out[2 * e + 1] = f.y;
    }
}

// eight consecutive k-entries of one row of A, zero outside
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

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ void zero_total(float* tot, int tid) {
#pragma unroll
    for (int e = 0; e < 64; ++e) tot[e * THREADS + tid] = 0.f;
}

// second level of the sum: total += run, run = 0
__device__ __forceinline__ void flush_acc(float (&acc)[8][8], float* tot,
                                          int tid) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            tot[(i * 8 + j) * THREADS + tid] += acc[i][j];
            acc[i][j] = 0.f;
        }
}

// acc += Xs^T Ys over the BK entries of one pass
__device__ __forceinline__ void mma_pass(float (*Xs)[LDS], float (*Ys)[LDS],
                                         int tx, int ty, float (&acc)[8][8]) {
#pragma unroll
    for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Xs[k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&Xs[k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Ys[k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Ys[k][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float c[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
}

// One tile of (A * d2) A^T:  acc[i][j] = sum_c X[r_i, c] d2[c] Y[r_j, c]  with
// X the 128 rows of A starting at xrow's block and Y those at yrow's.  Each
// thread loads row lr = tid / 2 of both operand tiles (xrow, yrow point at
// that row; x_ok / y_ok say whether it exists), eight k-entries a pass,
// fetching the next pass from device memory into registers while the current
// one is multiplied.  Summed in KC-column chunks, the chunk sums in `tot`
// (TOT_BYTES of shared memory).  All threads of the block must call it; it
// ends after a barrier.
template <typename T>
__device__ __forceinline__ void assembly_tile(
        const T* xrow, const T* yrow, bool x_ok, bool y_ok,
        const float* __restrict__ d2b, int n, bool vec_ok, float (*Xs)[LDS],
        float (*Ys)[LDS], float* tot, int tid, float (&acc)[8][8]) {
    const int lr = tid >> 1, lk = (tid & 1) * 8;
    const int tx = tid & 15, ty = tid >> 4;
    zero_acc(acc);
    zero_total(tot, tid);

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
        mma_pass(Xs, Ys, tx, ty, acc);
        if ((k0 + BK) % KC == 0)             // a chunk is complete
            flush_acc(acc, tot, tid);
        __syncthreads();
    }
    // total = finished chunks + the ragged last chunk (zero if n % KC == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            acc[i][j] += tot[(i * 8 + j) * THREADS + tid];
}

}  // namespace ipx_tile
