// Pair-solve  L L^T x = b  from the panel-major factor, batched:
//
//   panels[k]  (B, NB, m - k NB) f32: rows k NB .. (k+1) NB of L^T from the
//              diagonal on (only the strict suffix, local columns NB.., is
//              read here)
//   W          (B, m / NB, NB, NB) f32: inverses of the diagonal blocks of L
//   b, x       (B, m) f32
//
//   forward   k = 0 .. nb-1:  y_k = W_k r_k;  r[o+NB:] -= P_k[:, NB:]^T y_k
//   backward  k = nb-1 .. 0:  x_k = W_k^T (r_k - P_k[:, NB:] x[o+NB:])
//
// Replaces the Pallas kernel _solve_pair_panels_kernel of
// ipx/kernels/cholesky.py (entry chol_solve_batched_panels): one launch per
// preconditioner apply.
//
// Bound on this card: bytes.  Every panel entry and every W entry meets one
// vector entry in each sweep (2 flops a read), so the least time is the
// strict suffixes and W read twice over the memory rate.  Design: one block
// of 512 threads per instance; r and x live in shared memory for the whole
// call and the 2 nb steps run in order inside the block (the TPU kernel's
// chunks of instances, copy slots and its power-of-two batch padding have no
// counterpart: any B works, B = 1 launches one block).  The two access
// patterns are
//   col_sums  out[c] = sum_row Mat[row, c] v[row]: a warp takes 32 adjacent
//             columns of one of four 32-row groups (coalesced along c); the
//             four partial sums are added in a fixed order;
//   row_dots  out[row] = sum_c Mat[row, c] v[c]: a warp per row, 16-byte
//             loads, the lanes' sums combined by shuffles.
// Sums are accumulated in float64 and rounded to float32 once per entry of
// y, r and x, as the matvec kernels do: the preconditioner's accuracy is
// what the outer iteration's lanes live on.  No atomics: the result is the
// same bit for bit from launch to launch.
//
// Shapes: m a multiple of 128 up to IPX_PANEL_MAX_M, which must fit shared
// memory (checked below when this file is compiled); the caller pads other m.

#include "panel_common.cuh"

namespace {

using ipx_tile::PanelPtrs;
using ipx_tile::fill_panels;

constexpr int NB = 128;
constexpr int STHREADS = 512;
constexpr int NWARPS = STHREADS / 32;
constexpr int RG = 4;               // row groups of col_sums, 32 rows each

// doubles of shared memory: r, x, the col_sums partials, one NB-vector
constexpr size_t solve_smem_bytes(int m) {
    return (size_t(2) * m + size_t(RG) * ((m - NB > NB) ? m - NB : NB) + NB)
           * sizeof(double);
}
constexpr size_t SMEM_LIMIT = 227u * 1024u;     // one block's, sm_90
static_assert(solve_smem_bytes(IPX_PANEL_MAX_M) <= SMEM_LIMIT,
              "IPX_PANEL_MAX_M does not fit the pair-solve's shared memory");

// part[g * ncol + c] = sum over rows 32 g .. 32 g + 31 of Mat[row, c] v[row]
__device__ __forceinline__ void col_sums(const float* __restrict__ Mat,
                                         size_t ld, int ncol,
                                         const double* v, double* part,
                                         int warp, int lane) {
    const int items = (ncol / 32) * RG;
    for (int it = warp; it < items; it += NWARPS) {
        const int g = it % RG, c = (it / RG) * 32 + lane;
        const float* col = Mat + size_t(g * 32) * ld + c;
        const double* vg = v + g * 32;
        double acc = 0.0;
#pragma unroll 8
        for (int r = 0; r < 32; ++r)
            acc = fma(double(col[size_t(r) * ld]), vg[r], acc);
        part[g * ncol + c] = acc;
    }
}

// out[row] = sum_c Mat[row, c] v[c], rows 0 .. NB-1, ncol a multiple of 128
__device__ __forceinline__ void row_dots(const float* __restrict__ Mat,
                                         size_t ld, int ncol,
                                         const double* v, double* out,
                                         int warp, int lane) {
    for (int row = warp; row < NB; row += NWARPS) {
        const float* mr = Mat + size_t(row) * ld;
        double acc = 0.0;
#pragma unroll 2
        for (int c = lane * 4; c < ncol; c += 128) {
            const float4 q = *reinterpret_cast<const float4*>(mr + c);
            acc = fma(double(q.x), v[c], acc);
            acc = fma(double(q.y), v[c + 1], acc);
            acc = fma(double(q.z), v[c + 2], acc);
            acc = fma(double(q.w), v[c + 3], acc);
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, s);
        if (lane == 0) out[row] = acc;
    }
}

// the value a float32 store would keep, as a double
__device__ __forceinline__ double rnd(double v) { return double(float(v)); }

__global__ void __launch_bounds__(STHREADS)
solve_pair_panels_kernel(PanelPtrs panels, const float* __restrict__ W,
                         const float* __restrict__ bvec, float* __restrict__ x,
                         int m) {
    extern __shared__ double ssm[];
    const int nb = m / NB;
    const int pc = (m - NB > NB) ? m - NB : NB;
    double* r = ssm;                    // m: right-hand side, then y
    double* xs = r + m;                 // m: the solution
    double* part = xs + m;              // RG * pc
    double* yv = part + RG * pc;        // NB: y_k, then r_k - P_k x
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t b = blockIdx.x;
    const float* Wb = W + b * size_t(nb) * NB * NB;

    for (int i = tid; i < m; i += STHREADS) {
        r[i] = double(bvec[b * m + i]);
        xs[i] = 0.0;
    }
    __syncthreads();

    // ---- forward sweep ------------------------------------------------------
    for (int k = 0; k < nb; ++k) {
        const int o = k * NB, w = m - o;
        row_dots(Wb + size_t(k) * NB * NB, NB, NB, r + o, yv, warp, lane);
        __syncthreads();
        if (tid < NB) {
            yv[tid] = rnd(yv[tid]);
            r[o + tid] = yv[tid];
        }
        __syncthreads();
        if (k < nb - 1) {
            const int ncol = w - NB;
            const float* Pk = panels.p[k] + b * size_t(NB) * w + NB;
            col_sums(Pk, w, ncol, yv, part, warp, lane);
            __syncthreads();
            for (int c = tid; c < ncol; c += STHREADS) {
                const double s = (part[c] + part[ncol + c])
                                 + (part[2 * ncol + c] + part[3 * ncol + c]);
                r[o + NB + c] = rnd(r[o + NB + c] - s);
            }
            __syncthreads();
        }
    }

    // ---- backward sweep -----------------------------------------------------
    for (int k = nb - 1; k >= 0; --k) {
        const int o = k * NB, w = m - o;
        if (k < nb - 1) {
            const float* Pk = panels.p[k] + b * size_t(NB) * w + NB;
            row_dots(Pk, w, w - NB, xs + o + NB, yv, warp, lane);
            __syncthreads();
            if (tid < NB) yv[tid] = rnd(r[o + tid] - yv[tid]);
        } else if (tid < NB) {
            yv[tid] = r[o + tid];
        }
        __syncthreads();
        col_sums(Wb + size_t(k) * NB * NB, NB, NB, yv, part, warp, lane);
        __syncthreads();
        if (tid < NB)
            xs[o + tid] = rnd((part[tid] + part[NB + tid])
                              + (part[2 * NB + tid] + part[3 * NB + tid]));
        __syncthreads();
    }

    for (int i = tid; i < m; i += STHREADS) x[b * m + i] = float(xs[i]);
}

}  // namespace

// panels: host array of m / 128 device pointers, panel k being (B, 128,
// m - 128 k) contiguous f32.  Returns 0, a cudaError_t, or -1 for arguments
// the kernel does not take.
extern "C" int ipx_solve_pair_panels(const void* const* panels, const float* W,
                                     const float* b, float* x, int B, int m,
                                     void* stream) {
    if (B < 1 || m < NB || m % NB || m > IPX_PANEL_MAX_M) return -1;
    const size_t smem = solve_smem_bytes(m);
    if (reinterpret_cast<uintptr_t>(W) % 16 != 0) return -1;
    PanelPtrs pp;
    if (fill_panels(pp, panels, m / NB) != 0) return -1;
    cudaError_t err = cudaFuncSetAttribute(
        solve_pair_panels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
    solve_pair_panels_kernel<<<B, STHREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        pp, W, b, x, m);
    return int(cudaGetLastError());
}
