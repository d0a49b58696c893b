// Blocked triangular solves from a Cholesky factor and the inverses W of its
// diagonal blocks, batched.
//
// Pair-solve  L L^T x = b  from the rows of L^T:
//
//   stripe k   the strict suffix of rows k NB .. (k+1) NB of L^T, read either
//              from the panel-major factor (panels[k], (B, NB, m - k NB), local
//              columns NB..) or from a full (B, m, m) L^T
//              (LT[:, k NB:(k+1) NB, (k+1) NB:], row stride m)
//   W          (B, m / NB, NB, NB) f32: inverses of the diagonal blocks of L
//   b, x       (B, m) f32
//
//   forward   k = 0 .. nb-1:  y_k = W_k r_k;  r[o+NB:] -= S_k^T y_k
//   backward  k = nb-1 .. 0:  x_k = W_k^T (r_k - S_k x[o+NB:])
//
// Replaces the Pallas kernels _solve_pair_panels_kernel (entry
// chol_solve_batched_panels) and _solve_pair_lt_kernel / _solve_pair_lt_kernel_db
// (entry chol_solve_batched_lt) of ipx/kernels/cholesky.py: one launch per
// preconditioner apply.  The two layouts are one kernel body over an accessor
// that names stripe k's first entry and row stride, so both take the same sums
// in the same order and give the same bits for the same factor.  Of a full
// L^T only the strict-suffix stripes are read: what lies on and below the
// block diagonal may hold anything.
//
// One sweep from the untransposed L (solve_tri_kernel, replaces _solve_kernel,
// entry solve_triangular_batched):
//
//   lower     k = 0 .. nb-1:  y_k = W_k (b_k - L[k, :k] y[:k])      row blocks
//   upper     k = nb-1 .. 0:  x_k = W_k^T (b_k - L[k+1:, k]^T x[k+1:])
//                                                                column blocks
//
// The column block of the upper sweep is read row by row, a warp taking the
// 128 columns of a row in one 512-byte request (tall_col_sums), so the
// transposed product costs no strided loads and no transposed copy.
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
// the one-sweep solve: b, the solution, tall_col_sums' partials (one row of
// NB per warp), two NB-vectors
constexpr size_t tri_smem_bytes(int m) {
    return (size_t(2) * m + size_t(NWARPS) * NB + 2 * NB) * sizeof(double);
}
constexpr size_t SMEM_LIMIT = 227u * 1024u;     // one block's, sm_90
static_assert(solve_smem_bytes(IPX_PANEL_MAX_M) <= SMEM_LIMIT,
              "IPX_PANEL_MAX_M does not fit the pair-solve's shared memory");
static_assert(tri_smem_bytes(IPX_PANEL_MAX_M) <= SMEM_LIMIT,
              "IPX_PANEL_MAX_M does not fit the one-sweep solve's shared "
              "memory");

// Where stripe k of instance b starts (its local column 0 is global column
// (k + 1) NB) and its row stride, in floats.
struct PanelStripes {
    PanelPtrs panels;
    __device__ __forceinline__ const float* at(size_t b, int k, int m,
                                               size_t& ld) const {
        ld = size_t(m - k * NB);
        return panels.p[k] + b * size_t(NB) * ld + NB;
    }
};

struct FullStripes {
    const float* LT;                    // (B, m, m)
    __device__ __forceinline__ const float* at(size_t b, int k, int m,
                                               size_t& ld) const {
        ld = size_t(m);
        return LT + (b * size_t(m) + size_t(k) * NB) * ld + size_t(k + 1) * NB;
    }
};

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

// part[g * NB + c] = sum over rows g, g + NWARPS, ... of Mat[row, c] v[row]
// for the NB columns of a tall block (nrows a multiple of NB): warp g walks
// its rows, each lane four adjacent columns.
__device__ __forceinline__ void tall_col_sums(const float* __restrict__ Mat,
                                              size_t ld, int nrows,
                                              const double* v, double* part,
                                              int warp, int lane) {
    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
#pragma unroll 4
    for (int r = warp; r < nrows; r += NWARPS) {
        const float4 q = *reinterpret_cast<const float4*>(
            Mat + size_t(r) * ld + lane * 4);
        const double vr = v[r];
        a0 = fma(double(q.x), vr, a0);
        a1 = fma(double(q.y), vr, a1);
        a2 = fma(double(q.z), vr, a2);
        a3 = fma(double(q.w), vr, a3);
    }
    double* p = part + warp * NB + lane * 4;
    p[0] = a0; p[1] = a1; p[2] = a2; p[3] = a3;
}

// the value a float32 store would keep, as a double
__device__ __forceinline__ double rnd(double v) { return double(float(v)); }

template <typename Stripes>
__global__ void __launch_bounds__(STHREADS)
solve_pair_kernel(Stripes stripes, const float* __restrict__ W,
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
            size_t ld;
            const float* Pk = stripes.at(b, k, m, ld);
            col_sums(Pk, ld, ncol, yv, part, warp, lane);
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
            size_t ld;
            const float* Pk = stripes.at(b, k, m, ld);
            row_dots(Pk, ld, w - NB, xs + o + NB, yv, warp, lane);
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

template <typename Stripes>
int launch_pair(const Stripes& stripes, const float* W, const float* b,
                float* x, int B, int m, void* stream) {
    const size_t smem = solve_smem_bytes(m);
    auto kern = solve_pair_kernel<Stripes>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    kern<<<B, STHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        stripes, W, b, x, m);
    return int(cudaGetLastError());
}

// One sweep from the untransposed factor L (B, m, m): LOWER solves L y = b
// going down, reading the row block L[o:o+NB, :o]; otherwise L^T x = b going
// up, reading the column block L[o+NB:, o:o+NB].
template <bool LOWER>
__global__ void __launch_bounds__(STHREADS)
solve_tri_kernel(const float* __restrict__ L, const float* __restrict__ W,
                 const float* __restrict__ bvec, float* __restrict__ x, int m) {
    extern __shared__ double ssm[];
    const int nb = m / NB;
    double* r = ssm;                    // m: the right-hand side
    double* xs = r + m;                 // m: the solution
    double* part = xs + m;              // NWARPS * NB
    double* yv = part + NWARPS * NB;    // NB: b_k less what is already solved
    double* tv = yv + NB;               // NB: row_dots' output
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t b = blockIdx.x;
    const float* Lb = L + b * size_t(m) * m;
    const float* Wb = W + b * size_t(nb) * NB * NB;

    for (int i = tid; i < m; i += STHREADS) {
        r[i] = double(bvec[b * m + i]);
        xs[i] = 0.0;
    }
    __syncthreads();

    if (LOWER) {
        for (int k = 0; k < nb; ++k) {
            const int o = k * NB;
            if (k > 0) {
                row_dots(Lb + size_t(o) * m, m, o, xs, tv, warp, lane);
                __syncthreads();
                if (tid < NB) yv[tid] = rnd(r[o + tid] - tv[tid]);
            } else if (tid < NB) {
                yv[tid] = r[tid];
            }
            __syncthreads();
            row_dots(Wb + size_t(k) * NB * NB, NB, NB, yv, tv, warp, lane);
            __syncthreads();
            if (tid < NB) xs[o + tid] = rnd(tv[tid]);
            __syncthreads();
        }
    } else {
        for (int k = nb - 1; k >= 0; --k) {
            const int o = k * NB;
            if (k < nb - 1) {
                tall_col_sums(Lb + size_t(o + NB) * m + o, m, m - o - NB,
                              xs + o + NB, part, warp, lane);
                __syncthreads();
                if (tid < NB) {
                    double s = 0.0;
#pragma unroll
                    for (int g = 0; g < NWARPS; ++g) s += part[g * NB + tid];
                    yv[tid] = rnd(r[o + tid] - s);
                }
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
    }

    for (int i = tid; i < m; i += STHREADS) x[b * m + i] = float(xs[i]);
}

bool solve_args_ok(const float* F, const float* W, int B, int m) {
    return B >= 1 && m >= NB && m % NB == 0 && m <= IPX_PANEL_MAX_M
        && reinterpret_cast<uintptr_t>(W) % 16 == 0
        && (F == nullptr || reinterpret_cast<uintptr_t>(F) % 16 == 0);
}

}  // namespace

// panels: host array of m / 128 device pointers, panel k being (B, 128,
// m - 128 k) contiguous f32.  Returns 0, a cudaError_t, or -1 for arguments
// the kernel does not take.
extern "C" int ipx_solve_pair_panels(const void* const* panels, const float* W,
                                     const float* b, float* x, int B, int m,
                                     void* stream) {
    if (!solve_args_ok(nullptr, W, B, m)) return -1;
    PanelStripes st;
    if (fill_panels(st.panels, panels, m / NB) != 0) return -1;
    return launch_pair(st, W, b, x, B, m, stream);
}

// The same solve from a full LT (B, m, m) f32 = L^T, of which only the strict
// suffix of each 128-row stripe is read.
extern "C" int ipx_solve_pair_lt(const float* LT, const float* W,
                                 const float* b, float* x, int B, int m,
                                 void* stream) {
    if (!solve_args_ok(LT, W, B, m)) return -1;
    return launch_pair(FullStripes{LT}, W, b, x, B, m, stream);
}

// One sweep from the untransposed L (B, m, m) f32: L y = b (lower != 0) or
// L^T x = b (lower == 0).
extern "C" int ipx_solve_tri(const float* L, const float* W, const float* b,
                             float* x, int B, int m, int lower, void* stream) {
    if (!solve_args_ok(L, W, B, m)) return -1;
    const size_t smem = tri_smem_bytes(m);
    auto kern = lower ? solve_tri_kernel<true> : solve_tri_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    kern<<<B, STHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        L, W, b, x, m);
    return int(cudaGetLastError());
}
