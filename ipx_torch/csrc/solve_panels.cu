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
// strict suffixes and W read twice over the memory rate.  The pair-solve
// runs one thread-block cluster per instance (described above the kernel):
// the steps of an instance are a chain, so one block alone reads a stripe
// only once the step before it is done and the memory pipe drains at every
// step; a cluster splits each step's tiles over eight SMs and a ring of
// asynchronous copies keeps their loads in flight across the steps.  The
// one-sweep solve keeps one block of 512 threads per instance: r and x live
// in its shared memory for the whole call and the nb steps run in order
// inside the block.  Neither has the TPU kernel's chunks of instances, copy
// slots or power-of-two batch padding: any B works.  The one-sweep solve's
// two access patterns are
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

#include <cooperative_groups.h>

#include "mma_common.cuh"
#include "panel_common.cuh"

namespace {

namespace cg = cooperative_groups;
using ipx_mma::cp16;
using ipx_mma::cp_commit;
using ipx_mma::cp_wait;
using ipx_tile::MAX_PANELS;
using ipx_tile::PanelPtrs;
using ipx_tile::fill_panels;

constexpr int NB = 128;
constexpr int STHREADS = 512;
constexpr int NWARPS = STHREADS / 32;
constexpr int RG = 4;               // row groups of col_sums, 32 rows each

// the one-sweep solve: b, the solution, tall_col_sums' partials (one row of
// NB per warp), two NB-vectors
constexpr size_t tri_smem_bytes(int m) {
    return (size_t(2) * m + size_t(NWARPS) * NB + 2 * NB) * sizeof(double);
}
constexpr size_t SMEM_LIMIT = 227u * 1024u;     // one block's, sm_90
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

// ---- the pair-solve: one thread-block cluster per instance -----------------
//
// The cluster's CL blocks share an instance: block q owns the column blocks
// j with j % CL == q, holding their r (then y) and x in its shared memory,
// and reads of each stripe only the 128 x 128 tiles (k, j) of its own j.
//   forward, step k  the owner of block k forms y_k = W_k r_k (row_dots over
//                    W_k), keeps it as r_k and writes it into every block's
//                    yv through distributed shared memory; one cluster
//                    barrier; each block then takes S_k's tiles of its own
//                    j > k from its r_j (col_sums).
//   backward, step k each block sums S_k's tiles of its own j > k against its
//                    x_j (row_dots) and writes that partial into the owner's
//                    slot; one cluster barrier; the owner adds the CL partials
//                    in rank order, t = r_k - sum, x_k = W_k^T t (col_sums).
// The tiles a block reads do not depend on y or x, so they stream through a
// ring of RING chunks (RCH rows of a tile) that cp.async fills RING - 1
// chunks ahead, across steps and instances: the memory pipe does not drain at
// a step.  The grid is persistent, as many clusters as the card runs at once
// (the occupancy query), each walking the instances b = cluster,
// cluster + G, ...  Every sum has a fixed order (a thread's own chain, then a
// fixed shuffle or row-group tree, then the partials in rank order), and
// nothing depends on B or on the grid, so a lane gets the same bits at any B
// and from launch to launch (but not at another CL).
//
// CL = 1 is the size kept, from the times of this body at CL = 8, 4, 2 and 1,
// 256 and 512 threads, rings of 3 to 8 chunks (probes/pair_variants.py; H100,
// m = 1024).  A block turns about 4 entries a clock into f64 products (each
// entry is converted from f32 once), so an instance's chain of 2 nb steps
// takes a block some 0.18 ms however its loads are issued, and a cluster
// cuts that only to 0.08-0.13 ms: each step keeps two tiles and the cluster
// barrier on its critical path.  At B = 256 the card is then bound by its
// memory, and the clusters, of which fewer fit the card at once (eight of
// eight blocks), lose: 1.35-1.57 ms at CL = 8, 0.78-0.90 at 4, 0.40-0.48 at
// 2, 0.38-0.40 at 1, against 0.48 for one block that issues each stripe's
// loads only once y_k is known.  With CL = 1 two blocks share an SM at
// m = 1024 and all 256 instances run at once, each block reading its factor
// twice, some 3 TB/s in all; the backward sweep finds little in L2.

constexpr int CL = 1;               // blocks of a cluster (see above)
constexpr int PT = 256;             // threads of a block
constexpr int PWARPS = PT / 32;
constexpr int RCH = PT / 8;         // rows of a chunk: 4 a warp, 8 threads a row
constexpr int CHUNKS = NB / RCH;    // chunks of a tile
constexpr int CHUNK_F = RCH * NB;   // floats of a chunk
constexpr int RING = 3;             // chunks in the ring
static_assert(NB % RCH == 0 && (PWARPS & (PWARPS - 1)) == 0,
              "whole chunks a tile, a power-of-two tree of row groups");

// Shared memory of a block for nb column blocks: the ring, then doubles (its
// own blocks of r (then y) and of x; y_k as written by its owner and the
// partials an owner receives, two steps each; col_sums' row-group partials;
// y_k or t being formed), then the list of tiles it reads an instance (its
// W_k and, per step, its own tiles).
__host__ __device__ constexpr int owned(int nb) { return (nb + CL - 1) / CL; }
__host__ __device__ constexpr int list_len(int nb) { return 2 * owned(nb) * (nb + 1); }
constexpr size_t pair_smem_bytes(int nb) {
    return size_t(RING) * CHUNK_F * sizeof(float)
        + (size_t(2) * owned(nb) * NB + 2 * NB + size_t(2) * CL * NB
           + size_t(PWARPS) * NB + NB) * sizeof(double)
        + size_t(list_len(nb)) * sizeof(short2);
}
static_assert(pair_smem_bytes(MAX_PANELS) <= SMEM_LIMIT,
              "IPX_PANEL_MAX_M does not fit the pair-solve's shared memory");

// acc[e] += sum over rows 4 warp .. 4 warp + 3 of chunk rc of
// T[row][4 lane + e] v[RCH rc + row]
__device__ __forceinline__ void chunk_col_sums(const float* T, int rc,
                                               const double* v, int warp,
                                               int lane, double (&acc)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = warp * 4 + e;
        const float4 a = *reinterpret_cast<const float4*>(T + r * NB
                                                          + lane * 4);
        const double vr = v[rc * RCH + r];
        acc[0] = fma(double(a.x), vr, acc[0]);
        acc[1] = fma(double(a.y), vr, acc[1]);
        acc[2] = fma(double(a.z), vr, acc[2]);
        acc[3] = fma(double(a.w), vr, acc[3]);
    }
}

// acc += sum over this thread's 16 columns of T[row][c] v[c], row = tid / 8
// of the chunk: eight threads a row, float4 p, p + 8, p + 16, p + 24
__device__ __forceinline__ void chunk_row_dots(const float* T, const double* v,
                                               int tid, double& acc) {
    const float* row = T + (tid >> 3) * NB;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int c = 4 * ((tid & 7) + 8 * i);
        const float4 a = *reinterpret_cast<const float4*>(row + c);
        acc = fma(double(a.x), v[c], acc);
        acc = fma(double(a.y), v[c + 1], acc);
        acc = fma(double(a.z), v[c + 2], acc);
        acc = fma(double(a.w), v[c + 3], acc);
    }
}

// the eight threads of a row, added by a fixed tree
__device__ __forceinline__ double row_total(double a) {
    a += __shfl_xor_sync(0xffffffffu, a, 4);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    return a;
}

// the row groups' partials of column tid (stride NB), added by a fixed tree
template <int N>
__device__ __forceinline__ double group_total(const double* p) {
    if constexpr (N == 1) return p[0];
    else return group_total<N / 2>(p) + group_total<N / 2>(p + N / 2 * NB);
}

template <typename Stripes>
__global__ void __launch_bounds__(PT, 1)
solve_pair_kernel(Stripes stripes, const float* __restrict__ W,
                  const float* __restrict__ bvec, float* __restrict__ x,
                  int m, int B) {
    extern __shared__ __align__(128) unsigned char psm[];
    __shared__ int n_tiles;
    float* ringf = reinterpret_cast<float*>(psm);
    double* rv = reinterpret_cast<double*>(psm + size_t(RING) * CHUNK_F
                                           * sizeof(float));
    const int nb = m / NB, own = owned(nb);
    double* xv = rv + own * NB;         // own blocks: [own][NB] each
    double* yv = xv + own * NB;         // [2][NB]
    double* slot = yv + 2 * NB;         // [2][CL][NB]
    double* part = slot + 2 * CL * NB;  // [PWARPS][NB]
    double* tv = part + PWARPS * NB;    // [NB]
    short2* list = reinterpret_cast<short2*>(tv + NB);

    cg::cluster_group cluster = cg::this_cluster();
    const int q = int(cluster.block_rank());
    const int gc = blockIdx.x / CL, G = gridDim.x / CL;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    // the tiles this block reads an instance, in the order it reads them:
    // (k, -1) is W_k, (k, j) the tile of stripe k over column block j
    if (tid == 0) {
        int L = 0;
        for (int k = 0; k < nb; ++k) {
            if (k % CL == q) list[L++] = make_short2(short(k), short(-1));
            for (int j = k + 1; j < nb; ++j)
                if (j % CL == q) list[L++] = make_short2(short(k), short(j));
        }
        for (int k = nb - 1; k >= 0; --k) {
            for (int j = k + 1; j < nb; ++j)
                if (j % CL == q) list[L++] = make_short2(short(k), short(j));
            if (k % CL == q) list[L++] = make_short2(short(k), short(-1));
        }
        n_tiles = L;
    }
    __syncthreads();
    const int cpi = CHUNKS * n_tiles;             // chunks an instance
    const int iters = (B - gc + G - 1) / G;
    const int nch = iters * cpi;

    auto issue = [&](int c) {
        if (c < nch) {
            const int i = c / cpi, rem = c - i * cpi;
            const short2 t = list[rem / CHUNKS];
            const size_t b = size_t(gc) + size_t(i) * G;
            size_t ld;
            const float* src;
            if (t.y < 0) {
                ld = NB;
                src = W + (b * nb + t.x) * size_t(NB) * NB;
            } else {
                src = stripes.at(b, t.x, m, ld) + size_t(t.y - t.x - 1) * NB;
            }
            src += size_t(rem % CHUNKS) * RCH * ld;
            float* dst = ringf + (c % RING) * CHUNK_F;
#pragma unroll
            for (int u = 0; u < CHUNK_F / (4 * PT); ++u) {     // 4
                const int e = tid + u * PT, row = e >> 5, c4 = (e & 31) * 4;
                cp16(dst + row * NB + c4, src + row * ld + c4);
            }
        }
        cp_commit();
    };
    // the next chunk, once every thread's copies of it have landed and every
    // thread is done with the one before (whose stage is refilled here)
    int cur = 0;
    auto acquire = [&]() -> const float* {
        cp_wait<RING - 2>();
        __syncthreads();
        issue(cur + RING - 1);
        return ringf + (cur++ % RING) * CHUNK_F;
    };
    for (int c = 0; c < RING - 1; ++c) issue(c);
    cluster.sync();             // every block runs before any remote write

    for (int it = 0; it < iters; ++it) {
        const size_t b = size_t(gc) + size_t(it) * G;
        __syncthreads();
        for (int e = tid; e < own * NB; e += PT) {
            const int j = q + (e / NB) * CL;
            if (j < nb) rv[e] = double(bvec[b * m + size_t(j) * NB + e % NB]);
        }
        __syncthreads();

        // ---- forward sweep ----------------------------------------------------
        for (int k = 0; k < nb; ++k) {
            if (k % CL == q) {
                double* rk = rv + (k / CL) * NB;
                for (int rc = 0; rc < CHUNKS; ++rc) {
                    double acc = 0.0;
                    chunk_row_dots(acquire(), rk, tid, acc);
                    acc = row_total(acc);
                    if ((tid & 7) == 0) tv[rc * RCH + (tid >> 3)] = rnd(acc);
                }
                __syncthreads();
                if (tid < NB) rk[tid] = tv[tid];
                for (int e = tid; e < CL * NB; e += PT)
                    cluster.map_shared_rank(yv + (k & 1) * NB, e / NB)[e % NB]
                        = tv[e % NB];
            }
            cluster.sync();
            const double* y = yv + (k & 1) * NB;
            for (int j = k + 1 + ((q - k - 1) % CL + CL) % CL; j < nb;
                 j += CL) {
                double acc[4] = {0.0, 0.0, 0.0, 0.0};
                for (int rc = 0; rc < CHUNKS; ++rc)
                    chunk_col_sums(acquire(), rc, y, warp, lane, acc);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    part[warp * NB + lane * 4 + e] = acc[e];
                __syncthreads();
                if (tid < NB) {
                    double* rj = rv + (j / CL) * NB;
                    rj[tid] = rnd(rj[tid] - group_total<PWARPS>(part + tid));
                }
            }
        }

        // ---- backward sweep ---------------------------------------------------
        for (int k = nb - 1; k >= 0; --k) {
            const int owner = k % CL;
            double* rk = rv + (k / CL) * NB;
            if (k < nb - 1) {
                double acc[CHUNKS] = {};
                for (int j = k + 1 + ((q - k - 1) % CL + CL) % CL; j < nb;
                     j += CL) {
                    const double* xj = xv + (j / CL) * NB;
#pragma unroll
                    for (int rc = 0; rc < CHUNKS; ++rc)
                        chunk_row_dots(acquire(), xj, tid, acc[rc]);
                }
                double* dst = cluster.map_shared_rank(
                    slot + ((k & 1) * CL + q) * NB, owner);
#pragma unroll
                for (int rc = 0; rc < CHUNKS; ++rc) {
                    const double s = row_total(acc[rc]);
                    if ((tid & 7) == 0) dst[rc * RCH + (tid >> 3)] = s;
                }
                cluster.sync();
                if (owner == q && tid < NB) {
                    const double* s = slot + (k & 1) * CL * NB + tid;
                    double sum = s[0];
                    for (int p = 1; p < CL; ++p) sum += s[p * NB];
                    tv[tid] = rnd(rk[tid] - sum);
                }
            } else if (owner == q && tid < NB) {
                tv[tid] = rk[tid];
            }
            if (owner == q) {
                double acc[4] = {0.0, 0.0, 0.0, 0.0};
                for (int rc = 0; rc < CHUNKS; ++rc)
                    chunk_col_sums(acquire(), rc, tv, warp, lane, acc);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    part[warp * NB + lane * 4 + e] = acc[e];
                __syncthreads();
                if (tid < NB) {
                    const double v = rnd(group_total<PWARPS>(part + tid));
                    xv[(k / CL) * NB + tid] = v;
                    x[b * m + size_t(k) * NB + tid] = float(v);
                }
            }
        }
    }
    cp_wait<0>();               // nothing in flight when the block exits
}

template <typename Stripes>
int launch_pair(const Stripes& stripes, const float* W, const float* b,
                float* x, int B, int m, void* stream) {
    auto kern = solve_pair_kernel<Stripes>;
    const int nb = m / NB;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(pair_smem_bytes(MAX_PANELS)));
    if (err != cudaSuccess) return int(err);
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(PT);
    cfg.dynamicSmemBytes = pair_smem_bytes(nb);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // clusters the card runs at once, per device and m (its shared memory)
    static int active[16][MAX_PANELS + 1] = {};
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return int(err);
    if (dev >= 16) return -1;
    int& act = active[dev][nb];
    if (act == 0) {
        cfg.gridDim = dim3(CL);
        err = cudaOccupancyMaxActiveClusters(&act, kern, &cfg);
        if (err != cudaSuccess) return int(err);
        if (act < 1) return -1;
    }
    cfg.gridDim = dim3(CL * (B < act ? B : act));
    err = cudaLaunchKernelEx(&cfg, kern, stripes, W, b, x, m, B);
    if (err != cudaSuccess) return int(err);
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
