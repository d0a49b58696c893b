// Symmetric normal-matrix assembly, batched:
//
//   M[b] = (A[b] * d2[b]) @ A[b]^T      A (B, m, n) bf16 or f32, d2 (B, n) f32
//                                       M (B, m, m) f32, exactly symmetric
//
// Replaces the Pallas kernel _assemble_sym_kernel of ipx/kernels/cholesky.py
// (entry assemble_sym_batched), which multiplies on the TPU's matrix unit
// with an exact 3-way bf16 split of the f32 row operand.
//
// What is kept from the TPU kernel is the FUNCTION, not its blocking: only
// the lower triangle of 128 x 128 tiles is computed, a diagonal tile is
// written as 0.5 * (T + T^T), an off-diagonal tile is written twice (as is,
// and transposed into the upper triangle).  Computing both triangles
// independently would round the two products differently and M would stop
// being exactly symmetric.  Not kept: the whole-A residency in fast memory
// and its shape gate.
//
// Bound on this card: operations.  About m (m + 1) / 2 * n products an
// instance against 2 m n bytes of bf16 A in and 4 m m bytes of M out; at
// m = 1024, n = 2048 some 250 products a byte.
//
// bf16 A (the only type any route sends here) is multiplied on the tensor
// cores, as the fused panel stage is (fused_panel.cu, whose assembly half
// this is without the prior-panel subtraction): mma.sync m16n8k16 against
// A's stored bf16 rows, the row operand x = f32(A_i * d2) cut into exact
// hi/mid/lo bf16 parts, so every partial product is exact in float32 and
// only the order of the sums is the tensor cores'.  That order is part of
// the function (ROADMAP.md, "Rules"): every MMA starts from a zero
// accumulator and is added with an IEEE add (mma_add), into a run per
// 64-column chunk (4 k-steps x 3 split passes), and the chunk runs into a
// float32 total; nothing chains through an MMA accumulator.  The diagonal
// of M is the exception: its products all have one sign, so the truncation
// towards zero inside each MMA adds up there to a bias (about -9e-8 relative
// on an H100, six times that of float32 FMAs, and lanes of the
// chol_backend="pallas" route were lost to it; PERF.md, "What was hard, row
// 4"), and the diagonal tiles sum their diagonal apart on the CUDA cores
// (chains of 8 FMAs, a fixed tree over the row's threads, then the chunk
// runs) while they split their row chunks.  One block of 8
// warps per lower-triangle tile, warp (wm, wn) owning rows 32 wm .. +32 and
// columns 64 wn .. +64; the operands pass through a ring of four cp.async
// stages three chunks ahead, and the block splits each landed row chunk into
// padded bf16 tiles that ldmatrix reads (mma_common.cuh).  The blocks of one
// instance are adjacent in the grid, so the rows of A that they share come
// from L2.  This design (mma.sync, not wgmma) is row 5's, chosen because it
// is the one whose sums are proven on the lanes (PERF.md, row 5); what bounds
// it is the split between two block barriers and the FADD per MMA output.
// The finished tile is staged in shared memory (the ring's region) and
// written with coalesced stores: as is and mirrored, or, on the diagonal, as
// 0.5 * (T + T^T) read from the staged tile.
//
// Ragged shapes: rows past m and columns past n are zero-filled (cp.async
// with a source size of 0), stores are masked; when n % 8 != 0 the rows of A
// are not 16-byte aligned and the chunks are staged element by element.
//
// float32 A (no route sends it; the wrapper takes it) keeps the CUDA-core
// design it had before: a register-tiled product of float32 FMAs, summed in
// 64-column chunks and then the chunk sums (assembly_tile, panel_common.cuh).
//
// An instance gets the same bits at any B, and two launches the same bits:
// nothing depends on B and there are no atomics.

#include "mma_common.cuh"
#include "panel_common.cuh"

namespace {

using namespace ipx_tile;   // the tile, the CUDA-core tile product
using namespace ipx_mma;    // mma_add, the split, the ring

// blockIdx.x -> lower-triangle tile (bi >= bj), p = bi (bi + 1) / 2 + bj
__device__ __forceinline__ void tile_of(int p, int& bi, int& bj) {
    bi = int((sqrtf(8.f * float(p) + 1.f) - 1.f) * 0.5f);
    while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
    while (bi * (bi + 1) / 2 > p) --bi;
    bj = p - bi * (bi + 1) / 2;
}

// ---- bf16 A: the tensor cores ----------------------------------------------

constexpr int FT = 256;             // threads: 8 warps, 4 (rows) x 2 (columns)
constexpr int CK = KC;              // chunk: 64 columns of A
constexpr int ALD = CK + 8;         // bf16 row stride of a [row][k] tile
constexpr int RSTAGES = 4;          // raw stages in the ring
constexpr int OLD = TILE + 1;       // float row stride of the staged tile

constexpr size_t A_TILE_B = size_t(TILE) * ALD * 2;            // 18432
constexpr size_t RX_B = size_t(TILE) * CK * 2;                 // A_i chunk
constexpr size_t RSTAGE_B = RX_B + A_TILE_B + CK * 4;          // + A_j + d2
constexpr size_t OUT_B = size_t(TILE) * OLD * 4;               // 66048
static_assert(OUT_B <= RSTAGES * RSTAGE_B,
              "the finished tile is staged in the ring's region");
constexpr size_t DIAG_B = size_t(TILE) * 4;                   // diagonal sums
constexpr size_t ASM_SMEM = RSTAGES * RSTAGE_B + 3 * A_TILE_B + DIAG_B;  // 196096

__global__ void __launch_bounds__(FT, 1)
assemble_sym_tc_kernel(const bf16* __restrict__ A,
                       const float* __restrict__ d2, float* __restrict__ M,
                       int m, int n, int vec_ok) {
    extern __shared__ __align__(128) unsigned char sm[];
    unsigned char* split = sm + RSTAGES * RSTAGE_B;
    float* dsum = reinterpret_cast<float*>(split + 3 * A_TILE_B);
    int bi, bj;
    tile_of(blockIdx.x, bi, bj);
    const bool diag = bi == bj;
    const size_t b = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, q = lane & 3;        // fragment row, column pair
    const int xr0 = bi * TILE, yr0 = bj * TILE;
    const bf16* Ab = A + b * size_t(m) * size_t(n);
    const float* d2b = d2 + b * size_t(n);
    const bf16* S = reinterpret_cast<const bf16*>(split);
    const int nc = (n + CK - 1) / CK;

    Frag tot, run;
    zero_frag(tot);
    // entry r of dsum is only ever touched by the thread that converts row r
    // (tid / 8 + 32 u, tid % 8 == 0)
    if (diag && (tid & 7) == 0)
        for (int r = tid >> 3; r < TILE; r += FT / 8) dsum[r] = 0.f;

    auto issue = [&](int c) {
        if (c < nc) {
            unsigned char* st = sm + (c % RSTAGES) * RSTAGE_B;
            bf16* rx = reinterpret_cast<bf16*>(st);
            bf16* ys = reinterpret_cast<bf16*>(st + RX_B);
            float* dd = reinterpret_cast<float*>(st + RX_B + A_TILE_B);
            const int c0 = c * CK;
            if (vec_ok) {
                // n % 8 == 0: a 16-byte granule lies wholly inside or past n
                for (int e = tid; e < TILE * CK / 8; e += FT) {
                    const int r = e >> 3, s8 = (e & 7) * 8, col = c0 + s8;
                    const bool xin = col < n && xr0 + r < m;
                    const bool yin = col < n && yr0 + r < m;
                    cp16_or_zero(rx + r * CK + s8,
                                 xin ? Ab + size_t(xr0 + r) * n + col : Ab,
                                 xin);
                    cp16_or_zero(ys + r * ALD + s8,
                                 yin ? Ab + size_t(yr0 + r) * n + col : Ab,
                                 yin);
                }
                if (tid < CK / 4) {
                    const int col = c0 + tid * 4;
                    cp16_or_zero(dd + tid * 4, col < n ? d2b + col : d2b,
                                 col < n);
                }
            } else {
                const bf16 zero = __float2bfloat16(0.f);
                for (int e = tid; e < TILE * CK; e += FT) {
                    const int r = e / CK, cc = e % CK, col = c0 + cc;
                    rx[r * CK + cc] = (col < n && xr0 + r < m)
                        ? Ab[size_t(xr0 + r) * n + col] : zero;
                    ys[r * ALD + cc] = (col < n && yr0 + r < m)
                        ? Ab[size_t(yr0 + r) * n + col] : zero;
                }
                if (tid < CK) dd[tid] = c0 + tid < n ? d2b[c0 + tid] : 0.f;
            }
        }
        cp_commit();
    };
    auto convert = [&](int c) {
        const unsigned char* st = sm + (c % RSTAGES) * RSTAGE_B;
        const bf16* rx = reinterpret_cast<const bf16*>(st);
        const float* dd = reinterpret_cast<const float*>(st + RX_B + A_TILE_B);
        bf16* hi = reinterpret_cast<bf16*>(split);
        for (int e = tid; e < TILE * CK / 8; e += FT) {
            const int r = e >> 3, s8 = (e & 7) * 8;
            float a[8], x[8];
            unpack8(*reinterpret_cast<const uint4*>(rx + r * CK + s8), a);
#pragma unroll
            for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(a[i], dd[s8 + i]);
            if (diag) {
                // M[r][r] on the CUDA cores: a chain of 8 FMAs a thread, the
                // row's 8 threads by a fixed tree, the chunk into the total
                float dp = 0.f;
#pragma unroll
                for (int i = 0; i < 8; ++i) dp = __fmaf_rn(x[i], a[i], dp);
                dp = __fadd_rn(dp, __shfl_xor_sync(0xffffffffu, dp, 1));
                dp = __fadd_rn(dp, __shfl_xor_sync(0xffffffffu, dp, 2));
                dp = __fadd_rn(dp, __shfl_xor_sync(0xffffffffu, dp, 4));
                if ((tid & 7) == 0) dsum[r] = __fadd_rn(dsum[r], dp);
            }
            uint4 h, md, l;
            split8(x, h, md, l);
            bf16* at = hi + r * ALD + s8;
            *reinterpret_cast<uint4*>(at) = h;
            *reinterpret_cast<uint4*>(at + TILE * ALD) = md;
            *reinterpret_cast<uint4*>(at + 2 * TILE * ALD) = l;
        }
    };
    auto multiply = [&](int c) {
        const bf16* ys = reinterpret_cast<const bf16*>(
            sm + (c % RSTAGES) * RSTAGE_B + RX_B);
        zero_frag(run);                           // a fresh chunk
#pragma unroll
        for (int kk = 0; kk < CK; kk += 16) {
            unsigned a[3][2][4];
#pragma unroll
            for (int s = 0; s < 3; ++s)
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
                    ldm_x4<false>(a[s][mi],
                                  S + s * TILE * ALD
                                    + (wm * 32 + mi * 16 + (lane & 15)) * ALD
                                    + kk + (lane >> 4) * 8);
#pragma unroll
            for (int nj = 0; nj < 4; ++nj) {
                unsigned bb[4];
                ldm_x4<false>(bb, ys + (wn * 64 + nj * 16 + (lane & 7)
                                        + ((lane >> 4) << 3)) * ALD
                                     + kk + ((lane >> 3) & 1) * 8);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
#pragma unroll
                        for (int s = 0; s < 3; ++s)
                            mma_add(run[mi][2 * nj + h], a[s][mi],
                                    bb[2 * h], bb[2 * h + 1]);
            }
        }
        add_frag(tot, run);
    };
    ring<RSTAGES>(nc, issue, convert, multiply);

    // ---- the finished tile, staged in the ring's region (padded rows: both
    // a row and a column of it are read without bank conflicts) ------------
    float* T = reinterpret_cast<float*>(sm);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = wm * 32 + mi * 16 + g + 8 * h;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                const int c = wn * 64 + ni * 8 + 2 * q;
                T[r * OLD + c] = tot[mi][ni][2 * h];
                T[r * OLD + c + 1] = tot[mi][ni][2 * h + 1];
            }
        }
    __syncthreads();

    float* Mb = M + b * size_t(m) * size_t(m);
    const int ri = min(TILE, m - xr0), rj = min(TILE, m - yr0);
    if (bi != bj) {
        // as is (rows of block i), then mirrored (rows of block j); a warp
        // writes 32 adjacent floats of one row of M at a time
        for (int r = warp; r < ri; r += FT / 32)
            for (int c = lane; c < rj; c += 32)
                Mb[size_t(xr0 + r) * m + yr0 + c] = T[r * OLD + c];
        for (int c = warp; c < rj; c += FT / 32)
            for (int r = lane; r < ri; r += 32)
                Mb[size_t(yr0 + c) * m + xr0 + r] = T[r * OLD + c];
        return;
    }
    // diagonal tile: its diagonal from the CUDA cores, then 0.5 * (T + T^T);
    // a + b is commutative, so entry (i, j) and entry (j, i) get the same
    // bits
    if ((tid & 7) == 0)
        for (int r = tid >> 3; r < TILE; r += FT / 8) T[r * OLD + r] = dsum[r];
    __syncthreads();
    for (int r = warp; r < ri; r += FT / 32)
        for (int c = lane; c < ri; c += 32)
            Mb[size_t(xr0 + r) * m + xr0 + c] =
                __fmul_rn(0.5f, __fadd_rn(T[r * OLD + c], T[c * OLD + r]));
}

int launch_tc(const void* A, const float* d2, float* M, int B, int m, int n,
              cudaStream_t stream) {
    const int nt = (m + TILE - 1) / TILE;
    const int vec_ok = (n % 8 == 0)
        && ((reinterpret_cast<uintptr_t>(A)
             | reinterpret_cast<uintptr_t>(d2)) % 16 == 0);
    cudaError_t err = cudaFuncSetAttribute(
        assemble_sym_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(ASM_SMEM));
    if (err != cudaSuccess) return int(err);
    dim3 grid(nt * (nt + 1) / 2, B);
    assemble_sym_tc_kernel<<<grid, FT, ASM_SMEM, stream>>>(
        static_cast<const bf16*>(A), d2, M, m, n, vec_ok);
    return int(cudaGetLastError());
}

// ---- float32 A: the CUDA cores ---------------------------------------------

__global__ void __launch_bounds__(THREADS)
assemble_sym_f32_kernel(const float* __restrict__ A,
                        const float* __restrict__ d2, float* M, int m, int n,
                        int vec_ok) {
    __shared__ __align__(16) float Xs[BK][LDS];   // (A_i * d2) tile, [k][row]
    __shared__ __align__(16) float Ys[BK][LDS];   // A_j tile,        [k][row]
    extern __shared__ float tot[];                // parked chunk sums

    int bi, bj;
    tile_of(blockIdx.x, bi, bj);
    const size_t b = blockIdx.y;
    const float* Ab = A + b * size_t(m) * size_t(n);
    const float* d2b = d2 + b * size_t(n);
    float* Mb = M + b * size_t(m) * size_t(m);

    const int tid = threadIdx.x;
    // loader role: row lr of each operand tile
    const int lr = tid >> 1;
    const int xi = bi * TILE + lr, yj = bj * TILE + lr;
    const bool x_ok = xi < m, y_ok = yj < m;
    const float* xrow = Ab + size_t(x_ok ? xi : 0) * n;
    const float* yrow = Ab + size_t(y_ok ? yj : 0) * n;
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

int launch_f32(const void* A, const float* d2, float* M, int B, int m, int n,
               cudaStream_t stream) {
    const int nt = (m + TILE - 1) / TILE;
    const int vec_ok = (n % 8 == 0)
                       && (reinterpret_cast<uintptr_t>(A) % 16 == 0);
    dim3 grid(nt * (nt + 1) / 2, B);
    cudaError_t err = cudaFuncSetAttribute(
        assemble_sym_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(TOT_BYTES));
    if (err != cudaSuccess) return int(err);
    assemble_sym_f32_kernel<<<grid, THREADS, TOT_BYTES, stream>>>(
        static_cast<const float*>(A), d2, M, m, n, vec_ok);
    return int(cudaGetLastError());
}

}  // namespace

// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int ipx_assemble_sym(const void* A, int a_is_bf16, const float* d2,
                                float* M, int B, int m, int n, void* stream) {
    if (B < 1 || m < 1 || n < 1 || B > 65535) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a_is_bf16) return launch_tc(A, d2, M, B, m, n, s);
    return launch_f32(A, d2, M, B, m, n, s);
}
