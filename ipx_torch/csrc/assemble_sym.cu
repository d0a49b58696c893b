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
// instance against 2 m n bytes of bf16 A (4 m n of float32 A) in and 4 m m
// bytes of M out; at m = 1024, n = 2048 some 250 products a byte (125 for
// float32 A), each three bf16 tensor-core products for a bf16 A and six for
// a float32 A.
//
// bf16 A is multiplied on the tensor
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
// with a source size of 0), stores are masked; when the rows of A are not
// 16-byte aligned (n % 8 != 0 for bf16, n % 4 != 0 for float32) the chunks
// are copied element by element.  The float32 kernel runs whole 64-column
// chunks, the columns past n zero.
//
// float32 A (every f32 A on the card: normal_eq.assemble sends it here on
// every backend) is multiplied on the tensor cores too, with BOTH operands
// split exactly: the row operand x = f32(A_i * d2), rounded once as above,
// and the column operand A_j, each into hi + mid + lo bf16 parts (split8),
// of which six cross products are taken (hi.hi, hi.mid, mid.hi, hi.lo,
// lo.hi, mid.mid; the other three lie below 2^-24 of the product).  The
// design is rows 7 and 10's (accum_panel.cu; the pipeline in
// mma_common.cuh): one block of 16 warps per lower-triangle tile, one block
// an SM.  Two producer warpgroups keep cp.async copies of raw float32 chunks
// (16 columns of the tile's 128 rows of A_i and of A_j, and of d2; a diagonal
// tile copies its rows once) in flight three chunks ahead, consecutive
// threads on consecutive 16 bytes of a row, and split each landed chunk into
// 8 x 8 core matrices, a thread taking row r of every part over 8 of the 16
// columns; full and empty mbarriers per split stage hand the parts to two
// consumer warpgroups issuing wgmma m64n128k16 without swizzle, and no
// block-wide barrier stands in the loop; setmaxnreg moves registers from the
// producers to the consumers.  One producer warpgroup (WPG = 1, rows 7 and
// 10's split) was 8% slower.  The sums keep the two levels above (ROADMAP.md,
// "What may chain through a tensor-core accumulator"): every 16-deep step's
// hi.hi starts from a zero accumulator and is added to the chunk's run with
// an IEEE add; the five smaller products are chained through one accumulator
// per 64-column chunk (a truncation there is about 2^-32 of the product) and
// added to the run once; the chunk runs go into a float32 total, parked in
// shared memory between chunks.  The diagonal of a diagonal tile is summed on
// the CUDA cores by the producers from the raw chunks, in the order the bf16
// design sums it (chains of 8 FMAs, the 8 chains of a chunk by a fixed tree,
// the chunks into a total), and replaces the tensor cores' value.  No TF32
// anywhere.  The split is exact for |x| >= 2^-110, about 8e-34 (below it the
// lo part needs bits finer than bf16's subnormal step, 2^-133;
// tests/test_torch_split_algebra.py): far below what A o d2 reaches in a
// solve.  What bounds it (measured on an H100 at B = 256, m = 1024, n = 2048,
// probes/assembly_variants.py, PERF.md row 4): no one piece.  Without its
// products, its split or its copies the kernel still takes 0.79-0.85 of its
// time, and its skeleton alone (the handovers, the chunk sums and the
// epilogue) a third: the producers and the consumers wait on each other at
// every 16-column step.
//
// An instance gets the same bits at any B, and two launches the same bits:
// nothing depends on B and there are no atomics.

#include "mma_common.cuh"
#include "panel_common.cuh"

namespace {

using namespace ipx_tile;   // the tile, the chunk, unpack8
using namespace ipx_mma;    // mma_add, the split, the ring

// blockIdx.x -> lower-triangle tile (bi >= bj), p = bi (bi + 1) / 2 + bj
__device__ __forceinline__ void tile_of(int p, int& bi, int& bj) {
    bi = int((sqrtf(8.f * float(p) + 1.f) - 1.f) * 0.5f);
    while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
    while (bi * (bi + 1) / 2 > p) --bi;
    bj = p - bi * (bi + 1) / 2;
}

// ---- the finished tile -----------------------------------------------------

constexpr int OLD = TILE + 1;       // float row stride of the staged tile
constexpr size_t OUT_B = size_t(TILE) * OLD * 4;               // 66048

// The finished tile T, staged in shared memory with padded rows (both a row
// and a column of it are read without bank conflicts), into M by eight warps,
// a warp writing 32 adjacent floats of one row of M at a time: an
// off-diagonal tile as is (rows of block i), then mirrored (rows of block
// j); a diagonal tile as 0.5 * (T + T^T) (a + b is commutative, so entry
// (i, j) and entry (j, i) get the same bits).
__device__ __forceinline__ void store_tile(const float* T, float* Mb, int m,
                                           int xr0, int yr0, int warp,
                                           int lane) {
    const int ri = min(TILE, m - xr0), rj = min(TILE, m - yr0);
    if (xr0 != yr0) {
        for (int r = warp; r < ri; r += 8)
            for (int c = lane; c < rj; c += 32)
                Mb[size_t(xr0 + r) * m + yr0 + c] = T[r * OLD + c];
        for (int c = warp; c < rj; c += 8)
            for (int r = lane; r < ri; r += 32)
                Mb[size_t(yr0 + c) * m + xr0 + r] = T[r * OLD + c];
        return;
    }
    for (int r = warp; r < ri; r += 8)
        for (int c = lane; c < ri; c += 32)
            Mb[size_t(xr0 + r) * m + xr0 + c] =
                __fmul_rn(0.5f, __fadd_rn(T[r * OLD + c], T[c * OLD + r]));
}

// ---- bf16 A: the tensor cores ----------------------------------------------

constexpr int FT = 256;             // threads: 8 warps, 4 (rows) x 2 (columns)
constexpr int CK = KC;              // chunk: 64 columns of A
constexpr int ALD = CK + 8;         // bf16 row stride of a [row][k] tile
constexpr int RSTAGES = 4;          // raw stages in the ring

constexpr size_t A_TILE_B = size_t(TILE) * ALD * 2;            // 18432
constexpr size_t RX_B = size_t(TILE) * CK * 2;                 // A_i chunk
constexpr size_t RSTAGE_B = RX_B + A_TILE_B + CK * 4;          // + A_j + d2
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

    // ---- the finished tile, staged in the ring's region -------------------
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

    // a diagonal tile's diagonal from the CUDA cores
    if (diag) {
        if ((tid & 7) == 0)
            for (int r = tid >> 3; r < TILE; r += FT / 8)
                T[r * OLD + r] = dsum[r];
        __syncthreads();
    }
    store_tile(T, M + b * size_t(m) * size_t(m), m, xr0, yr0, warp, lane);
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

// ---- float32 A: the tensor cores, warp-specialised -------------------------

constexpr int WCT = 256;            // consumer threads: two warpgroups
constexpr int WPG = 2;              // producer warpgroups
constexpr int WPT = WPG * 128;      // producer threads
constexpr int WAT = WCT + WPT;      // 512
constexpr int WCK = 16;             // raw chunk: 16 columns, one MMA step
constexpr int WSTEPS = KC / WCK;    // steps of a 64-column chunk of the sum
constexpr int WRSTAGES = 4;         // raw float32 stages (cp.async)
constexpr int WSSTAGES = 3;         // split bf16 stages (mbarriers)
constexpr int WRLD = WCK + 4;       // float row stride of a raw operand tile
// the launch gives every thread 65536 / WAT registers, rounded down to 8
// (128); the handover may only move them: a setmaxnreg.inc that asks for
// more than the producers gave back waits for ever.  The consumers hold
// three 64-entry sums a thread; the producers keep what is left (56).
constexpr int W_LAUNCH_REGS = 65536 / WAT / 8 * 8;
constexpr int W_CONSUMER_REGS = 200;
constexpr int W_PRODUCER_REGS =
    (WAT * W_LAUNCH_REGS - WCT * W_CONSUMER_REGS) / WPT;
constexpr size_t WRAW_OP_B = size_t(TILE) * WRLD * 4;        // 10240
constexpr size_t WRSTAGE_B = 2 * WRAW_OP_B + WCK * 4;        // A_i, A_j, d2
constexpr size_t WPARK_B = size_t(64) * WCT * 4;             // 65536
constexpr size_t WRAW_OFF = WSSTAGES * SSTAGE_B;             // 73728
constexpr size_t WPARK_OFF = WRAW_OFF + WRSTAGES * WRSTAGE_B;
constexpr size_t WDSUM_OFF = WPARK_OFF + WPARK_B;
constexpr size_t WBAR_OFF = WDSUM_OFF + TILE * 4;
constexpr size_t F32_SMEM = WBAR_OFF + 2 * WSSTAGES * 8;     // 222000
static_assert(F32_SMEM <= 227 * 1024, "one block an SM");
static_assert(OUT_B <= WRSTAGES * WRSTAGE_B + WPARK_B,
              "the finished tile is staged over the raw ring and the park");
static_assert((WPG == 1 || WPG == 2) && WCT == 8 * 32,
              "a producer thread a row of a part (or of half its columns); "
              "eight consumer warps");
static_assert(PART_E == TILE * WCK && WSTEPS == 4,
              "a split part is a tile's rows by a raw chunk; four a chunk");
static_assert(WCT * W_CONSUMER_REGS + WPT * W_PRODUCER_REGS
                  <= WAT * W_LAUNCH_REGS
              && W_PRODUCER_REGS % 8 == 0 && W_PRODUCER_REGS >= 24,
              "the consumers take no more than the producers give");

// eight floats from 16-byte aligned shared memory
__device__ __forceinline__ void lds8(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 c = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = c.x; out[5] = c.y; out[6] = c.z; out[7] = c.w;
}

// row r's hi, mid and lo parts of contraction half kh
__device__ __forceinline__ void store_parts(bf16* dst, int r, int kh,
                                            const float* x) {
    uint4 h, md, l;
    split8(x, h, md, l);
    bf16* at = dst + core_off(r, kh);
    *reinterpret_cast<uint4*>(at) = h;
    *reinterpret_cast<uint4*>(at + PART_E) = md;
    *reinterpret_cast<uint4*>(at + 2 * PART_E) = l;
}

// Block (p, b): lower-triangle tile p of instance b.  Threads 0 .. WCT - 1
// consume, WCT .. WAT - 1 produce.
__global__ void __launch_bounds__(WAT, 1)
assemble_sym_f32_tc_kernel(const float* __restrict__ A,
                           const float* __restrict__ d2,
                           float* __restrict__ M, int m, int n, int vec_ok) {
    extern __shared__ __align__(128) unsigned char sm[];
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + WBAR_OFF);
    uint64_t* empty = full + WSSTAGES;
    float* park = reinterpret_cast<float*>(sm + WPARK_OFF);
    float* dsum = reinterpret_cast<float*>(sm + WDSUM_OFF);
    int bi, bj;
    tile_of(blockIdx.x, bi, bj);
    const bool diag = bi == bj;
    const size_t b = blockIdx.y;
    const int tid = threadIdx.x;
    const int xr0 = bi * TILE, yr0 = bj * TILE;
    // raw chunks of WCK columns, in whole 64-column chunks of the sum
    const int nc = (n + KC - 1) / KC * WSTEPS;
    if (tid == 0)
        for (int s = 0; s < WSSTAGES; ++s) {
            bar_init(&full[s], WPT / 32);
            bar_init(&empty[s], WCT / 32);
        }
    __syncthreads();

    if (tid >= WCT) {
        set_regs<false, W_PRODUCER_REGS>();
        // producer thread pt: row r of the parts, contraction halves kh0
        // .. kh0 + 2 / WPG
        const int pt = tid - WCT;
        const int r = WPG == 1 ? pt : pt % TILE;
        const int kh0 = WPG == 1 ? 0 : pt / TILE;
        const float* Ab = A + b * size_t(m) * size_t(n);
        const float* d2b = d2 + b * size_t(n);
        auto raw = [&](int c) {
            return reinterpret_cast<float*>(sm + WRAW_OFF
                                            + (c % WRSTAGES) * WRSTAGE_B);
        };
        // chunk c: rows xr0 .. +128 of A (and yr0 .. unless diag), columns
        // c WCK .. +WCK, consecutive threads on consecutive granules (or
        // elements) of a row; d2's columns by the first threads (the copy's
        // row is not the split's)
        auto issue = [&](int c) {
            if (c < nc) {
                float* rx = raw(c);
                float* ry = rx + TILE * WRLD;
                float* dd = ry + TILE * WRLD;
                const int c0 = c * WCK;
                if (vec_ok) {
#pragma unroll
                    for (int u = 0; u < TILE * WCK / 4 / WPT; ++u) {
                        const int e = pt + WPT * u, rr = e >> 2;
                        const int j = (e & 3) * 4, col = c0 + j;
                        const bool xin = col < n && xr0 + rr < m;
                        cp16_or_zero(rx + rr * WRLD + j,
                                     xin ? Ab + size_t(xr0 + rr) * n + col
                                         : Ab,
                                     xin);
                        if (!diag) {
                            const bool yin = col < n && yr0 + rr < m;
                            cp16_or_zero(ry + rr * WRLD + j,
                                         yin ? Ab + size_t(yr0 + rr) * n + col
                                             : Ab,
                                         yin);
                        }
                    }
                    if (pt < WCK / 4) {
                        const int col = c0 + pt * 4;
                        cp16_or_zero(dd + pt * 4, col < n ? d2b + col : d2b,
                                     col < n);
                    }
                } else {
#pragma unroll 4
                    for (int u = 0; u < TILE * WCK / WPT; ++u) {
                        const int e = pt + WPT * u, rr = e / WCK;
                        const int j = e % WCK, col = c0 + j;
                        const bool xin = col < n && xr0 + rr < m;
                        cp4_or_zero(rx + rr * WRLD + j,
                                    xin ? Ab + size_t(xr0 + rr) * n + col : Ab,
                                    xin);
                        if (!diag) {
                            const bool yin = col < n && yr0 + rr < m;
                            cp4_or_zero(ry + rr * WRLD + j,
                                        yin ? Ab + size_t(yr0 + rr) * n + col
                                            : Ab,
                                        yin);
                        }
                    }
                    if (pt < WCK) {
                        const int col = c0 + pt;
                        cp4_or_zero(dd + pt, col < n ? d2b + col : d2b,
                                    col < n);
                    }
                }
            }
            cp_commit();
        };
        // M[r][r] on the CUDA cores (diagonal tiles): a chain of 8 FMAs over
        // each 8 columns (chain8), the two of a raw chunk added, the four raw
        // chunks of a 64-column chunk as (q0 + q1) + (q2 + q3), the chunks
        // into the total: the bf16 kernel's order
        auto chain8 = [&](const float* rx, const float* dd, int kh) {
            float a[8], dv[8], ch = 0.f;
            lds8(rx + kh * 8, a);
            lds8(dd + kh * 8, dv);
#pragma unroll
            for (int i = 0; i < 8; ++i)
                ch = __fmaf_rn(__fmul_rn(a[i], dv[i]), a[i], ch);
            return ch;
        };
        float q01 = 0.f, q23 = 0.f, dtot = 0.f;
        produce<WRSTAGES, WSSTAGES, WPT>(full, empty, nc, issue,
                                         [&](int c, int s) {
            const float* rx = raw(c) + r * WRLD;
            const float* ry = diag ? rx : rx + TILE * WRLD;
            const float* dd = raw(c) + 2 * TILE * WRLD;
            bf16* dst = reinterpret_cast<bf16*>(sm + s * SSTAGE_B);
#pragma unroll
            for (int kh = kh0; kh < kh0 + 2 / WPG; ++kh) {
                float a[8], dv[8], x[8];
                lds8(rx + kh * 8, a);
                lds8(dd + kh * 8, dv);
#pragma unroll
                for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(a[i], dv[i]);
                store_parts(dst, r, kh, x);
                if (!diag) lds8(ry + kh * 8, a);
                store_parts(dst + 3 * PART_E, r, kh, a);
            }
            // the diagonal by the first warpgroup, both halves of its row
            if (diag && kh0 == 0) {
                const float q = __fadd_rn(chain8(rx, dd, 0),
                                          chain8(rx, dd, 1));
                const int step = c % WSTEPS;
                if (step == 0) {
                    q01 = q;
                } else if (step == 1) {
                    q01 = __fadd_rn(q01, q);
                } else if (step == 2) {
                    q23 = q;
                } else {
                    dtot = __fadd_rn(dtot, __fadd_rn(q01, __fadd_rn(q23, q)));
                    if (c == nc - 1) dsum[r] = dtot;
                }
            }
        });
        return;
    }

    set_regs<true, W_CONSUMER_REGS>();
    float tot[64];
    consume<WSTEPS, WSSTAGES, WCT, true>(sm, full, empty, nc, park, tid, tot);
    // the diagonal's CUDA-core sums came with the last chunk; the raw ring
    // is quiet once the last chunk was handed over, the park once both
    // consumer warpgroups are past their last chunk
    const int lane = tid & 31, warp = tid >> 5;
    float* T = reinterpret_cast<float*>(sm + WRAW_OFF);
    named_sync<2, WCT>();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        const int r = acc_row<true>(i, warp, lane);
        const int c = acc_col<true>(i, warp, lane);
        T[r * OLD + c] = diag && r == c ? dsum[r] : tot[i];
    }
    named_sync<2, WCT>();
    store_tile(T, M + b * size_t(m) * size_t(m), m, xr0, yr0, warp, lane);
}

int launch_f32(const void* A, const float* d2, float* M, int B, int m, int n,
               cudaStream_t stream) {
    const int nt = (m + TILE - 1) / TILE;
    const int vec_ok = (n % 4 == 0)
        && ((reinterpret_cast<uintptr_t>(A)
             | reinterpret_cast<uintptr_t>(d2)) % 16 == 0);
    cudaError_t err = cudaFuncSetAttribute(
        assemble_sym_f32_tc_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(F32_SMEM));
    if (err != cudaSuccess) return int(err);
    dim3 grid(nt * (nt + 1) / 2, B);
    assemble_sym_f32_tc_kernel<<<grid, WAT, F32_SMEM, stream>>>(
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

