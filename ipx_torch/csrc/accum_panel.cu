// The left-looking factors' panel accumulation and row-panel product on
// Hopper's tensor cores (NB = 128):
//
//   accum_panel   C_k = Ms[o : o + NB, o:] - sum_{j<k} P_j[:, lo : lo + NB]^T
//                                                       P_j[:, lo:],
//                 o = k NB, lo = (k - j) NB, C_k (B, NB, m - o), with the
//                 prior rows P_j read from the panel-major factor (PanelRows)
//                 or from the rows of a full L^T (FullRows);
//   lt_rows       LT[o : o + NB, t-tile] = W_k C_k[:, (t - k) NB : + NB] for
//                 t > k, zeros for t < k (the full-L^T factor's panel TRSM as
//                 a product with the block inverse).
//
// accum_panel replaces _accum_panel_kernel of ipx/kernels/cholesky.py (entry
// factor_lt_panels) and, over FullRows, the accumulation inside
// _factor_lt_kernel (entry factor_lt_batched); lt_rows the panel TRSM of
// _factor_lt_kernel.  One accumulation body runs over both address maps, so
// factor_lt_panels and factor_lt_batched get the same bits of C_k from the
// same prior rows.
//
// Bound on this card: bytes.  A left-looking accumulation reads the prior
// panels' suffixes again at every launch: at B = 256, m = 1024 the eight
// launches move 84 NB^2 floats of prior rows, Ms's tile rows and C once each
// an instance, 2.62 GB or 0.78 ms at 3.35 TB/s, against 0.55 ms for the 84
// tile products as six bf16 passes at the tensor-core rate.  Pre-split bf16
// planes would move 6 bytes an entry instead of 4, so the operands stay
// float32 in memory and are split on the way in.
//
// Design: warp-specialised, one block of 12 warps per 128 x 128 output tile,
// grid (column tile, instance), one block an SM.  Four producer warps (one
// warpgroup) keep cp.async copies of raw float32 chunks (16 contraction rows
// of both operands) in flight RSTAGES - 1 chunks ahead, and split each landed
// chunk exactly into hi + mid + lo bf16 parts (mma_common.cuh split8), a
// producer thread a row of every part, in a second ring of SSTAGES stages.
// The parts are stored as 8 x 8 core matrices of 128 contiguous bytes, the
// layout wgmma reads without swizzle and ldmatrix reads without bank
// conflicts.  Eight consumer warps take six of the nine cross products
// (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid; the rest lie below 2^-24 of
// the product).  Full and empty mbarriers per split stage hand the parts
// over, so one chunk's split overlaps the products of the chunks before it
// and no block-wide barrier stands in the loop; the producers give registers
// to the consumers (setmaxnreg).  The accumulation's consumers are two
// warpgroups issuing wgmma m64n128k16 from the shared parts; the row-panel
// product's are warps issuing ldmatrix-fed mma.sync m16n8k16, which measured
// faster there (its wgmma build spills).  What bounds it now (measured on
// an H100, probes/accum_variants.py, PERF.md rows 7 and 10): the
// producers, whose copies and split alone take four fifths of the time;
// the block's skeleton alone (its start, the handovers and the epilogue,
// without the copies, the split or the products) takes two fifths, and the
// epilogue's Ms rows in and C rows out, which nothing overlaps in a block of
// its own on the SM, a fifth.
//
// Summation, part of the function (ROADMAP.md, "Rules").  A tensor core
// aligns the products of one MMA to the largest and truncates what falls
// below, towards zero.  On hi.hi, the product itself, that truncation is a
// bias, so every hi.hi product starts from a zero accumulator and is added
// to the prior panel's run with an IEEE add.  The five smaller cross
// products are each at most 2^-8 of the product; they are chained through
// ONE accumulator per prior panel (a truncation there is about 2^-32 of the
// product) and added to the run once, when the panel is done.  The panel
// runs go into a total (parked in shared memory between panels), and the
// total comes off the start tile read from Ms in one subtraction.  Built
// with -DIPX_ACCUM_CHAIN_SMALL=0 (a probe's variant) every product is summed
// alone instead.  The diagonal of the t == k tile, a sum of squares of one
// sign, is summed on the CUDA cores by the producers from the raw chunks
// (column r by producer thread r: chains of 8 FMAs, a panel's run, the runs
// a total) and replaces the tensor cores' value.  The row-panel product sums
// W_k C_k's 128 terms the same way; it has no diagonal pass (a product with
// an inverse has mixed signs).
//
// An instance gets the same bits at any B: nothing depends on B and there are
// no atomics.  Shapes: m a multiple of 128 (the caller pads), the operands
// 16-byte aligned.  No TF32 anywhere.

#include "mma_common.cuh"
#include "panel_common.cuh"

#ifndef IPX_ACCUM_CHAIN_SMALL
#define IPX_ACCUM_CHAIN_SMALL 1
#endif
// the accumulation's consumers: wgmma (1) or, as a probe's variant,
// mma.sync (0); the row-panel product's are mma.sync
#ifndef IPX_ACCUM_WGMMA
#define IPX_ACCUM_WGMMA 1
#endif

namespace {

using namespace ipx_tile;   // TILE, PanelRows, FullRows, fill_panels
using namespace ipx_mma;    // mma, mma_add, the split, cp.async, ldmatrix

constexpr int CWARPS = 8;           // consumer warps: two warpgroups
constexpr int PWARPS = 4;           // producer warps: one warpgroup
constexpr int CT = CWARPS * 32;     // consumer threads, 0 .. CT - 1
constexpr int PT = PWARPS * 32;     // producer threads, CT .. AT - 1
constexpr int AT = CT + PT;         // 384
constexpr int CK = 16;              // contraction chunk: one MMA step
constexpr int CPP = TILE / CK;      // chunks a prior panel
constexpr int RSTAGES = 4;          // raw float32 stages (cp.async)
constexpr int SSTAGES = 3;          // split bf16 stages (mbarriers)
// setmaxnreg: the consumers' and the producers' registers, by the
// consumers' kind (wgmma holds three 64-entry sums a thread, mma.sync two
// and its fragments)
template <bool WG>
struct Regs {
    static constexpr int consumer = WG ? 200 : 224;
    static constexpr int producer = WG ? 104 : 56;
};

// the split parts, PART_E, PART_B and SSTAGE_B: mma_common.cuh
constexpr size_t RAW_OP_B = size_t(TILE) * CK * 4;         // 8192
constexpr size_t RSTAGE_B = 2 * RAW_OP_B;                  // X then Y
constexpr size_t PARK_B = size_t(64) * CT * 4;             // 65536
constexpr size_t SPLIT_OFF = RSTAGES * RSTAGE_B;           // 65536
constexpr size_t PARK_OFF = SPLIT_OFF + SSTAGES * SSTAGE_B;
constexpr size_t DSUM_OFF = PARK_OFF + PARK_B;
constexpr size_t BAR_OFF = DSUM_OFF + TILE * 4;
constexpr size_t ACCUM_SMEM = BAR_OFF + 2 * SSTAGES * 8;   // 205360
static_assert(ACCUM_SMEM <= 227 * 1024, "one block an SM");
static_assert(PT == TILE, "a producer thread a row of every split part");
static_assert(PART_E == TILE * CK, "a split part is a tile's rows by a chunk");
static_assert(CK * TILE / 4 % PT == 0, "a chunk is copied in whole passes");
// the launch gives every thread 65536 / AT registers, rounded down to 8
// (168); the handover may only move them: a setmaxnreg.inc that asks for
// more than the producers gave back waits for ever
constexpr int LAUNCH_REGS = 65536 / AT / 8 * 8;
static_assert(CT * Regs<true>::consumer + PT * Regs<true>::producer
                  <= AT * LAUNCH_REGS
              && CT * Regs<false>::consumer + PT * Regs<false>::producer
                  <= AT * LAUNCH_REGS,
              "the consumers take no more than the producers give");

// Split the raw chunk (X then Y, float32) into the split stage (X's hi, mid,
// lo parts, then Y's), producer thread pt taking row pt of every part.  Y's
// raw chunk is [k][col] (16 rows of 128), so row pt of its parts is column
// pt of the chunk; X's likewise, or with XT [row][k] (128 rows of 16).  With
// diag, ch[kh] = sum of the squares of X's column pt over the contraction
// half kh, a chain of 8 FMAs each.
template <bool XT>
__device__ __forceinline__ void split_chunk(const float* raw, bf16* dst,
                                            int pt, bool diag,
                                            float (&ch)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
            float x[8];
            if (XT && u == 0) {
                const float* src = raw + pt * CK + kh * 8;
                const float4 x0 = *reinterpret_cast<const float4*>(src);
                const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
                x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
                x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
            } else {
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    x[i] = raw[u * TILE * CK + (kh * 8 + i) * TILE + pt];
            }
            if (!XT && u == 0 && diag) {
                float c = 0.f;
#pragma unroll
                for (int i = 0; i < 8; ++i) c = __fmaf_rn(x[i], x[i], c);
                ch[kh] = c;
            }
            uint4 h, md, l;
            split8(x, h, md, l);
            bf16* at = dst + u * 3 * PART_E + core_off(pt, kh);
            *reinterpret_cast<uint4*>(at) = h;
            *reinterpret_cast<uint4*>(at + PART_E) = md;
            *reinterpret_cast<uint4*>(at + 2 * PART_E) = l;
        }
}

// The producer warpgroup (mma_common.cuh produce): split_chunk on every
// landed chunk.  With diag, the producer thread pt also sums the squares of
// column pt of every X chunk (chains of 8, a prior panel's run, the runs a
// total), into dsum[pt] before the last chunk is handed over.
template <bool XT, class Issue>
__device__ __forceinline__ void produce_split(unsigned char* sm,
                                              uint64_t* full, uint64_t* empty,
                                              int nc, Issue issue, bool diag,
                                              float* dsum, int pt) {
    float prun = 0.f, dtot = 0.f;
    produce<RSTAGES, SSTAGES, PT>(full, empty, nc, issue, [&](int c, int s) {
        float ch[2];
        split_chunk<XT>(reinterpret_cast<const float*>(
                            sm + (c % RSTAGES) * RSTAGE_B),
                        reinterpret_cast<bf16*>(sm + SPLIT_OFF
                                                + s * SSTAGE_B),
                        pt, diag, ch);
        if (diag) {
            prun = __fadd_rn(__fadd_rn(prun, ch[0]), ch[1]);
            if (c % CPP == CPP - 1) {   // a prior panel is done
                dtot = __fadd_rn(dtot, prun);
                prun = 0.f;
            }
            if (c == nc - 1) dsum[pt] = dtot;
        }
    });
}

// One 16-deep step of the warp's 32 x 64 block from a split stage: hi.hi
// alone into run, the five smaller products chained into chain.
__device__ __forceinline__ void multiply(const bf16* S, int lane, int wm,
                                         int wn, Frag& run, Frag& chain) {
    unsigned a[3][2][4];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
            ldm_x4<false>(a[s][mi], S + s * PART_E
                          + core_off(wm * 32 + mi * 16 + (lane & 15),
                                     lane >> 4));
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
        const bf16* yb = S + 3 * PART_E
            + core_off(wn * 64 + nj * 16 + (lane & 7) + ((lane >> 4) << 3),
                       (lane >> 3) & 1);
        // Y's hi, mid, lo: with X's hi, mid, lo; hi, mid; hi
#pragma unroll
        for (int sy = 0; sy < 3; ++sy) {
            unsigned bb[4];
            ldm_x4<false>(bb, yb + sy * PART_E);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int sx = 0; sx < 3 - sy; ++sx)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        if (!IPX_ACCUM_CHAIN_SMALL || (sx == 0 && sy == 0))
                            mma_add(run[mi][2 * nj + h], a[sx][mi],
                                    bb[2 * h], bb[2 * h + 1]);
                        else
                            mma(chain[mi][2 * nj + h], a[sx][mi],
                                bb[2 * h], bb[2 * h + 1]);
                    }
        }
    }
}

// The mma.sync consumers' loop: mma_common.cuh consume's sums, each warp a
// 32 x 64 block.
__device__ __forceinline__ void consume_mma(unsigned char* sm,
                                            uint64_t* full, uint64_t* empty,
                                            int nc, float* park, int tid,
                                            float (&tot)[64]) {
    const int lane = tid & 31, warp = tid >> 5;
    Frag& run = reinterpret_cast<Frag&>(tot);
    Frag chain;
    zero_frag(run);                     // the run of the current panel
    zero_frag(chain);
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
        const int s = c % SSTAGES;
        bar_wait(&full[s], (c / SSTAGES) & 1);
        multiply(reinterpret_cast<const bf16*>(sm + SPLIT_OFF
                                               + s * SSTAGE_B),
                 lane, warp & 3, warp >> 2, run, chain);
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[s]);
        if (c % CPP == CPP - 1) {       // a prior panel is done
            const bool first = c < CPP, last = c == nc - 1;
            const float* ch = &chain[0][0][0];
#pragma unroll
            for (int i = 0; i < 64; ++i) {
                float* at = park + i * CT + tid;
                float r = __fadd_rn(tot[i], ch[i]);
                if (!first) r = __fadd_rn(*at, r);
                if (last) {
                    tot[i] = r;
                } else {
                    *at = r;
                    tot[i] = 0.f;
                }
            }
            zero_frag(chain);
        }
    }
}

// Block (x, b): column tile t = k + x of C_k for instance b.
template <typename Prior>
__global__ void __launch_bounds__(AT, 1)
accum_panel_kernel(const float* __restrict__ Ms, Prior prior,
                   float* __restrict__ C, int m, int k) {
    extern __shared__ __align__(128) unsigned char sm[];
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
    uint64_t* empty = full + SSTAGES;
    float* park = reinterpret_cast<float*>(sm + PARK_OFF);
    float* dsum = reinterpret_cast<float*>(sm + DSUM_OFF);
    const int t = k + blockIdx.x;
    const size_t b = blockIdx.y;
    const int o = k * TILE, w = m - o, tid = threadIdx.x;
    const bool diag = t == k;
    const int nc = k * CPP;
    if (tid == 0)
        for (int s = 0; s < SSTAGES; ++s) {
            bar_init(&full[s], PWARPS);
            bar_init(&empty[s], CWARPS);
        }
    if (tid < TILE) dsum[tid] = 0.f;
    __syncthreads();

    constexpr bool WG = IPX_ACCUM_WGMMA != 0;
    if (tid >= CT) {
        set_regs<false, Regs<WG>::producer>();
        const int pt = tid - CT;
        auto issue = [&](int c) {
            if (c < nc) {
                const int jj = c / CPP, p0 = (c % CPP) * CK;
                size_t ld;
                const float* P = prior.at(jj, b, m, ld);
                P += size_t(p0) * ld;
                const float* xg = P + (k - jj) * TILE;
                const float* yg = P + (t - jj) * TILE;
                float* rx = reinterpret_cast<float*>(sm
                                                     + (c % RSTAGES) * RSTAGE_B);
                float* ry = rx + TILE * CK;
                for (int e = pt; e < CK * TILE / 4; e += PT) {
                    const int p = e / (TILE / 4), s4 = (e % (TILE / 4)) * 4;
                    cp16(rx + p * TILE + s4, xg + size_t(p) * ld + s4);
                    cp16(ry + p * TILE + s4, yg + size_t(p) * ld + s4);
                }
            }
            cp_commit();
        };
        produce_split<false>(sm, full, empty, nc, issue, diag, dsum, pt);
        return;
    }

    set_regs<true, Regs<WG>::consumer>();
    float tot[64];
    if constexpr (WG)
        consume<CPP, SSTAGES, CT, IPX_ACCUM_CHAIN_SMALL != 0>(
            sm + SPLIT_OFF, full, empty, nc, park, tid, tot);
    else
        consume_mma(sm, full, empty, nc, park, tid, tot);
    // the diagonal's CUDA-core sums came with the last chunk (k = 0: zeros)

    // ---- C = start - total, the one subtraction ------------------------------
    const int lane = tid & 31, warp = tid >> 5;
    float* Cb = C + b * size_t(TILE) * w + size_t(t - k) * TILE;
    const float* Mrow = Ms + b * size_t(m) * m + size_t(o) * m
                        + size_t(t) * TILE;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
        const int r = acc_row<WG>(i, warp, lane);
        const int c = acc_col<WG>(i, warp, lane);
        const float2 s = *reinterpret_cast<const float2*>(
            Mrow + size_t(r) * m + c);
        float u0 = tot[i], u1 = tot[i + 1];
        if (diag && r == c) u0 = dsum[r];
        if (diag && r == c + 1) u1 = dsum[r];
        *reinterpret_cast<float2*>(Cb + size_t(r) * w + c) =
            make_float2(__fsub_rn(s.x, u0), __fsub_rn(s.y, u1));
    }
}

// Block (t, b): tile t of rows k NB .. (k+1) NB of LT for instance b: zeros
// for t < k, W_k C[:, (t - k) NB ...] for t > k; t == k is diag_factor_inv's.
// (nc = CPP, given at run time: with it a constant, a wgmma build of this
// kernel unrolled the consumers' loop and spilled)
__global__ void __launch_bounds__(AT, 1)
lt_rows_kernel(const float* __restrict__ W, const float* __restrict__ C,
               float* __restrict__ LT, int m, int k, int nc) {
    extern __shared__ __align__(128) unsigned char sm[];
    const int t = blockIdx.x;
    if (t == k) return;
    const size_t b = blockIdx.y;
    const int o = k * TILE, w = m - o, nb = m / TILE, tid = threadIdx.x;
    float* out = LT + (b * size_t(m) + o) * m + size_t(t) * TILE;
    if (t < k) {
        for (int e = tid; e < TILE * TILE / 4; e += AT) {
            const int r = e / (TILE / 4), c4 = (e % (TILE / 4)) * 4;
            *reinterpret_cast<float4*>(out + size_t(r) * m + c4) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
        return;
    }
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
    uint64_t* empty = full + SSTAGES;
    if (tid == 0)
        for (int s = 0; s < SSTAGES; ++s) {
            bar_init(&full[s], PWARPS);
            bar_init(&empty[s], CWARPS);
        }
    __syncthreads();

    if (tid >= CT) {
        set_regs<false, Regs<false>::producer>();
        const int pt = tid - CT;
        const float* Wk = W + (b * nb + k) * size_t(TILE) * TILE;
        const float* Cg = C + b * size_t(TILE) * w + size_t(t - k) * TILE;
        auto issue = [&](int c) {
            if (c < nc) {
                float* rx = reinterpret_cast<float*>(sm
                                                     + (c % RSTAGES) * RSTAGE_B);
                float* ry = rx + TILE * CK;
                for (int e = pt; e < CK * TILE / 4; e += PT) {
                    // X: W_k's 128 rows, columns c CK .. +CK; Y: C's rows
                    const int r = e / (CK / 4), sx = (e % (CK / 4)) * 4;
                    cp16(rx + r * CK + sx, Wk + size_t(r) * TILE + c * CK + sx);
                    const int p = e / (TILE / 4), sy = (e % (TILE / 4)) * 4;
                    cp16(ry + p * TILE + sy,
                         Cg + size_t(c * CK + p) * w + sy);
                }
            }
            cp_commit();
        };
        produce_split<true>(sm, full, empty, nc, issue, false, nullptr, pt);
        return;
    }

    set_regs<true, Regs<false>::consumer>();
    float tot[64];
    consume_mma(sm, full, empty, nc, nullptr, tid, tot);
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
        const int r = acc_row<false>(i, warp, lane);
        const int c = acc_col<false>(i, warp, lane);
        *reinterpret_cast<float2*>(out + size_t(r) * m + c) =
            make_float2(tot[i], tot[i + 1]);
    }
}

template <typename K>
cudaError_t allow_smem(K kern) {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(ACCUM_SMEM));
}

bool args_ok(int B, int m, int k) {
    return B >= 1 && B <= 65535 && m >= TILE && m % TILE == 0 && k >= 0
        && k < m / TILE;
}

bool aligned(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Prior>
int launch_accum(const float* Ms, const Prior& prior, float* C, int B, int m,
                 int k, cudaStream_t stream) {
    auto kern = accum_panel_kernel<Prior>;
    cudaError_t err = allow_smem(kern);
    if (err != cudaSuccess) return int(err);
    dim3 grid(m / TILE - k, B);
    kern<<<grid, AT, ACCUM_SMEM, stream>>>(Ms, prior, C, m, k);
    return int(cudaGetLastError());
}

}  // namespace

// Panel k from an assembled, scaled, regularised Ms (B, m, m) f32 and the k
// prior panels (host array of k device pointers, panel j being (B, NB,
// m - j NB) contiguous) into C (B, NB, m - k NB).
// Returns 0, a cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int ipx_accum_panel(const float* Ms, const void* const* prior,
                               float* C, int B, int m, int k, void* stream) {
    if (!args_ok(B, m, k) || !aligned(Ms) || !aligned(C)) return -1;
    PanelRows pp;
    if (fill_panels(pp.panels, prior, k) != 0) return -1;
    return launch_accum(Ms, pp, C, B, m, k,
                        static_cast<cudaStream_t>(stream));
}

// Panel k from Ms, the k prior panels being rows 0 .. k NB of the full
// LT (B, m, m) f32 (only their columns from k NB on are read).
extern "C" int ipx_accum_panel_lt(const float* Ms, const float* LT, float* C,
                                  int B, int m, int k, void* stream) {
    if (!args_ok(B, m, k) || !aligned(Ms) || !aligned(LT) || !aligned(C))
        return -1;
    return launch_accum(Ms, FullRows{LT}, C, B, m, k,
                        static_cast<cudaStream_t>(stream));
}

// Rows k NB .. (k+1) NB of LT (B, m, m) outside the diagonal tile, from
// W (B, m / NB, NB, NB) and the accumulated panel C (B, NB, m - k NB):
// zeros to the left, W_k C[:, NB:] to the right.
extern "C" int ipx_lt_rows(const float* W, const float* C, float* LT, int B,
                           int m, int k, void* stream) {
    if (!args_ok(B, m, k) || !aligned(W) || !aligned(C) || !aligned(LT))
        return -1;
    cudaError_t err = allow_smem(lt_rows_kernel);
    if (err != cudaSuccess) return int(err);
    dim3 grid(m / TILE, B);
    lt_rows_kernel<<<grid, AT, ACCUM_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(W, C, LT, m, k,
                                                          CPP);
    return int(cudaGetLastError());
}
