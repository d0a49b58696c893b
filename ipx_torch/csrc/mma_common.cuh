// Tensor-core building blocks shared by the kernels that multiply on
// Hopper's tensor cores with an exact bf16 split of a float32 operand: the
// fused panel stage (fused_panel.cu), the symmetric assembly
// (assemble_sym.cu), the right-looking factor's panel products
// (cholesky_right.cu) and the left-looking factors' accumulation
// (accum_panel.cu).
//
// mma.sync m16n8k16 (bf16 in, float32 sums) fed by ldmatrix from shared
// tiles, asynchronous copies (cp.async) into a ring of stages, and the
// two-level sum these kernels keep: every MMA starts from a fresh zero
// accumulator and its 16 products are added to a run with an IEEE add
// (mma_add), the runs to a total (add_frag).  A tensor core aligns the
// products of one MMA to the largest and truncates what falls below, always
// towards zero, so a run chained through the MMA accumulator loses a biased
// truncation on every MMA (PERF.md, "What was hard, row 5"; ROADMAP.md,
// "Rules").
//
// Second half: the warp-specialised pipeline of the kernels that split BOTH
// operands (row 4's float32 A in assemble_sym.cu, rows 7 and 10 in
// accum_panel.cu).  A producer warpgroup copies raw float32 chunks of 16
// contraction entries and splits them into parts in core-matrix layout;
// full and empty mbarriers per split stage hand them to consumer
// warpgroups on wgmma m64n128k16; setmaxnreg moves registers from the
// producers to the consumers.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ipx_mma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return unsigned(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// cp16 that copies 16 bytes when `full`, else writes 16 zero bytes (a source
// size of 0 reads nothing; src must still be a valid address)
__device__ __forceinline__ void cp16_or_zero(void* dst, const void* src,
                                             bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// a 4-byte copy, or 4 zero bytes (rows that are not 16-byte aligned)
__device__ __forceinline__ void cp4_or_zero(void* dst, const void* src,
                                            bool full) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0)
                 : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldm_x4(unsigned (&r)[4], const bf16* p) {
    if (TRANS)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                     "{%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(smem_u32(p)) : "memory");
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                     "{%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                     : "r"(smem_u32(p)) : "memory");
}

// d += a b, one m16n8k16 tile, bf16 in, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// run += a b with the product summed alone: a fresh accumulator for the one
// MMA (16 products, which a tensor core may align and truncate together),
// then IEEE adds.  A run chained through the MMA accumulator instead loses
// the truncated bits on every MMA, always towards zero; on the prior-panel
// subtraction that cost most of the lanes (PERF.md, "What was hard, row 5").
__device__ __forceinline__ void mma_add(float (&run)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    mma(p, a, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) run[e] = __fadd_rn(run[e], p[e]);
}

// A warp's 32 x 64 block of sums: [m tile][n tile][fragment]
typedef float Frag[2][8][4];

__device__ __forceinline__ void zero_frag(Frag& f) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) f[i][j][e] = 0.f;
}

// total += run (IEEE adds), the second level of a sum
__device__ __forceinline__ void add_frag(Frag& tot, const Frag& run) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                tot[i][j][e] = __fadd_rn(tot[i][j][e], run[i][j][e]);
}

// the exact 3-way split of two floats, each part packed as a bf16 pair
__device__ __forceinline__ void split2(float a, float b, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __fsub_rn(a, __low2float(h));
    b = __fsub_rn(b, __high2float(h));
    __nv_bfloat162 md = __floats2bfloat162_rn(a, b);
    a = __fsub_rn(a, __low2float(md));
    b = __fsub_rn(b, __high2float(md));
    __nv_bfloat162 l = __floats2bfloat162_rn(a, b);
    hi = *reinterpret_cast<unsigned*>(&h);
    mid = *reinterpret_cast<unsigned*>(&md);
    lo = *reinterpret_cast<unsigned*>(&l);
}

// eight floats -> their hi, mid and lo parts as 16 bytes each
__device__ __forceinline__ void split8(const float* x, uint4& hi, uint4& mid,
                                       uint4& lo) {
    split2(x[0], x[1], hi.x, mid.x, lo.x);
    split2(x[2], x[3], hi.y, mid.y, lo.y);
    split2(x[4], x[5], hi.z, mid.z, lo.z);
    split2(x[6], x[7], hi.w, mid.w, lo.w);
}

// The ring of STAGES raw stages: issue(c) asks for chunk c (nothing past the
// last) and commits one cp.async group; convert(c) splits the landed chunk c
// into the bf16 tiles; multiply(c) runs the warps' MMAs on them.  Chunk
// c + STAGES - 1 goes into the stage that chunk c - 1 left, once every warp is
// past it.
template <int STAGES, class Issue, class Convert, class Multiply>
__device__ __forceinline__ void ring(int nc, Issue issue, Convert convert,
                                     Multiply multiply) {
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) issue(c);
    for (int c = 0; c < nc; ++c) {
        cp_wait<STAGES - 2>();          // this thread's copies of chunk c
        __syncthreads();                // everyone's; the split tiles free
        convert(c);
        issue(c + STAGES - 1);
        __syncthreads();                // the split tiles written
        multiply(c);
    }
    cp_wait<0>();
    __syncthreads();                    // the ring may be reused
}


// ---- the warp-specialised pipeline (both operands split) -------------------

// A split part: 128 rows (of the output) x 16 contraction entries, bf16, as
// 8 x 8 core matrices of 128 contiguous bytes: core (n / 8, kh) at
// (n / 8) * 256 + kh * 128 bytes, row n % 8 of it 16 bytes further each.
// wgmma reads it without swizzle (K-major, LBO 128, SBO 256) and ldmatrix
// reads each core matrix's 8 rows from distinct banks.  A split stage holds
// X's hi, mid, lo parts, then Y's.
constexpr int PART_E = 128 * 16;                           // 2048 bf16
constexpr size_t PART_B = size_t(PART_E) * 2;              // 4096
constexpr size_t SSTAGE_B = 6 * PART_B;                    // 24576

// element offset of row n, contraction half kh, in a split part
__device__ __forceinline__ int core_off(int n, int kh) {
    return (n >> 3) * 128 + kh * 64 + (n & 7) * 8;
}

// the descriptor of a split part (no swizzle, K-major: LBO 128, SBO 256)
__device__ __forceinline__ uint64_t part_desc(const void* p) {
    return uint64_t((smem_u32(p) & 0x3FFFF) >> 4)
        | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// release: the warp's shared-memory reads and writes before it are seen by
// whoever waits on the barrier's phase
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// acquire: wait for the phase of the given parity to complete
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

// a barrier of N threads (the producers alone: ID 1; the consumers alone: 2)
template <int ID, int N>
__device__ __forceinline__ void named_sync() {
    asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "n"(N) : "memory");
}

// setmaxnreg: the warpgroup's registers a thread, up (INC) or down.  An inc
// that asks for more than the block's other warpgroups gave back waits for
// ever: each kernel static_asserts its split against its launch.
template <bool INC, int N>
__device__ __forceinline__ void set_regs() {
    if (INC)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
    else
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// d (+)= A B^T over one 16-deep step for the warpgroup's 64 x 128 block, A
// and B split parts given by their descriptors; SCALE_D = 0 starts from zero
template <int SCALE_D>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da,
                                         uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
        " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
        " %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(SCALE_D));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of d across a wgmma or a
// wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Where entry i of a consumer thread's 64 sums lies in the 128 x 128 tile.
// wgmma: warpgroup wg = warp / 4 owns rows 64 wg .. +64, its warp w = warp %
// 4 rows 16 w .. +16, all 128 columns.  mma.sync: entry (mi * 8 + ni) * 4 +
// e, warp (wm, wn) = (warp % 4, warp / 4) owns rows 32 wm .. +32 and columns
// 64 wn .. +64, as 2 x 8 tiles of m16n8.
template <bool WG>
__device__ __forceinline__ int acc_row(int i, int warp, int lane) {
    return WG ? (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2)
                    + 8 * ((i >> 1) & 1)
              : (warp & 3) * 32 + (i >> 5) * 16 + (lane >> 2)
                    + 8 * ((i >> 1) & 1);
}
template <bool WG>
__device__ __forceinline__ int acc_col(int i, int warp, int lane) {
    return WG ? (i >> 2) * 8 + 2 * (lane & 3) + (i & 1)
              : (warp >> 2) * 64 + ((i >> 2) & 7) * 8 + 2 * (lane & 3)
                    + (i & 1);
}

// The producer warpgroup's loop over nc chunks (PT threads, named barrier
// 1).  issue(c) asks for raw chunk c into raw stage c % RSTAGES (nothing past
// the last) and commits one cp.async group; split(c, s) splits the landed raw
// chunk c into split stage s.  Chunk c + RSTAGES - 1 is asked for once every
// producer is past chunk c - 1, whose raw stage it takes; split stage s is
// written once the consumers have handed it back (empty), and handed over
// (full) with whatever else split wrote.
template <int RSTAGES, int SSTAGES, int PT, class Issue, class Split>
__device__ __forceinline__ void produce(uint64_t* full, uint64_t* empty,
                                        int nc, Issue issue, Split split) {
#pragma unroll 1
    for (int c = 0; c < RSTAGES - 1; ++c) issue(c);
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
        cp_wait<RSTAGES - 2>();         // this thread's copies of chunk c
        named_sync<1, PT>();            // everyone's; raw stage of c - 1 free
        issue(c + RSTAGES - 1);
        const int s = c % SSTAGES;
        if (c >= SSTAGES)               // the consumers are done with c - S
            bar_wait(&empty[s], ((c / SSTAGES) + 1) & 1);
        split(c, s);
        // the split tiles (and what else split wrote) to the tensor cores'
        // proxy, then to the consumers
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if ((threadIdx.x & 31) == 0) bar_arrive(&full[s]);
    }
    cp_wait<0>();
}

// Sum one chunk into run (hi.hi, fresh, one IEEE add an entry) and chain
// (with CHAIN, the five smaller products through the wgmma accumulator;
// without, every product alone into run).
template <bool CHAIN>
__device__ __forceinline__ void wg_step(const unsigned char* S, int wg,
                                        float (&run)[64], float (&hh)[64],
                                        float (&chain)[64]) {
    uint64_t dx[3], dy[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
        dx[s] = part_desc(S + s * PART_B + wg * 8 * 256);
        dy[s] = part_desc(S + (3 + s) * PART_B);
    }
    fence_regs(hh);
    fence_regs(chain);
    wgmma_fence();
    if (CHAIN) {
        wgmma128<0>(hh, dx[0], dy[0]);
        wgmma_commit();
        wgmma128<1>(chain, dx[1], dy[0]);
        wgmma128<1>(chain, dx[2], dy[0]);
        wgmma128<1>(chain, dx[0], dy[1]);
        wgmma128<1>(chain, dx[1], dy[1]);
        wgmma128<1>(chain, dx[0], dy[2]);
        wgmma_commit();
        wgmma_wait<1>();                // hi.hi done
        fence_regs(hh);
#pragma unroll
        for (int i = 0; i < 64; ++i) run[i] = __fadd_rn(run[i], hh[i]);
    } else {
        const int pairs[6][2] = {{0, 0}, {1, 0}, {2, 0}, {0, 1}, {1, 1},
                                 {0, 2}};
#pragma unroll
        for (int p = 0; p < 6; ++p) {
            if (p) wgmma_fence();
            wgmma128<0>(hh, dx[pairs[p][0]], dy[pairs[p][1]]);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(hh);
#pragma unroll
            for (int i = 0; i < 64; ++i) run[i] = __fadd_rn(run[i], hh[i]);
        }
    }
}

// The consumer warpgroups' loop over nc chunks (CT threads), CPP chunks a
// group of the two-level sum (nc a multiple of CPP): returns in tot the sum
// over the groups of (hi.hi run + small-product chain), the group sums added
// in order, parked in shared memory (park, 64 CT floats) between groups.  A
// chunk's split stage (split + s SSTAGE_B) is handed back once its products
// have completed, the chained ones one chunk later.  A group's chunks are
// unrolled, so that no branch joins while chained products are in flight:
// ptxas would make every chunk wait for them there.
template <int CPP, int SSTAGES, int CT, bool CHAIN>
__device__ __forceinline__ void consume(const unsigned char* split,
                                        uint64_t* full, uint64_t* empty,
                                        int nc, float* park, int tid,
                                        float (&tot)[64]) {
    const int lane = tid & 31;
    float chain[64], hh[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) tot[i] = chain[i] = hh[i] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < nc; c0 += CPP) {
#pragma unroll
        for (int cc = 0; cc < CPP; ++cc) {
            const int c = c0 + cc, s = c % SSTAGES;
            bar_wait(&full[s], (c / SSTAGES) & 1);
            __syncwarp();               // wgmma wants the warp converged
            wg_step<CHAIN>(split + s * SSTAGE_B, tid >> 7, tot, hh, chain);
            if (cc == CPP - 1) {        // the group's products all done
                wgmma_wait<0>();
                fence_regs(chain);
            }
            __syncwarp();
            if (lane == 0) {
                if (CHAIN && cc > 0)
                    bar_arrive(&empty[(c - 1) % SSTAGES]);
                if (!CHAIN || cc == CPP - 1)
                    bar_arrive(&empty[s]);
            }
        }
        const bool first = c0 == 0, last = c0 + CPP >= nc;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            float* at = park + i * CT + tid;
            float r = __fadd_rn(tot[i], chain[i]);
            if (!first) r = __fadd_rn(*at, r);
            if (last) {
                tot[i] = r;
            } else {
                *at = r;
                tot[i] = 0.f;
            }
            chain[i] = 0.f;
        }
    }
}

}  // namespace ipx_mma
