// Tensor-core building blocks shared by the kernels that multiply on
// Hopper's tensor cores with an exact bf16 split of a float32 operand: the
// fused panel stage (fused_panel.cu), the symmetric assembly
// (assemble_sym.cu) and the right-looking factor's panel products
// (cholesky_right.cu).
//
// mma.sync m16n8k16 (bf16 in, float32 sums) fed by ldmatrix from shared
// tiles, asynchronous 16-byte copies (cp.async) into a ring of stages, and
// the two-level sum these kernels keep: every MMA starts from a fresh zero
// accumulator and its 16 products are added to a run with an IEEE add
// (mma_add), the runs to a total (add_frag).  A tensor core aligns the
// products of one MMA to the largest and truncates what falls below, always
// towards zero, so a run chained through the MMA accumulator loses a biased
// truncation on every MMA (PERF.md, "What was hard, row 5"; ROADMAP.md,
// "Rules").

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

}  // namespace ipx_mma
