// What the panel kernels share: the tile edge, the chunk of the two-level
// sums, the largest m of the panel route, where a factor's prior rows lie
// (PanelRows, FullRows), and unpack8.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ipx_tile {

constexpr int TILE = 128;           // rows and columns of an output tile
constexpr int KC = 64;              // columns per chunk of the two-level sum

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

}  // namespace ipx_tile
