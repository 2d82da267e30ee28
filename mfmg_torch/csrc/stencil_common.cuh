// Shared code of the fine-grid stencil kernels (K1, K2, K3).
//
// The operator is a variable-coefficient stencil on a C-order (gz, gy, gx)
// node grid.  A one-sided stencil (K3) is stored as n_off contiguous planes,
// one per offset.  A symmetric one (K1, K2) is stored as 1 + n_pos planes:
// the center plane, then one plane per strictly positive offset o.  The
// negative offsets are never stored: by symmetry C_{-o}[i] = C_o[i - o], so
// each positive offset contributes the gathered pair
//     C_o[i] * v[i + o]  +  C_o[i - o] * v[i - o].
// K2's chain skips out-of-domain terms by explicit per-axis bounds checks
// (apply_at below); K1 and K3 stage x in shared memory with a zero halo
// (stencil_apply.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// One offset table for every stencil kernel: up to 7^3 = 343 offsets of
// radius <= 3 (a Q3 stencil, one-sided), of which a symmetric stencil
// stores the 171 strictly positive ones.  Signed bytes: 1,033 bytes of
// kernel parameter, read uniformly across a warp from the constant bank.
#define MFMG_MAX_OFF 343
#define MFMG_MAX_POS 171
#define MFMG_MAX_RADIUS 3

struct StencilOffsets {
    int n;
    signed char dz[MFMG_MAX_OFF];
    signed char dy[MFMG_MAX_OFF];
    signed char dx[MFMG_MAX_OFF];
};

__device__ __forceinline__ float load_coef(const float* __restrict__ p, int i) {
    return __ldg(p + i);
}

__device__ __forceinline__ float load_coef(const __nv_bfloat16* __restrict__ p, int i) {
    return __bfloat162float(p[i]);
}

// (A v)[i] of a symmetric stencil with float accumulation, in the order of
// the plain version: center, then for each positive offset the forward and
// the backward term.  K2's chain runs it.
template <typename T>
__device__ __forceinline__ float apply_at(const T* __restrict__ planes,
                                          const float* __restrict__ v,
                                          int i, int iz, int iy, int ix,
                                          int gz, int gy, int gx, int n,
                                          const StencilOffsets& o) {
    float acc = load_coef(planes, i) * v[i];
    for (int j = 0; j < o.n; ++j) {
        const T* __restrict__ c = planes + (size_t)(j + 1) * n;
        const int dz = o.dz[j], dy = o.dy[j], dx = o.dx[j];
        const int d = (dz * gy + dy) * gx + dx;
        const int jz = iz + dz, jy = iy + dy, jx = ix + dx;
        if (jz >= 0 && jz < gz && jy >= 0 && jy < gy && jx >= 0 && jx < gx)
            acc += load_coef(c, i) * v[i + d];
        const int kz = iz - dz, ky = iy - dy, kx = ix - dx;
        if (kz >= 0 && kz < gz && ky >= 0 && ky < gy && kx >= 0 && kx < gx)
            acc += load_coef(c, i - d) * v[i - d];
    }
    return acc;
}

__device__ __forceinline__ void grid_coords(int i, int gy, int gx,
                                            int& iz, int& iy, int& ix) {
    ix = i % gx;
    const int t = i / gx;
    iy = t % gy;
    iz = t / gy;
}

// The table of n (dz, dy, dx) triples; false if n exceeds max_n or a
// component the radius.
inline bool make_offsets(int n, const int* offs, int max_n, StencilOffsets& o) {
    if (n < 0 || n > max_n) return false;
    o.n = n;
    for (int j = 0; j < n; ++j) {
        for (int a = 0; a < 3; ++a) {
            const int v = offs[3 * j + a];
            if (v < -MFMG_MAX_RADIUS || v > MFMG_MAX_RADIUS) return false;
        }
        o.dz[j] = (signed char)offs[3 * j];
        o.dy[j] = (signed char)offs[3 * j + 1];
        o.dx[j] = (signed char)offs[3 * j + 2];
    }
    return true;
}

constexpr int kThreads = 256;

inline int n_blocks(int n) { return (n + kThreads - 1) / kThreads; }
