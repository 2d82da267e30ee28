// Shared device code of the fine-grid stencil kernels (K1, K2).
//
// The operator is a symmetric variable-coefficient stencil on a C-order
// (gz, gy, gx) node grid, stored as 1 + n_pos contiguous planes: the center
// plane, then one plane per strictly positive offset o.  The negative
// offsets are never stored: by symmetry C_{-o}[i] = C_o[i - o], so each
// positive offset contributes the gathered pair
//     C_o[i] * v[i + o]  +  C_o[i - o] * v[i - o].
// Out-of-domain terms are skipped by explicit per-axis bounds checks (the
// TPU kernel relied on zero boundary coefficients and flat-index wrap).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Q1 3-D stencils have 13 positive offsets, Q2 ones 62.
#define MFMG_MAX_POS 62

struct PosOffsets {
    int n_pos;
    int dz[MFMG_MAX_POS];
    int dy[MFMG_MAX_POS];
    int dx[MFMG_MAX_POS];
};

__device__ __forceinline__ float load_coef(const float* __restrict__ p, int i) {
    return __ldg(p + i);
}

__device__ __forceinline__ float load_coef(const __nv_bfloat16* __restrict__ p, int i) {
    return __bfloat162float(p[i]);
}

// (A v)[i] with float accumulation, in the order of the plain version:
// center, then for each positive offset the forward and the backward term.
template <typename T>
__device__ __forceinline__ float apply_at(const T* __restrict__ planes,
                                          const float* __restrict__ v,
                                          int i, int iz, int iy, int ix,
                                          int gz, int gy, int gx, int n,
                                          const PosOffsets& o) {
    float acc = load_coef(planes, i) * v[i];
    for (int j = 0; j < o.n_pos; ++j) {
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

inline PosOffsets make_offsets(int n_pos, const int* offs) {
    PosOffsets o;
    o.n_pos = n_pos;
    for (int j = 0; j < n_pos; ++j) {
        o.dz[j] = offs[3 * j];
        o.dy[j] = offs[3 * j + 1];
        o.dx[j] = offs[3 * j + 2];
    }
    return o;
}

constexpr int kThreads = 256;

inline int n_blocks(int n) { return (n + kThreads - 1) / kThreads; }
