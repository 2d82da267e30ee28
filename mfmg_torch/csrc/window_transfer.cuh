// Index arithmetic of the fine-level windowed transfer, shared by K4/K5
// (structured_transfer.cu) and the full-mode coarse tail (fused_tail.cu);
// window_prolong_at, one fine point's gather, is the tail's (K4 and K5 own
// their sites and points by agglomerate rows instead).
//
// The fine grid (nz, ny, nx) is covered by the agglomerate grid (gz, gy, gx)
// of windows w per axis at stride s = w - 1 (neighbouring windows share one
// node plane), so n = g * s + 1 per axis.  The weights are
// W[e, tz, ty, tx, az, ay, ax], C-order (c, wz, wy, wx, gz, gy, gx), and the
// coarse vector is site-major, xc[a * c + e]:
//   restrict:  out[a, e] = sum_t W[e, t, a] x[a * s + t]
//   prolong:   y[i] = sum over the <= 8 windows (a, t = i - a * s) holding i,
//              and over e, of W[e, t, a] xc[a, e]   (the exact adjoint)
// Every sum runs in a fixed order in one thread: no atomics, deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

struct FineWindows {
    int nz, ny, nx;     // fine grid
    int gz, gy, gx;     // agglomerate grid
    int wz, wy, wx;     // window per axis, stride w - 1
    int c;              // components (eigenvectors) per agglomerate
};

__device__ __forceinline__ float wload(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float wload(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
}

__device__ __forceinline__ int floor_div(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Prolongation at fine point i (xc site-major): the <= 2 windows per axis
// holding i, a = i / s and, where i lies on a window boundary, a - 1 (local
// offset s), in increasing a; the absent ones add zero (their loads
// clamped), so that all loads issue together.  kC: c at compile time, 0 for
// g.c.
template <int kC, typename T>
__device__ __forceinline__ float window_prolong_at(const T* __restrict__ W,
                                                   const float* xc,
                                                   const FineWindows& g, int i) {
    const int c = kC ? kC : g.c;
    const int sz = g.wz - 1, sy = g.wy - 1, sx = g.wx - 1;
    const int n_sites = g.gz * g.gy * g.gx, fw3 = g.wz * g.wy * g.wx;
    const int ix = i % g.nx, u = i / g.nx, iy = u % g.ny, iz = u / g.ny;
    float acc = 0.f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
        const int az = iz / sz - 1 + dz, tz = iz - az * sz;
        const bool okz = az >= 0 && az < g.gz && tz <= sz;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
            const int ay = iy / sy - 1 + dy, ty = iy - ay * sy;
            const bool oky = okz && ay >= 0 && ay < g.gy && ty <= sy;
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
                const int ax = ix / sx - 1 + dx, tx = ix - ax * sx;
                const bool ok = oky && ax >= 0 && ax < g.gx && tx <= sx;
                const int a = ok ? (az * g.gy + ay) * g.gx + ax : 0;
                const int tt = ok ? (tz * g.wy + ty) * g.wx + tx : 0;
                for (int e = 0; e < c; ++e) {
                    const float wv = wload(W, ((size_t)e * fw3 + tt) * n_sites + a);
                    acc += ok ? wv * xc[a * c + e] : 0.f;
                }
            }
        }
    }
    return acc;
}

// 0 when the geometry is consistent (w >= 2 and n = g * (w - 1) + 1 on
// every axis), else cudaErrorInvalidValue.
inline int check_fine_windows(const FineWindows& g) {
    const int n[3] = {g.nz, g.ny, g.nx}, a[3] = {g.gz, g.gy, g.gx},
              w[3] = {g.wz, g.wy, g.wx};
    if (g.c < 1) return (int)cudaErrorInvalidValue;
    for (int d = 0; d < 3; ++d)
        if (w[d] < 2 || a[d] < 1 || n[d] != a[d] * (w[d] - 1) + 1)
            return (int)cudaErrorInvalidValue;
    return 0;
}

inline FineWindows make_fine_windows(const int* geom) {
    FineWindows g;
    g.nz = geom[0]; g.ny = geom[1]; g.nx = geom[2];
    g.gz = geom[3]; g.gy = geom[4]; g.gx = geom[5];
    g.wz = geom[6]; g.wy = geom[7]; g.wx = geom[8];
    g.c = geom[9];
    return g;
}
