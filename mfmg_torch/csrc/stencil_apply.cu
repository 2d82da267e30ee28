// K3: one-sided variable-coefficient stencil apply, y = sum_o C_o x(i + o).
//
// Replaces mfmg_tpu/ops/pallas_stencil.py pallas_stencil_apply (the
// VMEM-resident TPU kernel that streamed every offset plane through a
// double-buffered DMA and rolled x in VMEM), and covers its z-tiled variant
// pallas_stencil_apply_tiled (the same function for grids beyond VMEM).
// It runs the fine applies of operators without the symmetric-pair form:
// Q2/Q3 elements (125 / 343 offsets, planes bit-asymmetric after the
// floating-point scatter) and stencils read from an assembled matrix.
//
// What bounds it on an H100: bytes.  Per grid point it reads one
// coefficient per offset and does 2 flops with it: at 65^3 Q2 with bf16
// planes that is 125 x 0.55 MB = 68.7 MB of planes plus 2.2 MB of x and y,
// ~21 us at 3.35 TB/s, against 69 Mflop, ~1 us at 67 TFLOP/s float32.
//
// Design: one thread per grid point in the gather form, looping over the
// offsets.  Neighbouring threads read neighbouring addresses of every plane,
// so each plane streams coalesced; the shifted reads of x hit lines that
// neighbouring warps have just brought into L1/L2.  The offset table is a
// __grid_constant__ parameter of signed bytes (radius <= 3, so up to 7^3 =
// 343 offsets in 1,033 bytes), uniform across the warp.  Out-of-grid terms
// are skipped by explicit per-axis bounds checks: x is never read outside
// the grid (the TPU kernel relied on zero padding and zero boundary
// coefficients).  Coefficients are float or bf16 (converted in registers);
// accumulation is float, in offset order, as in the plain version.
#include "stencil_common.cuh"

// A radius-3 stencil (Q3 elements) has 7^3 offsets.
#define MFMG_MAX_OFF 343
#define MFMG_MAX_RADIUS 3

struct OffsetTable {
    int n_off;
    signed char dz[MFMG_MAX_OFF];
    signed char dy[MFMG_MAX_OFF];
    signed char dx[MFMG_MAX_OFF];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_apply_kernel(const T* __restrict__ planes, const float* __restrict__ x,
                     float* __restrict__ y, int gz, int gy, int gx,
                     const __grid_constant__ OffsetTable o) {
    const int n = gz * gy * gx;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int iz, iy, ix;
    grid_coords(i, gy, gx, iz, iy, ix);
    float acc = 0.f;
    for (int j = 0; j < o.n_off; ++j) {
        const int dz = o.dz[j], dy = o.dy[j], dx = o.dx[j];
        const int jz = iz + dz, jy = iy + dy, jx = ix + dx;
        if (jz >= 0 && jz < gz && jy >= 0 && jy < gy && jx >= 0 && jx < gx)
            acc += load_coef(planes + (size_t)j * n, i)
                 * __ldg(x + i + (dz * gy + dy) * gx + dx);
    }
    y[i] = acc;
}

template <typename T>
cudaError_t launch_stencil_apply(const void* planes, const float* x, float* y,
                                 int gz, int gy, int gx, const OffsetTable& o,
                                 cudaStream_t stream) {
    const int n = gz * gy * gx;
    stencil_apply_kernel<T><<<n_blocks(n), kThreads, 0, stream>>>(
        static_cast<const T*>(planes), x, y, gz, gy, gx, o);
    return cudaGetLastError();
}

extern "C" {

// y = sum_o C_o x(i + o) over (n_off, gz, gy, gx) planes; offs holds n_off
// (dz, dy, dx) triples of radius <= 3.  planes_bf16 selects the coefficient
// type.  Returns the cudaError_t of the launch (0 on success).
int mfmg_stencil_apply(const void* planes, int planes_bf16, const float* x,
                       float* y, int gz, int gy, int gx, int n_off,
                       const int* offs, void* stream) {
    if (n_off < 1 || n_off > MFMG_MAX_OFF) return (int)cudaErrorInvalidValue;
    OffsetTable o;
    o.n_off = n_off;
    for (int j = 0; j < n_off; ++j) {
        for (int a = 0; a < 3; ++a) {
            const int v = offs[3 * j + a];
            if (v < -MFMG_MAX_RADIUS || v > MFMG_MAX_RADIUS)
                return (int)cudaErrorInvalidValue;
        }
        o.dz[j] = (signed char)offs[3 * j];
        o.dy[j] = (signed char)offs[3 * j + 1];
        o.dx[j] = (signed char)offs[3 * j + 2];
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = planes_bf16
        ? launch_stencil_apply<__nv_bfloat16>(planes, x, y, gz, gy, gx, o, s)
        : launch_stencil_apply<float>(planes, x, y, gz, gy, gx, o, s);
    return (int)e;
}

}  // extern "C"
