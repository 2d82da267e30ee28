// K2: one whole deal.II Chebyshev smoothing step on the fine grid,
//     x_s = x - p(D^-1 A) D^-1 (A x - b),   and optionally  res = A x_s - b.
//
// Replaces mfmg_tpu/ops/pallas_stencil.py pallas_cheb_smooth, which loaded
// the center + positive coefficient planes into VMEM once and ran every
// polynomial term and the residual against them in one kernel.
//
// What bounds it on an H100: bytes again, now across degree (+1) stencil
// applies.  The card has no 7.7 MB of fast memory per SM, but its 50 MB L2
// holds all 14 bf16 planes of a 65^3 grid: the step is a short chain of
// fused launches, each a K1-style gather apply fused with its recurrence
// update, and the planes stay in L2 between them.
//   launch 1:        r = A x - b; z = invd r; p = z; dx = a_0 z
//   launch s < deg:  p = invd (r - A dx) + b_s p; dx' = dx + a_s p
//                    (r stays the first residual; p is updated in place,
//                    which is safe because it is pointwise; dx is
//                    double-buffered because the apply reads neighbours)
//   the last launch writes x_s = x - dx instead of dx;
//   with a residual: one K1 launch, res = A x_s - b.
// The recurrence coefficients [a_0..a_{deg-1}, b_0..b_{deg-1}] are a device
// array read at run time, never compile-time constants, so a new setup never
// needs a new build.  A single cooperative or temporally blocked launch is
// later work.
#include "stencil_common.cuh"

template <typename T>
cudaError_t launch_stencil_apply_sym(const void* planes, const float* x,
                                     const float* b, float* y, int gz, int gy,
                                     int gx, const PosOffsets& o,
                                     cudaStream_t stream);

template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_first_kernel(const T* __restrict__ planes, const float* __restrict__ x,
                  const float* __restrict__ b, const float* __restrict__ invd,
                  const float* __restrict__ coef, float* __restrict__ r,
                  float* __restrict__ p, float* __restrict__ out, int last,
                  int gz, int gy, int gx, const __grid_constant__ PosOffsets o) {
    const int n = gz * gy * gx;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int iz, iy, ix;
    grid_coords(i, gy, gx, iz, iy, ix);
    const float ri = apply_at(planes, x, i, iz, iy, ix, gz, gy, gx, n, o) - b[i];
    const float z = invd[i] * ri;
    r[i] = ri;
    p[i] = z;
    const float dx = coef[0] * z;
    out[i] = last ? x[i] - dx : dx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_step_kernel(const T* __restrict__ planes, const float* __restrict__ dx_in,
                 const float* __restrict__ r, float* __restrict__ p,
                 const float* __restrict__ invd, const float* __restrict__ coef,
                 int step, int degree, const float* __restrict__ x,
                 float* __restrict__ out, int last,
                 int gz, int gy, int gx, const __grid_constant__ PosOffsets o) {
    const int n = gz * gy * gx;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int iz, iy, ix;
    grid_coords(i, gy, gx, iz, iy, ix);
    const float adx = apply_at(planes, dx_in, i, iz, iy, ix, gz, gy, gx, n, o);
    const float pn = invd[i] * (r[i] - adx) + coef[degree + step] * p[i];
    p[i] = pn;
    const float dxn = dx_in[i] + coef[step] * pn;
    out[i] = last ? x[i] - dxn : dxn;
}

template <typename T>
cudaError_t launch_cheb_smooth(const void* planes_v, const float* x,
                               const float* b, const float* invd,
                               const float* coef, int degree, float* r,
                               float* p, float* dx0, float* dx1, float* xs,
                               float* res, int gz, int gy, int gx,
                               const PosOffsets& o, cudaStream_t s) {
    const T* planes = static_cast<const T*>(planes_v);
    const int n = gz * gy * gx;
    float* dx[2] = {dx0, dx1};
    cheb_first_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
        planes, x, b, invd, coef, r, p, degree == 1 ? xs : dx[0],
        degree == 1, gz, gy, gx, o);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    for (int step = 1; step < degree; ++step) {
        const int last = step == degree - 1;
        cheb_step_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(
            planes, dx[(step - 1) % 2], r, p, invd, coef, step, degree, x,
            last ? xs : dx[step % 2], last, gz, gy, gx, o);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
    }
    if (res != nullptr)
        return launch_stencil_apply_sym<T>(planes_v, xs, b, res, gz, gy, gx, o, s);
    return cudaSuccess;
}

extern "C" {

// One Chebyshev step of the given degree (>= 1).  r, p, dx0, dx1 are
// n-float scratch buffers (dx1 unused for degree <= 2); xs receives x_s;
// res (may be null) receives A x_s - b.  Returns the first cudaError_t.
int mfmg_cheb_smooth(const void* planes, int planes_bf16, const float* x,
                     const float* b, const float* invd, const float* coef,
                     int degree, float* r, float* p, float* dx0, float* dx1,
                     float* xs, float* res, int gz, int gy, int gx, int n_pos,
                     const int* offs, void* stream) {
    if (n_pos < 0 || n_pos > MFMG_MAX_POS || degree < 1)
        return (int)cudaErrorInvalidValue;
    const PosOffsets o = make_offsets(n_pos, offs);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = planes_bf16
        ? launch_cheb_smooth<__nv_bfloat16>(planes, x, b, invd, coef, degree, r,
                                            p, dx0, dx1, xs, res, gz, gy, gx, o, s)
        : launch_cheb_smooth<float>(planes, x, b, invd, coef, degree, r, p,
                                    dx0, dx1, xs, res, gz, gy, gx, o, s);
    return (int)e;
}

}  // extern "C"
