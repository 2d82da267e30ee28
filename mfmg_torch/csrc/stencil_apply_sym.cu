// K1: symmetric-pair variable-coefficient stencil apply, y = A x (- b).
//
// Replaces mfmg_tpu/ops/pallas_stencil.py pallas_stencil_apply_sym (the
// VMEM-resident TPU kernel that streamed the center + positive planes once
// through a double-buffered DMA and rolled x in VMEM).
//
// What bounds it on an H100: bytes.  Per grid point it does ~2 flops per
// stored plane and reads one coefficient per plane: at 65^3 with bf16
// planes that is 14 x 0.55 MB = 7.7 MB of planes plus 1.1 MB of x in and
// 1.1 MB of y out, against ~3 TB/s of HBM and a 50 MB L2.
//
// Design: one thread per grid point in the gather form.  Neighbouring
// threads read neighbouring addresses of every plane, so each plane streams
// coalesced; the backward term's read C_o[i - o] and the shifted reads of x
// hit lines that neighbouring warps have just brought into L1/L2, so DRAM
// traffic stays close to one pass over the planes.  The offset table is a
// __grid_constant__ parameter: uniform across the warp, read from the
// constant bank.  Coefficients are float or bf16 (converted in registers);
// accumulation is float.  Temporal blocking and shared-memory tiling are
// later work.
#include "stencil_common.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_apply_sym_kernel(const T* __restrict__ planes, const float* __restrict__ x,
                         const float* __restrict__ b, float* __restrict__ y,
                         int gz, int gy, int gx,
                         const __grid_constant__ PosOffsets o) {
    const int n = gz * gy * gx;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int iz, iy, ix;
    grid_coords(i, gy, gx, iz, iy, ix);
    float acc = apply_at(planes, x, i, iz, iy, ix, gz, gy, gx, n, o);
    if (b != nullptr) acc -= b[i];
    y[i] = acc;
}

template <typename T>
cudaError_t launch_stencil_apply_sym(const void* planes, const float* x,
                                     const float* b, float* y, int gz, int gy,
                                     int gx, const PosOffsets& o,
                                     cudaStream_t stream) {
    const int n = gz * gy * gx;
    stencil_apply_sym_kernel<T><<<n_blocks(n), kThreads, 0, stream>>>(
        static_cast<const T*>(planes), x, b, y, gz, gy, gx, o);
    return cudaGetLastError();
}

template cudaError_t launch_stencil_apply_sym<float>(
    const void*, const float*, const float*, float*, int, int, int,
    const PosOffsets&, cudaStream_t);
template cudaError_t launch_stencil_apply_sym<__nv_bfloat16>(
    const void*, const float*, const float*, float*, int, int, int,
    const PosOffsets&, cudaStream_t);

extern "C" {

// y = A x - b (b may be null).  planes_bf16 selects the coefficient type.
// Returns the cudaError_t of the launch (0 on success).
int mfmg_stencil_apply_sym(const void* planes, int planes_bf16, const float* x,
                           const float* b, float* y, int gz, int gy, int gx,
                           int n_pos, const int* offs, void* stream) {
    if (n_pos < 0 || n_pos > MFMG_MAX_POS) return (int)cudaErrorInvalidValue;
    const PosOffsets o = make_offsets(n_pos, offs);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = planes_bf16
        ? launch_stencil_apply_sym<__nv_bfloat16>(planes, x, b, y, gz, gy, gx, o, s)
        : launch_stencil_apply_sym<float>(planes, x, b, y, gz, gy, gx, o, s);
    return (int)e;
}

const char* mfmg_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
