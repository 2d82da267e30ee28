// K4/K5: the fine-level windowed restriction and its adjoint prolongation.
//
// Replace mfmg_tpu/ops/pallas_transfer.py pallas_restrict_tiled (:214) and
// pallas_prolong_tiled (:291): z-tiled TPU kernels that ran the per-axis
// 0/1 selection-matmul chain of the structured transfer in VMEM, one z-slab
// of windows per grid step, carrying the slab boundary's overlap-add in
// scratch from one step to the next.  They compute
//   restrict:  out[a, e] = sum_t W[e, t, a] x[a * s + t]
//   prolong:   y = R^T xc, the exact adjoint
// (index arithmetic in window_transfer.cuh, shared with the coarse tail).
//
// What bounds them on an H100: bytes.  At 129^3 with float32 weights one
// call moves x or y (8.6 MB), W (32.8 MB) and the coarse vector (0.26 MB),
// ~12.4 us at 3.35 TB/s, against 16 Mflop (~0.25 us at 67 TFLOP/s).
//
// Design, gather form, no atomics, every sum in a fixed order:
// * K4: a block of 32 x 8 threads takes 32 consecutive coarse outputs
//   (e, a), a fastest so that the weight reads coalesce; its 8 thread rows
//   split each window's rows r = tz * wy + ty, and thread row 0 adds the 8
//   partial sums in order.  This keeps 8 threads busy per output where the
//   outputs are few (Q2: 1,024 outputs of 729 terms each).
// * K5: one thread per fine point gathers the <= 8 windows that hold it.
// The selection matrices, the padded lane layout and the slab carry of the
// TPU kernels are not needed: the windows are addressed directly.
#include "window_transfer.cuh"

constexpr int kRestrictLanes = 32;     // coarse outputs per block
constexpr int kRestrictParts = 8;      // threads per output
constexpr int kProlongThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRestrictLanes * kRestrictParts)
structured_restrict_kernel(const T* __restrict__ W, const float* __restrict__ x,
                           float* __restrict__ out, const FineWindows g) {
    __shared__ float part[kRestrictParts][kRestrictLanes];
    const int n_sites = g.gz * g.gy * g.gx;
    const int n_out = g.c * n_sites;
    const int q = blockIdx.x * kRestrictLanes + threadIdx.x;   // (e, a), a fastest
    const int rows = g.wz * g.wy;
    const int per = (rows + kRestrictParts - 1) / kRestrictParts;
    const int r0 = min((int)threadIdx.y * per, rows), r1 = min(r0 + per, rows);
    const int e = q / n_sites, a = q - e * n_sites;
    part[threadIdx.y][threadIdx.x] =
        q < n_out ? window_restrict_rows(W, x, g, e, a, r0, r1) : 0.f;
    __syncthreads();
    if (threadIdx.y == 0 && q < n_out) {
        float s = 0.f;
        for (int p = 0; p < kRestrictParts; ++p) s += part[p][threadIdx.x];
        out[a * g.c + e] = s;
    }
}

template <typename T>
__global__ void __launch_bounds__(kProlongThreads)
structured_prolong_kernel(const T* __restrict__ W, const float* __restrict__ xc,
                          float* __restrict__ y, const FineWindows g) {
    const int n = g.nz * g.ny * g.nx;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = window_prolong_at(W, xc, g, i);
}

extern "C" {

// out (gz*gy*gx*c, site-major) = R x.  geom = {nz, ny, nx, gz, gy, gx, wz,
// wy, wx, c}; w_bf16 selects the weight type.  Returns the cudaError_t of
// the launch (0 on success).
int mfmg_structured_restrict(int w_bf16, const void* W, const float* x, float* out,
                             const int* geom, void* stream) {
    const FineWindows g = make_fine_windows(geom);
    if (int err = check_fine_windows(g)) return err;
    const int n_out = g.c * g.gz * g.gy * g.gx;
    const dim3 block(kRestrictLanes, kRestrictParts);
    const int blocks = (n_out + kRestrictLanes - 1) / kRestrictLanes;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (w_bf16)
        structured_restrict_kernel<__nv_bfloat16><<<blocks, block, 0, s>>>(
            static_cast<const __nv_bfloat16*>(W), x, out, g);
    else
        structured_restrict_kernel<float><<<blocks, block, 0, s>>>(
            static_cast<const float*>(W), x, out, g);
    return (int)cudaGetLastError();
}

// y (nz*ny*nx) = R^T xc.
int mfmg_structured_prolong(int w_bf16, const void* W, const float* xc, float* y,
                            const int* geom, void* stream) {
    const FineWindows g = make_fine_windows(geom);
    if (int err = check_fine_windows(g)) return err;
    const int n = g.nz * g.ny * g.nx;
    const int blocks = (n + kProlongThreads - 1) / kProlongThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (w_bf16)
        structured_prolong_kernel<__nv_bfloat16><<<blocks, kProlongThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(W), xc, y, g);
    else
        structured_prolong_kernel<float><<<blocks, kProlongThreads, 0, s>>>(
            static_cast<const float*>(W), xc, y, g);
    return (int)cudaGetLastError();
}

}  // extern "C"
