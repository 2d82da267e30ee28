// The coarse tail of a 3-level hierarchy in one kernel launch.
//
// Replaces mfmg_tpu/ops/fused_cycle.py fused_correction_apply (:402, full
// mode: x - P . subcycle(R . res)) and fused_subcycle_apply (:376, sub-cycle
// mode: subcycle(b1)).  Both TPU kernels held every operand in VMEM and ran
// _subcycle_math (:289): the level-1 Chebyshev pre-smooth from zero, the
// residual, the level-1 -> 2 correction with the coarse pseudoinverse
// (dense Rd, or the windowed transfer when Rd is too large), and the
// post-smooth, wrapped in the fine restriction and prolongation in full
// mode.
//
// What bounds it on an H100: neither bytes nor operations but latency.  The
// operands are small (65^3 full tail with bf16 weights: fine W 2.05 MB,
// level-1 coefficients 0.88 MB, Rd 4.2 MB, inv2 0.26 MB, vectors 3.3 MB, so
// ~3.2 us at 3.35 TB/s; 129^3 sub-cycle: 7.1 + 1.8 + 16.8 + 0.8 MB, ~7.9 us),
// while the tail is a chain of ~10 dependent steps whose every step reads
// neighbours written by the step before.
//
// Design: one persistent cooperative kernel (cudaLaunchCooperativeKernel,
// grid = SMs x min(occupancy, kTailBlocksPerSM)), its phases separated by
// cooperative_groups grid syncs, so the whole tail is one launch.  Every
// phase is a grid-stride loop in gather form: each output is summed by one
// thread, or by one block with a fixed-order tree, so results are
// deterministic and no atomics are used.  Level-1 vectors are site-major,
// v[s * c + e], as at the port's public functions; the reference's
// (c, gx, gz*gy) plane layout and 0/1 selection matrices existed for Mosaic
// and are not used.  Out-of-grid stencil and window terms are skipped by
// explicit bounds checks (the TPU kernel let roll wrap-around land on zero
// coefficients).  Weights are float or bf16 (converted in registers), every
// sum is float.  With bf16 weights in the windowed level-1 -> 2 form the
// correction rounds four vectors to bf16 (round to nearest even), where the
// reference's reduced tail rounds them (fused_cycle.py:256, 268, 272, 285):
// r1, b2, x2, and the prolonged values summed over the z and y windows
// before the x windows are added.  The dense form and the fine transfer
// round nothing, as in the reference.  The phases at degree d and nss
// smoothing steps:
//   (full) restrict b1 = R res, fused with the first pointwise Chebyshev step
//   d-1 applies of the pre-smooth x1 = cheb(b1)
//   (nss-1) x d applies of further smooths
//   r1 = A x1 - b1
//   b2 = R2 r1 (one block per coarse row)
//   x2 = inv2 b2 (one block per coarse row)
//   x1 -= R2^T x2
//   nss x d applies of the post-smooth
//   (full) out = x - P x1
// At d = 2 and nss = 1: 8 grid syncs in full mode, 7 in sub-cycle mode.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_transfer.cuh"

namespace cg = cooperative_groups;

// A radius-1 3-D block stencil has at most 27 offsets.
#define MFMG_TAIL_MAX_OFF 27

constexpr int kTailThreads = 256;
constexpr int kTailBlocksPerSM = 2;     // fewer blocks, cheaper grid syncs
constexpr int kColTile = 32;            // columns per block in the dense R2^T

struct TailParams {
    // level-1 block stencil y[s,e] = sum_o sum_f C[o,s,e,f] x[s+o,f]
    const void* coeffs;          // (n_off, n_sites, c, c)
    const float* invd;           // (n1,)
    const float* coef;           // (2 * degree,) [alphas..., betas...]
    int gz, gy, gx, c, n_sites, n1, n_off, degree, nss;
    int odz[MFMG_TAIL_MAX_OFF], ody[MFMG_TAIL_MAX_OFF], odx[MFMG_TAIL_MAX_OFF];
    // level 1 -> 2: dense Rd or the windowed weights W2; round_vec: round
    // r1, b2, x2 and the z/y-summed prolonged values to bf16 (windowed form
    // with bf16 weights)
    int dense, round_vec;
    const void* Rd;              // (n2, n1)
    const void* W2;              // (n_S, n2e, wz2, wy2, wx2, c)
    const float* inv2;           // (n2, n2)
    int n2, n2e, oz, oy, ox, wz2, wy2, wx2, sz2, sy2, sx2, tz0, ty0, tx0;
    // fine transfer (full mode): windows of fw per axis at stride fw - 1
    int full;
    const void* W;               // (c, fwz, fwy, fwx, gz, gy, gx)
    FineWindows fw;
    // vectors
    const float* b1_in;          // sub-cycle input (n1)
    const float* x_in;           // full-mode x and residual (fine n)
    const float* res;
    float* out;                  // sub-cycle: x1 (n1); full: fine n
    // scratch (n1 each, b2 and x2 n2 each)
    float* B;
    float* R;
    float* P;
    float* X[2];
    float* D[2];
    float* b2;
    float* x2;
};

__device__ __forceinline__ float bf16_rn(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// Sum over the block, in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* smem) {
    v = warp_sum(v);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (lane == 0) smem[w] = v;
    __syncthreads();
    float t = 0.f;
    if (w == 0) t = warp_sum(lane < (int)(blockDim.x >> 5) ? smem[lane] : 0.f);
    __syncthreads();
    return t;
}

// (A v)[j] of the level-1 block stencil, j = s * c + e.
template <typename T>
__device__ float block_apply(const TailParams& p, const float* v, int j) {
    const T* C = static_cast<const T*>(p.coeffs);
    const int c = p.c;
    const int s = j / c, e = j - s * c;
    const int ax = s % p.gx, t = s / p.gx, ay = t % p.gy, az = t / p.gy;
    float acc = 0.f;
    for (int o = 0; o < p.n_off; ++o) {
        const int bz = az + p.odz[o], by = ay + p.ody[o], bx = ax + p.odx[o];
        if (bz < 0 || bz >= p.gz || by < 0 || by >= p.gy || bx < 0 || bx >= p.gx)
            continue;
        const size_t row = (((size_t)o * p.n_sites + s) * c + e) * c;
        const float* vv = v + (size_t)((bz * p.gy + by) * p.gx + bx) * c;
        for (int f = 0; f < c; ++f) acc += wload(C, row + f) * vv[f];
    }
    return acc;
}

// First pointwise step of cheb_vmult(src) at j, src value s_j:
// z = invd s; p = z; d = a_0 z.  With degree 1 the polynomial ends here and
// writes the result (x_sub - d, or d when x_sub is null) to x_out.
__device__ __forceinline__ void cheb_first(const TailParams& p, int j, float s_j,
                                           const float* x_sub, float* x_out) {
    const float z = __ldg(p.invd + j) * s_j;
    p.P[j] = z;
    const float d = __ldg(p.coef) * z;
    if (p.degree == 1)
        x_out[j] = x_sub ? x_sub[j] - d : d;
    else
        p.D[0][j] = d;
}

// Step i >= 1 of cheb_vmult(src): z = invd (src - A d); p = z + b_i p;
// d += a_i p.  Reads neighbours of D[(i-1)&1]; the last step writes the
// result to x_out.
template <typename T>
__device__ void cheb_step_phase(const TailParams& p, int i, const float* src,
                                const float* x_sub, float* x_out) {
    const float* d_in = p.D[(i - 1) & 1];
    float* d_out = p.D[i & 1];
    const float a = __ldg(p.coef + i), b = __ldg(p.coef + p.degree + i);
    const bool last = i == p.degree - 1;
    const int stride = gridDim.x * blockDim.x;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < p.n1; j += stride) {
        const float z = __ldg(p.invd + j) * (src[j] - block_apply<T>(p, d_in, j));
        const float pn = z + b * p.P[j];
        p.P[j] = pn;
        const float dn = d_in[j] + a * pn;
        if (last)
            x_out[j] = x_sub ? x_sub[j] - dn : dn;
        else
            d_out[j] = dn;
    }
}

// x_out = smooth(x_in) = x_in - cheb(A x_in - b1); x_out != x_in.
template <typename T>
__device__ void smooth(const TailParams& p, cg::grid_group& grid,
                       const float* b1, const float* x_in, float* x_out) {
    const int stride = gridDim.x * blockDim.x;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < p.n1; j += stride) {
        const float r = block_apply<T>(p, x_in, j) - b1[j];
        p.R[j] = r;
        cheb_first(p, j, r, x_in, x_out);
    }
    for (int i = 1; i < p.degree; ++i) {
        grid.sync();
        cheb_step_phase<T>(p, i, p.R, x_in, x_out);
    }
}

// b1[a, e] = sum_t W[e, t, a] res[a * s + t] into B, then the first
// pointwise Chebyshev step; one thread per (e, a), a fastest so that the
// weight reads coalesce.
template <typename T>
__device__ void restrict_fine(const TailParams& p, float* x_out) {
    const T* W = static_cast<const T*>(p.W);
    const int rows = p.fw.wz * p.fw.wy;
    const int n_out = p.c * p.n_sites;
    const int stride = gridDim.x * blockDim.x;
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < n_out; q += stride) {
        const int e = q / p.n_sites, a = q - e * p.n_sites;
        const float acc = window_restrict_rows(W, p.res, p.fw, e, a, 0, rows);
        const int j = a * p.c + e;
        p.B[j] = acc;
        cheb_first(p, j, acc, nullptr, x_out);
    }
}

// out[i] = x[i] - (P x1)[i].
template <typename T>
__device__ void prolong_fine(const TailParams& p, const float* x1) {
    const T* W = static_cast<const T*>(p.W);
    const int n = p.fw.nz * p.fw.ny * p.fw.nx;
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
        p.out[i] = __ldg(p.x_in + i) - window_prolong_at(W, x1, p.fw, i);
}

// b2 = R2 r1: one block per coarse row k = S * n2e + e2.
template <typename T>
__device__ void restrict_coarse(const TailParams& p, float* smem) {
    for (int k = blockIdx.x; k < p.n2; k += gridDim.x) {
        float acc = 0.f;
        if (p.dense) {
            const T* Rd = static_cast<const T*>(p.Rd);
            const size_t row = (size_t)k * p.n1;
            for (int j = threadIdx.x; j < p.n1; j += blockDim.x)
                acc += wload(Rd, row + j) * p.R[j];
        } else {
            // the window of super-site S: sites S * stride + t0 + t, all
            // components f; W2 holds them contiguously as [k][t][f]
            const T* W2 = static_cast<const T*>(p.W2);
            const int S = k / p.n2e;
            const int sx = S % p.ox, u = S / p.ox, sy = u % p.oy, sz = u / p.oy;
            const int wc = p.wz2 * p.wy2 * p.wx2 * p.c;
            for (int q = threadIdx.x; q < wc; q += blockDim.x) {
                const int f = q % p.c, t = q / p.c;
                const int tx = t % p.wx2, v = t / p.wx2, ty = v % p.wy2, tz = v / p.wy2;
                const int bz = sz * p.sz2 + p.tz0 + tz, by = sy * p.sy2 + p.ty0 + ty,
                          bx = sx * p.sx2 + p.tx0 + tx;
                if (bz < 0 || bz >= p.gz || by < 0 || by >= p.gy || bx < 0 || bx >= p.gx)
                    continue;
                acc += wload(W2, (size_t)k * wc + q)
                     * p.R[((bz * p.gy + by) * p.gx + bx) * p.c + f];
            }
        }
        acc = block_sum(acc, smem);
        if (threadIdx.x == 0) p.b2[k] = p.round_vec ? bf16_rn(acc) : acc;
    }
}

// x2 = inv2 b2: one block per row.
__device__ void coarse_solve(const TailParams& p, float* smem) {
    for (int k = blockIdx.x; k < p.n2; k += gridDim.x) {
        float acc = 0.f;
        const float* row = p.inv2 + (size_t)k * p.n2;
        for (int j = threadIdx.x; j < p.n2; j += blockDim.x) acc += __ldg(row + j) * p.b2[j];
        acc = block_sum(acc, smem);
        if (threadIdx.x == 0) p.x2[k] = p.round_vec ? bf16_rn(acc) : acc;
    }
}

// x1 -= R2^T x2.
template <typename T>
__device__ void prolong_coarse(const TailParams& p, float* x1, float* smem) {
    if (p.dense) {
        // a block takes kColTile columns; its warps split the rows k and
        // sum their partials in a fixed order
        const T* Rd = static_cast<const T*>(p.Rd);
        const int lane = threadIdx.x % kColTile, w = threadIdx.x / kColTile;
        const int n_w = blockDim.x / kColTile;
        const int n_tiles = (p.n1 + kColTile - 1) / kColTile;
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
            const int j = tile * kColTile + lane;
            float acc = 0.f;
            if (j < p.n1)
                for (int k = w; k < p.n2; k += n_w)
                    acc += wload(Rd, (size_t)k * p.n1 + j) * p.x2[k];
            smem[threadIdx.x] = acc;
            __syncthreads();
            if (w == 0 && j < p.n1) {
                float s = 0.f;
                for (int q = 0; q < n_w; ++q) s += smem[q * kColTile + lane];
                x1[j] -= s;
            }
            __syncthreads();
        }
        return;
    }
    // windowed: site b, component f gathers the <= 2 super-sites per axis
    // whose windows [S * stride + t0, S * stride + t0 + w) hold it
    const T* W2 = static_cast<const T*>(p.W2);
    const int w3 = p.wz2 * p.wy2 * p.wx2;
    const int stride = gridDim.x * blockDim.x;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < p.n1; j += stride) {
        const int f = j % p.c, b = j / p.c;
        const int bx = b % p.gx, u = b / p.gx, by = u % p.gy, bz = u / p.gy;
        float acc = 0.f;
        const int z0 = max(floor_div(bz - p.tz0 - p.wz2 + p.sz2, p.sz2), 0);
        const int z1 = min(floor_div(bz - p.tz0, p.sz2), p.oz - 1);
        const int y0 = max(floor_div(by - p.ty0 - p.wy2 + p.sy2, p.sy2), 0);
        const int y1 = min(floor_div(by - p.ty0, p.sy2), p.oy - 1);
        const int x0 = max(floor_div(bx - p.tx0 - p.wx2 + p.sx2, p.sx2), 0);
        const int x1_ = min(floor_div(bx - p.tx0, p.sx2), p.ox - 1);
        // x windows outermost: each one's sum over the z and y windows is
        // the value the reference rounds before adding the x windows
        for (int sx = x0; sx <= x1_; ++sx) {
            const int tx = bx - sx * p.sx2 - p.tx0;
            if (tx < 0 || tx >= p.wx2) continue;
            float zy = 0.f;
            for (int sz = z0; sz <= z1; ++sz) {
                const int tz = bz - sz * p.sz2 - p.tz0;
                if (tz < 0 || tz >= p.wz2) continue;
                for (int sy = y0; sy <= y1; ++sy) {
                    const int ty = by - sy * p.sy2 - p.ty0;
                    if (ty < 0 || ty >= p.wy2) continue;
                    const int S = (sz * p.oy + sy) * p.ox + sx;
                    const int t = (tz * p.wy2 + ty) * p.wx2 + tx;
                    for (int e2 = 0; e2 < p.n2e; ++e2) {
                        const int k = S * p.n2e + e2;
                        zy += wload(W2, ((size_t)k * w3 + t) * p.c + f) * p.x2[k];
                    }
                }
            }
            acc += p.round_vec ? bf16_rn(zy) : zy;
        }
        x1[j] -= acc;
    }
}

template <typename T>
__global__ void __launch_bounds__(kTailThreads, kTailBlocksPerSM)
fused_tail_kernel(const __grid_constant__ TailParams p) {
    __shared__ float smem[kTailThreads];
    cg::grid_group grid = cg::this_grid();
    const int stride = gridDim.x * blockDim.x;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const float* b1 = p.full ? p.B : p.b1_in;
    float* xc = p.X[0];
    float* xn = p.X[1];

    // pre-smooth x1 = cheb(b1), from zero
    if (p.full) {
        restrict_fine<T>(p, xc);
    } else {
        for (int j = tid; j < p.n1; j += stride) cheb_first(p, j, __ldg(p.b1_in + j), nullptr, xc);
    }
    for (int i = 1; i < p.degree; ++i) {
        grid.sync();
        cheb_step_phase<T>(p, i, b1, nullptr, xc);
    }
    for (int k = 0; k + 1 < p.nss; ++k) {
        grid.sync();
        smooth<T>(p, grid, b1, xc, xn);
        float* t = xc; xc = xn; xn = t;
    }

    // coarse correction
    grid.sync();
    for (int j = tid; j < p.n1; j += stride) {
        const float r = block_apply<T>(p, xc, j) - b1[j];
        p.R[j] = p.round_vec ? bf16_rn(r) : r;
    }
    grid.sync();
    restrict_coarse<T>(p, smem);
    grid.sync();
    coarse_solve(p, smem);
    grid.sync();
    prolong_coarse<T>(p, xc, smem);

    // post-smooth; in sub-cycle mode the last smooth writes the output
    for (int k = 0; k < p.nss; ++k) {
        float* target = (!p.full && k == p.nss - 1) ? p.out : xn;
        grid.sync();
        smooth<T>(p, grid, b1, xc, target);
        xn = xc;
        xc = target;
    }

    if (p.full) {
        grid.sync();
        prolong_fine<T>(p, xc);
    }
}

template <typename T>
cudaError_t launch_fused_tail(const TailParams& p, cudaStream_t s) {
    static int blocks = 0;
    if (blocks == 0) {
        int dev = 0, sms = 0, coop = 0, per_sm = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, fused_tail_kernel<T>, kTailThreads, 0);
        if (e != cudaSuccess) return e;
        if (!coop) return cudaErrorNotSupported;
        if (per_sm < 1) return cudaErrorLaunchOutOfResources;
        blocks = sms * (per_sm < kTailBlocksPerSM ? per_sm : kTailBlocksPerSM);
    }
    void* args[] = {const_cast<TailParams*>(&p)};
    return cudaLaunchCooperativeKernel((const void*)fused_tail_kernel<T>, dim3(blocks),
                                       dim3(kTailThreads), args, 0, s);
}

extern "C" {

// One coarse tail.  full: 1 = x - P subcycle(R res) into out (fine n),
// 0 = subcycle(b1) into out (n1).  dense: 1 = Rd, 0 = windowed W2.
//   l1   = {gz, gy, gx, c, n_off, degree, nss}, offs = n_off (dz, dy, dx)
//   l2   = {n2, n2e, oz, oy, ox, wz, wy, wx, sz, sy, sx, tz0, ty0, tx0}
//   fine = {nz, ny, nx, wz, wy, wx}
// scratch holds 7 * n1 + 2 * n2 floats.  Null pointers for the operands the
// mode and form do not use.  Returns the first cudaError_t (0 on success).
int mfmg_fused_tail(int weights_bf16, int full, int dense, const void* coeffs,
                    const float* invd, const float* coef, const void* Rd,
                    const void* W2, const float* inv2, const void* W,
                    const float* b1_in, const float* x_in, const float* res,
                    float* out, float* scratch, const int* l1, const int* offs,
                    const int* l2, const int* fine, void* stream) {
    TailParams p = {};
    p.gz = l1[0]; p.gy = l1[1]; p.gx = l1[2]; p.c = l1[3];
    p.n_off = l1[4]; p.degree = l1[5]; p.nss = l1[6];
    if (p.n_off < 1 || p.n_off > MFMG_TAIL_MAX_OFF || p.degree < 1 || p.nss < 1
        || p.c < 1)
        return (int)cudaErrorInvalidValue;
    p.n_sites = p.gz * p.gy * p.gx;
    p.n1 = p.n_sites * p.c;
    for (int o = 0; o < p.n_off; ++o) {
        p.odz[o] = offs[3 * o];
        p.ody[o] = offs[3 * o + 1];
        p.odx[o] = offs[3 * o + 2];
    }
    p.coeffs = coeffs; p.invd = invd; p.coef = coef;
    p.dense = dense; p.Rd = Rd; p.W2 = W2; p.inv2 = inv2;
    p.round_vec = weights_bf16 && !dense;
    p.n2 = l2[0]; p.n2e = l2[1]; p.oz = l2[2]; p.oy = l2[3]; p.ox = l2[4];
    p.wz2 = l2[5]; p.wy2 = l2[6]; p.wx2 = l2[7];
    p.sz2 = l2[8]; p.sy2 = l2[9]; p.sx2 = l2[10];
    p.tz0 = l2[11]; p.ty0 = l2[12]; p.tx0 = l2[13];
    if (p.n2 < 1 || (!dense && (p.sz2 < 1 || p.sy2 < 1 || p.sx2 < 1)))
        return (int)cudaErrorInvalidValue;
    p.full = full; p.W = W;
    const int fg[10] = {fine[0], fine[1], fine[2], p.gz, p.gy, p.gx,
                        fine[3], fine[4], fine[5], p.c};
    p.fw = make_fine_windows(fg);
    if (full)
        if (int err = check_fine_windows(p.fw)) return err;
    p.b1_in = b1_in; p.x_in = x_in; p.res = res; p.out = out;
    float* s = scratch;
    p.B = s; s += p.n1;
    p.R = s; s += p.n1;
    p.P = s; s += p.n1;
    p.X[0] = s; s += p.n1;
    p.X[1] = s; s += p.n1;
    p.D[0] = s; s += p.n1;
    p.D[1] = s; s += p.n1;
    p.b2 = s; s += p.n2;
    p.x2 = s;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = weights_bf16 ? launch_fused_tail<__nv_bfloat16>(p, st)
                                 : launch_fused_tail<float>(p, st);
    return (int)e;
}

}  // extern "C"
