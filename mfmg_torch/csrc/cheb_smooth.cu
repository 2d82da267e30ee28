// K2: one whole deal.II Chebyshev smoothing step on the fine grid,
//     x_s = x - p(D^-1 A) D^-1 (A x - b),   and optionally  res = A x_s - b.
//
// Replaces mfmg_tpu/ops/pallas_stencil.py pallas_cheb_smooth, which loaded
// the center + positive coefficient planes into VMEM once and ran every
// polynomial term and the residual against them in one kernel.
//
// Two forms.  The chain, for any symmetric stencil: a short chain of fused
// launches, each a K1-style gather apply fused with its recurrence update
// (the card has no 7.7 MB of fast memory per SM, but its 50 MB L2 holds all
// 14 bf16 planes of a 65^3 grid between them).
//   launch 1:        r = A x - b; z = invd r; p = z; dx = a_0 z
//   launch s < deg:  p = invd (r - A dx) + b_s p; dx' = dx + a_s p
//                    (r stays the first residual; p is updated in place,
//                    which is safe because it is pointwise; dx is
//                    double-buffered because the apply reads neighbours)
//   the last launch writes x_s = x - dx instead of dx;
//   with a residual: one more launch (cheb_residual_kernel), res = A x_s - b.
// The recurrence coefficients [a_0..a_{deg-1}, b_0..b_{deg-1}] are a device
// array read at run time, never compile-time constants, so a new setup never
// needs a new build.
//
// The chain streams the planes from memory once per apply: at 129^3 the 14
// bf16 planes (60 MB) exceed the 50 MB L2, so a degree-2 step with the
// residual reads them three times, and the r/p/dx intermediates go through
// device memory.  The blocked form (below; the TPU's pallas_cheb_smooth_tiled
// idea, rebuilt for an SM) does the whole step in one launch; the wrapper
// (ops/stencil_kernels.py k2_form) sends the Q1 step with the residual at
// degree <= 3 on a grid of more than 2^20 points to it, where it measured
// faster (129^3), and everything else to the chain.
#include "stencil_common.cuh"

// The chain's residual, res = A x_s - b: one thread per point in the gather
// form (K1's first kernel; K1 itself is now the tiled csrc/stencil_apply.cu).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_residual_kernel(const T* __restrict__ planes, const float* __restrict__ x,
                     const float* __restrict__ b, float* __restrict__ y,
                     int gz, int gy, int gx, const __grid_constant__ StencilOffsets o) {
    const int n = gz * gy * gx;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int iz, iy, ix;
    grid_coords(i, gy, gx, iz, iy, ix);
    y[i] = apply_at(planes, x, i, iz, iy, ix, gz, gy, gx, n, o) - b[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_first_kernel(const T* __restrict__ planes, const float* __restrict__ x,
                  const float* __restrict__ b, const float* __restrict__ invd,
                  const float* __restrict__ coef, float* __restrict__ r,
                  float* __restrict__ p, float* __restrict__ out, int last,
                  int gz, int gy, int gx, const __grid_constant__ StencilOffsets o) {
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
                 int gz, int gy, int gx, const __grid_constant__ StencilOffsets o) {
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
                               const StencilOffsets& o, cudaStream_t s) {
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
    if (res == nullptr) return cudaSuccess;
    cheb_residual_kernel<T><<<n_blocks(n), kThreads, 0, s>>>(planes, xs, b, res,
                                                             gz, gy, gx, o);
    return cudaGetLastError();
}

// ------------------------------------------------------------ blocked form
//
// 2.5-D temporal blocking of the Q1 step (the 13 positive offsets of the
// 27-point stencil, in lexicographic order: compile-time constants here).  A
// block owns a (ty, tx) tile of the (y, x) plane and a chunk [z0, z1) of z,
// and marches along z.  With L = degree (+1 with the residual) recurrence
// levels, step s loads x at slice s over a frame (the tile and a halo of L
// points per side) into shared memory; then level k = 1..L computes slice
// s - k from level k-1's slices s-k-1 .. s-k+1 over the tile plus a margin
// of L - k, the margins shrinking one point per level as in the TPU kernel
// (pallas_stencil.py:375-473).  Shared memory holds rings of value slices:
// x (enough slices for the pointwise x of level degree), each later level's
// apply input (dx_0, .., x_s: 3 slices each) and r, p (degree slices each);
// r, p and the dx never go to device memory.  The planes, b and invd are
// read where they are used: a plane slice's first read brings it from DRAM,
// the block's other levels find it in L1/L2 one to L steps later (its
// working set, L + 1 slices of the frame, ~40-80 KB, stays resident), so
// DRAM sees each plane about once per tile.  The halo's redundant reads and
// the z chunks' warm-up slices are sized by the wrapper's plan
// (ops/stencil_kernels.py cheb_blocked_plan).
//
// Out-of-domain terms: the block zeroes its shared memory first and writes
// only in-domain frame points, and zeroes the slice above the grid's top in
// each value ring, so every out-of-domain value it reads is 0; the matching
// coefficient read stays inside the plane array (planes 1.. are read at
// most one slice below their start) and is finite, so the applies run
// without bounds checks (the chain checks each term).  A warp takes a whole
// row of the frame, its lanes the columns, so no warp access straddles two
// rows (a bank conflict at a 32-float row stride); the forward and backward
// terms are summed apart (the chain sums them alternately: the two differ
// by float rounding).  The Chebyshev coefficients stay runtime data.
//
// What bounds both forms on an H100: not DRAM but the loads of each point's
// apply (27 coefficients and 27 values), about five SM cycles per point and
// apply.  The blocked form spends its halo's redundant applies (1.39x at
// 129^3 with the residual, 1.17x without) to save the chain's launches and
// DRAM passes; PERF.md has the two side by side.  Keeping each level's value neighbourhoods in
// registers along z (9 loads in place of 27) is the next step.

constexpr int kBlockedThreads = 512;
constexpr int kFrameRows = kBlockedThreads / 32;   // a frame row per warp
constexpr int kQ1Pos = 13;
// component d (z, y, x) of positive offset j: (0,0,1), (0,1,-1), (0,1,0),
// (0,1,1), (1,-1,-1), .., (1,1,1)
__host__ __device__ constexpr int q1_off(int j, int d) {
    return d == 0 ? (j >= 4) : d == 1 ? (j == 0 ? 0 : j < 4 ? 1 : j < 7 ? -1 : j < 10 ? 0 : 1)
                             : (j == 0 ? 1 : j < 4 ? j - 2 : (j - 4) % 3 - 1);
}

__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// A v at frame point f (global index gi) of slice z: v0/vm/vp the value
// slices z, z - 1, z + 1 in shared memory, the planes in device memory.
template <typename T>
__device__ __forceinline__ float apply_q1(const T* __restrict__ planes, size_t n,
                                          const float* v0, const float* vm,
                                          const float* vp, int f, size_t gi, int fx,
                                          int gx, size_t slice) {
    float fwd = ldg_f(planes + gi) * v0[f], bwd = 0.f;
#pragma unroll
    for (int j = 0; j < kQ1Pos; ++j) {
        const int dz = q1_off(j, 0), dy = q1_off(j, 1), dx = q1_off(j, 2);
        const int fo = dy * fx + dx;
        const ptrdiff_t go = dz * (ptrdiff_t)slice + dy * gx + dx;
        const T* c = planes + (size_t)(j + 1) * n + gi;
        fwd += ldg_f(c) * (dz ? vp : v0)[f + fo];
        bwd += ldg_f(c - go) * (dz ? vm : v0)[f - fo];
    }
    return fwd + bwd;
}

// Float slots of the value rings per frame point: x, the L - 1 later apply
// inputs, r and p.  At most 16 x 32 x 19 floats, under the 48 KB a block
// gets without opting in.
__host__ __device__ constexpr int blocked_value_slots(int degree, int want_res) {
    return (degree > 2 ? 4 : 3) + 3 * (degree + want_res - 1) + (degree > 1 ? 2 * degree : 0);
}

template <typename T, int DEG, bool RES>
__global__ void __launch_bounds__(kBlockedThreads, 2)
cheb_blocked_kernel(const T* __restrict__ planes, const float* __restrict__ x,
                    const float* __restrict__ b, const float* __restrict__ invd,
                    const float* __restrict__ coef, float* __restrict__ xs_out,
                    float* __restrict__ res_out, int gz, int gy, int gx, int ty,
                    int tx, int cz) {
    constexpr int L = DEG + (RES ? 1 : 0);
    constexpr int NX = DEG > 2 ? 4 : 3;             // x ring depth
    constexpr int NRP = DEG > 1 ? DEG : 0;          // r and p ring depth
    constexpr int NRPM = NRP > 0 ? NRP : 1;
    const int fx = tx + 2 * L, A = fx * (ty + 2 * L);
    const size_t n = (size_t)gz * gy * gx, slice = (size_t)gy * gx;
    extern __shared__ __align__(16) unsigned char smem[];
    float* vals = reinterpret_cast<float*>(smem);
    const int tid = threadIdx.x;
    for (int i = tid; i < blocked_value_slots(DEG, RES) * A; i += kBlockedThreads)
        vals[i] = 0.f;

    const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty, z0 = blockIdx.z * cz;
    const int txn = min(tx, gx - x0), tyn = min(ty, gy - y0), z1 = min(z0 + cz, gz);
    const int y_lo = y0 - L, x_lo = x0 - L;          // global (y, x) of frame (0, 0)
    // a warp takes frame row `warp`, its lanes the columns; this thread's
    // point of the frame, loaded if in the domain
    const int warp = tid / 32, lane = tid % 32;
    const int yl = y_lo + warp, xl = x_lo + lane;
    const bool load = yl >= 0 && yl < min(gy, y0 + tyn + L) && xl >= 0 &&
                      xl < min(gx, x0 + txn + L);
    const int fl = warp * fx + lane;
    float al[DEG], be[DEG];
#pragma unroll
    for (int i = 0; i < DEG; ++i) {
        al[i] = coef[i];
        be[i] = coef[DEG + i];
    }
    // ring slots; z >= -1 everywhere (12 is a multiple of every depth)
    auto V = [&](int k, int z) {
        return vals + (size_t)(k == 0 ? (z + 12) % NX : NX + 3 * (k - 1) + (z + 12) % 3) * A;
    };
    auto Rr = [&](int z) { return vals + (size_t)(NX + 3 * (L - 1) + z % NRPM) * A; };
    auto Pp = [&](int z) { return vals + (size_t)(NX + 3 * (L - 1) + NRP + z % NRPM) * A; };
    __syncthreads();

    for (int s = z0 - L; s < z1 + L; ++s) {
        if (s >= 0 && s < gz) {
            if (load) V(0, s)[fl] = __ldg(x + s * slice + (size_t)yl * gx + xl);
        } else if (s == gz) {               // the slice above the top reads as 0
            float* xd = V(0, s);
            for (int i = tid; i < A; i += kBlockedThreads) xd[i] = 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 1; k <= L; ++k) {
            const int z = s - k, m = L - k;
            const int kc = k <= DEG ? k - 1 : DEG - 1;  // recurrence index
            if (z >= max(0, z0 - m) && z < min(gz, z1 + m)) {
                // level k's region: the tile and a margin of m, in the domain
                const int ry0 = max(0, y0 - m), rx0 = max(0, x0 - m);
                const int Ry = min(gy, y0 + tyn + m) - ry0;
                const int Rx = min(gx, x0 + txn + m) - rx0;
                if (warp < Ry && lane < Rx) {
                    const int yy = ry0 + warp, xx = rx0 + lane;
                    const int f = (yy - y_lo) * fx + (xx - x_lo);
                    const size_t gi = z * slice + (size_t)yy * gx + xx;
                    const bool interior = z >= z0 && z < z1 && yy >= y0 &&
                                          yy < y0 + tyn && xx >= x0 && xx < x0 + txn;
                    const float bv = k == 1 || (RES && k == L) ? __ldg(b + gi) : 0.f;
                    const float iv = k <= DEG ? __ldg(invd + gi) : 0.f;
                    const float av = apply_q1(planes, n, V(k - 1, z), V(k - 1, z - 1),
                                              V(k - 1, z + 1), f, gi, fx, gx, slice);
                    if (RES && k == L) {
                        if (interior) res_out[gi] = av - bv;
                    } else {
                        float xsv = 0.f;
                        bool done = true;       // x_s reached at this level
                        if (k == 1) {
                            const float ri = av - bv, zz = iv * ri;
                            if (DEG > 1) {
                                Rr(z)[f] = ri;
                                Pp(z)[f] = zz;
                                V(1, z)[f] = al[0] * zz;
                                done = false;
                            } else {
                                xsv = V(0, z)[f] - al[0] * zz;
                            }
                        } else {
                            const float pn = iv * (Rr(z)[f] - av) + be[kc] * Pp(z)[f];
                            const float dxn = V(k - 1, z)[f] + al[kc] * pn;
                            if (k < DEG) {
                                Pp(z)[f] = pn;
                                V(k, z)[f] = dxn;
                                done = false;
                            } else {
                                xsv = V(0, z)[f] - dxn;
                            }
                        }
                        if (done) {
                            if (RES) V(DEG, z)[f] = xsv;
                            if (interior) xs_out[gi] = xsv;
                        }
                    }
                }
            } else if (k < L && z == gz) {  // the slice above the top reads as 0
                float* vd = V(k, z);
                for (int i = tid; i < A; i += kBlockedThreads) vd[i] = 0.f;
            }
            __syncthreads();
        }
    }
}

template <typename T, int DEG, bool RES>
cudaError_t launch_blocked(const void* planes, const float* x, const float* b,
                           const float* invd, const float* coef, float* xs, float* res,
                           int gz, int gy, int gx, int ty, int tx, int cz,
                           cudaStream_t s) {
    const size_t smem = sizeof(float) * blocked_value_slots(DEG, RES) * (ty + 2 * (DEG + RES))
                        * (tx + 2 * (DEG + RES));
    const dim3 grid((gx + tx - 1) / tx, (gy + ty - 1) / ty, (gz + cz - 1) / cz);
    cheb_blocked_kernel<T, DEG, RES><<<grid, kBlockedThreads, smem, s>>>(
        static_cast<const T*>(planes), x, b, invd, coef, xs, res, gz, gy, gx, ty, tx,
        cz);
    return cudaGetLastError();
}

template <typename T, bool RES>
cudaError_t launch_blocked_deg(int degree, const void* planes, const float* x,
                               const float* b, const float* invd, const float* coef,
                               float* xs, float* res, int gz, int gy, int gx, int ty,
                               int tx, int cz, cudaStream_t s) {
    switch (degree) {
    case 1: return launch_blocked<T, 1, RES>(planes, x, b, invd, coef, xs, res, gz, gy, gx, ty, tx, cz, s);
    case 2: return launch_blocked<T, 2, RES>(planes, x, b, invd, coef, xs, res, gz, gy, gx, ty, tx, cz, s);
    case 3: return launch_blocked<T, 3, RES>(planes, x, b, invd, coef, xs, res, gz, gy, gx, ty, tx, cz, s);
    default: return cudaErrorInvalidValue;
    }
}

extern "C" {

// The blocked form: one launch for the whole step, degree 1..3, the 13
// positive Q1 offsets in lexicographic order (offs is checked against
// them); (ty, tx, cz) the tile and z chunk of the wrapper's plan.  res may be
// null.  Returns the first cudaError_t.
int mfmg_cheb_smooth_blocked(const void* planes, int planes_bf16, const float* x,
                             const float* b, const float* invd, const float* coef,
                             int degree, float* xs, float* res, int gz, int gy, int gx,
                             int n_pos, const int* offs, int ty, int tx, int cz,
                             void* stream) {
    const int L = degree + (res != nullptr);
    if (n_pos != kQ1Pos || degree < 1 || degree > 3 || ty < 1 || tx < 1 || cz < 1 ||
        ty + 2 * L > kFrameRows || tx + 2 * L > 32)
        return (int)cudaErrorInvalidValue;
    for (int j = 0; j < kQ1Pos; ++j)
        for (int d = 0; d < 3; ++d)
            if (offs[3 * j + d] != q1_off(j, d)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (planes_bf16)
        e = res ? launch_blocked_deg<__nv_bfloat16, true>(degree, planes, x, b, invd, coef, xs, res, gz, gy, gx, ty, tx, cz, s)
                : launch_blocked_deg<__nv_bfloat16, false>(degree, planes, x, b, invd, coef, xs, res, gz, gy, gx, ty, tx, cz, s);
    else
        e = res ? launch_blocked_deg<float, true>(degree, planes, x, b, invd, coef, xs, res, gz, gy, gx, ty, tx, cz, s)
                : launch_blocked_deg<float, false>(degree, planes, x, b, invd, coef, xs, res, gz, gy, gx, ty, tx, cz, s);
    return (int)e;
}

// One Chebyshev step of the given degree (>= 1).  r, p, dx0, dx1 are
// n-float scratch buffers (dx1 unused for degree <= 2); xs receives x_s;
// res (may be null) receives A x_s - b.  Returns the first cudaError_t.
int mfmg_cheb_smooth(const void* planes, int planes_bf16, const float* x,
                     const float* b, const float* invd, const float* coef,
                     int degree, float* r, float* p, float* dx0, float* dx1,
                     float* xs, float* res, int gz, int gy, int gx, int n_pos,
                     const int* offs, void* stream) {
    StencilOffsets o;
    if (!make_offsets(n_pos, offs, MFMG_MAX_POS, o) || degree < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = planes_bf16
        ? launch_cheb_smooth<__nv_bfloat16>(planes, x, b, invd, coef, degree, r,
                                            p, dx0, dx1, xs, res, gz, gy, gx, o, s)
        : launch_cheb_smooth<float>(planes, x, b, invd, coef, degree, r, p,
                                    dx0, dx1, xs, res, gz, gy, gx, o, s);
    return (int)e;
}

}  // extern "C"
