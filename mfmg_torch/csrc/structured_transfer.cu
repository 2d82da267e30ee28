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
// * K5, owner computes: every fine point belongs to one agglomerate per axis
//   (local offset t in [0, s), the last node plane to the last agglomerate);
//   its value is its own window's term plus, on each axis where t == 0, the
//   t = s term of the lower neighbour's window.  A block owns one fine z
//   plane iz and a run of agglomerate rows ay (their fine rows ay * s + [0,
//   s), and the last row with the last ay), all of x.  Its threads run over
//   (fine row, window pair (tx, ax)) items, ax fastest, so each warp-load of
//   W is a contiguous run over ax; each item sums its <= 4 z/y windows over
//   e into shared memory, then the block adds the x overlap and writes whole
//   rows of y.  The block reads exactly the W entries of the points it owns,
//   so W is read once overall; no atomics and no search over windows.  Where
//   gx is a multiple of 4 (the main path) an item takes four ax, with one
//   16-byte load of W per window and component; elsewhere one ax.
//   (One thread per fine point, searching the <= 8 windows that hold it,
//   diverges inside a warp and scatters each warp-load of W over 4-5
//   32-byte pieces.)
// The selection matrices, the padded lane layout and the slab carry of the
// TPU kernels are not needed: the windows are addressed directly.
#include <cstdint>

#include "window_transfer.cuh"

constexpr int kRestrictLanes = 32;     // coarse outputs per block
constexpr int kRestrictParts = 8;      // threads per output
constexpr int kProlongThreads = 512;
constexpr int kProlongMaxSmem = 48 * 1024;

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

__device__ __forceinline__ float4 load_w4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One window's terms, summed over e, for V consecutive agglomerates a, ..,
// a + V - 1 (their weights at w, e-stride estride).  V = 4: one 16-byte (8
// for bf16) load of W per component and CC 16-byte loads of xc; V = 1: a
// scalar load of each over the c components.
template <typename T, int V, int CC>
__device__ __forceinline__ void add_window(const T* __restrict__ w, const float* __restrict__ xc,
                                           size_t a, size_t estride, int c, float (&acc)[V]) {
    if constexpr (V == 4) {
        const float4* xv = reinterpret_cast<const float4*>(xc + a * CC);
        float xa[4 * CC];                   // xc[(a + i) * CC + e] at i * CC + e
#pragma unroll
        for (int i = 0; i < CC; ++i) {
            const float4 t = __ldg(xv + i);
            xa[4 * i] = t.x;
            xa[4 * i + 1] = t.y;
            xa[4 * i + 2] = t.z;
            xa[4 * i + 3] = t.w;
        }
#pragma unroll
        for (int e = 0; e < CC; ++e) {
            const float4 wv = load_w4(w + e * estride);
            acc[0] += wv.x * xa[e];
            acc[1] += wv.y * xa[CC + e];
            acc[2] += wv.z * xa[2 * CC + e];
            acc[3] += wv.w * xa[3 * CC + e];
        }
    } else {
        for (int e = 0; e < c; ++e) acc[0] += wload(w, e * estride) * __ldg(xc + a * c + e);
    }
}

// K5.  A block owns fine plane iz and the agglomerate rows [ay0, ay0 + nay):
// fine rows ay0 * sy + [0, nrows), nrows = nay * sy (+1 on the last chunk).
// An item is (fine row, tx, V consecutive ax); it sums its <= 4 z/y windows
// into win[row][ax][tx], and the block reads each weight plane's rows (az,
// ay0 .. ay0 + nay) as one contiguous run.  V = 4 where gx is a multiple of
// 4 and c = CC in 1..4 (the main path: 129^3, Q2); V = 1, CC = 0 (c at run
// time) for any other geometry.
template <typename T, int V, int CC>
__global__ void __launch_bounds__(kProlongThreads)
structured_prolong_kernel(const T* __restrict__ W, const float* __restrict__ xc,
                          float* __restrict__ y, const FineWindows g, int ayc) {
    extern __shared__ float win[];          // [fine row][ax][tx]: window sums
    const int sz = g.wz - 1, sy = g.wy - 1, sx = g.wx - 1;
    const size_t n_sites = (size_t)g.gz * g.gy * g.gx;
    const size_t estride = (size_t)g.wz * g.wy * g.wx * n_sites;   // W's e stride
    const int ay0 = blockIdx.x * ayc, nay = min(ayc, g.gy - ay0), iz = blockIdx.y;
    const int az = min(iz / sz, g.gz - 1), tz = iz - az * sz;
    const int nzw = tz == 0 && az > 0 ? 2 : 1;      // own window, lower neighbour's
    const int nrows = nay * sy + (ay0 + nay == g.gy);
    const int gv = g.gx / V, pairs = g.wx * gv;
    for (int q = threadIdx.x; q < nrows * pairs; q += blockDim.x) {
        const int R = q / pairs, p = q - R * pairs;
        const int ayl = min(R / sy, nay - 1), ay = ay0 + ayl, r = R - ayl * sy;
        const int tx = p / gv, ax = V * (p - tx * gv);
        const int nyw = r == 0 && ay > 0 ? 2 : 1;
        float acc[V] = {};
#pragma unroll
        for (int k = 0; k < 4; ++k) {   // (own z, own y), (own, lower y), (lower z, ..)
            const int zw = k >> 1, yw = k & 1;
            if (zw < nzw && yw < nyw) {
                const size_t a = ((size_t)(az - zw) * g.gy + ay - yw) * g.gx + ax;
                const size_t tt = ((size_t)(zw ? sz : tz) * g.wy + (yw ? sy : r)) * g.wx + tx;
                add_window<T, V, CC>(W + tt * n_sites + a, xc, a, estride, g.c, acc);
            }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) win[(R * g.gx + ax + i) * g.wx + tx] = acc[i];
    }
    __syncthreads();
    // each fine column takes its own window and, at tx == 0, the lower
    // neighbour's tx = sx term; whole rows of y
    float* yz = y + ((size_t)iz * g.ny + ay0 * sy) * g.nx;
    for (int q = threadIdx.x; q < nrows * g.nx; q += blockDim.x) {
        const int R = q / g.nx, ix = q - R * g.nx;
        const int ax = min(ix / sx, g.gx - 1), tx = ix - ax * sx;
        const float* w = win + (size_t)R * g.gx * g.wx;
        float v = w[ax * g.wx + tx];
        if (tx == 0 && ax > 0) v += w[(ax - 1) * g.wx + sx];
        yz[q] = v;
    }
}

template <typename T>
void launch_prolong(const T* W, const float* xc, float* y, const FineWindows& g,
                    int n_sm, cudaStream_t s) {
    const bool vec = g.gx % 4 == 0 && g.c >= 1 && g.c <= 4 &&
                     reinterpret_cast<uintptr_t>(xc) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(W) % (4 * sizeof(T)) == 0;
    // agglomerate rows per block: at most as many as kProlongMaxSmem holds,
    // few enough for two blocks per SM, split evenly over a plane's blocks
    const int sy = g.wy - 1, row = g.gx * g.wx;     // floats of a fine row's sums
    const int fit = (kProlongMaxSmem / (int)sizeof(float) / row - 1) / sy;
    int chunks = (g.gy + fit - 1) / fit;
    const int want = (2 * n_sm + g.nz - 1) / g.nz;
    if (chunks < want) chunks = want < g.gy ? want : g.gy;
    const int ayc = (g.gy + chunks - 1) / chunks;
    chunks = (g.gy + ayc - 1) / ayc;
    const size_t smem = sizeof(float) * (ayc * sy + 1) * row;
    const dim3 grid(chunks, g.nz);
    const int t = kProlongThreads;
    switch (vec ? g.c : 0) {
    case 0: structured_prolong_kernel<T, 1, 0><<<grid, t, smem, s>>>(W, xc, y, g, ayc); break;
    case 1: structured_prolong_kernel<T, 4, 1><<<grid, t, smem, s>>>(W, xc, y, g, ayc); break;
    case 2: structured_prolong_kernel<T, 4, 2><<<grid, t, smem, s>>>(W, xc, y, g, ayc); break;
    case 3: structured_prolong_kernel<T, 4, 3><<<grid, t, smem, s>>>(W, xc, y, g, ayc); break;
    default: structured_prolong_kernel<T, 4, 4><<<grid, t, smem, s>>>(W, xc, y, g, ayc);
    }
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

// y (nz*ny*nx) = R^T xc; n_sm, the card's SM count, sizes the blocks.
int mfmg_structured_prolong(int w_bf16, const void* W, const float* xc, float* y,
                            const int* geom, int n_sm, void* stream) {
    const FineWindows g = make_fine_windows(geom);
    if (int err = check_fine_windows(g)) return err;
    // one agglomerate row's window sums (s + 1 fine rows) must fit
    if (sizeof(float) * g.wy * g.gx * g.wx > kProlongMaxSmem) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (w_bf16)
        launch_prolong(static_cast<const __nv_bfloat16*>(W), xc, y, g, n_sm, s);
    else
        launch_prolong(static_cast<const float*>(W), xc, y, g, n_sm, s);
    return (int)cudaGetLastError();
}

}  // extern "C"
