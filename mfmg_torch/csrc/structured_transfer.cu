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
// * K4, owner computes, the mirror of K5: a block owns the windows of a run
//   of agglomerates (nay rows of nax in one z-slab, restrict_plan in
//   ops/transfer_kernels.py, sized from the SM count so that both main
//   shapes fill the card: at 129^3 a row of 32 per block, 1,024 blocks; on
//   the Q2 cube's 8^3 agglomerates half a row, 128 blocks).  It stages the
//   x box its windows cover in shared memory once (the rows are 129 or 65
//   floats, not 16-byte multiples, so plain coalesced 4-byte loads; the box
//   re-reads the one shared node plane of neighbouring slabs and rows,
//   1.56x x at 129^3), split by the column's phase mod s so that the
//   stride-s reads of neighbouring agglomerates do not meet on a bank.  Each
//   thread keeps all c components of its sites, so every staged value is
//   read once per term for all of them; W is read with 16-byte loads over 4
//   consecutive ax where gx % 4 == 0 (a scalar path otherwise); a thread
//   takes one window row of its sites, and one thread per output adds the
//   rows' partial sums in a fixed order.  (The earlier design, a block per
//   32 outputs (e, a), gathered x at stride s per warp, once per component,
//   with 2 of 8 thread rows idle, at 46% of the byte bound at 129^3.)
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

constexpr int kRestrictMaxThreads = 512;  // RESTRICT_MAX_THREADS in ops/transfer_kernels.py
constexpr int kRestrictMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr int kProlongThreads = 512;
constexpr int kProlongMaxSmem = 48 * 1024;

// K4's launch (ops/transfer_kernels.py restrict_plan, its fields in order):
// a block owns nay agglomerate rows of nax agglomerates (vec: 4 per thread
// item) in nzc consecutive z-slabs; threads; the x ring's row stride
// (odd); lanes per output of the final sums; blocks; byte offsets of the
// two W tiles (wtile bytes each) and of the partial sums, and the dynamic
// shared memory in bytes.
struct RestrictPlan {
    int nay, nax, nzc, vec, threads, rowstride, red_lanes, blocks;
    int off_w, wtile, off_part, smem_bytes;
};

__device__ __forceinline__ float4 load_w4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// the same from shared memory
__device__ __forceinline__ float4 tile_w4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 tile_w4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float tile_w(const float* p) { return *p; }
__device__ __forceinline__ float tile_w(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n / d for 0 <= n < 2^22 from inv = 1.f / d: (n + 0.5) / d lies at least
// 0.5 / d from an integer, and the float product errs by less.
__device__ __forceinline__ int fdiv(int n, float inv) {
    return __float2int_rz(((float)n + 0.5f) * inv);
}

// Sum over an aligned group of G lanes (G a power of two <= 32), a fixed
// butterfly; every lane of the warp calls it with the same G.
__device__ __forceinline__ float lanes_sum(float v, int G) {
    for (int m = G >> 1; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// K4.  Block (az0 / nzc, ay0 / nay, ax0 / nax) marches over the slabs az0 +
// [0, nzc) of its agglomerates ay0 + [0, nay) x ax0 + [0, nax), in a
// two-stage pipeline of asynchronous copies (cp.async): while it sums slab
// k, the copies of slab k + 1 are in flight -- its W tile (rows W[e, tz,
// ty, tx, az, ay, ax0 .. ax0 + nax), 16- or 8-byte copies, into the other
// of two tiles) and the x planes it does not share with slab k (slabs
// share their boundary plane, so each plane is read once), into a ring of
// wz + sz planes.  A plane is stored split by the column's phase q = col %
// sx (k = col / sx), so that the stride-sx reads of neighbouring
// agglomerates fall on neighbouring words: ring[slot][row][q][k] at row
// stride rs (odd: the 4 window rows a warp spans fall on different banks)
// and phase stride nax + 1; consecutive threads copy consecutive columns.  An item of the sums is (agglomerate row ayl, V
// consecutive agglomerates, window row r = tz * wy + ty): it sums the r-th
// row's wx terms of its V sites for every component (V = 4: a 16-byte, or
// 8-byte bf16, read of the tile per tx and component, CC components at
// compile time; V = 1: scalar reads, c at run time) into part[r][site, e];
// then red_lanes lanes per output add the window rows, each in increasing
// r from its own, and meet in a butterfly.  Every W entry is copied once,
// every output written once; no atomics, so two launches give the same
// bits.  Where the 16-byte form does not apply (V = 1) the tile is filled by
// plain loads.
template <typename T, int V, int CC>
__global__ void __launch_bounds__(kRestrictMaxThreads)
structured_restrict_kernel(const T* __restrict__ W, const float* __restrict__ x,
                           float* __restrict__ out, const FineWindows g,
                           const RestrictPlan p) {
    extern __shared__ __align__(16) char smc[];
    const int sz = g.wz - 1, sy = g.wy - 1, sx = g.wx - 1;
    const int c = CC ? CC : g.c;
    const int nyc = (g.gy + p.nay - 1) / p.nay, nxc = (g.gx + p.nax - 1) / p.nax;
    const int bx = blockIdx.x % nxc, u = blockIdx.x / nxc, by = u % nyc, bz = u / nyc;
    const int az0 = bz * p.nzc, ay0 = by * p.nay, ax0 = bx * p.nax;
    const int nzk = min(p.nzc, g.gz - az0);
    const int nay = min(p.nay, g.gy - ay0), nax = min(p.nax, g.gx - ax0);
    const int ks = p.nax + 1, rs = p.rowstride, ps = (p.nay * sy + 1) * rs;
    const int nring = p.nzc > 1 ? g.wz + sz : g.wz;
    float* ring = reinterpret_cast<float*>(smc);
    float* part = reinterpret_cast<float*>(smc + p.off_part);
    const int R = g.wz * g.wy, nv = nax / V, P = p.nay * p.nax * c;
    const size_t n_sites = (size_t)g.gz * g.gy * g.gx;
    const int nrows = nay * sy + 1, ncols = nax * sx + 1;
    const int n_wrows = c * R * g.wx * nay;     // tile rows (e, r, tx, ayl)
    const auto tile = [&](int k) {
        return reinterpret_cast<T*>(smc + p.off_w + (k & 1) * p.wtile);
    };

    // the copies of slab k: its x planes from plane `first` on, consecutive
    // threads on consecutive columns (row and plane by an exact float
    // reciprocal, fdiv; the phase and k by shift and mask where sx is a power
    // of two, the main shapes' 4 and 8);
    // its W tile rows (t = (e * R + r) * wx + tx, ayl) of nax weights in
    // chunks of 16 (or 8) bytes, a thread keeping one chunk lane where the
    // chunks of a row divide a warp
    const int lsx = (sx & (sx - 1)) == 0 ? __ffs(sx) - 1 : -1;
    const float ncols_inv = 1.f / ncols, nrows_inv = 1.f / nrows;
    const int bytes = nax * (int)sizeof(T);
    const int chunk = bytes % 16 == 0 && (p.nax * sizeof(T)) % 16 == 0
                      && (g.gx * sizeof(T)) % 16 == 0 ? 16 : 8;
    const int per = bytes / chunk;
    const bool lanes_fixed = p.vec && (per & (per - 1)) == 0 && per <= 32;
    const auto copy_slab = [&](int k, int first) {
        const int az = az0 + k;
        const float* xz = x + ((size_t)az * sz * g.ny + (size_t)ay0 * sy) * g.nx
                          + (size_t)ax0 * sx;
        const int slot0 = (k * sz) % nring;
        for (int i = threadIdx.x; i < (g.wz - first) * nrows * ncols; i += blockDim.x) {
            const int rowi = fdiv(i, ncols_inv), col = i - rowi * ncols;
            const int pr = fdiv(rowi, nrows_inv), row = rowi - pr * nrows, pl = first + pr;
            const int slot = slot0 + pl < nring ? slot0 + pl : slot0 + pl - nring;
            const int q = lsx >= 0 ? col & (sx - 1) : col % sx;
            const int kk = lsx >= 0 ? col >> lsx : col / sx;
            cp_async4(ring + slot * ps + row * rs + q * ks + kk,
                      xz + ((size_t)pl * g.ny + row) * g.nx + col);
        }
        T* wt = tile(k);
        const T* wg = W + ((size_t)az * g.gy + ay0) * g.gx + ax0;
        if (lanes_fixed) {
            const int j = threadIdx.x % per, step = blockDim.x / per;
            for (int row = threadIdx.x / per; row < n_wrows; row += step) {
                const int ayl = nay == 1 ? 0 : row % nay, t = nay == 1 ? row : row / nay;
                const char* src = reinterpret_cast<const char*>(
                                      wg + (size_t)t * n_sites + (size_t)ayl * g.gx) + j * chunk;
                char* dst = reinterpret_cast<char*>(wt + (size_t)row * p.nax) + j * chunk;
                if (chunk == 16)
                    cp_async16(dst, src);
                else
                    cp_async8(dst, src);
            }
        } else if (p.vec) {
            for (int i = threadIdx.x; i < n_wrows * per; i += blockDim.x) {
                const int row = i / per, j = i - row * per, ayl = row % nay, t = row / nay;
                const char* src = reinterpret_cast<const char*>(
                                      wg + (size_t)t * n_sites + (size_t)ayl * g.gx) + j * chunk;
                char* dst = reinterpret_cast<char*>(wt + (size_t)row * p.nax) + j * chunk;
                if (chunk == 16)
                    cp_async16(dst, src);
                else
                    cp_async8(dst, src);
            }
        } else {
            for (int i = threadIdx.x; i < n_wrows * nax; i += blockDim.x) {
                const int row = i / nax, a = i - row * nax, ayl = row % nay, t = row / nay;
                wt[(size_t)row * p.nax + a] = wg[(size_t)t * n_sites + (size_t)ayl * g.gx + a];
            }
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };

    // a thread's items: decoded once where the block has a thread per item
    struct Item {
        int r, ayl, axl, tz, ty;
    };
    const auto decode = [&](int it) {
        const int v = it % nv, w_ = it / nv, r = w_ % R, tz = r / g.wy;
        return Item{r, w_ / R, v * V, tz, r - tz * g.wy};
    };
    const Item mine = decode(threadIdx.x);

    copy_slab(0, 0);
    for (int k = 0; k < nzk; ++k) {
        if (k + 1 < nzk) {
            copy_slab(k + 1, 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const T* wt = tile(k);
        const int slot_k = (k * sz) % nring;
        for (int it = threadIdx.x; it < nay * nv * R; it += blockDim.x) {
            const Item im = it == (int)threadIdx.x ? mine : decode(it);
            const int r = im.r, ayl = im.ayl, axl = im.axl, tz = im.tz, ty = im.ty;
            const int slot = slot_k + tz < nring ? slot_k + tz : slot_k + tz - nring;
            const float* xr = ring + slot * ps + (ayl * sy + ty) * rs + axl;
            // tile row of (e, r, tx, ayl): ((e * R + r) * wx + tx) * nay + ayl
            const T* wr = wt + ((size_t)r * g.wx * nay + ayl) * p.nax + axl;
            const size_t wes = (size_t)R * g.wx * nay * p.nax, wxs = (size_t)nay * p.nax;
            float* pr = part + (size_t)r * P + (ayl * p.nax + axl) * c;
            if constexpr (V == 4) {
                float acc[4][CC] = {};
#pragma unroll 3
                for (int tx = 0; tx < g.wx; ++tx) {
                    // column ax * sx + tx: phase tx, k = ax; at tx = sx phase 0, k = ax + 1
                    const float* xs = tx < sx ? xr + tx * ks : xr + 1;
                    const float x0 = xs[0], x1 = xs[1], x2 = xs[2], x3 = xs[3];
#pragma unroll
                    for (int e = 0; e < CC; ++e) {
                        const float4 wv = tile_w4(wr + tx * wxs + e * wes);
                        acc[0][e] += wv.x * x0;
                        acc[1][e] += wv.y * x1;
                        acc[2][e] += wv.z * x2;
                        acc[3][e] += wv.w * x3;
                    }
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < CC; ++e) pr[i * CC + e] = acc[i][e];
            } else {
                for (int e = 0; e < c; ++e) {
                    float acc = 0.f;
                    for (int tx = 0; tx < g.wx; ++tx)
                        acc += tile_w(wr + tx * wxs + e * wes) * (tx < sx ? xr[tx * ks] : xr[1]);
                    pr[e] = acc;
                }
            }
        }
        __syncthreads();

        // G = red_lanes lanes per output (ayl, ax, e): lane l adds the window
        // rows l, l + G, .. in order, then the group's butterfly
        const int G = p.red_lanes, groups = blockDim.x / G;
        const int grp = threadIdx.x / G, lane = threadIdx.x % G;
        const int row_out = nax * c, n_out = nay * row_out;
        const size_t az = az0 + k;
        for (int base = 0; base < n_out; base += groups) {
            const int j = base + grp;
            float s = 0.f;
            if (j < n_out) {
                const int ayl = j / row_out, m = j - ayl * row_out;
                const float* pj = part + ayl * p.nax * c + m;
                for (int r = lane; r < R; r += G) s += pj[(size_t)r * P];
            }
            s = lanes_sum(s, G);
            if (j < n_out && lane == 0) {
                const int ayl = j / row_out, m = j - ayl * row_out;
                out[((az * g.gy + ay0 + ayl) * g.gx + ax0) * c + m] = s;
            }
        }
    }
}

template <typename T, int V, int CC>
cudaError_t launch_restrict(const T* W, const float* x, float* out, const FineWindows& g,
                            const RestrictPlan& p, cudaStream_t s) {
    static int smem_set = 48 * 1024;      // raised once per size beyond the default
    if (p.smem_bytes > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            structured_restrict_kernel<T, V, CC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
        if (e != cudaSuccess) return e;
        smem_set = p.smem_bytes;
    }
    structured_restrict_kernel<T, V, CC><<<p.blocks, p.threads, p.smem_bytes, s>>>(
        W, x, out, g, p);
    return cudaGetLastError();
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
// wy, wx, c}; plan = the 12 fields of RestrictPlan (ops/transfer_kernels.py
// restrict_plan); w_bf16 selects the weight type.  Returns the cudaError_t
// of the launch (0 on success).
int mfmg_structured_restrict(int w_bf16, const void* W, const float* x, float* out,
                             const int* geom, const int* plan, void* stream) {
    const FineWindows g = make_fine_windows(geom);
    if (int err = check_fine_windows(g)) return err;
    RestrictPlan p;
    p.nay = plan[0]; p.nax = plan[1]; p.nzc = plan[2]; p.vec = plan[3];
    p.threads = plan[4]; p.rowstride = plan[5]; p.red_lanes = plan[6]; p.blocks = plan[7];
    p.off_w = plan[8]; p.wtile = plan[9]; p.off_part = plan[10]; p.smem_bytes = plan[11];
    const int sx = g.wx - 1, sy = g.wy - 1, wsize = w_bf16 ? 2 : 4;
    const long long ring = 4LL * (p.nzc > 1 ? g.wz + g.wz - 1 : g.wz) * (p.nay * sy + 1)
                           * p.rowstride;
    const long long tile = (long long)wsize * g.c * g.wz * g.wy * g.wx * p.nay * p.nax;
    const long long part = 4LL * g.wz * g.wy * p.nay * p.nax * g.c;
    const long long blocks = (long long)((g.gz + p.nzc - 1) / p.nzc)
                             * ((g.gy + p.nay - 1) / p.nay) * ((g.gx + p.nax - 1) / p.nax);
    const int G = p.red_lanes;
    // the plan must hold the ring, the two tiles and the partial sums on
    // 16-byte boundaries, and the 16-byte form needs whole vectors of
    // agglomerates and 16-byte aligned weights
    if (p.nay < 1 || p.nax < 1 || p.nzc < 1 || p.threads < 32 || p.threads % 32
        || p.threads > kRestrictMaxThreads || p.rowstride < sx * (p.nax + 1)
        || p.off_w < ring || p.off_w % 16 || p.wtile < tile || p.wtile % 16
        || p.off_part < p.off_w + 2LL * p.wtile || p.off_part % 16
        || p.smem_bytes < p.off_part + part || p.smem_bytes > kRestrictMaxSmem
        || blocks != p.blocks || G < 1 || G > 32 || (G & (G - 1))
        || (p.vec && (g.gx % 4 || p.nax % 4 || g.c > 4
                      || reinterpret_cast<uintptr_t>(W) % 16)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFMG_RESTRICT(T, V, CC) \
    launch_restrict<T, V, CC>(static_cast<const T*>(W), x, out, g, p, s)
    cudaError_t e;
    switch ((p.vec ? g.c : 0) + (w_bf16 ? 8 : 0)) {
    case 0: e = MFMG_RESTRICT(float, 1, 0); break;
    case 1: e = MFMG_RESTRICT(float, 4, 1); break;
    case 2: e = MFMG_RESTRICT(float, 4, 2); break;
    case 3: e = MFMG_RESTRICT(float, 4, 3); break;
    case 4: e = MFMG_RESTRICT(float, 4, 4); break;
    case 8: e = MFMG_RESTRICT(__nv_bfloat16, 1, 0); break;
    case 9: e = MFMG_RESTRICT(__nv_bfloat16, 4, 1); break;
    case 10: e = MFMG_RESTRICT(__nv_bfloat16, 4, 2); break;
    case 11: e = MFMG_RESTRICT(__nv_bfloat16, 4, 3); break;
    default: e = MFMG_RESTRICT(__nv_bfloat16, 4, 4);
    }
#undef MFMG_RESTRICT
    return (int)e;
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
