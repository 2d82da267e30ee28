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
// neighbours written by the step before.  Measured per phase (PERF.md,
// scripts/tail_phases.py), an earlier design lost most of its time in
// serial per-thread chains (a thread's 27 offsets of an apply, its 125 or
// 729 window terms of the fine restriction, one after another); this one
// spreads each sum over lanes, and what is left is about 2-4 us per phase
// and 1 us per grid sync.
//
// Design: one persistent cooperative kernel (cudaLaunchCooperativeKernel),
// its phases separated by cooperative_groups grid syncs, so the whole tail
// is one launch.  The launch follows a plan (ops/fused_cycle.py tail_plan):
// * Owner computes.  Block b owns the level-1 sites [b * S, b * S + S) for
//   the whole launch (one block of kTailThreads per SM at most; fewer where
//   the level-1 grid is small).  At entry it copies its sites' coefficients
//   (n_off chunks of S * c * c weights) and, in the dense form, its columns
//   of Rd (n2 chunks of S * c) into shared memory with asynchronous copies
//   (cp.async), which complete behind the first phase; every apply and both
//   dense transfers then read them there.  Where they do not fit, the plan
//   leaves them in global memory.  The block's own b1, residual and
//   Chebyshev p, x2 and the applies' gather buffer stay in shared memory
//   where they fit; where not (large level-1 grids with many eigenvectors,
//   e.g. 64^3 sites at c = 8), the plan places x2, then the gather buffer,
//   then the block's vectors in global scratch of their own, and the kernel
//   reads them there in the same order, so the sums and their bits do not
//   depend on the placement.  d, x and r1, which neighbours read, go
//   through global memory and are read after the phase's grid sync.
// * Several lanes per output.  An apply gives each site a group of G lanes
//   (G a power of two, as many as the block's threads allow) that gather
//   the neighbour values together, then one lane per output sums them in
//   the plain sequential order (see applies_c); the fine restriction gives
//   each (e, a) Gf lanes that split the
//   window's entries (their fine offsets tabulated once per block, loads
//   issued in batches); the dense restriction sums the block's own columns for
//   every coarse row (a partial per block), the reduction over blocks, the
//   windowed restriction and x2 = inv2 b2 take a warp per row; the dense
//   prolongation splits the coarse rows over the lanes of each column; the
//   fine prolongation takes a thread per fine point, over the whole grid.
//   Every split sum runs in a fixed order: each lane in increasing index,
//   then a butterfly of __shfl_xor_sync over its group, so results are
//   deterministic and no atomics are used.  The applies' order is the
//   earlier design's, and so are their bits: the windowed form's bf16
//   roundings of r1, b2, x2 make the tail's output move by up to 1e-4 when
//   one of them flips (PERF.md), and another order of the residual's
//   sums flips some.
// Level-1 vectors are site-major, v[s * c + e], as at the port's public
// functions; the reference's (c, gx, gz*gy) plane layout and 0/1 selection
// matrices existed for Mosaic and are not used.  Out-of-grid stencil and
// window terms are skipped by explicit bounds checks.  Weights are float or
// bf16 (converted in registers), every sum is float.  With bf16 weights in
// the windowed level-1 -> 2 form the correction rounds four vectors to bf16
// (round to nearest even), where the reference's reduced tail rounds them
// (fused_cycle.py:256, 268, 272, 285): r1, b2, x2, and the prolonged values
// summed over the z and y windows before the x windows are added (one
// thread sums each x window's z/y windows, then rounds).  The dense form and
// the fine transfer round nothing, as in the reference.  The phases at
// degree d and nss smoothing steps, each ending at a grid sync:
//   (full) restrict b1 = R res, fused with the first pointwise Chebyshev step
//   d-1 applies of the pre-smooth x1 = cheb(b1)
//   (nss-1) x d applies of further smooths
//   r1 = A x1 - b1 (dense: and the block's partial R2 r1)
//   dense: b2 = sum of the partials; windowed: b2 = R2 r1
//   x2 = inv2 b2
//   x1 -= R2^T x2, own sites
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

constexpr int kTailThreads = 512;   // TAIL_THREADS in ops/fused_cycle.py

// The plan (ops/fused_cycle.py tail_plan): sites per block and lanes per
// output of each split, what is staged in shared memory, and its layout
// (byte offsets: the block's own b1, residual and p at 0; a staged chunk is
// the 16-byte-aligned cover of its bytes, cstride / rstride bytes apart; the
// fine window's offsets at off_tab; the applies' gathered neighbour values,
// n_off * c floats per group, at off_vb).  stage_vecs, stage_x2, stage_vb:
// 1 where the block's vectors, x2 and the gather buffer lie in shared
// memory (the main paths' plans), 0 where they lie in global scratch.
struct Plan {
    int blocks, sites, group, fine_group, row_parts, col_parts;
    int stage_coeffs, stage_rd, cstride, rstride;
    int off_coef, off_rd, off_x2, off_tab, off_vb, smem_bytes;
    int stage_vecs, stage_x2, stage_vb;   // 0: in global scratch (gvec, x2, gvb)
};

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
    // scratch: d (two), x (two), r1 (n1 each), the dense partials
    // (blocks, n2), b2, x2 (n2 each); where the plan says so, each block's
    // vectors (3 * sites * c) and gather buffer (T / group * n_off * c)
    float* D[2];
    float* X[2];
    float* R;
    float* part;
    float* b2;
    float* x2;
    float* gvec;
    float* gvb;
    Plan plan;
    // phase stamps (the stamped instance only)
    long long* stamps;
};

__device__ __forceinline__ long long global_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// Phase stamps of one block: mark() records when the whole block got there
// (%globaltimer, ns) into stamps[1 + k * gridDim.x + blockIdx.x], k counting
// the marks; stamps[0] is the grid size.  Only the kStamp instance, which a
// measurement script launches, records; in the main path's instance mark()
// is empty.
template <bool kStamp>
struct Marks {
    long long* buf;
    int k = 0;
    __device__ __forceinline__ void mark() {
        if constexpr (kStamp) {
            __syncthreads();
            if (threadIdx.x == 0) {
                buf[1 + (size_t)k * gridDim.x + blockIdx.x] = global_ns();
                if (k == 0 && blockIdx.x == 0) buf[0] = gridDim.x;
            }
            ++k;
        }
    }
    // a grid barrier, marked on both sides
    __device__ __forceinline__ void sync(cg::grid_group& grid) {
        mark();
        grid.sync();
        mark();
    }
};

__device__ __forceinline__ float bf16_rn(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// Plain loads: the staged weights lie in shared memory, the rest in global.
__device__ __forceinline__ float wval(const float* p) { return *p; }
__device__ __forceinline__ float wval(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Sum over an aligned group of G lanes (G a power of two <= 32), a fixed
// butterfly; every lane of the warp must call it with the same G.
__device__ __forceinline__ float group_sum(float v, int G) {
    for (int m = G >> 1; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The 16-byte pieces of the aligned cover of bytes [a, a + len): a staged
// chunk copies them, and its data starts (a & 15) bytes in.
__device__ __forceinline__ int cover_pieces(size_t a, size_t len) {
    return (int)((((a + len + 15) & ~(size_t)15) - (a & ~(size_t)15)) >> 4);
}

// The block's sites: [s0, s0 + ns).
struct Own {
    int s0, ns;
};

// Runs body(item, active, lane) over n items with G lanes per item; every
// thread of the block makes the same number of calls (inactive ones with
// active = false), so bodies may shuffle within their group.
template <class F>
__device__ __forceinline__ void for_groups(int n, int G, F body) {
    const int ng = blockDim.x / G, grp = threadIdx.x / G, lane = threadIdx.x % G;
    for (int base = 0; base < n; base += ng) body(base + grp, base + grp < n, lane);
}

template <typename T>
struct Tail {
    const TailParams& p;
    const Own w;
    char* sm;                    // dynamic shared memory
    float* sB;                   // own b1, residual, Chebyshev p (ns * c each)
    float* sR;
    float* sP;
    float* sV;                   // the applies' gathered neighbour values

    __device__ Tail(const TailParams& p_, Own w_, char* sm_)
        : p(p_), w(w_), sm(sm_) {
        const int n = p.plan.sites * p.c;
        sB = p.plan.stage_vecs ? reinterpret_cast<float*>(sm)
                               : p.gvec + (size_t)blockIdx.x * 3 * n;
        sR = sB + n;
        sP = sR + n;
        sV = p.plan.stage_vb
                 ? reinterpret_cast<float*>(sm + p.plan.off_vb)
                 : p.gvb + (size_t)blockIdx.x * (blockDim.x / p.plan.group) * p.n_off * p.c;
    }

    // C[o, s0 + sl, e, 0] for o = 0, 1, ... in turn: the offsets' chunks
    // lie `step` bytes apart, each (staged) at its own 16-byte phase
    struct CoefCursor {
        const char* row;         // chunk o's bytes, before its phase
        int phase, dphase;       // (byte offset of the data) & 15, its step
        size_t step;
        __device__ __forceinline__ const T* at() const {
            return reinterpret_cast<const T*>(row + phase);
        }
        __device__ __forceinline__ void next() {
            row += step;
            phase = (phase + dphase) & 15;
        }
    };

    __device__ __forceinline__ CoefCursor coef_rows(int sl, int e) const {
        const int c = p.c;
        const size_t in = ((size_t)sl * c + e) * c * sizeof(T);
        const size_t s0 = (size_t)w.s0 * c * c * sizeof(T);
        const size_t chunk = (size_t)p.n_sites * c * c * sizeof(T);
        if (!p.plan.stage_coeffs)
            return {static_cast<const char*>(p.coeffs) + s0 + in, 0, 0, chunk};
        return {sm + p.plan.off_coef + in, (int)(s0 & 15), (int)(chunk & 15),
                (size_t)p.plan.cstride};
    }

    // Rd[k, s0 * c]: staged or in global memory
    __device__ __forceinline__ const T* rd_row(int k) const {
        const size_t g = (size_t)k * p.n1 + (size_t)w.s0 * p.c;
        if (!p.plan.stage_rd) return static_cast<const T*>(p.Rd) + g;
        return reinterpret_cast<const T*>(sm + p.plan.off_rd + (size_t)k * p.plan.rstride
                                          + ((g * sizeof(T)) & 15));
    }

    // Start the asynchronous copies of the block's coefficients and Rd
    // columns (stage_wait() before their first use).
    __device__ void stage_start() const {
        const int c = p.c, ncc = w.ns * c * c, ncol = w.ns * c;
        if (p.plan.stage_coeffs) {
            const int per = p.plan.cstride >> 4;
            const char* src = static_cast<const char*>(p.coeffs);
            for (int q = threadIdx.x; q < p.n_off * per; q += blockDim.x) {
                const int o = q / per, i = q - o * per;
                const size_t a = ((size_t)o * p.n_sites + w.s0) * c * c * sizeof(T);
                if (i < cover_pieces(a, (size_t)ncc * sizeof(T)))
                    cp_async16(sm + p.plan.off_coef + (size_t)o * p.plan.cstride + 16 * i,
                               src + (a & ~(size_t)15) + 16 * i);
            }
        }
        if (p.plan.stage_rd) {
            const int per = p.plan.rstride >> 4;
            const char* src = static_cast<const char*>(p.Rd);
            for (int q = threadIdx.x; q < p.n2 * per; q += blockDim.x) {
                const int k = q / per, i = q - k * per;
                const size_t a = ((size_t)k * p.n1 + (size_t)w.s0 * c) * sizeof(T);
                if (i < cover_pieces(a, (size_t)ncol * sizeof(T)))
                    cp_async16(sm + p.plan.off_rd + (size_t)k * p.plan.rstride + 16 * i,
                               src + (a & ~(size_t)15) + 16 * i);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::);
    }

    __device__ void stage_wait() const {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
    }

    // The applies of one phase, A v at the block's sites, G lanes per site:
    // the lanes gather the site's neighbour values v[s + o, f] (zero out of
    // the grid) into their group's buffer in shared memory, the loads of
    // kBatch offsets in flight per lane (with c = 2 a float2 each); then
    // lane e sums output e over o and f in that order,
    // one multiply-add per term.  That is the order of a plain sequential
    // sum, so an apply gives the same bits whatever the plan's G (the
    // windowed form's bf16 roundings make the tail sensitive to the last
    // bit of its residual).  body(sl, jl, Av) takes each output.  kC: c at
    // compile time (the hierarchies' two eigenvectors), 0 for any c.
    template <int kC, class F>
    __device__ __forceinline__ void applies_c(const float* v, F& body) const {
        const int c = kC ? kC : p.c, G = p.plan.group, n_off = p.n_off;
        for_groups(w.ns, G, [&](int sl, bool active, int lane) {
            float* vb = sV + (size_t)(threadIdx.x / G) * n_off * c;
            if (active) {
                const int s = w.s0 + sl;
                const int ax = s % p.gx, t = s / p.gx, ay = t % p.gy, az = t / p.gy;
                constexpr int kBatch = 8;
                for (int o0 = lane; o0 < n_off; o0 += kBatch * G) {
                    const float* src[kBatch];
                    bool ok[kBatch];
#pragma unroll
                    for (int u = 0; u < kBatch; ++u) {
                        const int o = min(o0 + u * G, n_off - 1);
                        const int bz = az + p.odz[o], by = ay + p.ody[o], bx = ax + p.odx[o];
                        ok[u] = o0 + u * G < n_off && bz >= 0 && bz < p.gz && by >= 0
                                && by < p.gy && bx >= 0 && bx < p.gx;
                        src[u] = v + (size_t)(ok[u] ? (bz * p.gy + by) * p.gx + bx : s) * c;
                    }
                    if constexpr (kC == 2) {
                        float2 x[kBatch];
#pragma unroll
                        for (int u = 0; u < kBatch; ++u)
                            x[u] = ok[u] ? *reinterpret_cast<const float2*>(src[u])
                                         : make_float2(0.f, 0.f);
#pragma unroll
                        for (int u = 0; u < kBatch; ++u)
                            if (o0 + u * G < n_off)
                                reinterpret_cast<float2*>(vb)[o0 + u * G] = x[u];
                    } else {
#pragma unroll
                        for (int u = 0; u < kBatch; ++u)
                            if (o0 + u * G < n_off)
                                for (int f = 0; f < c; ++f)
                                    vb[(o0 + u * G) * c + f] = ok[u] ? src[u][f] : 0.f;
                    }
                }
            }
            __syncwarp();
            if (active)
                for (int e = lane; e < c; e += G) {
                    float acc = 0.f;
                    CoefCursor C = coef_rows(sl, e);
#pragma unroll 9
                    for (int o = 0; o < n_off; ++o) {
                        for (int f = 0; f < c; ++f) acc += wval(C.at() + f) * vb[o * c + f];
                        C.next();
                    }
                    body(sl, sl * c + e, acc);
                }
            __syncwarp();
        });
    }

    template <class F>
    __device__ void applies(const float* v, F body) const {
        if (p.c == 2)
            applies_c<2>(v, body);
        else
            applies_c<0>(v, body);
    }

    // First pointwise step of cheb_vmult(src) at own index jl, src value
    // s_j: z = invd s; p = z; d = a_0 z.  With degree 1 the polynomial ends
    // here and writes the result (x_sub - d, or d when x_sub is null).
    __device__ __forceinline__ void cheb_first(int jl, float s_j, const float* x_sub,
                                               float* x_out) const {
        const int j = w.s0 * p.c + jl;
        const float z = __ldg(p.invd + j) * s_j;
        sP[jl] = z;
        const float d = __ldg(p.coef) * z;
        if (p.degree == 1)
            x_out[j] = x_sub ? x_sub[j] - d : d;
        else
            p.D[0][j] = d;
    }

    // Step i >= 1 of cheb_vmult(src) (src own, in shared memory):
    // z = invd (src - A d); p = z + b_i p; d += a_i p.  Reads neighbours of
    // D[(i-1)&1]; the last step writes the result to x_out.
    __device__ void cheb_step(int i, const float* src, const float* x_sub, float* x_out) const {
        const float* d_in = p.D[(i - 1) & 1];
        float* d_out = p.D[i & 1];
        const float a = __ldg(p.coef + i), b = __ldg(p.coef + p.degree + i);
        const bool last = i == p.degree - 1;
        applies(d_in, [&](int sl, int jl, float Ad) {
            const int j = w.s0 * p.c + jl;
            const float z = __ldg(p.invd + j) * (src[jl] - Ad);
            const float pn = z + b * sP[jl];
            sP[jl] = pn;
            const float dn = d_in[j] + a * pn;
            if (last)
                x_out[j] = x_sub ? x_sub[j] - dn : dn;
            else
                d_out[j] = dn;
        });
    }

    // r = A v - b1 at own sites into sR (and into global R when to_global),
    // rounded to bf16 when rnd; with x_out, the first pointwise step of
    // smooth(v) follows.
    __device__ void residual(const float* v, bool rnd, bool to_global, float* x_out) const {
        applies(v, [&](int sl, int jl, float Av) {
            float r = Av - sB[jl];
            if (rnd) r = bf16_rn(r);
            sR[jl] = r;
            if (to_global) p.R[w.s0 * p.c + jl] = r;
            if (x_out) cheb_first(jl, r, v, x_out);
        });
    }

    // Phase 0: b1 at own sites (the fine restriction in full mode, Gf lanes
    // per (e, a) over the window's entries; the input in sub-cycle mode)
    // into sB, and the first pointwise Chebyshev step.
    __device__ void first_phase(float* x_out) const {
        const int c = p.c;
        if (!p.full) {
            for (int jl = threadIdx.x; jl < w.ns * c; jl += blockDim.x) {
                const float s = __ldg(p.b1_in + w.s0 * c + jl);
                sB[jl] = s;
                cheb_first(jl, s, nullptr, x_out);
            }
            return;
        }
        const T* W = static_cast<const T*>(p.W);
        const FineWindows& g = p.fw;
        const int n_t = g.wz * g.wy * g.wx, G = p.plan.fine_group;
        const size_t n_sites = p.n_sites;
        // the fine offsets of the window entries t = (tz, ty, tx), once
        int* tab = reinterpret_cast<int*>(sm + p.plan.off_tab);
        for (int t = threadIdx.x; t < n_t; t += blockDim.x) {
            const int tx = t % g.wx, v = t / g.wx, ty = v % g.wy, tz = v / g.wy;
            tab[t] = (tz * g.ny + ty) * g.nx + tx;
        }
        __syncthreads();
        for_groups(w.ns * c, G, [&](int q, bool active, int lane) {
            float acc = 0.f;
            const int e = q / w.ns, sl = q - e * w.ns, jl = sl * c + e;
            if (active) {
                // the window of agglomerate a: W[e, t, a] x[origin(a) + tab[t]]
                const int a = w.s0 + sl;
                const int ax = a % g.gx, u = a / g.gx, ay = u % g.gy, az = u / g.gy;
                const float* x0 = p.res + ((size_t)(az * (g.wz - 1)) * g.ny
                                           + ay * (g.wy - 1)) * g.nx + ax * (g.wx - 1);
                const T* w0 = W + (size_t)e * n_t * n_sites + a;
                // kBatch entries' loads issue before their sums; idle slots
                // load the last entry and add zero
                constexpr int kBatch = 8;
                for (int t0 = lane; t0 < n_t; t0 += kBatch * G) {
                    float wv[kBatch], xv[kBatch];
#pragma unroll
                    for (int b = 0; b < kBatch; ++b) {
                        const int t = min(t0 + b * G, n_t - 1);
                        wv[b] = wval(w0 + (size_t)t * n_sites);
                        xv[b] = t0 + b * G < n_t ? __ldg(x0 + tab[t]) : 0.f;
                    }
#pragma unroll
                    for (int b = 0; b < kBatch; ++b) acc += wv[b] * xv[b];
                }
            }
            acc = group_sum(acc, G);
            if (active && lane == 0) {
                sB[jl] = acc;
                cheb_first(jl, acc, nullptr, x_out);
            }
        });
    }

    // Dense form, in the residual's phase: part[block, k] = sum over the
    // block's columns of Rd[k, j] r1[j], row_parts lanes per row.
    __device__ void restrict_partial() const {
        __syncthreads();
        const int P = p.plan.row_parts, ncol = w.ns * p.c;
        for_groups(p.n2, P, [&](int k, bool active, int lane) {
            float acc = 0.f;
            if (active) {
                const T* r = rd_row(k);
                for (int jl = lane; jl < ncol; jl += P) acc += wval(r + jl) * sR[jl];
            }
            acc = group_sum(acc, P);
            if (active && lane == 0) p.part[(size_t)blockIdx.x * p.n2 + k] = acc;
        });
    }

    // Warp per coarse row over the grid: b2 (dense: the partials summed over
    // the blocks in order; windowed: R2 r1 over the row's window) or x2.
    __device__ void coarse_rows(bool solve) const {
        const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
        const int n_w = gridDim.x * warps;
        for (int k = blockIdx.x * warps + (threadIdx.x >> 5); k < p.n2; k += n_w) {
            float acc = 0.f;
            if (solve) {
                const float* row = p.inv2 + (size_t)k * p.n2;
#pragma unroll 8
                for (int j = lane; j < p.n2; j += 32) acc += __ldg(row + j) * p.b2[j];
            } else if (p.dense) {
#pragma unroll 4
                for (int b = lane; b < gridDim.x; b += 32) acc += p.part[(size_t)b * p.n2 + k];
            } else {
                // the window of super-site S: sites S * stride + t0 + t, all
                // components f; W2 holds them contiguously as [k][t][f]
                const T* W2 = static_cast<const T*>(p.W2);
                const int S = k / p.n2e;
                const int sx = S % p.ox, u = S / p.ox, sy = u % p.oy, sz = u / p.oy;
                const int wc = p.wz2 * p.wy2 * p.wx2 * p.c;
                // out-of-grid entries add zero (their loads clamped), so
                // that the loop has no branch
#pragma unroll 4
                for (int q = lane; q < wc; q += 32) {
                    const int f = q % p.c, t = q / p.c;
                    const int tx = t % p.wx2, v = t / p.wx2, ty = v % p.wy2, tz = v / p.wy2;
                    const int bz = sz * p.sz2 + p.tz0 + tz, by = sy * p.sy2 + p.ty0 + ty,
                              bx = sx * p.sx2 + p.tx0 + tx;
                    const bool ok = bz >= 0 && bz < p.gz && by >= 0 && by < p.gy && bx >= 0
                                    && bx < p.gx;
                    const float r = p.R[ok ? ((bz * p.gy + by) * p.gx + bx) * p.c + f : 0];
                    acc += ok ? wval(W2 + (size_t)k * wc + q) * r : 0.f;
                }
            }
            acc = group_sum(acc, 32);
            if (lane == 0) {
                if (solve)
                    p.x2[k] = p.round_vec ? bf16_rn(acc) : acc;
                else
                    p.b2[k] = p.round_vec ? bf16_rn(acc) : acc;
            }
        }
    }

    // x1 -= R2^T x2 at own sites, x2 staged in shared memory first (where
    // the plan places it in global memory, read there).
    __device__ void prolong_coarse(float* x1) const {
        const float* sx2 = p.x2;
        if (p.plan.stage_x2) {
            float* st = reinterpret_cast<float*>(sm + p.plan.off_x2);
            for (int k = threadIdx.x; k < p.n2; k += blockDim.x) st[k] = p.x2[k];
            sx2 = st;
        }
        __syncthreads();
        const int c = p.c, ncol = w.ns * c;
        if (p.dense) {
            const int P = p.plan.col_parts;
            for_groups(ncol, P, [&](int jl, bool active, int lane) {
                float acc = 0.f;
                if (active)
                    for (int k = lane; k < p.n2; k += P) acc += wval(rd_row(k) + jl) * sx2[k];
                acc = group_sum(acc, P);
                if (active && lane == 0) x1[w.s0 * c + jl] -= acc;
            });
            return;
        }
        // windowed: site b, component f gathers the <= 2 super-sites per
        // axis whose windows [S * stride + t0, S * stride + t0 + w) hold it
        const T* W2 = static_cast<const T*>(p.W2);
        const int w3 = p.wz2 * p.wy2 * p.wx2;
        for (int jl = threadIdx.x; jl < ncol; jl += blockDim.x) {
            const int j = w.s0 * c + jl;
            const int f = j % c, b = j / c;
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
                            zy += wval(W2 + ((size_t)k * w3 + t) * c + f) * sx2[k];
                        }
                    }
                }
                acc += p.round_vec ? bf16_rn(zy) : zy;
            }
            x1[j] -= acc;
        }
    }

    // out[i] = x[i] - (P x1)[i] over the whole fine grid, a thread per point.
    __device__ void prolong_fine(const float* x1) const {
        const T* W = static_cast<const T*>(p.W);
        const int n = p.fw.nz * p.fw.ny * p.fw.nx;
        const int stride = gridDim.x * blockDim.x;
        for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
            p.out[i] = __ldg(p.x_in + i) - (p.c == 2 ? window_prolong_at<2>(W, x1, p.fw, i)
                                                     : window_prolong_at<0>(W, x1, p.fw, i));
    }
};

// x_out = smooth(x_in) = x_in - cheb(A x_in - b1); x_out != x_in.  Starts
// after a grid sync.
template <typename T, bool kStamp>
__device__ void smooth(const Tail<T>& tl, cg::grid_group& grid, Marks<kStamp>& mk,
                       const float* x_in, float* x_out) {
    tl.residual(x_in, false, false, x_out);
    for (int i = 1; i < tl.p.degree; ++i) {
        mk.sync(grid);
        tl.cheb_step(i, tl.sR, x_in, x_out);
    }
}

template <typename T, bool kStamp>
__global__ void __launch_bounds__(kTailThreads, 1)
fused_tail_kernel(const __grid_constant__ TailParams p) {
    extern __shared__ __align__(16) char smem[];
    cg::grid_group grid = cg::this_grid();
    Marks<kStamp> mk{p.stamps};
    mk.mark();
    const int s0 = blockIdx.x * p.plan.sites;
    const Tail<T> tl(p, Own{s0, min(p.plan.sites, p.n_sites - s0)}, smem);
    float* xc = p.X[0];
    float* xn = p.X[1];

    // pre-smooth x1 = cheb(b1), from zero; the staged weights arrive behind
    // the first phase and its grid sync
    tl.stage_start();
    tl.first_phase(xc);
    mk.sync(grid);
    tl.stage_wait();
    for (int i = 1; i < p.degree; ++i) {
        if (i > 1) mk.sync(grid);
        tl.cheb_step(i, tl.sB, nullptr, xc);
    }
    for (int k = 0; k + 1 < p.nss; ++k) {
        if (k > 0 || p.degree > 1) mk.sync(grid);
        smooth<T, kStamp>(tl, grid, mk, xc, xn);
        float* t = xc; xc = xn; xn = t;
    }

    // coarse correction
    if (p.degree > 1 || p.nss > 1) mk.sync(grid);
    tl.residual(xc, p.round_vec, !p.dense, nullptr);
    if (p.dense) tl.restrict_partial();
    mk.sync(grid);
    tl.coarse_rows(false);
    mk.sync(grid);
    tl.coarse_rows(true);
    mk.sync(grid);
    tl.prolong_coarse(xc);

    // post-smooth; in sub-cycle mode the last smooth writes the output
    for (int k = 0; k < p.nss; ++k) {
        float* target = (!p.full && k == p.nss - 1) ? p.out : xn;
        mk.sync(grid);
        smooth<T, kStamp>(tl, grid, mk, xc, target);
        xn = xc;
        xc = target;
    }

    if (p.full) {
        mk.sync(grid);
        tl.prolong_fine(xc);
    }
    mk.mark();
}

namespace {

// The cooperative launch of the plan's grid; the grid must be resident
// (checked against the occupancy at the plan's shared memory, which also
// raises the kernel's dynamic shared-memory limit once per size).  In an
// anonymous namespace, so that its cache stays private to this library
// when two builds of it share a process (the measurement scripts' A/B).
template <typename T, bool kStamp>
cudaError_t launch_fused_tail(const TailParams& p, cudaStream_t s) {
    static int sms = 0, coop = 0, smem_set = -1, per_sm = 0;
    cudaError_t e = cudaSuccess;
    if (sms == 0) {
        int dev = 0;
        e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
        if (e != cudaSuccess) return e;
    }
    if (!coop) return cudaErrorNotSupported;
    const int smem = p.plan.smem_bytes;
    if (smem != smem_set) {
        e = cudaFuncSetAttribute(fused_tail_kernel<T, kStamp>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, fused_tail_kernel<T, kStamp>, kTailThreads, smem);
        if (e != cudaSuccess) return e;
        smem_set = smem;
    }
    if (per_sm * sms < p.plan.blocks) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {const_cast<TailParams*>(&p)};
    return cudaLaunchCooperativeKernel((const void*)fused_tail_kernel<T, kStamp>,
                                       dim3(p.plan.blocks), dim3(kTailThreads), args,
                                       (size_t)smem, s);
}

template <bool kStamp>
int run_fused_tail(int weights_bf16, int full, int dense, const void* coeffs,
                   const float* invd, const float* coef, const void* Rd,
                   const void* W2, const float* inv2, const void* W,
                   const float* b1_in, const float* x_in, const float* res,
                   float* out, float* scratch, const int* l1, const int* offs,
                   const int* l2, const int* fine, const int* plan,
                   long long* stamps, void* stream) {
    TailParams p = {};
    p.stamps = stamps;
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
    Plan& q = p.plan;
    q.blocks = plan[0]; q.sites = plan[1]; q.group = plan[2]; q.fine_group = plan[3];
    q.row_parts = plan[4]; q.col_parts = plan[5]; q.stage_coeffs = plan[6];
    q.stage_rd = plan[7]; q.cstride = plan[8]; q.rstride = plan[9];
    q.off_coef = plan[10]; q.off_rd = plan[11]; q.off_x2 = plan[12];
    q.off_tab = plan[13]; q.off_vb = plan[14]; q.smem_bytes = plan[15];
    q.stage_vecs = plan[16]; q.stage_x2 = plan[17]; q.stage_vb = plan[18];
    // every block owns at least one site; lanes per output divide a warp
    const int lanes[4] = {q.group, q.fine_group, q.row_parts, q.col_parts};
    for (int G : lanes)
        if (G < 1 || G > 32 || (G & (G - 1))) return (int)cudaErrorInvalidValue;
    if ((q.stage_vecs | q.stage_x2 | q.stage_vb) & ~1) return (int)cudaErrorInvalidValue;
    if (q.sites < 1 || q.blocks < 1 || (long long)(q.blocks - 1) * q.sites >= p.n_sites
        || (long long)q.blocks * q.sites < p.n_sites)
        return (int)cudaErrorInvalidValue;
    p.b1_in = b1_in; p.x_in = x_in; p.res = res; p.out = out;
    float* s = scratch;
    p.D[0] = s; s += p.n1;
    p.D[1] = s; s += p.n1;
    p.X[0] = s; s += p.n1;
    p.X[1] = s; s += p.n1;
    p.R = s; s += p.n1;
    p.part = s; s += (size_t)q.blocks * p.n2;
    p.b2 = s; s += p.n2;
    p.x2 = s; s += p.n2;
    // the blocks' vectors and gather buffers from 16-byte boundaries (the
    // applies store float2 pairs)
    const auto at16 = [&](float* t) { return scratch + (((size_t)(t - scratch) + 3) & ~(size_t)3); };
    s = at16(s);
    p.gvec = q.stage_vecs ? nullptr : s;
    if (!q.stage_vecs) s = at16(s + (size_t)q.blocks * 3 * q.sites * p.c);
    p.gvb = q.stage_vb ? nullptr : s;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = weights_bf16 ? launch_fused_tail<__nv_bfloat16, kStamp>(p, st)
                                 : launch_fused_tail<float, kStamp>(p, st);
    return (int)e;
}

}  // namespace

extern "C" {

// One coarse tail.  full: 1 = x - P subcycle(R res) into out (fine n),
// 0 = subcycle(b1) into out (n1).  dense: 1 = Rd, 0 = windowed W2.
//   l1   = {gz, gy, gx, c, n_off, degree, nss}, offs = n_off (dz, dy, dx)
//   l2   = {n2, n2e, oz, oy, ox, wz, wy, wx, sz, sy, sx, tz0, ty0, tx0}
//   fine = {nz, ny, nx, wz, wy, wx}
//   plan = the 19 fields of Plan, in order (ops/fused_cycle.py tail_plan)
// scratch holds 5 * n1 + (blocks + 2) * n2 floats, then, each from a
// multiple of 4 floats and where the plan leaves them in global memory,
// blocks * 3 * sites * c floats of the blocks' vectors and blocks * (512 /
// group) * n_off * c of their gather buffers (ops/fused_cycle.py
// scratch_floats); scratch, coeffs and Rd start on 16 bytes.  Null pointers for the operands the mode and form do not use.
// Returns the first cudaError_t (0 on success).
int mfmg_fused_tail(int weights_bf16, int full, int dense, const void* coeffs,
                    const float* invd, const float* coef, const void* Rd,
                    const void* W2, const float* inv2, const void* W,
                    const float* b1_in, const float* x_in, const float* res,
                    float* out, float* scratch, const int* l1, const int* offs,
                    const int* l2, const int* fine, const int* plan, void* stream) {
    return run_fused_tail<false>(weights_bf16, full, dense, coeffs, invd, coef, Rd, W2,
                                 inv2, W, b1_in, x_in, res, out, scratch, l1, offs, l2,
                                 fine, plan, nullptr, stream);
}

// The same tail through the instance that records phase stamps: stamps
// holds 1 + marks x blocks int64, zeroed by the caller; a measurement
// entry, never called by the solver.
int mfmg_fused_tail_stamped(int weights_bf16, int full, int dense, const void* coeffs,
                            const float* invd, const float* coef, const void* Rd,
                            const void* W2, const float* inv2, const void* W,
                            const float* b1_in, const float* x_in, const float* res,
                            float* out, float* scratch, const int* l1, const int* offs,
                            const int* l2, const int* fine, const int* plan,
                            long long* stamps, void* stream) {
    return run_fused_tail<true>(weights_bf16, full, dense, coeffs, invd, coef, Rd, W2,
                                inv2, W, b1_in, x_in, res, out, scratch, l1, offs, l2,
                                fine, plan, stamps, stream);
}

}  // extern "C"
