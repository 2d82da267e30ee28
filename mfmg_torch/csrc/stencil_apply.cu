// K1 and K3: the fine-grid stencil applies, one tiled kernel for both.
//
// K3, the one-sided apply, y = sum_o C_o x(i + o) over n_off planes,
// replaces mfmg_tpu/ops/pallas_stencil.py pallas_stencil_apply and covers
// its z-tiled variant pallas_stencil_apply_tiled (Q2/Q3 elements, 125 / 343
// offsets; stencils read from an assembled matrix).  K1, the symmetric-pair
// apply, y = C_0 x + sum_{o>0} [C_o x(i + o) + C_o(i - o) x(i - o)] (- b),
// over the center and positive planes, replaces pallas_stencil_apply_sym
// and covers pallas_stencil_apply_tiled_sym.  (The TPU kernels streamed the
// planes through a double-buffered DMA into VMEM and rolled x there.)
//
// What bounds them on an H100: bytes, once the instructions per term are
// few.  Each coefficient is used for one multiply-add: at 65^3 Q2 with bf16
// planes K3 reads 125 x 0.55 MB = 68.7 MB of planes, ~21 us at 3.35 TB/s,
// against ~1 us of float32 arithmetic.  The first, thread-per-point
// gather spent its instructions on six bounds checks per term, the offset
// decoded from the table and 64-bit addresses, and kept one load in flight
// per thread: bf16 planes ran slower than f32.
//
// Design: a block owns a tile of `rows` whole grid rows of one z slice (or,
// where a row is longer than a tile, one segment of `cols` points of a
// row): a contiguous run [i0, i0 + P) of the grid.  The terms are read as
// "virtual planes": K3's plane v at its offset; K1's center, then per
// positive offset o the forward term (plane o at +o) and the backward term
// (plane o read at the flat shift -d(o), at -o): the plain version's order.
// The block
//  * tabulates each virtual plane's coefficient offset and x offset once in
//    shared memory (one broadcast 16-byte read per plane in the loop);
//  * stages x over the tile and a halo of the stencil radius r on every
//    side, (2r + 1) slices, in shared memory, zero outside the grid, with
//    4-byte cp.async: no bounds checks in the inner loop, and an
//    out-of-grid partner reads 0 (a backward term whose partner lies
//    outside reads a finite coefficient of another point, times 0; on a
//    grid of a few points a side such a read could fall before the planes,
//    and CLAMP keeps it on the first element);
//  * gives each of its 256 threads 4 points of the tile (p = t + 256 k),
//    loads 8 virtual planes' coefficients for them together (32 loads in
//    flight, coalesced across the warp; one 32 x 32 + 64-bit multiply-add
//    per address), then sums their terms in virtual-plane order with float
//    multiply-adds.  At 65^3 the grid gives each SM only ~2,100 points,
//    so the loads in flight per point set the rate: 8 planes at a time (3
//    blocks per SM fit, <= 85 registers) took less time than 4, and tiles
//    of 1024 points less than 512 or 256 (more blocks, more halo).
// The tile plan (rows, cols) is the wrapper's
// (ops/stencil_kernels.py stencil_tile_plan); the offsets are a
// __grid_constant__ table of signed bytes.
#include "stencil_common.cuh"

// a block's threads, the points of each, the virtual planes loaded together
constexpr int kThreads13 = 256, kPoints = 4, kUnroll = 8;
constexpr int kMaxTile = kThreads13 * kPoints;  // points per tile

// A virtual plane: its coefficients' element offset from the point's own
// index in plane 0, and its x offset in the staged tile.
struct VPlane {
    long long coef;
    int x;
    int pad;
};

// Shared-memory layout: the virtual planes, then the x tile (floats).
struct TileLayout {
    int sy, sz, xs, off_x, bytes;
};

__host__ __device__ inline TileLayout tile_layout(int nv, int r, int rows, int cols) {
    TileLayout L;
    L.sy = cols + 2 * r;
    L.sz = (rows + 2 * r) * L.sy;
    L.xs = (2 * r + 1) * L.sz;
    L.off_x = (int)sizeof(VPlane) * nv;
    L.bytes = L.off_x + 4 * L.xs;
    return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float ld_coef(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_coef(const __nv_bfloat16* p) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// The coefficient of a virtual plane at coefficient offset `coef` for the
// point of grid index i: one 32 x 32 + 64-bit multiply-add for the address.
template <bool CLAMP, typename T>
__device__ __forceinline__ float term_coef(const T* __restrict__ planes, long long coef,
                                           int i) {
    if (CLAMP) return ld_coef(planes + max(coef + i, 0LL));
    return ld_coef(planes + coef + i);
}

// The block's sums: kPoints points per thread (p = t + 256 k, those past
// the tile clamped to its last point: computed, never stored), kUnroll
// virtual planes at a time, their loads issued together, then their terms
// in order.
template <bool CLAMP, typename T>
__device__ __forceinline__ void tile_terms(const T* __restrict__ planes, const VPlane* vt,
                                           const float* xs, int nv, int i0, int P, int cols,
                                           int r, const TileLayout& L,
                                           const float* __restrict__ b,
                                           float* __restrict__ y) {
    constexpr int KP = kPoints, U = kUnroll;
    const int tid = threadIdx.x;
    int xb[KP], idx[KP];
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
        const int p = min(tid + k * kThreads13, P - 1);
        idx[k] = i0 + p;
        xb[k] = r * L.sz + (p / cols + r) * L.sy + p % cols + r;
        acc[k] = 0.f;
    }
    const int nv_full = nv - nv % U;
    for (int v0 = 0; v0 < nv_full; v0 += U) {
        float c[U][KP];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long coef = vt[v0 + u].coef;
#pragma unroll
            for (int k = 0; k < KP; ++k) c[u][k] = term_coef<CLAMP>(planes, coef, idx[k]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int d = vt[v0 + u].x;
#pragma unroll
            for (int k = 0; k < KP; ++k) acc[k] = fmaf(c[u][k], xs[xb[k] + d], acc[k]);
        }
    }
    for (int v = nv_full; v < nv; ++v) {
        const VPlane e = vt[v];
#pragma unroll
        for (int k = 0; k < KP; ++k)
            acc[k] = fmaf(term_coef<CLAMP>(planes, e.coef, idx[k]), xs[xb[k] + e.x], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < KP; ++k) {
        const int p = tid + k * kThreads13;
        if (p < P) y[i0 + p] = b != nullptr ? acc[k] - b[i0 + p] : acc[k];
    }
}

template <typename T, bool CLAMP>
__global__ void __launch_bounds__(kThreads13, 3)
stencil_tile_kernel(const T* __restrict__ planes, const float* __restrict__ x,
                    const float* __restrict__ b, float* __restrict__ y, int gz, int gy,
                    int gx, int sym, int r, int rows_max, int cols_max,
                    const __grid_constant__ StencilOffsets o) {
    const int nv = sym ? 2 * o.n + 1 : o.n;
    const TileLayout L = tile_layout(nv, r, rows_max, cols_max);
    extern __shared__ __align__(16) unsigned char smem[];
    VPlane* vt = reinterpret_cast<VPlane*>(smem);
    float* xs = reinterpret_cast<float*>(smem + L.off_x);
    const int tid = threadIdx.x, nt = kThreads13;

    // the tile: a contiguous run [i0, i0 + P) of the grid
    const int n_xt = (gx + cols_max - 1) / cols_max, n_yt = (gy + rows_max - 1) / rows_max;
    const int xt = blockIdx.x % n_xt, yt = (blockIdx.x / n_xt) % n_yt;
    const int z = blockIdx.x / (n_xt * n_yt);
    const int x0 = xt * cols_max, y0 = yt * rows_max;
    const int cols = min(cols_max, gx - x0), rows = min(rows_max, gy - y0);
    const int P = rows * cols;
    const long long n = (long long)gz * gy * gx;
    const long long i0 = ((long long)z * gy + y0) * gx + x0;

    for (int v = tid; v < nv; v += nt) {
        int pl = v, s = 1, j = v;
        if (sym) {
            j = v == 0 ? 0 : (v - 1) >> 1;
            pl = v == 0 ? 0 : j + 1;
            s = v == 0 ? 0 : (v & 1) ? 1 : -1;
        }
        const int dz = s * o.dz[j], dy = s * o.dy[j], dx = s * o.dx[j];
        // K1's backward term reads C_o at i - o
        const long long shift = s < 0 ? ((long long)dz * gy + dy) * gx + dx : 0;
        vt[v] = VPlane{pl * n + shift, dz * L.sz + dy * L.sy + dx, 0};
    }
    // x over the tile and its halo, zero outside the grid: a warp per row
    for (int row = tid / 32; row < (2 * r + 1) * (rows_max + 2 * r); row += nt / 32) {
        const int sz = row / (rows_max + 2 * r), sy = row % (rows_max + 2 * r);
        const int zz = z - r + sz, yy = y0 - r + sy;
        const bool row_ok = zz >= 0 && zz < gz && yy >= 0 && yy < gy;
        const float* src = x + ((size_t)(row_ok ? zz : 0) * gy + (row_ok ? yy : 0)) * gx;
        for (int sx = tid % 32; sx < L.sy; sx += 32) {
            const int xx = x0 - r + sx;
            const bool ok = row_ok && xx >= 0 && xx < gx;
            cp_async4(xs + sz * L.sz + sy * L.sy + sx, ok ? src + xx : x, ok);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    tile_terms<CLAMP>(planes, vt, xs, nv, (int)i0, P, cols, r, L, b, y);
}

namespace {

// The largest dynamic shared memory granted so far, per kernel instance.
template <typename T, bool CLAMP>
int& smem_granted() {
    static int bytes = 48 * 1024;
    return bytes;
}

template <typename T, bool CLAMP>
cudaError_t launch_tile(const void* planes, const float* x, const float* b, float* y,
                        int gz, int gy, int gx, int sym, int r, int rows, int cols,
                        const StencilOffsets& o, cudaStream_t stream) {
    const TileLayout L = tile_layout(sym ? 2 * o.n + 1 : o.n, r, rows, cols);
    if (L.bytes > smem_granted<T, CLAMP>()) {
        const cudaError_t e = cudaFuncSetAttribute(
            stencil_tile_kernel<T, CLAMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            L.bytes);
        if (e != cudaSuccess) return e;
        smem_granted<T, CLAMP>() = L.bytes;
    }
    const long long blocks =
        (long long)((gx + cols - 1) / cols) * ((gy + rows - 1) / rows) * gz;
    stencil_tile_kernel<T, CLAMP><<<(unsigned)blocks, kThreads13, L.bytes, stream>>>(
        static_cast<const T*>(planes), x, b, y, gz, gy, gx, sym, r, rows, cols, o);
    return cudaGetLastError();
}

int launch_checked(const void* planes, int planes_bf16, const float* x, const float* b,
                   float* y, int gz, int gy, int gx, int sym, int n, const int* offs,
                   int rows, int cols, void* stream) {
    StencilOffsets o;
    if (!make_offsets(n, offs, sym ? MFMG_MAX_POS : MFMG_MAX_OFF, o) || (!sym && n < 1))
        return (int)cudaErrorInvalidValue;
    int r = 0;
    for (int j = 0; j < 3 * n; ++j) r = max(r, abs(offs[j]));
    if (rows < 1 || cols < 1 || (rows > 1 && cols < gx) || rows * cols > kMaxTile ||
        tile_layout(sym ? 2 * n + 1 : n, r, rows, cols).bytes > 227 * 1024)
        return (int)cudaErrorInvalidValue;
    // a backward read C_o[i - o] can fall before the planes only where the
    // flat shift of an offset exceeds a plane (grids of a few points a side)
    const bool clamp = sym && (long long)r * ((long long)gy * gx + gx + 1) >
                                  (long long)gz * gy * gx;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (planes_bf16)
        e = clamp ? launch_tile<__nv_bfloat16, true>(planes, x, b, y, gz, gy, gx, sym, r, rows, cols, o, s)
                  : launch_tile<__nv_bfloat16, false>(planes, x, b, y, gz, gy, gx, sym, r, rows, cols, o, s);
    else
        e = clamp ? launch_tile<float, true>(planes, x, b, y, gz, gy, gx, sym, r, rows, cols, o, s)
                  : launch_tile<float, false>(planes, x, b, y, gz, gy, gx, sym, r, rows, cols, o, s);
    return (int)e;
}

}  // namespace

extern "C" {

// K3: y = sum_o C_o x(i + o) over (n_off, gz, gy, gx) planes; offs holds
// n_off (dz, dy, dx) triples of radius <= 3; (rows, cols) the tile plan.
// Returns the cudaError_t of the launch (0 on success).
int mfmg_stencil_apply(const void* planes, int planes_bf16, const float* x, float* y,
                       int gz, int gy, int gx, int n_off, const int* offs, int rows,
                       int cols, void* stream) {
    return launch_checked(planes, planes_bf16, x, nullptr, y, gz, gy, gx, 0, n_off, offs,
                          rows, cols, stream);
}

// K1: y = A x - b (b may be null) over the (1 + n_pos, gz, gy, gx) center
// and positive planes.
int mfmg_stencil_apply_sym(const void* planes, int planes_bf16, const float* x,
                           const float* b, float* y, int gz, int gy, int gx, int n_pos,
                           const int* offs, int rows, int cols, void* stream) {
    return launch_checked(planes, planes_bf16, x, b, y, gz, gy, gx, 1, n_pos, offs, rows,
                          cols, stream);
}

const char* mfmg_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
