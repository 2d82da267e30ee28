// The ELL apply y = A x: one pass over the stored (n_rows, L) rows of
// (value, column).
//
// Replaces no Pallas kernel: the reference's ell_spmv
// (mfmg_tpu/ops/sparse.py:48-51) is an XLA gather and row sum.  The port
// ran it as four PyTorch kernels per apply (the int32 -> int64 cast of the
// columns that aten::index makes, the gather, the products, the row sums),
// each a pass through device memory, at 12% of the byte bound on the
// ball's fine operator (232,609 x 27), where the ELL applies held 70% of
// a solve's device time.  This kernel is that apply in one launch.
//
// What bounds it on an H100: bytes.  An apply reads every stored value and
// column once (n_rows * L * 8 bytes in float32: 50 MB at 232,609 x 27,
// as much as the L2) and x and y once: ~15 us at 3.35 TB/s, against 2
// flops an entry (12.6 Mflop, 0.2 us at 67 TFLOP/s).
//
// Design: every stored byte read once, with 16-byte loads; only y written.
// * A block owns `rows` consecutive rows (ell_plan in ops/sparse.py, from
//   (n_rows, L) and the SM count), so one contiguous span of vals and one
//   of cols.  It streams its span in passes of kChunk entries: each thread
//   loads kUnits (2) 16-byte vectors of values and of columns (float4 and
//   int4; double2 and int2 in float64), all issued before any is used, gathers
//   x[col] through the read-only path (x, 0.93 MB on the ball, stays in
//   L2), and writes the products into shared memory, a word of padding
//   after every 32 so that the row sums below read without bank conflicts
//   whatever L is (rows of 16 entries read by one lane each otherwise met
//   16 to a bank).  `rows` is a multiple of the vector width, so every span
//   starts on a vector; buffers that do not start on 16 bytes (a view at an
//   offset) take scalar loads, and so does the matrix's last partial vector.
// * Then `lanes` threads per row (a power of two <= 32, from L) sum the
//   row's products in the pass, lane l the terms l, l + lanes, ... in
//   order, add across the lanes by a butterfly of shuffles, and lane 0 adds
//   the sum to the row's total in shared memory.  A row longer than a pass
//   (L > kChunk / V: 512 entries) is summed pass by pass, in
//   order; every other row lies in one pass.  The block then writes its
//   totals to y, coalesced.
// * The float32 kernel is held to 32 registers, so that 8 blocks fill an
//   SM.  Of the variants timed on an H100 (4 or 8 vectors a thread, lanes
//   for 2 to 32 terms a row, without the bound, without the padding) this
//   one took least device time on the ball's fine operator (24.5 us), a
//   65^3 operator and a 16-wide R^T; float64 ran faster without the bound.
// * Sums are in the values' type, in a fixed order: two applies give the
//   same bits.  Padded entries (value 0, column 0) are read like any other.
// No intermediate goes to device memory and no column is cast.
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // ELL_THREADS in ops/sparse.py
constexpr int kUnits = 2;      // ELL_UNITS: 16-byte vectors per thread and pass
constexpr int kMaxSmem = 48 * 1024;
// blocks per SM the float32 kernel is compiled for (<= 32 registers: the
// whole SM's 2,048 threads); float64 keeps the registers it wants
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 8 : 1;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
    static constexpr int n = 4;
};
template <>
struct Vec16<double> {
    static constexpr int n = 2;
};

__device__ __forceinline__ void load_vec(const float* v, const int* c, float* vo, int* co) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(v));
    const int4 b = __ldg(reinterpret_cast<const int4*>(c));
    vo[0] = a.x; vo[1] = a.y; vo[2] = a.z; vo[3] = a.w;
    co[0] = b.x; co[1] = b.y; co[2] = b.z; co[3] = b.w;
}

__device__ __forceinline__ void load_vec(const double* v, const int* c, double* vo, int* co) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(v));
    const int2 b = __ldg(reinterpret_cast<const int2*>(c));
    vo[0] = a.x; vo[1] = a.y;
    co[0] = b.x; co[1] = b.y;
}

// a pass's entry f in shared memory, one word of padding after every 32: the
// lanes of a warp that read rows L entries apart meet on no bank for any L
__device__ __forceinline__ int skew(int f) { return f + (f >> 5); }

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                    const T* __restrict__ x, T* __restrict__ y, int n_rows, int L,
                    int rows, int lanes) {
    constexpr int V = Vec16<T>::n;
    constexpr int kChunk = kThreads * kUnits * V;
    extern __shared__ __align__(16) unsigned char smem[];
    T* prod = reinterpret_cast<T*>(smem);  // a pass's products, skewed
    T* acc = prod + kChunk + kChunk / 32;  // the block's row totals
    const int r0 = blockIdx.x * rows;
    const int nr = min(rows, n_rows - r0);
    const long long span = (long long)nr * L;
    const T* vb = vals + (long long)r0 * L;
    const int* cb = cols + (long long)r0 * L;
    for (int i = threadIdx.x; i < nr; i += kThreads) acc[i] = T(0);
    const int group = threadIdx.x / lanes, lane = threadIdx.x % lanes;
    const int n_groups = kThreads / lanes;
    for (long long c0 = 0; c0 < span; c0 += kChunk) {
        const int cn = (int)min((long long)kChunk, span - c0);
        T v[kUnits][V];
        int c[kUnits][V];
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
            const int e = (threadIdx.x + k * kThreads) * V;
            if (kVec && e + V <= cn) {
                load_vec(vb + c0 + e, cb + c0 + e, v[k], c[k]);
            } else {
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    const bool in = e + i < cn;
                    v[k][i] = in ? __ldg(vb + c0 + e + i) : T(0);
                    c[k][i] = in ? __ldg(cb + c0 + e + i) : 0;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
            const int e = (threadIdx.x + k * kThreads) * V;
#pragma unroll
            for (int i = 0; i < V; ++i)
                if (e + i < cn) prod[skew(e + i)] = v[k][i] * __ldg(x + c[k][i]);
        }
        __syncthreads();
        // the block's rows this pass holds: rf..rl; every warp runs the same
        // iterations, so the shuffles see all their lanes
        const int rf = (int)(c0 / L), rl = (int)((c0 + cn - 1) / L);
        for (int r1 = rf; r1 <= rl; r1 += n_groups) {
            const int r = r1 + group;
            T s = T(0);
            if (r <= rl) {
                const int a = (int)(max((long long)r * L, c0) - c0);
                const int b = (int)(min((long long)(r + 1) * L, c0 + cn) - c0);
                for (int j = a + lane; j < b; j += lanes) s += prod[skew(j)];
            }
            for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            if (r <= rl && lane == 0) acc[r] += s;
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < nr; i += kThreads) y[r0 + i] = acc[i];
}

template <typename T>
int launch_ell(const void* vals, const int* cols, const void* x, void* y, int n_rows,
               int L, const int* plan, cudaStream_t s) {
    constexpr int V = Vec16<T>::n;
    const int rows = plan[0], lanes = plan[1], chunk = plan[2], threads = plan[3];
    const int blocks = plan[4], smem = plan[5];
    // the plan must hold every row once, in blocks whose spans start on a
    // vector, with a power-of-two group of lanes inside a warp
    if (n_rows < 1 || L < 1 || threads != kThreads || chunk != kThreads * kUnits * V ||
        rows < 1 || rows % V || rows > chunk || lanes < 1 || lanes > 32 ||
        (lanes & (lanes - 1)) || blocks != (n_rows + rows - 1) / rows ||
        smem != (int)sizeof(T) * (chunk + chunk / 32 + rows) || smem > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    const bool vec = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cols) % (4 * V) == 0;
    const T* v = static_cast<const T*>(vals);
    const T* xx = static_cast<const T*>(x);
    T* yy = static_cast<T*>(y);
    if (vec)
        ell_spmv_kernel<T, true><<<blocks, kThreads, smem, s>>>(v, cols, xx, yy, n_rows, L,
                                                                rows, lanes);
    else
        ell_spmv_kernel<T, false><<<blocks, kThreads, smem, s>>>(v, cols, xx, yy, n_rows, L,
                                                                 rows, lanes);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (n_rows) = A x for the row-major (n_rows, L) vals (float32, or float64
// where f64) and int32 cols; plan = the six fields of EllPlan
// (ops/sparse.py ell_plan).  Returns the cudaError_t of the launch (0 on
// success).
int mfmg_ell_spmv(int f64, const void* vals, const int* cols, const void* x, void* y,
                  int n_rows, int L, const int* plan, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return f64 ? launch_ell<double>(vals, cols, x, y, n_rows, L, plan, s)
               : launch_ell<float>(vals, cols, x, y, n_rows, L, plan, s);
}

}  // extern "C"
