// The sum-factorised Q_k apply y = A u (ops/sumfac.py sumfac_apply) in
// two launches: a cell pass and a node pass.
//
// Replaces no Pallas kernel: the reference's apply (mfmg_tpu/ops/sumfac.py)
// is plain XLA.  The port ran it as ~520 PyTorch operations an apply (18
// one-axis contractions as 3-wide SGEMMs on permuted copies, a batched
// gemv for the metric, the gather and the fixed-order sums), each a pass
// through device memory: 3.28 ms an apply on the Q2 cube at 65^3 nodes,
// 270x its byte bound, 99% of that cell's device time.
//
// What bounds it on an H100: bytes.  An apply reads the per-cell metric
// K (n_cells x n_q x 3 x 3, 31.9 MB in float32 at 32^3 Q2 cells, 75% of
// the bytes), the int64 cells (7.1 MB), u, the flags and the diagonal,
// and writes y: 42.5 MB, 12.7 us at 3.35 TB/s, against 114 Mflop (1.7 us
// at 67 TFLOP/s: 2.7 flops a byte, the card's float32 ratio is 20).  K and
// the cells are read as SumFactoredOperator stores them.
//
// Design: K and the cells read once, coalesced; every intermediate of the
// contractions stays in shared memory or registers.
// * The cell pass: a block owns kCells consecutive cells (a multiple of 4,
//   so that every block's K starts on 16 bytes) and one thread per point of
//   each cell's N^3 box (N = max(n1, nq1)).  It gathers u by the cells (0
//   at the flagged dofs), whose dependent loads go out first, stages its
//   cells' K into shared memory with 16-byte loads, runs the 1-D passes on
//   x, then y, then z, sharing the
//   partial contractions of the three gradients (D_x u and V_x u; then
//   D_y V_x u, V_y V_x u and V_y D_x u), holds each point's gradient in
//   registers through the 3x3 metric, integrates back the same way
//   (x, then y with the two gradients that meet there summed, then z),
//   and writes each cell's n1^3 results to y_loc in one coalesced store.
// * The node pass: a thread a dof sums its y_loc entries in the order of
//   the incidence (ops/local_apply.py ``incidence``, as int32 offsets and
//   positions), or writes diag * u at a flagged dof.
// Two extra streams of bytes, y_loc out and in (3.5 MB each) and the
// incidence (4.6 MB), are the price of summing without atomics: every
// sum is taken in a fixed order, so two applies give the same bits.
// The float32 cell pass is held to 32 registers, so that the whole SM's
// threads can be resident.  Of the variants timed on an H100 at the Q2
// cube's 32^3 cells this one took least device time: 26.4 us, against
// 26.7 with K staged before the gather, 28.7 without the register bound
// and 29.8 with neither.
#include <cstdint>

namespace {

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
    using type = float4;
};
template <>
struct Vec16<double> {
    using type = double2;
};

template <int N1, int NQ1>
struct Cell {
    static constexpr int N = N1 > NQ1 ? N1 : NQ1;
    static constexpr int kBox = N * N * N;
    static constexpr int kLoc = N1 * N1 * N1;
    static constexpr int kQ = NQ1 * NQ1 * NQ1;
    static constexpr int kMetric = kQ * 9;
    static constexpr int kCells = (256 / kBox) & ~3;  // 32, 8, 4 at Q1, Q2, Q3
    static constexpr int kThreads = kCells * kBox;
    static_assert(kCells >= 4, "a block holds at least four cells");
};

// blocks per SM the float32 cell pass is compiled for (<= 32 registers:
// the whole SM's 2,048 threads); float64 keeps the registers it wants
template <typename T, int N1, int NQ1>
constexpr int kMinBlocks = sizeof(T) == 4 ? 2048 / Cell<N1, NQ1>::kThreads : 1;

constexpr int kNodeThreads = 256;

// The 1-D contraction along axis A (0 x, 1 y, 2 z) at the thread's point
// (iz, iy, ix) of a cell's box: sum_j M(o, j) in(line, j), o the point's
// index on the axis, M(o, j) = M[o * SO + j * SJ], NJ terms in order.
template <typename T, int N, int A, int NJ, int SO, int SJ>
__device__ __forceinline__ T line(const T* in, const T* M, int iz, int iy, int ix) {
    constexpr int st = A == 0 ? 1 : A == 1 ? N : N * N;
    const int o = A == 0 ? ix : A == 1 ? iy : iz;
    const T* l = in + (iz * N + iy) * N + ix - o * st;
    T s = M[o * SO] * l[0];
#pragma unroll
    for (int j = 1; j < NJ; ++j) s += M[o * SO + j * SJ] * l[j * st];
    return s;
}

template <typename T, int N1, int NQ1, bool kVec>
__global__ void __launch_bounds__(Cell<N1, NQ1>::kThreads, kMinBlocks<T, N1, NQ1>)
    sumfac_cell_kernel(const T* __restrict__ u, const uint8_t* __restrict__ flags,
                       const long long* __restrict__ cells, const T* __restrict__ K,
                       const T* __restrict__ V, const T* __restrict__ D,
                       T* __restrict__ y_loc, int n_cells) {
    using S = Cell<N1, NQ1>;
    constexpr int N = S::N, BOX = S::kBox, C = S::kCells, NT = S::kThreads;
    static_assert(C * S::kMetric * sizeof(T) % 16 == 0, "blocks' K starts on 16 bytes");
    __shared__ T sV[NQ1 * N1], sD[NQ1 * N1];
    __shared__ __align__(16) T sK[C * S::kMetric];
    __shared__ T buf[6][C * BOX];
    const int tid = threadIdx.x;
    const long long c0 = (long long)blockIdx.x * C;
    const int nc = (int)min((long long)C, n_cells - c0);

    // u at the block's cells' nodes, 0 at the flagged dofs, in box order
    const long long* cb = cells + c0 * S::kLoc;
    for (int e = tid; e < nc * S::kLoc; e += NT) {
        const long long d = __ldg(cb + e);
        const int i = e % S::kLoc;
        const int b = (i / (N1 * N1) * N + i / N1 % N1) * N + i % N1;
        buf[0][e / S::kLoc * BOX + b] = __ldg(flags + d) ? T(0) : __ldg(u + d);
    }
    // the block's metric: one contiguous span, 16-byte loads where aligned
    const T* kb = K + c0 * S::kMetric;
    const int nk = nc * S::kMetric;
    int k0 = 0;
    if (kVec) {
        using V16 = typename Vec16<T>::type;
        constexpr int W = 16 / sizeof(T);
        for (int i = tid; i < nk / W; i += NT)
            reinterpret_cast<V16*>(sK)[i] = __ldg(reinterpret_cast<const V16*>(kb) + i);
        k0 = nk / W * W;
    }
    for (int i = k0 + tid; i < nk; i += NT) sK[i] = __ldg(kb + i);
    for (int i = tid; i < NQ1 * N1; i += NT) {
        sV[i] = __ldg(V + i);
        sD[i] = __ldg(D + i);
    }
    __syncthreads();

    const int cl = tid / BOX, p = tid % BOX;
    const int iz = p / (N * N), iy = p / N % N, ix = p % N;
    T* const w0 = buf[0] + cl * BOX;
    T* const w1 = buf[1] + cl * BOX;
    T* const w2 = buf[2] + cl * BOX;
    T* const w3 = buf[3] + cl * BOX;
    T* const w4 = buf[4] + cl * BOX;
    T* const w5 = buf[5] + cl * BOX;
    // forward, M (nq1, n1): x: w1 = D_x u, w2 = V_x u
    if (iz < N1 && iy < N1 && ix < NQ1) {
        w1[p] = line<T, N, 0, N1, N1, 1>(w0, sD, iz, iy, ix);
        w2[p] = line<T, N, 0, N1, N1, 1>(w0, sV, iz, iy, ix);
    }
    __syncthreads();
    // y: w0 = D_y V_x u, w3 = V_y V_x u, w4 = V_y D_x u
    if (iz < N1 && iy < NQ1 && ix < NQ1) {
        w0[p] = line<T, N, 1, N1, N1, 1>(w2, sD, iz, iy, ix);
        w3[p] = line<T, N, 1, N1, N1, 1>(w2, sV, iz, iy, ix);
        w4[p] = line<T, N, 1, N1, N1, 1>(w1, sV, iz, iy, ix);
    }
    __syncthreads();
    // z: the reference gradient (t_x, t_y, t_z) at the point, then the
    // metric s_a = sum_b K[a][b] t_b
    const bool at_q = iz < NQ1 && iy < NQ1 && ix < NQ1;
    if (at_q) {
        const T tx = line<T, N, 2, N1, N1, 1>(w4, sV, iz, iy, ix);
        const T ty = line<T, N, 2, N1, N1, 1>(w0, sV, iz, iy, ix);
        const T tz = line<T, N, 2, N1, N1, 1>(w3, sD, iz, iy, ix);
        const T* k = sK + (cl * S::kQ + (iz * NQ1 + iy) * NQ1 + ix) * 9;
        w1[p] = k[0] * tx + k[1] * ty + k[2] * tz;
        w2[p] = k[3] * tx + k[4] * ty + k[5] * tz;
        w5[p] = k[6] * tx + k[7] * ty + k[8] * tz;
    }
    __syncthreads();
    // backward, M^T (n1, nq1): x: w0 = D_x^T s_x, w3 = V_x^T s_y, w4 = V_x^T s_z
    if (iz < NQ1 && iy < NQ1 && ix < N1) {
        w0[p] = line<T, N, 0, NQ1, 1, N1>(w1, sD, iz, iy, ix);
        w3[p] = line<T, N, 0, NQ1, 1, N1>(w2, sV, iz, iy, ix);
        w4[p] = line<T, N, 0, NQ1, 1, N1>(w5, sV, iz, iy, ix);
    }
    __syncthreads();
    // y: w1 = V_y^T w0 + D_y^T w3, w2 = V_y^T w4
    if (iz < NQ1 && iy < N1 && ix < N1) {
        w1[p] = line<T, N, 1, NQ1, 1, N1>(w0, sV, iz, iy, ix) +
                line<T, N, 1, NQ1, 1, N1>(w3, sD, iz, iy, ix);
        w2[p] = line<T, N, 1, NQ1, 1, N1>(w4, sV, iz, iy, ix);
    }
    __syncthreads();
    // z: y_loc = V_z^T w1 + D_z^T w2 at the cell's nodes, x fastest
    if (cl < nc && iz < N1 && iy < N1 && ix < N1)
        y_loc[(c0 + cl) * S::kLoc + (iz * N1 + iy) * N1 + ix] =
            line<T, N, 2, NQ1, 1, N1>(w1, sV, iz, iy, ix) +
            line<T, N, 2, NQ1, 1, N1>(w2, sD, iz, iy, ix);
}

template <typename T>
__global__ void __launch_bounds__(kNodeThreads)
    sumfac_node_kernel(const T* __restrict__ y_loc, const int* __restrict__ inc_ptr,
                       const int* __restrict__ inc_pos, const T* __restrict__ u,
                       const uint8_t* __restrict__ flags, const T* __restrict__ diag,
                       T* __restrict__ y, int n_dofs) {
    const int t = blockIdx.x * kNodeThreads + threadIdx.x;
    if (t >= n_dofs) return;
    if (flags[t]) {
        y[t] = diag[t] * u[t];
        return;
    }
    T s = T(0);
    for (int j = inc_ptr[t], e = inc_ptr[t + 1]; j < e; ++j) s += y_loc[inc_pos[j]];
    y[t] = s;
}

template <typename T, int N1, int NQ1>
int launch_sumfac(const void* u, const uint8_t* flags, const void* diag, const void* K,
                  const long long* cells, const void* V, const void* D, const int* inc_ptr,
                  const int* inc_pos, void* y_loc, void* y, int n_dofs, int n_cells,
                  cudaStream_t s) {
    using S = Cell<N1, NQ1>;
    const T* uu = static_cast<const T*>(u);
    T* yl = static_cast<T*>(y_loc);
    if (n_cells > 0) {
        const int blocks = (n_cells + S::kCells - 1) / S::kCells;
        const T *kk = static_cast<const T*>(K), *vv = static_cast<const T*>(V),
                *dd = static_cast<const T*>(D);
        if (reinterpret_cast<uintptr_t>(K) % 16 == 0)
            sumfac_cell_kernel<T, N1, NQ1, true>
                <<<blocks, S::kThreads, 0, s>>>(uu, flags, cells, kk, vv, dd, yl, n_cells);
        else
            sumfac_cell_kernel<T, N1, NQ1, false>
                <<<blocks, S::kThreads, 0, s>>>(uu, flags, cells, kk, vv, dd, yl, n_cells);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    sumfac_node_kernel<T><<<(n_dofs + kNodeThreads - 1) / kNodeThreads, kNodeThreads, 0, s>>>(
        yl, inc_ptr, inc_pos, uu, flags, static_cast<const T*>(diag), static_cast<T*>(y),
        n_dofs);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int n1, int nq1, const void* u, const uint8_t* flags, const void* diag,
             const void* K, const long long* cells, const void* V, const void* D,
             const int* inc_ptr, const int* inc_pos, void* y_loc, void* y, int n_dofs,
             int n_cells, cudaStream_t s) {
    if (n1 == 2 && nq1 == 2)
        return launch_sumfac<T, 2, 2>(u, flags, diag, K, cells, V, D, inc_ptr, inc_pos, y_loc,
                                      y, n_dofs, n_cells, s);
    if (n1 == 3 && nq1 == 3)
        return launch_sumfac<T, 3, 3>(u, flags, diag, K, cells, V, D, inc_ptr, inc_pos, y_loc,
                                      y, n_dofs, n_cells, s);
    if (n1 == 4 && nq1 == 4)
        return launch_sumfac<T, 4, 4>(u, flags, diag, K, cells, V, D, inc_ptr, inc_pos, y_loc,
                                      y, n_dofs, n_cells, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y (n_dofs) = A u of the 3-D sum-factorised operator: u, diag, K
// (n_cells, nq1^3, 3, 3), V and D (nq1, n1) float32, or float64 where f64;
// flags the (n_dofs) Dirichlet bools; cells (n_cells, n1^3) int64; the
// incidence as int32 offsets (n_dofs + 1) and positions into y_loc, the
// (n_cells * n1^3) scratch.  (n1, nq1) is (2, 2), (3, 3) or (4, 4).
// Returns the cudaError_t of the launches (0 on success).
int mfmg_sumfac_apply(int f64, int n1, int nq1, const void* u, const void* flags,
                      const void* diag, const void* K, const void* cells, const void* V,
                      const void* D, const int* inc_ptr, const int* inc_pos, void* y_loc,
                      void* y, int n_dofs, int n_cells, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_dofs < 1 || n_cells < 0) return (int)cudaErrorInvalidValue;
    const uint8_t* fl = static_cast<const uint8_t*>(flags);
    const long long* cl = static_cast<const long long*>(cells);
    return f64 ? dispatch<double>(n1, nq1, u, fl, diag, K, cl, V, D, inc_ptr, inc_pos, y_loc,
                                  y, n_dofs, n_cells, s)
               : dispatch<float>(n1, nq1, u, fl, diag, K, cl, V, D, inc_ptr, inc_pos, y_loc,
                                 y, n_dofs, n_cells, s);
}

}  // extern "C"
