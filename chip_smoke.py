"""Smoke run of the mfmg_torch main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check or exception exits non-zero before the last line;
each phase prints its wall time):
 1. the card (nvidia-smi name and power limit), torch and CUDA versions;
 2. build the CUDA kernels from mfmg_torch/csrc (nvcc, sm_90a) and, beside
    them, the host library from mfmg_torch/csrc/host (g++), timed, with the
    host library's threads per call;
 3. kernels against their plain PyTorch versions at the 65^3 main-path
    shapes: K1 (bf16 and f32 planes) and K2 (with and without the residual;
    its two forms, blocked and chain, timed in turns), with the
    median time of each over 50 runs (CUDA events), K1's library
    yardstick (one cuSPARSE CSR SpMV of the assembled float32 matrix); K1
    and K2's chain at 171 pairs on a Q3 stencil (49^3 nodes, its planes
    symmetrized: radius 3, the kernels' largest offset table); and
    the fused coarse tail in both modes (full tail, sub-cycle), both
    level-1 -> 2 forms (dense, windowed) and both storages (f32, bf16) on
    the 17^3 and 33^3 hierarchies (every tail check also launches it twice
    and requires the same bits); windowed bf16 random tails whose coarse
    correction is a hierarchy-like share of the output (32^3 and 13x17x11
    level-1 sites) held on seeds 7-11 to the float64 plain version with the
    same bf16 rounding points, under the limit the rounding check measures
    on each input (tests/_torch_tails.py rounding_limit);
 4. a small-input reference: the 17^3 main-path hierarchy on the GPU against
    the same hierarchy on the CPU (plain versions, the same bf16 tail; both
    set up by the host route), and against the CPU's generic recursion
    within the bf16 storage's gap; then the 17^3 hierarchy set up by the
    device route on the card against the same pipeline run on the CPU with
    the card's probe block (V-cycle and PCG count);
 5. the main path at 65^3 (274,625 dofs): Hierarchy(..., device="cuda"),
    whose level 0 must take the device setup route (eigen/device_eig.py;
    setup seconds per stage, setup's peak device memory apart from the
    solve's), with the full-mode tail, solve_cg(tol=1e-5, maxiter=50), the
    true residual in
    float64 on the host, the launch counts (the tail once per V-cycle), the
    tail against its plain version at these shapes (and the windowed
    level-1 -> 2 form, timed beside the dense one), the median ms per
    V-cycle with the tail and with the generic recursion in turns, and the
    PCG count with K2's plain version as the smoother, and the V-cycle
    with K2 as its rule routes it against either form for every call, in
    turns;
 6. the main path at 129^3 (2,146,689 dofs): the same (device route) with
    the sub-cycle-mode tail (windowed level-1 -> 2 inside the kernel) and
    the fine transfer
    through K4/K5 (once each per V-cycle), setup seconds per stage, peak
    device memory, and K1 (which stands for the reference's z-tiled
    pallas_stencil_apply_tiled_sym there), K2 (which stands for
    pallas_cheb_smooth_tiled), the tail, K3 on the 129^3 operator as 27
    one-sided planes (which stands for pallas_stencil_apply_tiled) and
    K4/K5 (float32 and bf16 weights, with cuSPARSE yardsticks of R and R^T;
    K4 and K5 repeat their bits) against their plain versions at these
    shapes; the sub-cycle tail on seeds 7-11 against the float64 plain
    version under its rounding limit (as in phase 3); the V-cycle and its
    device time with K4/K5 and with their plain versions, in turns;
 7. the Q2 paths (fe_degree 2, 65^3 nodes, 274,625 dofs, 125 offsets):
    (a) the main configuration on the Q2 cube, with the full-mode tail over
    9^3 windows (held against its plain version at these shapes, with
    K4/K5 at these windows) and the generic recursion in turns; its fine
    applies take K1/K2 or K3 as the planes come out symmetric or not on
    the host.  Where they are symmetric, K1 (62 positive planes, f32 and
    bf16) and K2 are held against their plain versions at these shapes,
    and the same cube runs again with its fine operator kept one-sided:
    every fine apply through K3 and the plain Chebyshev smoother, with the
    tail, as the reference runs it where the planes are not symmetric;
    (b) the distorted Q2 cube with two levels, one-sided on every host: K3
    (bf16 and f32 planes, cuSPARSE yardstick) against its plain version,
    then the path with every fine apply through K3 and the fine transfer
    through K4/K5, and K4/K5 (float32 and bf16 weights) at its transfer.
    The Q2 cube sets up by the device route; the one-sided cube (set up on
    the host, then moved) and the distorted cube (no shared cell matrix)
    by the host route;
 8. level-0 setup at 65^3 and 129^3: the device pipeline on the card against
    host ssyevx and the host Galerkin blocks (eigenvalue error, the
    smallest singular value of V_dev^T V_host, max |K_dev - K_host| /
    max |K_host| for the same R, under the SETUP_* limits), with the time
    of each stage; then the whole 65^3 setup by the host route and by the
    device route, in turns;
 9. the ELL operators and deeper hierarchies, each through Hierarchy and
    solve_cg as a main path: (a) the distorted Q2 cube at three levels
    (K3, K4/K5, ELL R/R^T at level 1 and an ELL level 2 of 2,048 dofs, no
    tail); (b) Q1 65^3 at four levels (K1, K2's chain, K4/K5, window
    transfers at levels 1-2, the level-2 restrictor through the per-cell
    patch path, whose seconds it prints, Hierarchy.per_cell_levels == [2];
    no tail); (c) Q1 65^3 with operator="ell" in float32 (ELL at every
    level, level 1 through the per-cell path); each with its setup route and stages, its
    levels' sizes and types, PCG counts and residuals under the reference's
    limits, the kernel launches and ELL applies of one V-cycle, the V-cycle
    in CUDA-event ms and profiler device ms, setup's peak host RSS and
    device memory; an ELL apply against one torch.sparse CSR matvec of the
    same matrix (the 65^3 fine operator, the distorted cube's level-1 R);
    (d) the library's default Config (ELL, float64, Jacobi) with
    is_preconditioner=False on hyper_cube(3, 2): its V-cycle rate on the
    card against the CPU port;
10. the unstructured meshes, each through Hierarchy and solve_cg with the
    main configuration but operator="ell" (ELL at every level, the host
    setup route, no kernel of the port: every launch count stays 0), the
    right-hand side zero at the constrained dofs: (a) hyper_ball(3, 5)
    (229,376 cells) with the 4x4x4 block walk, levels 232,609 -> 7,168 ->
    14,336 (its level-2 pseudoinverse by float64 eigh on the card), and a
    float64 hyper_ball(3, 3) hierarchy's V-cycle rate against the CPU
    port's; (b) adaptive_cube(3, 5, x, y, z < 0.5) (61,440 cells, 2,256
    hanging dofs) with n_cells // 64 RCB parts, levels 66,961 -> 1,920 ->
    3,840, its hanging slaves at 0 within 1e-8.  Each prints its mesh and
    setup seconds (per stage), setup's peak host RSS and device memory,
    agglomerate sizes, PCG count, recursive and true relres against the
    reference's (UNSTRUCTURED_REF), ELL applies per V-cycle, the V-cycle
    in CUDA-event ms and profiler device ms, and the idle share;
11. the reference's other operators and smoothers, each the main
    configuration with one change, through Hierarchy and solve_cg, its
    PCG count equal to the reference's (NEW_PATHS_REF), its levels, setup
    stages, true relres, launches and V-cycle ms (events and device):
    (a) operator="matrix_free" on Q1 65^3 (identity mode, host route, the
    fine matrix never assembled), its apply timed against its byte bound
    beside the ELL apply and K1 of the same matrix, two applies bit-equal;
    (b) operator="sumfac" on the Q2 cube, the same for its apply;
    (c) operator="matrix_free" on phase 10's adaptive cube (the condensed
    cell-wise apply); (d) multicolor symmetric Gauss-Seidel on the stencil
    path at 65^3 (8 lattice colors, the sublattice sweep; K1 in the
    residual and the outer CG, K4/K5 once per V-cycle) and on
    operator="ell" (greedy colors), level 0 by the host route; (e)
    float64 on hyper_cube(3, 2): lexicographic GS in deal.II's order
    against the golden 0.0235237332 within 1e-6 and ILU(0) against the
    CPU port within 1e-10, then one dense triangular smoothing step of
    each at 4,913 dofs, timed.
Each path is driven with the launch counts set to 0 just before it and read
just after; it fails if one of its kernels was never launched, or if K2 ran
another form than its rule gives (the blocked form for the step with the
residual at 129^3, the chain for every other step; counted per form).  The
line
before the last is the kernel table as JSON, one row per TPU kernel of the
reference (launches from the main paths' runs; bound_ms from the bytes and
operations of this run's inputs at 3.35 TB/s and 67 TFLOP/s float32, the
H100 SXM data sheet); the last line is {"ok": true, "device": {...}}.
Without CUDA, or without the mfmg_torch package beside this file, it exits
non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_REF, N_REF_LARGE = 6, 7         # 65^3 (274,625 dofs), 129^3 (2,146,689)
N_REF_Q2 = 5                      # Q2: 32^3 cells, 65^3 nodes (274,625 dofs)
PCG_TOL, PCG_MAX = 1e-5, 50
# PCG iterations to PCG_TOL with the RHS of run_main_path, per path: the
# reference's own counts (mfmg_tpu on the CPU: 9 at 65^3, 10 at 129^3, 15 at
# Q2, 16 on the distorted Q2 cube with two levels), with one to spare at Q2
# for another summation order.
PCG_ITERS_MAX = {"65^3": 9, "129^3": 10, "Q2 65^3": 16, "Q2 65^3 one-sided": 16,
                 "Q2 65^3 distorted": 17,
                 # phase 9 (scripts/reference_cpu_counts.py): 16 on the
                 # distorted cube at three levels, with the Q2 paths' spare;
                 # 9 at four levels and 9 with operator="ell"
                 "Q2 65^3 distorted 3 levels": 17, "65^3 4 levels": 9,
                 "65^3 ELL": 9}
# True residual ||b - A x|| / ||b|| in float64 of the float32 iterate.  The
# float32 CG (the reference's own algorithm) stops on its recursive residual
# (<= PCG_TOL); its true residual levels off near 2e-5 at 65^3: mfmg_tpu
# reaches 2.0e-5 on the same configuration, and the float32 rounding of an
# exact solution alone leaves 5.9e-6.  The bound is twice the reference's.
# At 129^3 mfmg_tpu (x64 on the CPU, the same configuration and RHS) takes
# 10 iterations to relres 2.61e-6 with a true relres of 8.33e-5; at Q2 65^3
# 15 iterations, 7.37e-6 and 4.93e-5 (its planes one-sided on that host, as
# on the Q2 path "one-sided"); on the distorted Q2 cube (seed 0, two levels)
# 16 iterations, 6.65e-6 and 5.46e-5.  Each bound is twice the reference's.
TRUE_RES_MAX = 4e-5
TRUE_RES_MAX_LARGE = 2 * 8.33e-5
TRUE_RES_MAX_Q2 = 2 * 4.93e-5
TRUE_RES_MAX_Q2_DISTORTED = 2 * 5.46e-5
# phase 9, twice the reference's (scripts/reference_cpu_counts.py, the same
# RHS): the distorted cube at three levels 5.453e-5 (16 iterations), Q1
# 65^3 at four levels 2.018e-5 (9), operator="ell" 2.043e-5 (9)
TRUE_RES_MAX_DISTORTED_3 = 1.09e-4
TRUE_RES_MAX_DEEP = 2 * 2.018e-5
TRUE_RES_MAX_ELL = 2 * 2.043e-5
# the default Config's V-cycle rate on the card against the CPU port (phase
# 9 (d)), and a float64 ball hierarchy's (phase 10 (a)): float64 sums in
# another order
DEFAULT_RATE_TOL = 1e-6
# phase 10, the reference's levels, PCG count and true relres on the same
# RHS (mfmg_tpu on the CPU with x64, scripts/reference_cpu_counts.py 5 1
# --operator ell --mesh ball|adaptive --partitioner block|rcb): the ball 9
# iterations, true relres 4.462e-5; the adaptive cube 10, 1.080e-5.  The
# true relres bound is twice the reference's; the hanging slaves of the
# solution stay 0 within 1e-8 (tests/test_adaptive.py:116)
N_REF_BALL, N_REF_ADAPTIVE, N_REF_BALL_RATE = 5, 5, 3
UNSTRUCTURED_REF = {
    "ball": dict(levels=[232609, 7168, 14336], pcg_iterations=9,
                 true_relres=4.462e-5),
    "adaptive": dict(levels=[66961, 1920, 3840], pcg_iterations=10,
                     true_relres=1.080e-5),
}
HANGING_TOL = 1e-8
# an ELL apply against torch.sparse's CSR matvec of the same float32 matrix
ELL_TOL = 1e-5
K1_TOL = 1e-5             # ||dy||_inf / ||y||_inf
# K3, ||dy||_inf / ||y||_inf: float32 planes; bf16 planes hold the same bound,
# since the kernel and its plain version accumulate in float32 the products
# of the same bf16-rounded planes (only the order and FMA contraction differ)
K3_TOL, K3_BF16_TOL = 1e-5, 1e-5
XFER_TOL = 1e-5           # K4/K5, ||d||_2 / ||ref||_2
K2_X_TOL, K2_RES_TOL = 1e-5, 1e-4
# fused tail: ||d||_2 / ||ref||_2, float sums over the same operands in
# another order (the bound tests/test_fused_cycle.py holds the reference's
# kernel to against its recursion)
TAIL_TOL = 1e-5
# a V-cycle with the bf16-weight tail against the generic recursion (float32
# coarse levels): the bf16 storage alone, 1.1e-3 to 1.6e-3 at 17^3 and 33^3
# (tests/test_torch_fused_cycle.py::test_bf16_tail_gap_to_generic_recursion)
BF16_STORAGE_GAP = 2e-3
N_TIMED = 50
# the level-0 device pipeline against host ssyevx (phase 8): eigenvalues to
# 1e-2 of the largest, the pipeline's eigenvectors inside the host's four
# smallest (smallest singular value), the smallest eigenvector to |dot|
# 0.999, and K = Rb A Rb^T on the same R to 1e-5 of its largest entry; the
# pipeline's CPU readings at 17^3 and 33^3 (tests/test_torch_device_eig.py):
# 1.2e-3 and 1.7e-3, 0.994, K ~1e-7
SETUP_EVAL_TOL, SETUP_SV_MIN, SETUP_V1_MIN, SETUP_K_TOL = 1e-2, 0.98, 0.999, 1e-5
# a 17^3 V-cycle set up by the device route on the card against the same
# pipeline on the CPU with the same probe block (phase 4): float32 roundoff
# of cuSOLVER against LAPACK, carried through the level-0 and level-1
# eigenvectors; read 4.5e-6 on an H100 (PERF.md)
DEVICE_ROUTE_VCYCLE_TOL = 1e-4
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12    # H100 SXM data sheet
# phase 11, the reference's levels, PCG count and true relres on the same
# RHS (mfmg_tpu on the CPU with x64, scripts/reference_cpu_counts.py:
# "6 1 --operator matrix_free", "5 2 --operator sumfac", "5 1 --operator
# matrix_free --mesh adaptive --partitioner rcb", "6 1 --smoother sgs",
# "6 1 --operator ell --smoother sgs"); the true relres bound is twice the
# reference's.  The Gauss-Seidel paths set level 0 up by the host route
# (backend="host"), as these counts do: with the reference's device
# pipeline (--device-pipeline) both take 8 iterations, but they stop at
# relres 8.24e-6 and 9.57e-6, so close to PCG_TOL that an eigensolver's
# float32 roundoff decides between 8 and 9.
NEW_PATHS_REF = {
    "matrix_free 65^3": dict(levels=[274625, 8192, 256], pcg_iterations=9,
                             true_relres=1.846e-5),
    "sumfac Q2 65^3": dict(levels=[274625, 1024, 32], pcg_iterations=15,
                           true_relres=4.673e-5),
    "matrix_free adaptive": dict(levels=[66961, 1920, 3840], pcg_iterations=10,
                                 true_relres=9.330e-6),
    "sgs stencil 65^3": dict(levels=[274625, 8192, 256], pcg_iterations=9,
                             true_relres=2.026e-5),
    "sgs ell 65^3": dict(levels=[274625, 8192, 256], pcg_iterations=9,
                         true_relres=2.011e-5),
}
# phase 11 (e): the matrix-path golden (test_hierarchy.cc:343) at the
# reference test's 1e-6, and a float64 rate on the card against the CPU port
GOLDEN_MATRIX_SGS_3D, GOLDEN_TOL, RATE_TOL_F64 = 0.0235237332, 1e-6, 1e-10


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def median_ms(fn, n=N_TIMED, batch=10, warm=5):
    """Median over n batches of the CUDA-event time per call of `batch`
    back-to-back calls (n * batch >= 50 runs)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / batch)
    return float(np.median(times))


def bound(bytes_moved, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the float32 peak."""
    tb, to = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def k1_work(planes, n):
    """K1: the planes once, x in, y out; 2 flops per plane term, each
    positive plane used twice."""
    return nbytes(planes) + 8 * n, 2 * (2 * planes.shape[0] - 1) * n


def k2_work(planes, n, degree, want_res):
    """K2: planes once, x, b, invd in, x_s (and res) out; degree applies
    plus the residual's."""
    applies = degree + int(want_res)
    return (nbytes(planes) + 4 * n * (3 + 1 + int(want_res)),
            applies * 2 * (2 * planes.shape[0] - 1) * n + 8 * degree * n)


def tail_work(ft, full):
    """Fused tail: every operand once plus the vectors in and out;
    operations of its applies, transfers and coarse solve."""
    vec = (3 * ft.n_fine if full else 2 * ft.n1) * 4
    ops = nbytes(ft.coeffs, ft.invd, ft.cheb_coef, ft.inv2, ft.Rd, ft.W2,
                 ft.W if full else None) + vec
    d, nss = ft.degree, ft.nss
    applies = (d - 1) + (nss - 1) * d + 1 + nss * d
    flops = (applies * 2 * ft.coeffs.numel()
             + 4 * (ft.Rd if ft.Rd is not None else ft.W2).numel()
             + 2 * ft.n2 ** 2 + (4 * ft.W.numel() if full else 0))
    return ops, flops


def k3_work(planes, n):
    """K3: the planes once, x in, y out; 2 flops per plane term."""
    return nbytes(planes) + 8 * n, 2 * planes.shape[0] * n


def xfer_work(W, n_fine, n_coarse):
    """K4/K5: W once, the fine and coarse vectors once each; 2 flops per
    weight."""
    return nbytes(W) + 4 * (n_fine + n_coarse), 2 * W.numel()


def csr_from_transfer(tr, device):
    """R (n_coarse, n_fine) of a 3-D StructuredTransfer and R^T, as torch
    sparse CSR tensors on the card: the operands of K4/K5's library
    yardsticks, never used by the port."""
    c, (wz, wy, wx), (gz, gy, gx) = tr.n_ev, tr.window_shape, tr.agg_shape
    _, ny, nx = tr.grid_shape
    W = tr.W.to(device=device, dtype=torch.float32)
    idx = [torch.arange(k, device=device) for k in W.shape]
    e, tz, ty, tx, az, ay, ax = torch.meshgrid(*idx, indexing="ij")
    rows = ((az * gy + ay) * gx + ax) * c + e
    cols = ((az * (wz - 1) + tz) * ny + ay * (wy - 1) + ty) * nx + ax * (wx - 1) + tx
    ij = torch.stack([rows.reshape(-1), cols.reshape(-1)])
    R = torch.sparse_coo_tensor(ij, W.reshape(-1), tr.shape, check_invariants=False)
    RT = torch.sparse_coo_tensor(ij.flip(0), W.reshape(-1), tr.shape[::-1],
                                 check_invariants=False)
    return R.coalesce().to_sparse_csr(), RT.coalesce().to_sparse_csr()


def csr_from_stencil(op, device):
    """The assembled float32 matrix of a host stencil (all offset planes,
    zeros dropped) as a torch sparse CSR tensor on the card: the operand of
    K1's library yardstick, never used by the port."""
    gz, gy, gx = op.grid_shape
    n = gz * gy * gx
    idx = torch.arange(n, device=device)
    iz, iy, ix = idx // (gy * gx), (idx // gx) % gy, idx % gx
    C = op.coeffs.to(device=device, dtype=torch.float32).reshape(len(op.offsets), n)
    rows, cols, vals = [], [], []
    for o, (dz, dy, dx) in enumerate(op.offsets):
        ok = ((iz + dz >= 0) & (iz + dz < gz) & (iy + dy >= 0) & (iy + dy < gy)
              & (ix + dx >= 0) & (ix + dx < gx) & (C[o] != 0))
        rows.append(idx[ok])
        cols.append(idx[ok] + (dz * gy + dy) * gx + dx)
        vals.append(C[o][ok])
    A = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                torch.cat(vals), (n, n),
                                check_invariants=False).coalesce()
    return A.to_sparse_csr()


def main_config(cfg, max_levels=3, backend="auto"):
    return cfg.Config(max_levels=max_levels, operator="stencil", dtype="float32",
                      coeff_dtype="bfloat16",
                      eigensolver=cfg.EigensolverConfig(
                          type="lapack", n_eigenvectors=2, n_eigenvectors_deep=4,
                          backend=backend),
                      smoother=cfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=cfg.AgglomerationConfig(nx=4, ny=4, nz=4),
                      coarse=cfg.CoarseConfig(type="direct"))


def check_setup_pipeline(label, prob, dev):
    """The device pipeline on the card against host ssyevx and the host
    Galerkin blocks on the same light batch: eigenvalues, subspaces (the
    host's n_ev + 2 smallest eigenvectors hold the pipeline's, which may
    pick its second vector inside a cluster), and K = Rb A Rb^T for the
    same R (the host eigenvectors'), with the stage times of each."""
    import mfmg_torch.config as cfg
    from mfmg_torch.amge.agglomeration import build_agglomerates
    from mfmg_torch.amge.local_problems import build_agglomerate_batch
    from mfmg_torch.amge.multilevel import _dof_row_structure, agg_galerkin_blocks
    from mfmg_torch.amge.restriction import build_restriction
    from mfmg_torch.eigen import device_eig
    from mfmg_torch.eigen.batched_eigh import batched_smallest_eigenpairs
    n_ev = 2
    t = {}
    t0 = time.perf_counter()
    ids = build_agglomerates(prob.mesh, cfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    light = build_agglomerate_batch(prob.mesh, prob.A_loc, ids,
                                    batch_dtype=np.float32,
                                    assemble_operator=False)
    t["light batch"] = time.perf_counter() - t0
    check(device_eig.supports(prob.mesh, ids, dev, geom=prob.geom),
          f"{label}: the device pipeline does not apply")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = t_mark = time.perf_counter()

    def mark(stage):
        nonlocal t_mark
        now = time.perf_counter()
        t[f"device eigensolve: {stage}"], t_mark = now - t_mark, now

    ev_d, V_d, A_d = device_eig.device_smallest_eigenpairs(
        prob, ids, light, n_ev, keep_A=True, device=dev, mark=mark)
    torch.cuda.synchronize()
    t["device eigensolve"] = time.perf_counter() - t0
    peak_eig = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    full = build_agglomerate_batch(prob.mesh, prob.A_loc, ids,
                                   batch_dtype=np.float32)
    t["host batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev_h, V_h = batched_smallest_eigenpairs(full, n_ev + 2,
                                            host_dtype=np.float32)
    t["host ssyevx (n_ev + 2)"] = time.perf_counter() - t0
    eval_err = float(np.abs(ev_d - ev_h[:, :n_ev]).max()
                     / np.abs(ev_h[:, :n_ev]).max())
    sv_pair = np.linalg.svd(np.einsum("aik,ail->akl", V_d, V_h[:, :, :n_ev]),
                            compute_uv=False).min(axis=1)
    sv_cluster = np.linalg.svd(np.einsum("aik,ail->akl", V_d, V_h),
                               compute_uv=False).min(axis=1)
    v1_dot = float(np.abs(np.einsum("ai,ai->a", V_d[:, :, 0],
                                    V_h[:, :, 0])).min())
    R = build_restriction(light, V_h[:, :, :n_ev], prob.diag_raw, prob.n_dofs)
    dof_rows, dof_vals = _dof_row_structure(R)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    blk_d = device_eig.device_galerkin_blocks(light, A_d, dof_rows, dof_vals,
                                              R.shape[0])
    torch.cuda.synchronize()
    t["device Galerkin blocks"] = time.perf_counter() - t0
    peak_gal = torch.cuda.max_memory_allocated() - base
    del A_d
    t0 = time.perf_counter()
    blk_h = agg_galerkin_blocks(full, dof_rows, dof_vals, R.shape[0],
                                eliminate=False)
    t["host Galerkin blocks"] = time.perf_counter() - t0
    check(np.array_equal(blk_d.arows, blk_h.arows)
          and np.array_equal(blk_d.t_s, blk_h.t_s)
          and np.array_equal(blk_d.Rb, blk_h.Rb),
          f"{label}: the device and host Galerkin blocks' rows differ")
    k_err = float(np.abs(blk_d.K.astype(np.float64) - blk_h.K).max()
                  / np.abs(blk_h.K).max())
    r = dict(n_agg=len(ev_d), m=V_d.shape[1], eval_err=eval_err,
             sv_min_pair=float(sv_pair.min()),
             sv_min_cluster=float(sv_cluster.min()),
             n_pair_below_099=int((sv_pair < 0.99).sum()),
             v1_dot_min=v1_dot, k_err=k_err, seconds=t,
             peak_device_gib_eigensolve=peak_eig / 2**30,
             peak_device_gib_galerkin=peak_gal / 2**30)
    print(f"{label} setup pipeline: {json.dumps(r)}", flush=True)
    check(eval_err <= SETUP_EVAL_TOL,
          f"{label}: eigenvalue error {eval_err:.3e} > {SETUP_EVAL_TOL}")
    check(r["sv_min_cluster"] >= SETUP_SV_MIN,
          f"{label}: subspace sv {r['sv_min_cluster']:.4f} < {SETUP_SV_MIN}")
    check(v1_dot >= SETUP_V1_MIN,
          f"{label}: smallest eigenvector |dot| {v1_dot:.5f} < {SETUP_V1_MIN}")
    check(k_err <= SETUP_K_TOL, f"{label}: K error {k_err:.3e} > {SETUP_K_TOL}")
    return r


def device_ms_per_cycle(hier, bd, n=20):
    """Device time per V-cycle from torch.profiler: the events that ran
    on the card (kernels, copies, fills) over n cycles, in ms per cycle,
    with the largest eight by name and every row by name."""
    by_name = device_ms_by_name(lambda: hier.vmult(bd), n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return sum(by_name.values()), [(k[:60], v) for k, v in top], by_name

def device_ms_by_name(fn, n):
    """{event name: device ms per call} from torch.profiler over n calls
    of fn after one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / n
    return by_name


class HostPeak:
    """Peak resident set size of this process while the block runs, sampled
    from /proc/self/statm every 5 ms by a thread (GiB; ``start`` the RSS
    when it began)."""

    def __init__(self):
        import threading
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self.start = self.peak = self._rss()

    @staticmethod
    def _rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30

    def _poll(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def ell_modules(hier):
    """{name: ELLMatrix} of every ELL operator and transfer in a hierarchy."""
    from mfmg_torch.ops.sparse import ELLMatrix
    return {f"L{i}.{name}" if name else f"L{i}": m
            for i, lv in enumerate(hier.levels)
            for name, m in lv.named_modules() if isinstance(m, ELLMatrix)}


def per_vcycle_launches(hier, bd, tk):
    """Kernel launches and ELL applies (forward hooks, by module) of one
    V-cycle, counts set to 0 just before it."""
    applies = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, k=k: applies.__setitem__(k, applies.get(k, 0) + 1))
        for k, m in ell_modules(hier).items()]
    tk.reset_launch_counts()
    try:
        hier.vmult(bd)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return {k: v for k, v in tk.LAUNCHES.items() if v}, applies


def unstructured_config(cfg, mesh, dtype="float32"):
    """Phase 10's configuration: the main configuration with operator="ell"
    (the stencil needs a structured mesh), the 4x4x4 block walk on a ball,
    n_cells // 64 RCB parts on a mesh with hanging nodes."""
    c = main_config(cfg, 3)
    c.operator, c.dtype, c.coeff_dtype = "ell", dtype, None
    if mesh.hanging is not None:
        c.agglomeration = cfg.AgglomerationConfig(
            partitioner="rcb", n_agglomerates=mesh.n_cells // 64)
    return c


def unstructured_rhs(prob):
    """Uniform float32 (default_rng(0)), zero at the constrained dofs
    (Dirichlet and hanging), so that the hanging slaves stay 0."""
    b = np.random.default_rng(0).uniform(size=prob.n_dofs).astype(np.float32)
    b[prob.constrained] = 0.0
    return b


def run_unstructured(label, build_mesh, cfg, tk):
    """One unstructured path of phase 10 through Hierarchy and solve_cg, the
    counts set to 0 just before and read just after: the mesh and problem
    (the caller's), setup (host route; stages, peak host RSS and device
    memory), PCG and true relres against the reference's, the hanging
    slaves, ELL applies per V-cycle, V-cycle events, profiler device time
    and idle share.  No kernel of the port runs on this path (ELL at every
    level): every count must stay 0."""
    from mfmg_torch import Hierarchy, LaplaceProblem
    ref = UNSTRUCTURED_REF[label]
    t0 = time.perf_counter()
    mesh = build_mesh()
    mesh_s = time.perf_counter() - t0
    prob = LaplaceProblem.from_mesh(mesh, "linear")
    problem_s = time.perf_counter() - t0 - mesh_s
    n_hang = 0 if mesh.hanging is None else mesh.hanging.n
    print(f"{label}: mesh {mesh_s:.2f} s ({mesh.n_cells} cells, {mesh.n_nodes} "
          f"dofs, {n_hang} hanging), problem {problem_s:.2f} s", flush=True)
    config = unstructured_config(cfg, mesh)
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with HostPeak() as rss:
        hier = Hierarchy(prob, config, device="cuda")
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b = unstructured_rhs(prob)
    t0 = time.perf_counter()
    xs, info = hier.solve_cg(b, tol=PCG_TOL, maxiter=PCG_MAX)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    sizes = [lv.op.shape[0] for lv in hier.levels]
    batch = hier._level0_eigendata[0]
    agg_sizes = [int(batch.sizes.min()), int(batch.sizes.max())]
    print(f"  setup {setup_s:.2f} s ({hier.setup_route} route, peak device "
          f"memory {setup_peak / 2**30:.3f} GiB, peak host RSS {rss.peak:.3f} "
          f"GiB from {rss.start:.3f}), levels {sizes}, {batch.n_agg} "
          f"agglomerates of {agg_sizes[0]}..{agg_sizes[1]} dofs", flush=True)
    print("  setup stages: " + ", ".join(f"{k} {v:.2f}s"
                                         for k, v in hier.setup_seconds.items()),
          flush=True)
    x64 = xs.cpu().double().numpy()
    b64 = b.astype(np.float64)
    tr = float(np.linalg.norm(b64 - prob.A @ x64) / np.linalg.norm(b64))
    hang_max = (0.0 if mesh.hanging is None
                else float(np.abs(x64[mesh.hanging.slaves]).max()))
    print(f"  solve_cg: {info['iterations']} iterations, relres "
          f"{info['relres']:.3e}, true relres (f64 host) {tr:.3e}, "
          f"{solve_s:.3f} s; largest |x| at a hanging slave {hang_max:.3e}; "
          f"launches {launches}", flush=True)
    check(hier.setup_route == "host", f"{label}: setup took the "
          f"{hier.setup_route} route, not host")
    check(sizes == ref["levels"], f"{label}: levels {sizes}, the reference's "
          f"{ref['levels']}")
    check(xs.shape == (prob.n_dofs,) and bool(torch.isfinite(xs).all()),
          f"{label}: solution not finite or of the wrong shape")
    check(all(t.is_cuda for lv in hier.levels for t in lv.buffers()),
          f"{label}: a level buffer is not on cuda")
    check(info["iterations"] == ref["pcg_iterations"],
          f"{label}: PCG took {info['iterations']} iterations, the reference "
          f"{ref['pcg_iterations']}")
    check(info["relres"] <= PCG_TOL, f"{label}: relres {info['relres']:.3e}")
    check(tr <= 2 * ref["true_relres"], f"{label}: true relres {tr:.3e} > "
          f"twice the reference's {ref['true_relres']:.3e}")
    check(hang_max <= HANGING_TOL, f"{label}: a hanging slave of the solution "
          f"is {hang_max:.3e}, not 0")
    check(not launches, f"{label}: kernels launched on the ELL path: {launches}")
    bd = torch.from_numpy(b).to("cuda")
    cycle_launches, cycle_ell = per_vcycle_launches(hier, bd, tk)
    check(not cycle_launches and cycle_ell.get("L0.op", 0) > 0,
          f"{label}: one V-cycle launched {cycle_launches}, applied {cycle_ell}")
    ms = [median_ms(lambda: hier.vmult(bd), batch=2) for _ in range(2)]
    dev_ms, dev_top, _ = device_ms_per_cycle(hier, bd)
    idle = 1.0 - dev_ms / float(np.mean(ms))
    print(f"  per V-cycle: ELL applies {cycle_ell}; V-cycle ms (CUDA events, "
          f"two medians) {ms}; device ms/cycle (profiler) {dev_ms:.4f}, idle "
          f"share {idle:.3f}; by kernel: "
          + "; ".join(f"{k} {v:.4f}" for k, v in dev_top), flush=True)
    summary = dict(n_dofs=prob.n_dofs, n_cells=mesh.n_cells, hanging=n_hang,
                   mesh_s=mesh_s, problem_s=problem_s, setup_s=setup_s,
                   setup_route=hier.setup_route, setup_stages=hier.setup_seconds,
                   setup_peak_device_gib=setup_peak / 2**30,
                   setup_peak_host_rss_gib=rss.peak,
                   host_rss_before_setup_gib=rss.start,
                   levels=sizes, n_agglomerates=batch.n_agg,
                   agglomerate_sizes=agg_sizes,
                   pcg_iterations=info["iterations"], relres=info["relres"],
                   true_relres=tr, hanging_max=hang_max, solve_s=solve_s,
                   ell_applies_per_vcycle=cycle_ell, ms_per_vcycle=ms,
                   device_ms_per_vcycle=dev_ms, device_top=dev_top,
                   device_idle_share=idle, reference=ref)
    del hier
    return summary


def ball_rate_check(cfg):
    """Phase 10 (a)'s check of the card against the CPU port: the V-cycle
    rate of a float64 ball hierarchy (hyper_ball(3, N_REF_BALL_RATE), the
    phase's configuration, is_preconditioner=False) within
    DEFAULT_RATE_TOL."""
    from mfmg_torch import Hierarchy, LaplaceProblem
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate
    from mfmg_torch.fem.mesh import hyper_ball
    prob = LaplaceProblem.from_mesh(hyper_ball(3, N_REF_BALL_RATE), "linear")
    c = unstructured_config(cfg, prob.mesh, dtype="float64")
    c.is_preconditioner = False
    rates = {dev: measure_vcycle_rate(Hierarchy(prob, c, device=dev))
             for dev in ("cuda", "cpu")}
    print(f"ball n_ref {N_REF_BALL_RATE}, float64: V-cycle rate {rates['cuda']!r} "
          f"(card) vs {rates['cpu']!r} (CPU)", flush=True)
    check(abs(rates["cuda"] - rates["cpu"]) <= DEFAULT_RATE_TOL,
          f"float64 ball rate {rates['cuda']} (card) vs {rates['cpu']} (CPU)")
    return dict(n_dofs=prob.n_dofs, rate_gpu=rates["cuda"], rate_cpu=rates["cpu"])


def unstructured_phase(cfg, tk):
    """Phase 10: (a) hyper_ball(3, N_REF_BALL) with the 4x4x4 block walk
    and the float64 rate check at N_REF_BALL_RATE; (b) adaptive_cube(3,
    N_REF_ADAPTIVE, x, y, z < 0.5) with RCB parts."""
    from mfmg_torch.fem.adaptive import adaptive_cube
    from mfmg_torch.fem.mesh import hyper_ball
    ball = run_unstructured("ball", lambda: hyper_ball(3, N_REF_BALL), cfg, tk)
    ball["rate_check"] = ball_rate_check(cfg)
    adaptive = run_unstructured(
        "adaptive", lambda: adaptive_cube(3, N_REF_ADAPTIVE,
                                          lambda c: np.all(c < 0.5, axis=1)),
        cfg, tk)
    return ball, adaptive


def new_path_config(cfg, operator="stencil", smoother=None, mesh=None):
    """Phase 11's configurations: the main configuration with the operator
    (and on a hanging mesh phase 10's RCB parts) or the smoother changed; a
    changed smoother sets level 0 up by the host route (NEW_PATHS_REF)."""
    c = main_config(cfg, backend="auto" if smoother is None else "host")
    c.operator = operator
    if mesh is not None and mesh.hanging is not None:
        c.agglomeration = cfg.AgglomerationConfig(
            partitioner="rcb", n_agglomerates=mesh.n_cells // 64)
    if smoother is not None:
        c.smoother = smoother
    return c


def run_new_path(label, prob, config, route, tk, kernels=()):
    """One path of phase 11 through Hierarchy and solve_cg, the counts set
    to 0 just before and read just after: levels, setup stages, the PCG
    count and the true relres in float64 against the reference's
    (NEW_PATHS_REF), launches of the solve and of one V-cycle (each kernel
    of `kernels` launched, no other), the V-cycle in CUDA-event ms and
    profiler device ms, and the idle share.  The right-hand side is phase
    5's (phase 10's, zero at the constrained dofs, on a hanging mesh)."""
    from mfmg_torch import Hierarchy
    ref = NEW_PATHS_REF[label]
    tk.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hier = Hierarchy(prob, config, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    assembled = prob._A is not None
    b = np.random.default_rng(0).uniform(size=prob.n_dofs).astype(np.float32)
    if prob.mesh.hanging is not None:
        b[prob.constrained] = 0.0
    t0 = time.perf_counter()
    xs, info = hier.solve_cg(b, tol=PCG_TOL, maxiter=PCG_MAX)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    sizes = [lv.op.shape[0] for lv in hier.levels]
    types = [f"{type(lv.op).__name__}/{type(lv.smoother).__name__}"
             for lv in hier.levels]
    colors = [getattr(lv.smoother, "n_colors", None) for lv in hier.levels[:-1]]
    x64 = xs.cpu().double().numpy()
    b64 = b.astype(np.float64)
    tr = float(np.linalg.norm(b64 - prob.A @ x64) / np.linalg.norm(b64))
    print(f"{label}: setup {setup_s:.2f} s ({hier.setup_route} route, "
          f"constrained mode {hier._constrained_mode()}, fine matrix assembled "
          f"in setup: {assembled}, peak device memory {setup_peak / 2**30:.3f} "
          f"GiB), levels {sizes} ({', '.join(types)}), colors per level "
          f"{colors}", flush=True)
    print("  setup stages: " + ", ".join(f"{k} {v:.2f}s"
                                         for k, v in hier.setup_seconds.items()),
          flush=True)
    print(f"  solve_cg: {info['iterations']} iterations (reference "
          f"{ref['pcg_iterations']}), relres {info['relres']:.3e}, true relres "
          f"(f64 host) {tr:.3e} (reference {ref['true_relres']:.3e}), "
          f"{solve_s:.3f} s; launches {launches}", flush=True)
    check(hier.setup_route == route, f"{label}: setup took the "
          f"{hier.setup_route} route, not {route}")
    check(sizes == ref["levels"], f"{label}: levels {sizes}, the reference's "
          f"{ref['levels']}")
    check(xs.shape == (prob.n_dofs,) and bool(torch.isfinite(xs).all()),
          f"{label}: solution not finite or of the wrong shape")
    check(all(t.is_cuda for lv in hier.levels for t in lv.buffers()),
          f"{label}: a level buffer is not on cuda")
    check(info["iterations"] == ref["pcg_iterations"],
          f"{label}: PCG took {info['iterations']} iterations, the reference "
          f"{ref['pcg_iterations']}")
    check(info["relres"] <= PCG_TOL, f"{label}: relres {info['relres']:.3e}")
    check(tr <= 2 * ref["true_relres"], f"{label}: true relres {tr:.3e} > "
          f"twice the reference's {ref['true_relres']:.3e}")
    check(set(launches) == set(kernels), f"{label}: launched {launches}, "
          f"wanted each of {kernels} and no other")
    bd = torch.from_numpy(b).to("cuda")
    cycle_launches, cycle_ell = per_vcycle_launches(hier, bd, tk)
    ms = [median_ms(lambda: hier.vmult(bd), n=10, batch=2) for _ in range(2)]
    dev_ms, dev_top, _ = device_ms_per_cycle(hier, bd, n=5)
    idle = 1.0 - dev_ms / float(np.mean(ms))
    print(f"  per V-cycle: kernel launches {cycle_launches}, ELL applies "
          f"{cycle_ell}; ms (CUDA events, two medians) {ms}; device ms "
          f"(profiler) {dev_ms:.4f}, idle share {idle:.3f}; by kernel: "
          + "; ".join(f"{k} {v:.4f}" for k, v in dev_top), flush=True)
    summary = dict(n_dofs=prob.n_dofs, setup_s=setup_s,
                   setup_route=hier.setup_route,
                   constrained_mode=hier._constrained_mode(),
                   fine_matrix_assembled_in_setup=assembled,
                   setup_stages=hier.setup_seconds,
                   setup_peak_device_gib=setup_peak / 2**30, levels=sizes,
                   level_types=types, colors=colors,
                   pcg_iterations=info["iterations"], relres=info["relres"],
                   true_relres=tr, solve_s=solve_s, launches=launches,
                   launches_per_vcycle=cycle_launches,
                   ell_applies_per_vcycle=cycle_ell, ms_per_vcycle=ms,
                   device_ms_per_vcycle=dev_ms, device_top=dev_top,
                   device_idle_share=idle, reference=ref)
    return hier, summary


def apply_timing(name, op, x, work):
    """An operator's apply on the card: two applies' bits, the median time
    in CUDA events and the profiler's device time per apply, against the
    bound of work = (bytes, flops)."""
    y1, y2 = op(x), op(x)
    torch.cuda.synchronize()
    same = bool(torch.equal(y1, y2))
    b_ms, b_by = bound(*work)
    r = dict(ms=median_ms(lambda: op(x)),
             device_ms=sum(device_ms_by_name(lambda: op(x), 20).values()),
             bound_ms=b_ms, bound_by=b_by, bytes=work[0], flops=work[1],
             same_bits=same, finite=bool(torch.isfinite(y1).all()))
    print(f"  {name} apply: {json.dumps(r)}", flush=True)
    check(r["finite"], f"{name}: non-finite apply")
    return y1, r


def new_paths_phase(cfg, tk):
    """Phase 11: the reference's other operators and smoothers on the card.
    (a) operator="matrix_free" on Q1 65^3 (identity mode, host route) with
    its apply against its bound, the ELL apply and K1 of the same problem;
    (b) operator="sumfac" on the Q2 cube; (c) operator="matrix_free" on
    phase 10's adaptive cube; (d) multicolor symmetric Gauss-Seidel on the
    stencil main path and on operator="ell" at 65^3; (e) lexicographic GS
    (deal.II order) and ILU(0) in float64 on hyper_cube(3, 2) against the
    golden and the CPU port, and one dense triangular step on
    hyper_cube(3, 4).  The matrix-free and sum-factorized applies must give
    the same bits twice."""
    from mfmg_torch import Hierarchy, LaplaceProblem
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate
    from mfmg_torch.fem.adaptive import adaptive_cube
    from mfmg_torch.ops import stencil as st
    from mfmg_torch.solve.smoothers import build_smoother
    out = {}
    sgs = cfg.SmootherConfig(type="symmetric gauss-seidel")

    # (a) matrix-free Q1 65^3
    prob = LaplaceProblem.hyper_cube(3, N_REF, material_property="linear")
    hier, out["matrix_free 65^3"] = run_new_path(
        "matrix_free 65^3", prob, new_path_config(cfg, "matrix_free"), "host", tk)
    check(not out["matrix_free 65^3"]["fine_matrix_assembled_in_setup"],
          "matrix_free 65^3: setup assembled the fine matrix")
    op = hier.levels[0].op
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        prob.n_dofs)).to("cuda", torch.float32)
    n = prob.n_dofs
    y_mf, r_mf = apply_timing("matrix_free", op, x, (
        nbytes(op.A_loc, op.cells) + 8 * n, 2 * op.A_loc.numel()))
    ell = prob.ell_operator(dtype=torch.float32, device="cuda")
    y_ell, r_ell = apply_timing("ell (same A)", ell, x, (
        nbytes(ell.vals, ell.cols) + 8 * n, 2 * ell.vals.numel()))
    k1 = st.stencil_to_device(st.stencil_from_cell_matrices(
        prob.mesh, prob.A_loc, prob.constrained, prob.diag_raw,
        dtype=torch.float32), "cuda")
    y_k1, r_k1 = apply_timing("K1 (same A, f32 planes)", k1, x,
                              k1_work(k1.planes, n))
    for name, y in (("ell", y_ell), ("K1", y_k1)):
        rel = float((y_mf - y).abs().max() / y.abs().max())
        print(f"  matrix_free against {name}: |dy|/|y| {rel:.3e}", flush=True)
        check(rel <= ELL_TOL, f"matrix_free apply against {name}: {rel:.3e}")
    check(r_mf["same_bits"], "matrix_free: two applies differ")
    out["matrix_free 65^3"]["applies"] = dict(matrix_free=r_mf, ell=r_ell,
                                              k1=r_k1)
    del hier, op, ell, k1, prob

    # (b) sum-factorized Q2 cube
    prob = LaplaceProblem.hyper_cube(3, N_REF_Q2, degree=2,
                                     material_property="linear")
    hier, out["sumfac Q2 65^3"] = run_new_path(
        "sumfac Q2 65^3", prob, new_path_config(cfg, "sumfac"), "host", tk)
    op = hier.levels[0].op
    n_cells, n_q = op.K.shape[:2]
    n1, nq1 = op.V.shape[1], op.V.shape[0]
    # per cell: dim directions x dim 1-D contractions forward and backward
    # (at most n1^2 x nq1 multiply-adds on (n1 or nq1)^2 lines each), the
    # 3x3 metric
    flops = n_cells * (2 * 9 * 2 * nq1 ** 3 * n1 + 2 * 9 * n_q)
    x = torch.from_numpy(np.random.default_rng(22).standard_normal(
        prob.n_dofs)).to("cuda", torch.float32)
    _, r_sf = apply_timing("sumfac", op, x, (
        nbytes(op.K, op.cells, op.V, op.D) + 8 * prob.n_dofs, flops))
    check(r_sf["same_bits"], "sumfac: two applies differ")
    out["sumfac Q2 65^3"]["applies"] = dict(sumfac=r_sf)
    del hier, op, prob

    # (c) matrix-free on the adaptive cube (the condensed cell-wise apply)
    mesh = adaptive_cube(3, N_REF_ADAPTIVE, lambda c: np.all(c < 0.5, axis=1))
    prob = LaplaceProblem.from_mesh(mesh, "linear")
    hier, out["matrix_free adaptive"] = run_new_path(
        "matrix_free adaptive", prob,
        new_path_config(cfg, "matrix_free", mesh=mesh), "host", tk)
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(
        prob.n_dofs)).to("cuda", torch.float32)
    op = hier.levels[0].op
    _, r_ad = apply_timing("matrix_free adaptive", op, x, (
        nbytes(op.A_loc, op.cells) + 8 * prob.n_dofs, 2 * op.A_loc.numel()))
    check(r_ad["same_bits"], "matrix_free adaptive: two applies differ")
    out["matrix_free adaptive"]["applies"] = dict(matrix_free=r_ad)
    del hier, op, prob

    # (d) multicolor symmetric Gauss-Seidel at 65^3: the stencil main path
    # (lattice colors, the sublattice sweep; K1 in the residual and the
    # outer CG, K4/K5 the fine transfer) and operator="ell" (greedy colors)
    prob = LaplaceProblem.hyper_cube(3, N_REF, material_property="linear")
    hier, out["sgs stencil 65^3"] = run_new_path(
        "sgs stencil 65^3", prob, new_path_config(cfg, smoother=sgs), "host",
        tk, kernels=("stencil_apply_sym", "structured_restrict",
                     "structured_prolong"))
    s = out["sgs stencil 65^3"]
    n_cyc = s["pcg_iterations"] + 1
    check(s["colors"][0] == 8
          and s["launches"].get("structured_restrict") == n_cyc
          and s["launches"].get("structured_prolong") == n_cyc
          and s["launches_per_vcycle"].get("stencil_apply_sym") == 1,
          f"sgs stencil 65^3: colors {s['colors']}, launches {s['launches']}, "
          f"per V-cycle {s['launches_per_vcycle']}")
    del hier
    hier, out["sgs ell 65^3"] = run_new_path(
        "sgs ell 65^3", prob, new_path_config(cfg, "ell", smoother=sgs),
        "host", tk)
    del hier, prob

    # (e) lexicographic GS and ILU(0), float64, on the card
    prob = LaplaceProblem.hyper_cube(3, 2, material_property="constant")

    def cfg_3d(smoother):
        return cfg.Config(operator="ell", is_preconditioner=False,
                          eigensolver=cfg.EigensolverConfig(type="lapack",
                                                            n_eigenvectors=2),
                          smoother=smoother,
                          agglomeration=cfg.AgglomerationConfig(nx=2, ny=2, nz=2))

    lex = cfg.SmootherConfig(type="gauss-seidel", coloring="lexicographic",
                             ordering="dealii")
    rate_gs = measure_vcycle_rate(Hierarchy(prob, cfg_3d(lex)))
    ilu = cfg.SmootherConfig(type="ilu")
    rate_ilu = {dev: measure_vcycle_rate(Hierarchy(prob, cfg_3d(ilu), device=dev))
                for dev in ("cuda", "cpu")}
    print(f"lexicographic GS (deal.II order): rate {rate_gs!r} (golden "
          f"{GOLDEN_MATRIX_SGS_3D}); ILU(0): rate {rate_ilu['cuda']!r} (card) "
          f"vs {rate_ilu['cpu']!r} (CPU)", flush=True)
    check(abs(rate_gs - GOLDEN_MATRIX_SGS_3D) <= GOLDEN_TOL,
          f"lexicographic GS rate {rate_gs} against the golden "
          f"{GOLDEN_MATRIX_SGS_3D}")
    check(abs(rate_ilu["cuda"] - rate_ilu["cpu"]) <= RATE_TOL_F64,
          f"ILU rate {rate_ilu['cuda']} (card) vs {rate_ilu['cpu']} (CPU)")
    steps = {}
    prob4 = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    op4 = prob4.ell_operator(device="cuda")
    xb = torch.from_numpy(np.random.default_rng(24).uniform(
        size=prob4.n_dofs)).to("cuda")
    for name, scfg in (("symmetric gauss-seidel lexicographic",
                        cfg.SmootherConfig(type="symmetric gauss-seidel",
                                           coloring="lexicographic")),
                       ("ilu", ilu)):
        t0 = time.perf_counter()
        sm = build_smoother(op4, scfg, dtype=torch.float64, A_scipy=prob4.A,
                            problem=prob4)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        steps[name] = dict(setup_s=setup, n=prob4.n_dofs,
                           ms=median_ms(lambda: sm.apply(op4, xb, xb), n=10,
                                        batch=2))
    print(f"dense triangular steps at {prob4.n_dofs} dofs: {json.dumps(steps)}",
          flush=True)
    out["dense triangular"] = dict(rate_gs_dealii=rate_gs, rate_ilu=rate_ilu,
                                   steps=steps)
    return out


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== phase {self.name}", flush=True)

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run needs "
              "an NVIDIA GPU", flush=True)
        sys.exit(2)
    import mfmg_torch.config as cfg
    from mfmg_torch import Hierarchy, LaplaceProblem, native
    from mfmg_torch.amge.hierarchy import LevelData
    from mfmg_torch.eigen import device_eig
    from mfmg_torch.ops import fused_cycle as fc
    from mfmg_torch.ops import stencil as st
    from mfmg_torch.ops import stencil_kernels as tk
    from mfmg_torch.ops import transfer_kernels as ttk
    from mfmg_torch.ops.structured_transfer import GeneralWindowTransfer
    from mfmg_torch.solve.smoothers import (FusedChebyshevSmoother,
                                            build_smoother, fuse_chebyshev)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import _torch_tails as tt
    from _torch_stencils import symmetrize

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    problems = {}

    def problem(key):
        """The problems several phases share, built once."""
        if key not in problems:
            kw = dict(material_property="linear")
            if key == "65^3":
                problems[key] = LaplaceProblem.hyper_cube(3, N_REF, **kw)
            elif key == "Q2 distorted":
                problems[key] = LaplaceProblem.hyper_cube(
                    3, N_REF_Q2, degree=2, distort_random=True, seed=0, **kw)
        return problems[key]

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    variants = {}

    def rel2(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    def check_k1(name, planes, x, pos, grid):
        args = (planes, x, pos, grid)
        y = tk.stencil_apply_sym(*args)
        ref = tk.stencil_apply_sym_plain(*args)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(bool(torch.isfinite(y).all()), f"K1 {name}: non-finite output")
        check(rel <= K1_TOL, f"K1 {name}: |dy|/|y| = {rel:.3e} > {K1_TOL}")
        ms = median_ms(lambda: tk.stencil_apply_sym(*args))
        pms = median_ms(lambda: tk.stencil_apply_sym_plain(*args), batch=1)
        variants[name] = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=pms)
        print(f"{name}: max|dy| {err:.3e} (rel {rel:.3e}), kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms", flush=True)
        return y

    def library_spmv(name, A, x, y_kernel):
        """One cuSPARSE CSR SpMV of the same matrix, timed beside a kernel."""
        y = torch.mv(A, x)
        torch.cuda.synchronize()
        err = float((y - y_kernel).abs().max() / y_kernel.abs().max())
        lms = median_ms(lambda: torch.mv(A, x))
        variants[name]["library_ms"] = lms
        variants[name]["library_nnz"] = int(A.values().numel())
        print(f"{name}: cuSPARSE CSR SpMV (nnz {A.values().numel()}) "
              f"{lms:.4f} ms, |dy|/|y| vs the kernel {err:.3e}", flush=True)
        return lms

    def check_k3(name, op, x, tol):
        """K3 on a one-sided operator's planes against its plain version."""
        args = (op.coeffs, x, op.offsets, op.grid_shape)
        y = tk.stencil_apply(*args)
        ref = tk.stencil_apply_plain(*args)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(bool(torch.isfinite(y).all()), f"K3 {name}: non-finite output")
        check(rel <= tol, f"K3 {name}: |dy|/|y| = {rel:.3e} > {tol}")
        ms = median_ms(lambda: tk.stencil_apply(*args))
        pms = median_ms(lambda: tk.stencil_apply_plain(*args), batch=1)
        variants[name] = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=pms,
                              n_off=len(op.offsets), planes=str(op.coeffs.dtype))
        print(f"{name}: {len(op.offsets)} planes {op.coeffs.dtype}, max|dy| "
              f"{err:.3e} (rel {rel:.3e}), kernel {ms:.4f} ms, plain {pms:.4f} "
              f"ms", flush=True)
        return y

    def check_xfer(tag, tr, W, rng, csr=None):
        """K4 and K5 on the weights W (float32 or bf16) of a level-0
        transfer against their plain versions, with cuSPARSE SpMVs of R and
        R^T as yardsticks when given."""
        g = (tr.window_shape, tr.agg_shape, tr.grid_shape)
        n_c, n_f = tr.shape
        x = torch.from_numpy(rng.standard_normal(n_f).astype(np.float32)).to(dev)
        xc = torch.from_numpy(rng.standard_normal(n_c).astype(np.float32)).to(dev)
        for kind, v, A in (("restrict", x, None if csr is None else csr[0]),
                           ("prolong", xc, None if csr is None else csr[1])):
            fn = getattr(ttk, f"structured_{kind}")
            plain = getattr(ttk, f"structured_{kind}_plain")
            got, ref, again = fn(W, v, *g), plain(W, v, *g), fn(W, v, *g)
            torch.cuda.synchronize()
            rel, err = rel2(got, ref), float((got - ref).abs().max())
            name = f"structured_{kind}/{tag}"
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
            check(torch.equal(got, again), f"{name}: two launches differ")
            check(rel <= XFER_TOL, f"{name}: rel err {rel:.3e} > {XFER_TOL}")
            ms = median_ms(lambda: fn(W, v, *g))
            pms = median_ms(lambda: plain(W, v, *g), batch=1)
            variants[name] = dict(max_abs_err=err, rel_err=rel, ms=ms,
                                  plain_ms=pms, weights=str(W.dtype))
            print(f"{name}: W {tuple(W.shape)} {W.dtype}, max|d| {err:.3e} "
                  f"(rel {rel:.3e}), kernel {ms:.4f} ms, plain {pms:.4f} ms",
                  flush=True)
            if A is not None:
                library_spmv(name, A, v, got)

    def check_tail(name, ft, full, rng, time_it=False):
        """One mode of a tail against its plain version on card tensors, and
        against itself (two launches, the same bits)."""
        if full:
            x, res = (torch.from_numpy(v.astype(np.float32)).to(dev) for v in
                      (rng.uniform(size=ft.n_fine), rng.standard_normal(ft.n_fine)))
            run = lambda: fc.fused_correction_apply(ft, x, res)          # noqa: E731
            plain = lambda: fc.fused_correction_apply_plain(ft, x, res)  # noqa: E731
        else:
            b1 = torch.from_numpy(rng.standard_normal(ft.n1).astype(np.float32)).to(dev)
            run = lambda: fc.fused_subcycle_apply(ft, b1)                # noqa: E731
            plain = lambda: fc.fused_subcycle_apply_plain(ft, b1)        # noqa: E731
        got, ref, again = run(), plain(), run()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        # fixed-order sums without atomics: a second launch repeats the bits
        check(torch.equal(got, again), f"{name}: two launches differ")
        rel = rel2(got, ref)
        err = float((got - ref).abs().max())
        check(rel <= TAIL_TOL, f"{name}: rel err {rel:.3e} > {TAIL_TOL}")
        v = dict(max_abs_err=err, rel_err=rel)
        if time_it:
            v["ms"] = median_ms(run)
            v["plain_ms"] = median_ms(plain, batch=1)
        variants[name] = v
        print(f"{name}: max|d| {err:.3e} (rel {rel:.3e})"
              + (f", kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms"
                 if time_it else ""), flush=True)
        return v

    def check_tail_rounding(name, ft, seeds=(7, 8, 9, 10, 11), time_it=False,
                            full=False):
        """The windowed bf16 tail against the float64 plain version with the
        same rounding points, on every seed, under the limit
        _torch_tails.rounding_limit (rounding_limit_full for the full mode)
        measures on that input (the float32 plain version's gap and 8
        float32-sized perturbations of the values before their roundings,
        the largest times 4, plus TAIL_TOL; max norm); two launches repeat
        their bits.  full: the full mode on (x, res), read on its correction
        x - out (the limit's reference is the float64 correction, so x does
        not dilute a wrong one), else the sub-cycle on b1."""
        def inputs(seed):
            rng = np.random.default_rng(seed)
            if full:
                return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in
                             (rng.uniform(size=ft.n_fine),
                              rng.standard_normal(ft.n_fine)))
            return (torch.from_numpy(rng.standard_normal(ft.n1)
                                     .astype(np.float32)).to(dev),)

        def sub_input(args):
            if not full:
                return args[0]
            return ttk.structured_restrict_plain(ft.W.float(), args[1], ft.fine_window,
                                                 ft.grid, ft.fine_grid)

        run = fc.fused_correction_apply if full else fc.fused_subcycle_apply
        plain = (fc.fused_correction_apply_plain if full
                 else fc.fused_subcycle_apply_plain)
        limit_of = tt.rounding_limit_full if full else tt.rounding_limit
        v = dict(max_abs_err=0.0, rel_err=0.0, seeds={})
        for seed in seeds:
            args = inputs(seed)
            got, again = run(ft, *args), run(ft, *args)
            ref, limit, readings = limit_of(ft, *args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
            check(torch.equal(got, again), f"{name}: two launches differ")
            read = tt.correction_of(args[0], got) if full else got
            rel = tt.rel_inf(read, ref)
            share = tt.correction_share(ft, sub_input(args))
            check(rel <= limit, f"{name} seed {seed}: |d|_inf/|ref|_inf {rel:.3e} > "
                  f"its rounding limit {limit:.3e}")
            v["seeds"][seed] = dict(rel_inf=rel, limit=limit, share=share,
                                    plain_f32=readings["plain_f32"],
                                    draws_max=max(readings["draws"]),
                                    rel2_vs_plain32=rel2(got, plain(ft, *args)))
            v["max_abs_err"] = max(v["max_abs_err"], float((read.double() - ref).abs().max()))
            v["rel_err"] = max(v["rel_err"], rel)
            print(f"{name} seed {seed}: rel_inf vs plain64 {rel:.3e} <= limit {limit:.3e} "
                  + ("(on the correction x - out) " if full else "") +
                  f"(plain32 {readings['plain_f32']:.3e}, draws max "
                  f"{max(readings['draws']):.3e}; coarse share {share:.3f}; rel2 vs "
                  f"plain32 {v['seeds'][seed]['rel2_vs_plain32']:.3e})", flush=True)
        if time_it:
            args = inputs(seeds[0])
            v["ms"] = median_ms(lambda: run(ft, *args))
            v["plain_ms"] = median_ms(lambda: plain(ft, *args), batch=1)
            print(f"{name}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms", flush=True)
        variants[name] = v
        return v

    def check_k2(tag, op, x, b, fsm):
        """K2 with and without the residual against its plain version, in
        the form its rule gives and, where the blocked kernel takes the
        offsets, in the other form too (both timed in turns); returns the
        largest absolute error."""
        k2_err = 0.0
        for want_res in (True, False):
            args = (op.planes, x, b, fsm.inv_diag, fsm.coef, op.pos_offsets,
                    op.grid_shape, fsm.degree, want_res)
            form = tk.k2_form(tuple(op.pos_offsets), fsm.degree, want_res,
                              tuple(op.grid_shape))
            both = tk._blocked_takes(tuple(op.pos_offsets), fsm.degree)
            forms = (form, "chain" if form == "blocked" else "blocked") if both \
                else (form,)
            ref = tk.cheb_smooth_plain(*args)
            key = f"cheb_smooth/{tag}/" + ("with_residual" if want_res
                                           else "no_residual")
            v = dict(form=form, max_abs_err=0.0)
            msg = f"K2 {tag} res={want_res}:"
            for f in forms:
                got = tk.cheb_smooth(*args) if f == form else tk._cheb_smooth(f, *args)
                torch.cuda.synchronize()
                ex = rel2(got[0], ref[0])
                err = float((got[0] - ref[0]).abs().max())
                check(bool(torch.isfinite(got[0]).all()),
                      f"K2 {f} {tag}: non-finite output")
                check(ex <= K2_X_TOL, f"K2 {f} {tag} res={want_res}: x rel err "
                      f"{ex:.3e} > {K2_X_TOL}")
                msg += f" {f}: max|dx| {err:.3e} (rel {ex:.3e})"
                if want_res:
                    er = rel2(got[1], ref[1])
                    check(er <= K2_RES_TOL, f"K2 {f} {tag}: residual rel err "
                          f"{er:.3e} > {K2_RES_TOL}")
                    err = max(err, float((got[1] - ref[1]).abs().max()))
                    msg += f", residual rel {er:.3e};"
                v[f"{f}_rel_err"] = ex
                v["max_abs_err"] = max(v["max_abs_err"], err)
            v["rel_err"] = v[f"{form}_rel_err"]
            if both:
                t = {"blocked": [], "chain": []}
                for f in ("blocked", "chain", "chain", "blocked"):
                    t[f].append(median_ms(lambda: tk._cheb_smooth(f, *args)))
                for f in t:
                    v.update({f"{f}_ms": float(np.mean(t[f])), f"{f}_ms_turns": t[f]})
                v["ms"] = v[f"{form}_ms"]
                msg += f" blocked {t['blocked']} ms, chain {t['chain']} ms;"
            else:
                v["ms"] = median_ms(lambda: tk.cheb_smooth(*args))
            v["plain_ms"] = median_ms(lambda: tk.cheb_smooth_plain(*args), batch=1)
            variants[key] = v
            k2_err = max(k2_err, v["max_abs_err"])
            print(f"{msg} routed {form} {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms",
                  flush=True)
        return k2_err

    class PlainChebyshev(torch.nn.Module):
        """K2's plain PyTorch version on a fused smoother's buffers: the
        same smoother without the kernel, for the PCG count."""

        def __init__(self, fsm):
            super().__init__()
            self.fsm = fsm

        def _run(self, op, b, x, want_res):
            f = self.fsm
            return tk.cheb_smooth_plain(op.planes, x, b, f.inv_diag, f.coef,
                                        op.pos_offsets, op.grid_shape,
                                        f.degree, want_res)

        def apply(self, op, b, x):
            return self._run(op, b, x, False)[0]

        def apply_with_residual(self, op, b, x):
            return self._run(op, b, x, True)

    class FormChebyshev(PlainChebyshev):
        """The same fused smoother through one form of K2 for every call,
        for the V-cycle's A/B of the forms."""

        def __init__(self, fsm, form):
            super().__init__(fsm)
            self.form = form

        def _run(self, op, b, x, want_res):
            f = self.fsm
            return tk._cheb_smooth(self.form, op.planes, x, b, f.inv_diag, f.coef,
                                   op.pos_offsets, op.grid_shape, f.degree,
                                   want_res)

    def tail_variants(levels, windowed, reduced):
        if windowed:
            tr = levels[1].transfer
            win = GeneralWindowTransfer(tr.W, tr.window_shape, tr.t0, tr.stride,
                                        tr.in_grid, tr.out_grid, tr.n_in, tr.n_out)
            levels = [levels[0], LevelData(levels[1].op, smoother=levels[1].smoother,
                                           transfer=win), levels[2]]
        return fc.build_fused_tail(levels, 1, reduced_storage=reduced)

    def true_relres(prob, xs, bh):
        A64 = st.stencil_to_device(st.stencil_from_cell_matrices(
            prob.mesh, prob.A_loc, prob.constrained, prob.diag_raw,
            dtype=torch.float64), "cpu")
        b64 = torch.from_numpy(bh.astype(np.float64))
        return float(torch.linalg.norm(b64 - A64(xs.cpu().double()))
                     / torch.linalg.norm(b64))

    class PlainTransfer(torch.nn.Module):
        """K4/K5's plain versions (the per-axis chain) on a level-0
        transfer's weights: the same transfer without the kernels, for the
        V-cycle's A/B."""

        def __init__(self, tr):
            super().__init__()
            self.tr = tr

        def _geom(self):
            return self.tr.window_shape, self.tr.agg_shape, self.tr.grid_shape

        def restrict(self, x):
            return ttk.structured_restrict_plain(self.tr.W, x, *self._geom())

        def prolong(self, xc):
            return ttk.structured_prolong_plain(self.tr.W, xc, *self._geom())

    def one_sided_hierarchy(prob):
        """The main configuration with the fine operator kept one-sided: the
        hierarchy set up on the host, its level-0 planes (bf16) and the
        outer CG's (float32) replaced by one-sided operators of the same
        values, then moved to the card, whose finalization keeps the plain
        Chebyshev smoother (fine applies through K3) and builds the tail."""
        hier = Hierarchy(prob, main_config(cfg), device="cpu")

        def one_sided(dt):
            host = st.stencil_from_cell_matrices(prob.mesh, prob.A_loc,
                                                 prob.constrained,
                                                 prob.diag_raw, dtype=dt)
            return st.stencil_to_device(st.StencilOperator(
                host.coeffs, host.offsets, host.grid_shape, None), "cpu")

        hier.levels[0].op = one_sided(torch.bfloat16)
        hier._exact_op_cache = one_sided(torch.float32)
        return hier.to("cuda")

    def run_main_path(label, prob, mode_full, kernels, route, max_levels=3,
                      build=None, config=None, extras=True):
        """Hierarchy (or build()) + solve_cg with the counts set to 0 just
        before and read just after, each kernel of `kernels` launched at
        least once and the fine level's kernels as often as its operator
        calls for; the rest of the phase is measurement.  mode_full: the
        tail's mode (True full, False sub-cycle), None for a hierarchy
        without a tail; route: the level-0 setup route the hierarchy must
        have taken ("device" or "host"); config: the Config (the main
        configuration at max_levels if None); extras: also the PCG counts
        with other smoothers and tails, and K2's forms in turns."""
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with HostPeak() as rss:
            hier = (build() if build is not None else
                    Hierarchy(prob, config or main_config(cfg, max_levels),
                              device="cuda"))
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        check(hier.setup_route == route,
              f"{label}: setup took the {hier.setup_route} route, not {route}")
        bh = np.random.default_rng(0).uniform(size=prob.n_dofs).astype(np.float32)
        t0 = time.perf_counter()
        xs, info = hier.solve_cg(bh, tol=PCG_TOL, maxiter=PCG_MAX)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = dict(tk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        sizes = [lv.op.shape[0] for lv in hier.levels]
        types = [f"{type(lv.op).__name__}/{type(lv.transfer).__name__}"
                 for lv in hier.levels]
        ft = hier.levels[0].fused
        print(f"{label}: setup {setup_s:.2f} s ({hier.setup_route} route, peak "
              f"device memory {setup_peak / 2**30:.3f} GiB, peak host RSS "
              f"{rss.peak:.3f} GiB from {rss.start:.3f}), levels {sizes} "
              f"({', '.join(types)}), smoother L0 "
              f"{type(hier.levels[0].smoother).__name__}", flush=True)
        print("  setup stages: " + ", ".join(f"{k} {v:.2f}s"
                                             for k, v in hier.setup_seconds.items()),
              flush=True)
        check((ft is None) == (mode_full is None),
              f"{label}: a fused tail on level 0 is {ft is not None}")
        if ft is not None:
            check((ft.fine_grid is not None) == mode_full,
                  f"{label}: tail mode is not {'full' if mode_full else 'sub-cycle'}")
            print(f"  tail: {'full' if mode_full else 'sub-cycle'} mode, "
                  f"{'dense' if ft.Rd is not None else 'windowed'} L1->L2, "
                  f"weights {ft.coeffs.dtype}", flush=True)
        check(all(t.is_cuda for lv in hier.levels for t in lv.buffers()),
              "a level buffer is not on cuda")
        check(xs.shape == (prob.n_dofs,) and bool(torch.isfinite(xs).all()),
              "solution not finite or of the wrong shape")
        tr = true_relres(prob, xs, bh)
        print(f"  solve_cg: {info['iterations']} iterations, relres "
              f"{info['relres']:.3e}, true relres (f64 host) {tr:.3e}, "
              f"{solve_s:.3f} s; peak device memory {peak / 2**30:.3f} GiB",
              flush=True)
        print(f"  launches in the main path: {launches}", flush=True)
        it_max = PCG_ITERS_MAX[label]
        check(info["iterations"] <= it_max,
              f"{label}: PCG took {info['iterations']} > {it_max} iterations")
        check(info["relres"] <= PCG_TOL, f"relres {info['relres']:.3e} > {PCG_TOL}")
        check(np.isfinite(tr), "true relres not finite")
        for k in kernels:
            check(launches[k] > 0,
                  f"kernel {k} was never launched by the {label} main path")
        # solve_cg applies the preconditioner once per iteration plus once
        n_cyc = info["iterations"] + 1
        check(launches["fused_tail"] == (0 if ft is None else n_cyc),
              f"tail launched {launches['fused_tail']} times in {n_cyc} "
              f"V-cycles")
        # the fine applies: one-sided, five K3 per V-cycle (two per degree-2
        # smooth, the residual) and one per CG apply (the first residual,
        # one per iteration); symmetric, two K2 per V-cycle (the pre-smooth
        # with the residual, the post-smooth without, each of the form its
        # rule gives) and one K1 per CG apply
        op0 = hier.levels[0].op
        if not isinstance(op0, st.StencilOperator):
            want = dict(stencil_apply=0, stencil_apply_sym=0, cheb_smooth=0,
                        cheb_smooth_blocked=0, cheb_smooth_chain=0)
        elif op0.sym_pos is None:
            want = dict(stencil_apply=6 * n_cyc, stencil_apply_sym=0, cheb_smooth=0,
                        cheb_smooth_blocked=0, cheb_smooth_chain=0)
        else:
            forms = [tk.k2_form(tuple(op0.pos_offsets), hier.levels[0].smoother.degree,
                                want_res, tuple(op0.grid_shape))
                     for want_res in (True, False)]
            want = dict(stencil_apply=0, stencil_apply_sym=n_cyc,
                        cheb_smooth=2 * n_cyc, cheb_smooth_blocked=0,
                        cheb_smooth_chain=0)
            for form in forms:
                want[f"cheb_smooth_{form}"] += n_cyc
        got = {k: launches[k] for k in want}
        check(got == want, f"{label}: fine-level launches {got}, not {want}")
        # same-call A/B: the tail and the generic recursion, in turns
        bd = torch.from_numpy(bh).to(dev)
        cycle_launches, cycle_ell = per_vcycle_launches(hier, bd, tk)
        print(f"  per V-cycle: kernel launches {cycle_launches}, ELL applies "
              f"{cycle_ell}", flush=True)
        keys = ("generic",) if ft is None else ("tail", "generic")
        ab = {k: [] for k in keys}
        for key in ("tail", "generic", "generic", "tail"):
            if key in keys:
                hier.levels[0].fused = ft if key == "tail" else None
                ab[key].append(median_ms(lambda: hier.vmult(bd), batch=2))
        dev_ms, dev_top, dev_rows, pcg = {}, {}, {}, {}
        for key in keys:
            hier.levels[0].fused = ft if key == "tail" else None
            dev_ms[key], dev_top[key], dev_rows[key] = device_ms_per_cycle(hier, bd)
            if key == "generic" and ft is not None and extras:
                pcg[key] = hier.solve_cg(bh, tol=PCG_TOL, maxiter=PCG_MAX)[1]
        if ft is not None and extras:
            # the tail with float32 weight storage, for the iteration count
            hier.levels[0].fused = fc.build_fused_tail(hier.levels, ft.nss)
            pcg["tail_f32_weights"] = hier.solve_cg(bh, tol=PCG_TOL,
                                                    maxiter=PCG_MAX)[1]
            hier.levels[0].fused = ft
        # K2's plain version as the smoother, for the iteration count
        fsm = hier.levels[0].smoother
        ab_k2, dev_k2 = {}, {}
        if isinstance(fsm, FusedChebyshevSmoother) and extras:
            hier.levels[0].smoother = PlainChebyshev(fsm)
            pcg["tail_plain_smoother"] = hier.solve_cg(bh, tol=PCG_TOL,
                                                       maxiter=PCG_MAX)[1]
            hier.levels[0].smoother = fsm
            if tk._blocked_takes(tuple(op0.pos_offsets), fsm.degree):
                # the V-cycle (with the tail where there is one) with K2 as
                # its rule routes it and with either form for every call, in
                # turns, wall and device time
                sms = {"rule": fsm, "chain": FormChebyshev(fsm, "chain"),
                       "blocked": FormChebyshev(fsm, "blocked")}
                ab_k2 = {k: [] for k in sms}
                dev_k2 = {k: [] for k in sms}
                for turn in range(4):
                    for key in list(sms)[::(-1) ** turn]:
                        hier.levels[0].smoother = sms[key]
                        ab_k2[key].append(median_ms(lambda: hier.vmult(bd), batch=2))
                        if turn < 2:
                            dev_k2[key].append(device_ms_per_cycle(hier, bd)[0])
                for other in ("chain", "blocked"):
                    hier.levels[0].smoother = sms[other]
                    pcg[f"k2_{other}"] = hier.solve_cg(bh, tol=PCG_TOL,
                                                       maxiter=PCG_MAX)[1]
                hier.levels[0].smoother = fsm
                print(f"  V-cycle ms, K2 by its rule / chain / blocked (in turns): "
                      f"{ab_k2}; device ms/cycle: {dev_k2}", flush=True)
        print(f"  V-cycle ms (CUDA events, medians in turns tail/generic/"
              f"generic/tail): {ab}; device ms/cycle (profiler): "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()), flush=True)
        for key in keys:
            print(f"  device ms/cycle by kernel ({key}): "
                  + "; ".join(f"{k} {v:.4f}" for k, v in dev_top[key]), flush=True)
        if pcg:
            print("  PCG in the same process: " + ", ".join(
                f"{k} {v['iterations']} iterations (relres {v['relres']:.3e})"
                for k, v in pcg.items()), flush=True)
        summary = dict(n_dofs=prob.n_dofs, setup_s=setup_s,
                       setup_route=hier.setup_route,
                       setup_peak_device_gib=setup_peak / 2**30,
                       setup_peak_host_rss_gib=rss.peak,
                       host_rss_before_setup_gib=rss.start,
                       levels=sizes, level_types=types,
                       launches_per_vcycle=cycle_launches,
                       ell_applies_per_vcycle=cycle_ell,
                       device_idle_share={k: 1.0 - dev_ms[k] / float(np.mean(ab[k]))
                                          for k in dev_ms},
                       setup_stages=hier.setup_seconds,
                       pcg_iterations=info["iterations"], relres=info["relres"],
                       true_relres=tr, solve_s=solve_s,
                       ms_per_vcycle_tail=ab.get("tail"),
                       ms_per_vcycle_generic=ab["generic"],
                       device_ms_per_vcycle=dev_ms, device_top=dev_top,
                       pcg_iterations_other={k: v["iterations"]
                                             for k, v in pcg.items()},
                       peak_device_gib=peak / 2**30, launches=launches,
                       ms_per_vcycle_k2_forms=ab_k2,
                       device_ms_per_vcycle_k2_forms=dev_k2)
        return hier, summary, tr, dev_rows

    # ---- 2. build -----------------------------------------------------
    with Phase("2 build"):
        # g++ for the host library beside the nvcc processes of the kernels
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            host_build = pool.submit(native.build_host_library)
            path, log = tk.build_library()
            host_path = host_build.result()
        tk._library()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}; host "
              f"library {host_path}, {native.host_threads()} threads per call "
              f"(affinity {len(os.sched_getaffinity(0))} cores, os.cpu_count() "
              f"{os.cpu_count()}, torch threads {torch.get_num_threads()})",
              flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # ---- 3. kernels against plain --------------------------------------
    with Phase("3 kernels at 65^3 and the tail at 17^3 / 33^3"):
        prob = problem("65^3")
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.uniform(-1, 1, prob.n_dofs).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.uniform(size=prob.n_dofs).astype(np.float32)).to(dev)
        ops, hosts = {}, {}
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            host = st.stencil_from_cell_matrices(prob.mesh, prob.A_loc,
                                                 prob.constrained, prob.diag_raw,
                                                 dtype=dt)
            if dt == torch.bfloat16:
                sm = build_smoother(host, cfg.SmootherConfig(type="chebyshev",
                                                             degree=2),
                                    dtype=torch.float32)
            else:
                hosts[name] = st.StencilOperator(host.coeffs, host.offsets,
                                                 host.grid_shape, host.sym_pos)
            ops[name] = st.stencil_to_device(host, dev)
        fused = fuse_chebyshev(sm.to(dev), ops["bf16"])
        check(fused is not None, "no fused smoother for the 65^3 bf16 stencil")
        for name, op in ops.items():
            y = check_k1(f"stencil_apply_sym/{name}", op.planes, x,
                         op.pos_offsets, op.grid_shape)
        library_spmv("stencil_apply_sym/f32", csr_from_stencil(hosts["f32"], dev),
                     x, y)

        op = ops["bf16"]
        k2_err = check_k2("65^3", op, x, b, fused)
        k1_work65 = k1_work(ops["f32"].planes, prob.n_dofs)
        k2_work65 = k2_work(op.planes, prob.n_dofs, fused.degree, True)
        del ops, hosts, fused, x, b

        # K1 and K2's chain at 171 pairs: a Q3 stencil with its planes
        # symmetrized (C_{-o}[i] := C_o[i - o]), radius 3
        prob3 = LaplaceProblem.hyper_cube(3, 4, degree=3, material_property="linear")
        host3 = st.stencil_from_cell_matrices(prob3.mesh, prob3.A_loc, prob3.constrained,
                                              prob3.diag_raw, dtype=torch.float64)
        c3 = symmetrize(host3.coeffs.numpy(), host3.offsets, host3.grid_shape)
        pos3 = st.detect_symmetry(c3, host3.offsets, host3.grid_shape)
        check(pos3 is not None and len(pos3) == 171,
              f"the symmetrized Q3 stencil has {None if pos3 is None else len(pos3)} "
              f"positive offsets, not 171")
        rng3 = np.random.default_rng(15)
        x3 = torch.from_numpy(rng3.uniform(-1, 1, prob3.n_dofs).astype(np.float32)).to(dev)
        b3 = torch.from_numpy(rng3.uniform(size=prob3.n_dofs).astype(np.float32)).to(dev)
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            h3 = st.StencilOperator(torch.from_numpy(c3).to(dt), host3.offsets,
                                    host3.grid_shape, pos3)
            sm3 = build_smoother(h3, cfg.SmootherConfig(type="chebyshev", degree=2),
                                 dtype=torch.float32)
            op3 = st.stencil_to_device(h3, dev)
            check_k1(f"stencil_apply_sym/Q3 171 pairs/{name}", op3.planes, x3,
                     op3.pos_offsets, op3.grid_shape)
            if name == "bf16":
                k2_err = max(k2_err, check_k2("Q3 49^3 171 pairs", op3, x3, b3,
                                              fuse_chebyshev(sm3.to(dev), op3)))
            del h3, sm3, op3
        del prob3, host3, c3, x3, b3

        # the tail in both modes, forms and storages at small sizes
        for n_ref in (4, 5):
            h = Hierarchy(LaplaceProblem.hyper_cube(3, n_ref,
                                                    material_property="linear"),
                          main_config(cfg), device="cuda")
            for windowed in (False, True):
                for reduced in (False, True):
                    ft = tail_variants(list(h.levels), windowed, reduced)
                    check(ft is not None and (ft.Rd is None) == windowed,
                          "tail variant not built")
                    for full in (True, False):
                        check_tail(f"fused_tail/{2 ** n_ref + 1}^3/"
                                   f"{'full' if full else 'subcycle'}/"
                                   f"{'windowed' if windowed else 'dense'}/"
                                   f"{'bf16' if reduced else 'f32'}",
                                   ft, full, np.random.default_rng(n_ref))
            del h
        # windowed bf16 random tails whose coarse correction is a hierarchy-
        # like share of the output (the 129^3 shape and a ragged grid)
        for grid in ((32, 32, 32), (13, 17, 11)):
            ft = tt.random_tail(grid, dense=False, inv2_scale=tt.HIERARCHY_INV2_SCALE,
                                device=dev)
            check_tail_rounding(f"fused_subcycle_apply/random {'x'.join(map(str, grid))}"
                                f"/hierarchy-like", ft)
            del ft

    # ---- 4. small-input reference: GPU hierarchy against CPU ----------
    with Phase("4 17^3 GPU against CPU"):
        # the kernels along the whole path: both set up by the host route
        small = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
        hc = Hierarchy(small, main_config(cfg), device="cpu")
        hg = Hierarchy(small, main_config(cfg, backend="host"), device="cuda")
        check(hc.setup_route == hg.setup_route == "host", "17^3: not the host route")
        bs = np.random.default_rng(1).uniform(size=small.n_dofs).astype(np.float32)
        y_generic = hc.vmult(bs)          # the CPU generic recursion
        # the card's tail (bf16 weights) on the CPU levels too, plain version
        hc.levels[0].fused = fc.build_fused_tail(hc.levels, 1, reduced_storage=True)
        yc, yg = hc.vmult(bs), hg.vmult(bs).cpu()
        rel, rel_generic = rel2(yg, yc), rel2(yg, y_generic)
        _, ic = hc.solve_cg(bs, tol=PCG_TOL, maxiter=PCG_MAX)
        _, ig = hg.solve_cg(bs, tol=PCG_TOL, maxiter=PCG_MAX)
        print(f"17^3 reference: V-cycle GPU vs CPU rel {rel:.3e} (vs the CPU "
              f"generic recursion {rel_generic:.3e}); PCG "
              f"{ig['iterations']} (GPU) vs {ic['iterations']} (CPU)", flush=True)
        check(rel <= 1e-5, f"17^3 V-cycle GPU vs CPU rel {rel:.3e} > 1e-5")
        check(rel_generic <= BF16_STORAGE_GAP,
              f"17^3 V-cycle GPU vs CPU generic rel {rel_generic:.3e} > "
              f"{BF16_STORAGE_GAP}")
        check(ig["iterations"] == ic["iterations"], "17^3 PCG counts differ")
        # the device route on the card against the same pipeline on the CPU,
        # fed the card's probe block
        hd = Hierarchy(small, main_config(cfg), device="cuda")
        check(hd.setup_route == "device", f"17^3: the {hd.setup_route} route")
        supports, probe = device_eig.supports, device_eig.probe_block
        device_eig.supports = lambda mesh, ids, device, geom=None: supports(
            mesh, ids, dev, geom)
        device_eig.probe_block = lambda n, m, p, device: probe(n, m, p, dev).to(device)
        try:
            hdc = Hierarchy(small, main_config(cfg), device="cpu")
        finally:
            device_eig.supports, device_eig.probe_block = supports, probe
        check(hdc.setup_route == "device", "17^3 CPU: not the device pipeline")
        hdc.levels[0].fused = fc.build_fused_tail(hdc.levels, 1, reduced_storage=True)
        rel_d = rel2(hd.vmult(bs).cpu(), hdc.vmult(bs))
        _, idc = hdc.solve_cg(bs, tol=PCG_TOL, maxiter=PCG_MAX)
        _, idg = hd.solve_cg(bs, tol=PCG_TOL, maxiter=PCG_MAX)
        print(f"17^3 device route: V-cycle GPU vs the CPU pipeline (same probe) "
              f"rel {rel_d:.3e}; PCG {idg['iterations']} (GPU) vs "
              f"{idc['iterations']} (CPU)", flush=True)
        check(rel_d <= DEVICE_ROUTE_VCYCLE_TOL, f"17^3 device route V-cycle GPU vs "
              f"CPU rel {rel_d:.3e} > {DEVICE_ROUTE_VCYCLE_TOL}")
        check(idg["iterations"] == idc["iterations"], "17^3 device-route PCG "
              "counts differ")
        del hc, hg, hd, hdc

    # ---- 5. the main path at 65^3 --------------------------------------
    with Phase("5 main path 65^3"):
        hier, summary65, tr65, _ = run_main_path(
            "65^3", prob, True, ("stencil_apply_sym", "cheb_smooth",
                                 "cheb_smooth_chain", "fused_tail"), "device")
        check(tr65 <= TRUE_RES_MAX, f"true relres {tr65:.3e} > {TRUE_RES_MAX}")
        ft65 = hier.levels[0].fused
        v65 = check_tail("fused_correction_apply/65^3", ft65, True,
                         np.random.default_rng(5), time_it=True)
        # the same tail's sub-cycle alone: the fine transfer's share
        check_tail("fused_subcycle_apply/65^3", ft65, False,
                   np.random.default_rng(6), time_it=True)
        # the windowed level-1 -> 2 form at the same shapes, timed beside the
        # dense form the builder picks here
        # (bf16 weights: held, as every windowed bf16 tail, to the float64
        # plain version with its rounding points under its rounding limit)
        check_tail_rounding("fused_correction_apply/65^3/windowed",
                            tail_variants(list(hier.levels), True, True),
                            time_it=True, full=True)
        del hier

    # ---- 6. the main path at 129^3 -------------------------------------
    with Phase("6 main path 129^3"):
        t0 = time.perf_counter()
        prob7 = LaplaceProblem.hyper_cube(3, N_REF_LARGE, material_property="linear")
        print(f"problem: {prob7.n_dofs} dofs in {time.perf_counter() - t0:.1f} s",
              flush=True)
        hier7, summary129, tr129, rows129 = run_main_path(
            "129^3", prob7, False, ("stencil_apply_sym", "cheb_smooth",
                                    "cheb_smooth_blocked", "cheb_smooth_chain",
                                    "fused_tail",
                                    "structured_restrict",
                                    "structured_prolong"), "device")
        check(tr129 <= TRUE_RES_MAX_LARGE,
              f"129^3 true relres {tr129:.3e} > {TRUE_RES_MAX_LARGE}")
        ft129 = hier7.levels[0].fused
        check(ft129.W2 is not None, "129^3 tail is not in the windowed form")
        l129 = summary129["launches"]
        n_cyc = summary129["pcg_iterations"] + 1
        for k in ("structured_restrict", "structured_prolong"):
            check(l129[k] == n_cyc, f"{k} launched {l129[k]} times in {n_cyc} "
                  f"V-cycles at 129^3")
        blas = [k for k in rows129["tail"] if "gemv" in k.lower() or "gemm" in k.lower()]
        print(f"  BLAS rows in the 129^3 tail V-cycle: {blas}", flush=True)
        check(not blas, "the 129^3 tail V-cycle still runs BLAS kernels")
        # the fine transfer through K4/K5 against their plain versions inside
        # the same V-cycle, in turns
        tr7 = hier7.levels[0].transfer
        bd7 = torch.from_numpy(np.random.default_rng(0).uniform(
            size=prob7.n_dofs).astype(np.float32)).to(dev)
        ab_x, dev_x, top_x = {"kernels": [], "chain": []}, {}, {}
        for key in ("kernels", "chain", "chain", "kernels"):
            hier7.levels[0].transfer = tr7 if key == "kernels" else PlainTransfer(tr7)
            ab_x[key].append(median_ms(lambda: hier7.vmult(bd7), batch=2))
        for key in ("kernels", "chain"):
            hier7.levels[0].transfer = tr7 if key == "kernels" else PlainTransfer(tr7)
            dev_x[key], top_x[key], _ = device_ms_per_cycle(hier7, bd7)
        hier7.levels[0].transfer = tr7
        print(f"  129^3 V-cycle ms, fine transfer by K4/K5 vs their plain "
              f"versions (in turns): kernels {ab_x['kernels']}, chain "
              f"{ab_x['chain']}; device ms/cycle: kernels "
              f"{dev_x['kernels']:.4f}, chain {dev_x['chain']:.4f}", flush=True)
        for key in ("kernels", "chain"):
            print(f"  device ms/cycle by kernel ({key}): "
                  + "; ".join(f"{k} {v:.4f}" for k, v in top_x[key]), flush=True)
        summary129.update(ms_per_vcycle_transfer=ab_x,
                          device_ms_per_vcycle_transfer=dev_x)
        del bd7
        # the windowed bf16 tail rounds r1, b2, x2 and the z/y sums: held to
        # the float64 plain version with the same rounding points, seeds 7-11
        v129 = check_tail_rounding("fused_subcycle_apply/129^3", ft129, time_it=True)
        ex7 = hier7._exact_fine_op()
        rng7 = np.random.default_rng(8)
        x7 = torch.from_numpy(rng7.uniform(-1, 1, prob7.n_dofs)
                              .astype(np.float32)).to(dev)
        b7 = torch.from_numpy(rng7.uniform(size=prob7.n_dofs)
                              .astype(np.float32)).to(dev)
        op7 = hier7.levels[0].op
        k2_err = max(k2_err, check_k2("129^3", op7, x7, b7,
                                      hier7.levels[0].smoother))
        del b7
        y7 = check_k1("stencil_apply_tiled_sym/f32", ex7.planes, x7,
                      ex7.pos_offsets, ex7.grid_shape)
        check_k1("stencil_apply_tiled_sym/bf16", op7.planes, x7,
                 op7.pos_offsets, op7.grid_shape)
        host7 = st.stencil_from_cell_matrices(prob7.mesh, prob7.A_loc,
                                              prob7.constrained, prob7.diag_raw,
                                              dtype=torch.float32)
        A7 = csr_from_stencil(host7, dev)
        library_spmv("stencil_apply_tiled_sym/f32", A7, x7, y7)
        # K3 on the same operator as 27 one-sided planes: the shape the
        # reference's z-tiled one-sided kernel existed for
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            one7 = st.stencil_to_device(st.StencilOperator(
                host7.coeffs.to(dt), host7.offsets, host7.grid_shape, None), dev)
            y = check_k3(f"stencil_apply_tiled/{name}", one7, x7,
                         K3_TOL if name == "f32" else K3_BF16_TOL)
            if name == "f32":
                library_spmv("stencil_apply_tiled/f32", A7, x7, y)
                k3_work129 = k3_work(one7.coeffs, prob7.n_dofs)
            del one7
        del A7
        check_xfer("129^3/f32", tr7, tr7.W, np.random.default_rng(9),
                   csr=csr_from_transfer(tr7, dev))
        check_xfer("129^3/bf16", tr7, tr7.W.to(torch.bfloat16),
                   np.random.default_rng(9))
        k1_work129 = k1_work(ex7.planes, prob7.n_dofs)
        k2_work129 = k2_work(op7.planes, prob7.n_dofs,
                             hier7.levels[0].smoother.degree, True)
        xfer_work129 = xfer_work(tr7.W, *tr7.shape[::-1])
        tail_work129 = tail_work(ft129, False)
        del host7, hier7, tr7

    # ---- 7. the Q2 path at 65^3 ----------------------------------------
    with Phase("7 Q2 paths 65^3"):
        # (a) the main configuration on the Q2 cube.  Whether its planes are
        # symmetric bit for bit depends on how the host's numpy sums the
        # cell matrices, so the fine applies take K1/K2 or K3 as the
        # reference's dispatch does on that host.
        probq = LaplaceProblem.hyper_cube(3, N_REF_Q2, degree=2,
                                          material_property="linear")
        sym_q = st.stencil_from_cell_matrices(
            probq.mesh, probq.A_loc, probq.constrained, probq.diag_raw,
            dtype=torch.float64).sym_pos is not None
        print(f"Q2 cube: {probq.n_dofs} dofs, planes "
              f"{'symmetric' if sym_q else 'one-sided'} on this host", flush=True)
        hierq, summaryq, trq, _ = run_main_path(
            "Q2 65^3", probq, True,
            ("stencil_apply_sym", "cheb_smooth", "cheb_smooth_chain", "fused_tail")
            if sym_q
            else ("stencil_apply", "fused_tail"), "device")
        check(trq <= TRUE_RES_MAX_Q2,
              f"Q2 true relres {trq:.3e} > {TRUE_RES_MAX_Q2}")
        ftq = hierq.levels[0].fused
        check(ftq.fine_window == (9, 9, 9), f"Q2 tail windows {ftq.fine_window}")
        check_tail("fused_correction_apply/Q2 65^3", ftq, True,
                   np.random.default_rng(11), time_it=True)
        check_tail("fused_subcycle_apply/Q2 65^3", ftq, False,
                   np.random.default_rng(12), time_it=True)
        trq0 = hierq.levels[0].transfer
        check_xfer("Q2/f32", trq0, trq0.W, np.random.default_rng(13),
                   csr=csr_from_transfer(trq0, dev))
        check_xfer("Q2/bf16", trq0, trq0.W.to(torch.bfloat16),
                   np.random.default_rng(13))
        summaryo = None
        if sym_q:
            # the pair kernels this path ran, at its shapes: K1 on the outer
            # CG's float32 planes and the V-cycle's bf16 planes (1 + 62), K2
            # on the level-0 smoother
            rngq = np.random.default_rng(14)
            xq = torch.from_numpy(rngq.uniform(-1, 1, probq.n_dofs)
                                  .astype(np.float32)).to(dev)
            bq = torch.from_numpy(rngq.uniform(size=probq.n_dofs)
                                  .astype(np.float32)).to(dev)
            opq0 = hierq.levels[0].op
            for name, op in (("f32", hierq._exact_fine_op()), ("bf16", opq0)):
                check(len(op.pos_offsets) == 62,
                      f"Q2 {name} planes: {len(op.pos_offsets)} positive")
                check_k1(f"stencil_apply_sym/Q2/{name}", op.planes, xq,
                         op.pos_offsets, op.grid_shape)
            k2_err = max(k2_err, check_k2("Q2 65^3", opq0, xq, bq,
                                          hierq.levels[0].smoother))
            del hierq, trq0, opq0, xq, bq
            # the same cube with its fine operator kept one-sided, as the
            # reference runs it where the planes are not bit-symmetric: K3
            # for every fine apply, with the full-mode tail
            hiero, summaryo, tro, _ = run_main_path(
                "Q2 65^3 one-sided", probq, True, ("stencil_apply", "fused_tail"),
                "host", build=lambda: one_sided_hierarchy(probq))
            check(tro <= TRUE_RES_MAX_Q2,
                  f"one-sided Q2 true relres {tro:.3e} > {TRUE_RES_MAX_Q2}")
            check(hiero.levels[0].fused.fine_window == (9, 9, 9),
                  "one-sided Q2 tail windows "
                  f"{hiero.levels[0].fused.fine_window}")
            del hiero
        else:
            del hierq, trq0

        # (b) the distorted Q2 cube (general cell Jacobians): one-sided
        # planes on every host, two levels (its level-1 agglomerates are not
        # windowed), so every fine apply runs K3 and every V-cycle K4/K5
        probd = problem("Q2 distorted")
        xq = torch.from_numpy(np.random.default_rng(10).uniform(
            -1, 1, probd.n_dofs).astype(np.float32)).to(dev)
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            opq = st.stencil_to_device(st.stencil_from_cell_matrices(
                probd.mesh, probd.A_loc, probd.constrained, probd.diag_raw,
                dtype=dt), dev)
            check(opq.sym_pos is None and len(opq.offsets) == 125,
                  "the distorted Q2 operator is not one-sided with 125 offsets")
            y = check_k3(f"stencil_apply/Q2/{name}", opq, xq,
                         K3_TOL if name == "f32" else K3_BF16_TOL)
            if name == "f32":
                library_spmv("stencil_apply/Q2/f32", csr_from_stencil(opq, dev),
                             xq, y)
                k3_work_q2 = k3_work(opq.coeffs, probd.n_dofs)
            del opq
        del xq
        hierd, summaryd, trd, _ = run_main_path(
            "Q2 65^3 distorted", probd, None,
            ("stencil_apply", "structured_restrict", "structured_prolong"),
            "host", max_levels=2)
        check(trd <= TRUE_RES_MAX_Q2_DISTORTED,
              f"distorted Q2 true relres {trd:.3e} > {TRUE_RES_MAX_Q2_DISTORTED}")
        ld = summaryd["launches"]
        n_cyc = summaryd["pcg_iterations"] + 1
        # the fine transfer once each way per V-cycle
        check(ld["structured_restrict"] == ld["structured_prolong"] == n_cyc,
              f"K4/K5 launched {ld['structured_restrict']}/"
              f"{ld['structured_prolong']} times in {n_cyc} V-cycles")
        # K4/K5 at this path's own transfer (9^3 windows over 8^3 agglomerates)
        trd0 = hierd.levels[0].transfer
        check_xfer("Q2 distorted/f32", trd0, trd0.W, np.random.default_rng(16),
                   csr=csr_from_transfer(trd0, dev))
        check_xfer("Q2 distorted/bf16", trd0, trd0.W.to(torch.bfloat16),
                   np.random.default_rng(16))
        del hierd, trd0


    # ---- 8. level-0 setup: the device route against the host route -------
    with Phase("8 level-0 setup, device route against host route"):
        setup_pipeline = {"65^3": check_setup_pipeline("65^3", prob, dev),
                          "129^3": check_setup_pipeline("129^3", prob7, dev)}
        del prob7
        # the whole setup at 65^3 by either route, in turns
        turns = []
        for backend in ("host", "auto", "auto", "host"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            h = Hierarchy(prob, main_config(cfg, backend=backend), device="cuda")
            torch.cuda.synchronize()
            turns.append(dict(route=h.setup_route, setup_s=time.perf_counter() - t0,
                              peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
                              stages=h.setup_seconds))
            check(h.setup_route == ("host" if backend == "host" else "device"),
                  f"backend {backend!r} took the {h.setup_route} route")
            del h
            print(f"65^3 setup, {turns[-1]['route']} route: "
                  f"{turns[-1]['setup_s']:.2f} s, peak device memory "
                  f"{turns[-1]['peak_device_gib']:.3f} GiB; "
                  + ", ".join(f"{k} {v:.2f}s" for k, v in turns[-1]["stages"].items()),
                  flush=True)
        setup_pipeline["65^3 setup in turns"] = turns

    # ---- 9. ELL operators and deeper hierarchies --------------------------
    with Phase("9 ELL levels, four levels, the default Config"):
        from mfmg_torch.amge.hierarchy import measure_vcycle_rate
        from mfmg_torch.ops.sparse import ELLMatrix, ELLTransfer
        from mfmg_torch.ops.structured_transfer import StructuredTransfer

        def ell_vs_csr(name, ell, rng):
            """An ELL apply against one torch.sparse CSR matvec of the same
            matrix (padding dropped): events and profiler device time."""
            x = torch.from_numpy(rng.standard_normal(ell.shape[1])).to(dev, ell.vals.dtype)
            keep = ell.vals != 0
            rows = torch.arange(ell.shape[0], device=dev)[:, None].expand_as(ell.cols)
            A = torch.sparse_coo_tensor(
                torch.stack([rows[keep], ell.cols[keep].long()]), ell.vals[keep],
                ell.shape).coalesce().to_sparse_csr()
            y, yl = ell(x), torch.mv(A, x)
            torch.cuda.synchronize()
            rel = float((y - yl).abs().max() / yl.abs().max())
            check(bool(torch.isfinite(y).all()) and rel <= ELL_TOL,
                  f"ELL {name}: |dy|/|y| {rel:.3e} against the CSR matvec")
            r = dict(shape=list(ell.shape), width=ell.vals.shape[1],
                     nnz=int(keep.sum()), dtype=str(ell.vals.dtype), rel_err=rel,
                     ms=median_ms(lambda: ell(x)),
                     csr_ms=median_ms(lambda: torch.mv(A, x)),
                     device_ms=sum(device_ms_by_name(lambda: ell(x), 50).values()),
                     csr_device_ms=sum(device_ms_by_name(lambda: torch.mv(A, x),
                                                         50).values()))
            variants[f"ell_apply/{name}"] = r
            print(f"  ELL apply {name}: {json.dumps(r)}", flush=True)

        # (a) the distorted Q2 cube at three levels: its level-1 transfer
        # is not windowed (ELL R/R^T), level 2 is ELL and larger than
        # level 1 (the reference's centroid-layer grouping), no tail
        hier_a, summary_a, tr_a, _ = run_main_path(
            "Q2 65^3 distorted 3 levels", problem("Q2 distorted"), None,
            ("stencil_apply", "structured_restrict", "structured_prolong"),
            "host", max_levels=3, extras=False)
        check(tr_a <= TRUE_RES_MAX_DISTORTED_3, f"distorted Q2, three levels: "
              f"true relres {tr_a:.3e} > {TRUE_RES_MAX_DISTORTED_3}")
        check(summary_a["levels"] == [274625, 1024, 2048],
              f"distorted Q2 levels {summary_a['levels']}")
        la = hier_a.levels
        check(isinstance(la[0].transfer, StructuredTransfer)
              and isinstance(la[1].transfer, ELLTransfer)
              and isinstance(la[2].op, ELLMatrix)
              and hier_a.per_cell_levels == [],
              f"distorted Q2 level types {summary_a['level_types']}, per-cell "
              f"levels {hier_a.per_cell_levels}")
        n_cyc = summary_a["pcg_iterations"] + 1
        check(summary_a["launches"]["structured_restrict"] == n_cyc
              and summary_a["launches"]["structured_prolong"] == n_cyc,
              "distorted Q2, three levels: K4/K5 not once per V-cycle")
        ell_vs_csr("distorted Q2 L1 R", la[1].transfer.R, np.random.default_rng(17))
        del hier_a, la

        # (b) Q1 65^3 at four levels: window transfers at levels 1-2, the
        # level-2 restrictor through the per-cell patch path, no tail
        hier_b, summary_b, tr_b, _ = run_main_path(
            "65^3 4 levels", problem("65^3"), None,
            ("stencil_apply_sym", "cheb_smooth", "cheb_smooth_chain",
             "structured_restrict", "structured_prolong"),
            "device", max_levels=4, extras=False)
        check(tr_b <= TRUE_RES_MAX_DEEP,
              f"65^3, four levels: true relres {tr_b:.3e} > {TRUE_RES_MAX_DEEP}")
        check(summary_b["levels"] == [274625, 8192, 256, 4],
              f"65^3 four levels: levels {summary_b['levels']}")
        check(hier_b.per_cell_levels == [2], f"65^3, four levels: the per-cell "
              f"patch path ran at levels {hier_b.per_cell_levels}, not [2]")
        # the stage's seconds; setup's peak host RSS bounds the stage's
        summary_b["restrictor_L2_s"] = hier_b.setup_seconds["restrictor L2"]
        print(f"  restrictor L2 (per-cell patch path) "
              f"{summary_b['restrictor_L2_s']:.2f} s; setup's peak host RSS "
              f"{summary_b['setup_peak_host_rss_gib']:.3f} GiB", flush=True)
        del hier_b

        # (c) Q1 65^3 with operator="ell", float32: ELL at every level,
        # the host SpGEMM Galerkin product, the device route's light
        # batch (no Galerkin blocks) so level 1 takes the per-cell path
        cfg_c = main_config(cfg)
        cfg_c.operator = "ell"
        hier_c, summary_c, tr_c, _ = run_main_path(
            "65^3 ELL", problem("65^3"), None, (), "device", config=cfg_c,
            extras=False)
        check(tr_c <= TRUE_RES_MAX_ELL,
              f"65^3 ELL: true relres {tr_c:.3e} > {TRUE_RES_MAX_ELL}")
        check(all(isinstance(lv.op, ELLMatrix) for lv in hier_c.levels)
              and hier_c._device_A is None,
              f"65^3 ELL level types {summary_c['level_types']}")
        check(hier_c.per_cell_levels == [1], f"65^3 ELL: the per-cell patch "
              f"path ran at levels {hier_c.per_cell_levels}, not [1]")
        check(summary_c["ell_applies_per_vcycle"].get("L0.op", 0) > 0,
              "65^3 ELL: the fine ELL operator was not applied")
        summary_c["restrictor_L1_s"] = hier_c.setup_seconds["restrictor L1"]
        ell_vs_csr("65^3 fine A", hier_c.levels[0].op, np.random.default_rng(18))
        del hier_c

        # (d) the library's default Config (ELL, float64, Jacobi, two levels)
        # with is_preconditioner=False: its V-cycle rate on the card against
        # the CPU port
        prob_d = LaplaceProblem.hyper_cube(3, 2, material_property="constant")
        h_d = Hierarchy(prob_d, cfg.Config(is_preconditioner=False))
        rate_gpu = measure_vcycle_rate(h_d)
        rate_cpu = measure_vcycle_rate(Hierarchy(prob_d, cfg.Config(
            is_preconditioner=False), device="cpu"))
        check(h_d.device.type == "cuda" and all(
            t.is_cuda for lv in h_d.levels for t in lv.buffers()),
            "the default Config's levels are not on the card")
        summary_d = dict(rate_gpu=rate_gpu, rate_cpu=rate_cpu,
                         levels=[lv.op.shape[0] for lv in h_d.levels],
                         setup_route=h_d.setup_route)
        print(f"default Config: V-cycle rate {rate_gpu!r} (card) vs "
              f"{rate_cpu!r} (CPU), levels {summary_d['levels']}, "
              f"{h_d.setup_route} route", flush=True)
        check(abs(rate_gpu - rate_cpu) <= DEFAULT_RATE_TOL,
              f"default Config rate {rate_gpu} (card) vs {rate_cpu} (CPU)")
        del h_d

    # ---- 10. unstructured meshes: the ball and the adaptive cube --------
    with Phase("10 unstructured meshes: hyper_ball, adaptive_cube"):
        summary_ball, summary_adaptive = unstructured_phase(cfg, tk)

    # ---- 11. the other operators and smoothers -----------------------------
    with Phase("11 matrix-free and sum-factorized operators, Gauss-Seidel, ILU"):
        summary_new = new_paths_phase(cfg, tk)

    tail_work65 = tail_work(ft65, True)
    l65 = summary65["launches"]

    def row(name, source, replaces, launches, var, work, library_ms, err=None):
        b_ms, b_by = bound(*work)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches,
                    max_abs_err=var["max_abs_err"] if err is None else err,
                    ms=var["ms"], plain_ms=var["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=library_ms)

    k1v, k1tv = variants["stencil_apply_sym/f32"], variants["stencil_apply_tiled_sym/f32"]
    kernels = [
        row("stencil_apply_sym", "mfmg_torch/csrc/stencil_apply.cu",
            "mfmg_tpu/ops/pallas_stencil.py:611", l65["stencil_apply_sym"],
            k1v, k1_work65, k1v["library_ms"],
            err=max(v["max_abs_err"] for k, v in variants.items()
                    if k.startswith("stencil_apply_sym/"))),
        row("cheb_smooth", "mfmg_torch/csrc/cheb_smooth.cu",
            "mfmg_tpu/ops/pallas_stencil.py:691", l65["cheb_smooth"],
            variants["cheb_smooth/65^3/with_residual"], k2_work65, None,
            err=k2_err),
        row("fused_correction_apply", "mfmg_torch/csrc/fused_tail.cu",
            "mfmg_tpu/ops/fused_cycle.py:402", l65["fused_tail"], v65,
            tail_work65, None),
        row("fused_subcycle_apply", "mfmg_torch/csrc/fused_tail.cu",
            "mfmg_tpu/ops/fused_cycle.py:376", l129["fused_tail"], v129,
            tail_work129, None),
        row("stencil_apply_tiled_sym", "mfmg_torch/csrc/stencil_apply.cu",
            "mfmg_tpu/ops/pallas_stencil.py:139", l129["stencil_apply_sym"],
            k1tv, k1_work129, k1tv["library_ms"],
            err=max(k1tv["max_abs_err"],
                    variants["stencil_apply_tiled_sym/bf16"]["max_abs_err"])),
    ]
    for kind, line in (("restrict", 214), ("prolong", 291)):
        v = variants[f"structured_{kind}/129^3/f32"]
        kernels.append(row(
            f"structured_{kind}", "mfmg_torch/csrc/structured_transfer.cu",
            f"mfmg_tpu/ops/pallas_transfer.py:{line}",
            l129[f"structured_{kind}"], v, xfer_work129, v["library_ms"],
            err=max(v["max_abs_err"],
                    variants[f"structured_{kind}/129^3/bf16"]["max_abs_err"])))
    k3v, k3tv = variants["stencil_apply/Q2/f32"], variants["stencil_apply_tiled/f32"]
    kernels += [
        row("stencil_apply", "mfmg_torch/csrc/stencil_apply.cu",
            "mfmg_tpu/ops/pallas_stencil.py:807", ld["stencil_apply"], k3v,
            k3_work_q2, k3v["library_ms"],
            err=max(k3v["max_abs_err"],
                    variants["stencil_apply/Q2/bf16"]["max_abs_err"])),
        # closed by K3: its launches are K3's on the distorted Q2 path
        row("stencil_apply_tiled", "mfmg_torch/csrc/stencil_apply.cu",
            "mfmg_tpu/ops/pallas_stencil.py:514", ld["stencil_apply"], k3tv,
            k3_work129, k3tv["library_ms"],
            err=max(k3tv["max_abs_err"],
                    variants["stencil_apply_tiled/bf16"]["max_abs_err"])),
        # closed by K2: its launches are K2's on the 129^3 path
        row("cheb_smooth_tiled", "mfmg_torch/csrc/cheb_smooth.cu",
            "mfmg_tpu/ops/pallas_stencil.py:344", l129["cheb_smooth"],
            variants["cheb_smooth/129^3/with_residual"], k2_work129, None),
    ]
    summaries = {"65^3": summary65, "129^3": summary129, "Q2 65^3": summaryq,
                 "Q2 65^3 one-sided": summaryo,
                 "Q2 65^3 distorted": summaryd,
                 "Q2 65^3 distorted 3 levels": summary_a,
                 "65^3 4 levels": summary_b, "65^3 ELL": summary_c,
                 "default Config": summary_d, "ball": summary_ball,
                 "adaptive cube": summary_adaptive, **summary_new}
    for label, s in summaries.items():
        if s is not None:
            s["card"] = card
            print(f"summary {label}: {json.dumps(s)}", flush=True)
    print(f"kernel variants: {json.dumps(variants)}", flush=True)
    print(f"setup routes: {json.dumps(setup_pipeline)}", flush=True)
    print(f"total wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
