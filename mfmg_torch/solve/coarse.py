"""Coarsest-level solvers.

Port of mfmg_tpu/solve/coarse.py, the analog of the reference's DealIISolver
(Amesos-KLU direct / ML, source/dealii/dealii_solver.cc:25-87) and
CudaSolver (cusolver cholesky/lu_dense, AMGX, source/cuda/
cuda_solver.cu:42-515):

  * "direct" (also "cholesky", "lu_dense", "amesos-klu"): the coarse matrix
    inverted once at setup, the apply one dense matvec;
  * "cg": unpreconditioned CG on the coarse ELL matrix to the configured
    tolerance (solve/cg.py: one host synchronization per CG iteration, the
    reference's tolerance exit);
  * "amg" / "amgx" / "ml": a nested V-cycle over algebraic levels
    (``AMGCoarseSolver``).  Built here from the coarse matrix alone, it is
    spectral aggregation ("amg"/"amgx") or smoothed aggregation ("ml", what
    Trilinos ML does) over a graph partition of the matrix
    (``_build_algebraic_amg``); inside a Hierarchy, "amg"/"amgx" instead
    continue the AMGe recursion for coarse.max_levels - 1 levels
    (amge/hierarchy.py), and "ml" seeds the aggregation with the restricted
    fine-grid constant.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch
from torch import nn

DIRECT_TYPES = ("direct", "cholesky", "lu_dense", "amesos-klu")
AMG_TYPES = ("amg", "amgx", "ml")


class DirectCoarseSolver(nn.Module):
    """x = A_c^+ b as one matmul.  A pseudoinverse (eigh with a relative
    cutoff) rather than a factorization because AMGe coarse matrices can be
    exactly consistent-singular (dependent restriction rows)."""

    def __init__(self, inv: torch.Tensor):
        super().__init__()
        self.register_buffer("inv", inv)

    def apply(self, b):
        return self.inv @ b


class CGCoarseSolver(nn.Module):
    """Unpreconditioned CG on the coarse ELL matrix, to ||r|| <= tol ||b||
    or maxiter iterations (mfmg_tpu/solve/coarse.py:46-57)."""

    def __init__(self, op, tol: float = 1e-12, maxiter: int = 200):
        super().__init__()
        self.op = op
        self.tol = float(tol)
        self.maxiter = int(maxiter)

    def apply(self, b):
        from mfmg_torch.solve.cg import cg_solve
        x, _ = cg_solve(self.op, b, tol=self.tol, maxiter=self.maxiter)
        return x


class AMGCoarseSolver(nn.Module):
    """Algebraic multigrid as the coarsest-level solver (the analog of the
    reference's Trilinos ML coarse solver, applied as one AMG vmult, and of
    its AMGX path): n_cycles V-cycles from zero over ``levels``, the same
    LevelData modules as the outer hierarchy's, through its ``_cycle``."""

    def __init__(self, levels, n_smoothing_steps: int = 1, n_cycles: int = 1):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.n_smoothing_steps = int(n_smoothing_steps)
        self.n_cycles = int(n_cycles)

    def apply(self, b):
        from mfmg_torch.amge.hierarchy import _cycle
        x = torch.zeros_like(b)
        for _ in range(self.n_cycles):
            x = _cycle(self.levels, b, x, 0, self.n_smoothing_steps, "v")
        return x


# ML parameter-list keys accepted in coarse.params.*: the analog of the
# reference's ptree2plist overlay (source/common/utils.cc:20-80) mapped onto
# the knobs of the AMG coarse solvers
_ML_PARAM_KEYS = {
    "max levels": ("max_levels", int),
    "smoother: sweeps": ("n_smoothing_steps", int),
    "smoother: type": ("smoother_type", str),
    "aggregation: nodes per aggregate": ("nodes_per_aggregate", int),
    "number of eigenvectors": ("n_eigenvectors", int),
    # ML's bottom solver; ours is always the dense direct solve (the
    # Amesos-KLU analog), so the value is accepted and need not dispatch
    "coarse: type": ("coarse_type", str),
}


def parse_ml_params(coarse_cfg):
    """Consume the coarse.params.* ML parameter list; warn on the keys it
    does not consume.  Defaults mirror ML_Epetra::SetDefaults("SA") where a
    knob maps: "smoother: sweeps" 2, symmetric Gauss-Seidel smoothing."""
    knobs = dict(max_levels=coarse_cfg.max_levels,
                 n_smoothing_steps=2, smoother_type=None,
                 nodes_per_aggregate=27, n_eigenvectors=2)
    for key, val in dict(getattr(coarse_cfg, "params", {}) or {}).items():
        if key in _ML_PARAM_KEYS:
            attr, conv = _ML_PARAM_KEYS[key]
            knobs[attr] = conv(val)
        else:
            warnings.warn(f"coarse.params key {key!r} not consumed by the "
                          f"mfmg_torch AMG coarse solver", stacklevel=3)
    return knobs


def _ml_smoother_type(name) -> str:
    """ML smoother names onto the port's: Gauss-Seidel (ML's SA default and
    the reference's hidden raw-ML configuration) is symmetric Gauss-Seidel,
    Jacobi is Jacobi, Chebyshev / MLS / anything else Chebyshev."""
    t = (name or "symmetric gauss-seidel").strip().lower()
    if "gauss" in t or t in ("sgs", "sor", "ssor"):
        return "symmetric gauss-seidel"
    if "jacobi" in t:
        return "jacobi"
    return "chebyshev"


def _build_algebraic_amg(A_c: sp.spmatrix, coarse_cfg, dtype, device,
                         smoothed: bool, near_null=None):
    """Nested algebraic aggregation hierarchy on the coarse matrix
    (mfmg_tpu/solve/coarse.py:118-240), host scipy throughout.

    Rows are partitioned into disjoint aggregates (amge/graph_partition.py
    on the matrix graph); each aggregate's tentative basis is the
    restriction of the near-null candidates (ML's nullspace; for an AMGe
    coarse matrix the outer hierarchy passes R 1) enriched with the lowest
    eigenvectors of the lumped-Neumann local block, orthonormalized by QR;
    ``smoothed`` applies one Jacobi step to the tentative prolongator
    (smoothed aggregation).  Candidates propagate down by restriction.
    """
    from mfmg_torch.amge.graph_partition import partition_graph
    from mfmg_torch.amge.hierarchy import LevelData
    from mfmg_torch.config import CoarseConfig, SmootherConfig
    from mfmg_torch.ops.sparse import ell_from_scipy, ell_transfer_from_scipy
    from mfmg_torch.solve.smoothers import _host_lanczos_interval, build_smoother

    knobs = parse_ml_params(coarse_cfg)
    sm_type = _ml_smoother_type(knobs["smoother_type"])
    n_ev = knobs["n_eigenvectors"]

    levels = []
    A = sp.csr_matrix(A_c).astype(np.float64)
    if near_null is not None:
        near_null = np.asarray(near_null, dtype=np.float64).reshape(A.shape[0], -1)
    for _ in range(max(1, knobs["max_levels"]) - 1):
        n = A.shape[0]
        n_agg = max(1, n // max(2 * n_ev, knobs["nodes_per_aggregate"]))
        if n <= 128 or n_agg < 2:
            break
        parts = partition_graph(A.indptr, A.indices, n_agg)
        n_agg = int(parts.max()) + 1
        # the padded principal-submatrix batch
        order = np.argsort(parts, kind="stable")
        counts = np.bincount(parts, minlength=n_agg)
        offs = np.concatenate([[0], np.cumsum(counts)])
        m_max = int(counts.max())
        Ad = A.toarray()
        rowsum = Ad.sum(axis=1)
        batchA = np.zeros((n_agg, m_max, m_max))
        for g in range(n_agg):
            idx = order[offs[g]: offs[g + 1]]
            m = len(idx)
            blk = Ad[np.ix_(idx, idx)]
            # lumped-Neumann compensation: each row's off-aggregate
            # couplings folded into the diagonal, so globally near-null
            # vectors stay near-null on the local block
            blk = blk + np.diag(rowsum[idx] - blk.sum(axis=1))
            batchA[g, :m, :m] = blk
            batchA[g, m:, m:] = np.eye(m_max - m) * 1e30   # decouple padding
        _, V = np.linalg.eigh(batchA)
        kk = min(n_ev, m_max)
        # tentative basis per aggregate: the near-null restrictions first
        # (what the coarse space must represent), block eigenvectors fill
        # the remaining columns; a per-aggregate QR keeps it conditioned
        R_rows, R_cols, R_vals = [], [], []
        next_row = 0
        for g in range(n_agg):
            idx = order[offs[g]: offs[g + 1]]
            m = len(idx)
            cand = [] if near_null is None else [near_null[idx]]
            cand.append(V[g, :m, :kk])
            Q, Rq = np.linalg.qr(np.concatenate(cand, axis=1))
            diagR = np.abs(np.diag(Rq))
            keep = diagR > 1e-10 * max(diagR.max(), 1e-300)
            cols = Q[:, keep][:, :min(kk, m)]
            for j in range(cols.shape[1]):
                R_rows.append(np.full(m, next_row))
                R_cols.append(idx)
                R_vals.append(cols[:, j])
                next_row += 1
        R = sp.csr_matrix((np.concatenate(R_vals),
                           (np.concatenate(R_rows), np.concatenate(R_cols))),
                          shape=(next_row, n))
        if near_null is not None:
            near_null = np.asarray(R @ near_null)
        if smoothed:
            # one Jacobi step on the prolongator (smoothed aggregation):
            # P = (I - 4/(3 lmax) D^{-1} A) R^T, applied as a row op on R
            d = np.asarray(A.diagonal())
            Dinv = sp.diags(1.0 / np.where(d != 0, d, 1.0))
            _, lmax = _host_lanczos_interval(lambda v: A @ v, d, n, 20, 7)
            R = (R - (R @ A @ Dinv) * (4.0 / (3.0 * max(lmax, 1e-30)))).tocsr()
        R = R[np.diff(R.indptr) > 0]
        op = ell_from_scipy(A, dtype=dtype)
        # Trilinos ML's Gauss-Seidel is lexicographic: the dense triangular
        # sweep at the small sizes SA levels have, multicolor beyond
        coloring = ("lexicographic"
                    if "gauss" in sm_type and A.shape[0] <= 4096
                    else "multicolor")
        smoother = build_smoother(op, SmootherConfig(
            type=sm_type, degree=2, coloring=coloring), dtype=dtype, A_scipy=A)
        levels.append(LevelData(op, smoother=smoother,
                                transfer=ell_transfer_from_scipy(R, dtype=dtype)))
        A = (R @ A @ R.T).tocsr()
    direct = build_coarse_solver(A, CoarseConfig(type="direct"), dtype=dtype,
                                 device=device)
    levels.append(LevelData(ell_from_scipy(A, dtype=dtype), coarse=direct))
    return AMGCoarseSolver([lv.to(device) for lv in levels],
                           n_smoothing_steps=knobs["n_smoothing_steps"])


def build_coarse_solver(A_c: sp.spmatrix, coarse_cfg, dtype, device,
                        near_null=None):
    """Factory (analog of HierarchyHelpers::build_coarse_solver), on
    ``device``.

    "direct": a large float32 problem takes the reference's jittered
    float32 Cholesky inverse on the host; otherwise, and where that
    factorization fails (a consistent-singular coarse matrix, e.g. the
    ball's level 2 at 14,336 dofs), the pseudoinverse comes from float64
    ``torch.linalg.eigh`` on ``device`` with the reference's relative
    cutoff.  "cg": CGCoarseSolver with coarse.tolerance and
    coarse.max_iterations.  "amg"/"amgx"/"ml": _build_algebraic_amg on the
    matrix, ``near_null`` (n, k) the candidates of its aggregation."""
    from mfmg_torch.ops.sparse import ell_from_scipy
    ctype = coarse_cfg.type.strip().lower()
    if ctype in AMG_TYPES:
        # "ml" = smoothed aggregation (the Trilinos ML default); "amg" /
        # "amgx" = unsmoothed spectral aggregation
        return _build_algebraic_amg(A_c, coarse_cfg, dtype, device,
                                    smoothed=(ctype == "ml"),
                                    near_null=near_null)
    if ctype == "cg":
        return CGCoarseSolver(ell_from_scipy(A_c, dtype=dtype, device=device),
                              tol=coarse_cfg.tolerance,
                              maxiter=coarse_cfg.max_iterations)
    if ctype not in DIRECT_TYPES:
        raise ValueError(f"unknown coarse solver type {coarse_cfg.type!r}")
    Ad = np.asarray(A_c.todense())
    Ad = 0.5 * (Ad + Ad.T)                 # symmetrize against assembly roundoff
    n = Ad.shape[0]
    if n >= 2048 and dtype != torch.float64:
        # large coarse problems: jittered float32 Cholesky inverse on the
        # host (the jitter keeps consistent-singular matrices factorizable)
        A32 = Ad.astype(np.float32)
        jitter = np.float32(1e-6 * (np.trace(A32) / n))
        try:
            c = scipy.linalg.cho_factor(A32 + jitter * np.eye(n, dtype=np.float32))
            inv = scipy.linalg.cho_solve(c, np.eye(n, dtype=np.float32))
            if np.all(np.isfinite(inv)):
                return DirectCoarseSolver(torch.from_numpy(inv).to(device, dtype))
        except scipy.linalg.LinAlgError:
            pass                           # fall through to the eigh pinv
    w, V = torch.linalg.eigh(torch.from_numpy(Ad).to(device, torch.float64))
    cut = w > 1e-10 * max(float(w[-1]), 0.0)
    Vc = V[:, cut]
    return DirectCoarseSolver(((Vc / w[cut]) @ Vc.T).to(dtype))
