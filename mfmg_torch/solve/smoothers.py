"""Smoothers.

Port of mfmg_tpu/solve/smoothers.py.  Every smoother implements the
reference contract (common/smoother.hpp:23-43) x <- x + B^{-1}(b - A x)
through the negative-residual form, as the reference does
(dealii_smoother.cc:69-81, cuda_smoother.cu:39-60):
  * Jacobi, the reference's device smoother;
  * Chebyshev, after deal.II PreconditionChebyshev: the interval is
    [max_ev/smoothing_range, max_ev] when smoothing_range > 1, otherwise
    [min_est, max_ev], with max_ev = 1.2 x an estimate (host Lanczos, or
    deal.II's 8-step CG estimate for ``eig_estimate="dealii_cg"``);
  * multicolor (symmetric) Gauss-Seidel: lattice colors for stencil and
    block-stencil operators, greedy colors (the host library) for ELL;
    a stencil operator whose colors fill the lattice sweeps each color on
    its own strided sublattice, as the reference does on every backend but
    the TPU;
  * lexicographic (symmetric) Gauss-Seidel and ILU(0), the reference's
    sequential Trilinos semantics as dense triangular solves
    (``torch.linalg.solve_triangular``, the library solve the reference
    calls through jax.scipy), capped at 8,192 dofs.

``FusedChebyshevSmoother`` is the counterpart of the reference's fused
Pallas smoother: the whole step of a symmetric 3-D fine stencil goes
through kernel K2 (ops/stencil_kernels.cheb_smooth).  The hierarchy swaps it
in for the level-0 ``ChebyshevSmoother`` when that level lives on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mfmg_torch.ops import stencil_kernels
from mfmg_torch.solve.operator import apply_op, operator_diagonal

# the dense triangular factors of the lexicographic and ILU smoothers
# (mfmg_tpu/solve/smoothers.py:747, 777)
DENSE_FACTOR_MAX_N = 8192


class JacobiSmoother(nn.Module):
    def __init__(self, inv_diag: torch.Tensor, omega: float = 1.0):
        super().__init__()
        self.register_buffer("inv_diag", inv_diag)
        self.omega = float(omega)

    def apply(self, op, b, x):
        # x += omega * D^{-1} (b - A x)   [negative-residual form]
        r = apply_op(op, x) - b
        return x - self.omega * self.inv_diag * r


class MulticolorGSSmoother(nn.Module):
    """Multicolor Gauss-Seidel (mfmg_tpu/solve/smoothers.py:44-92): the
    reference's (symmetric) Gauss-Seidel (dealii_smoother.cc:38-52) with
    the dofs colored so that no two of one color couple; each color's
    update is a Jacobi-like step, the Gauss-Seidel order carried between
    colors.  colors: (n,) int64 per dof, n_colors of them; symmetric: the
    colors forward, then backward.  coeffs: every plane of a stencil
    operator (the finalized operator keeps only its center and positive
    planes), which the sublattice sweep reads."""

    def __init__(self, inv_diag: torch.Tensor, colors: torch.Tensor,
                 n_colors: int, symmetric: bool = True, coeffs=None):
        super().__init__()
        self.register_buffer("inv_diag", inv_diag)
        self.register_buffer("colors", colors)
        self.register_buffer("coeffs", coeffs)
        self.n_colors = int(n_colors)
        self.symmetric = bool(symmetric)

    def apply(self, op, b, x):
        from mfmg_torch.ops.stencil import StencilOperator
        order = list(range(self.n_colors))
        if self.symmetric:
            order = order + order[::-1]
        if isinstance(op, StencilOperator) and self.coeffs is not None:
            k = max(max(abs(o) for o in off) for off in op.offsets)
            if self.n_colors == (k + 1) ** len(op.grid_shape):
                return _stencil_color_sweep(self.coeffs, op.offsets,
                                            op.grid_shape, self.inv_diag, b,
                                            x, order)
            # an axis shorter than k+1 compresses colors away
            # (_color_operator): the masked form
        for c in order:
            r = apply_op(op, x) - b
            x = torch.where(self.colors == c, x - self.inv_diag * r, x)
        return x


def _stencil_color_sweep(coeffs, offsets, grid, inv_diag, b, x, color_order):
    """Gauss-Seidel sweep over lattice colors with per-color sublattice
    residuals (mfmg_tpu/solve/smoothers.py:95-137): color (cz..cx) updates
    x[c::base, ...] from r_c = sum_i C_i[c::base] * x[c+off_i :: base] -
    b[c::base], each coefficient read once per sweep; the same updates as
    the masked apply-per-color form.  bfloat16 planes multiply the float32
    iterate in float32 (the reference's promotion)."""
    dim = len(grid)
    k = max(max(abs(o) for o in off) for off in offsets)
    base = k + 1
    if len(set(color_order)) != base ** dim:
        raise ValueError("the lattice sweep needs the lattice colors")
    xg = x.reshape(grid).clone()
    bg = b.reshape(grid)
    dg = inv_diag.reshape(grid)

    def color_multi(c):
        out = []
        for _ in range(dim):
            out.append(c % base)
            c //= base
        return tuple(reversed(out))        # (cz, .., cx), as _color_operator

    def sub(arr, c_mi, shift=None):
        sl = []
        for d in range(dim):
            start = c_mi[d] + (0 if shift is None else shift[d])
            ext = (grid[d] - c_mi[d] + base - 1) // base
            sl.append(slice(start, start + (ext - 1) * base + 1, base))
        return arr[tuple(sl)]

    for c in color_order:
        c_mi = color_multi(c)
        xp = F.pad(xg, (k,) * (2 * dim))
        r = -sub(bg, c_mi)
        for i, off in enumerate(offsets):
            r = r + sub(coeffs[i], c_mi) * sub(xp, c_mi, [k + o for o in off])
        sl = tuple(slice(c_mi[d], None, base) for d in range(dim))
        xg[sl] += -(sub(dg, c_mi) * r)
    return xg.reshape(x.shape)


class LexicographicGSSmoother(nn.Module):
    """Sequential (lexicographic) Gauss-Seidel / symmetric Gauss-Seidel with
    the reference's Trilinos semantics (dealii_smoother.cc:38-52;
    mfmg_tpu/solve/smoothers.py:140-174): "gauss-seidel" is one forward
    sweep from zero, B^{-1} = (D+L)^{-1}; "symmetric gauss-seidel" forward
    then backward, B^{-1} = (D+U)^{-1} D (D+L)^{-1}.  L = D + strict lower
    and U = D + strict upper are dense; perm/iperm the sweep order
    (deal.II's dof numbering for ordering="dealii"), None for natural."""

    def __init__(self, L, U=None, diag=None, perm=None, iperm=None,
                 symmetric: bool = False):
        super().__init__()
        for name, t in (("L", L), ("U", U), ("diag", diag), ("perm", perm),
                        ("iperm", iperm)):
            self.register_buffer(name, t)
        self.symmetric = bool(symmetric)

    def apply(self, op, b, x):
        r = apply_op(op, x) - b           # negative residual
        if self.perm is not None:
            r = r[self.perm]
        y = torch.linalg.solve_triangular(self.L, r[:, None], upper=False)
        if self.symmetric:
            y = torch.linalg.solve_triangular(self.U, self.diag[:, None] * y,
                                              upper=True)
        y = y[:, 0]
        if self.perm is not None:
            y = y[self.iperm]
        return x - y


class ILUSmoother(nn.Module):
    """ILU(0) smoother (dealii_smoother.cc:38-52, Ifpack ILU with fill level
    0; mfmg_tpu/solve/smoothers.py:177-200): x += (LU)^{-1} (b - A x), the
    factors on A's pattern (``_ilu0_factor``), L unit lower and U upper,
    dense."""

    def __init__(self, L, U):
        super().__init__()
        self.register_buffer("L", L)
        self.register_buffer("U", U)

    def apply(self, op, b, x):
        r = apply_op(op, x) - b           # negative residual
        y = torch.linalg.solve_triangular(self.L, r[:, None], upper=False,
                                          unitriangular=True)
        y = torch.linalg.solve_triangular(self.U, y, upper=True)
        return x - y[:, 0]


def _ilu0_factor(A_csr):
    """Classical IKJ ILU(0), the factors confined to A's sparsity pattern
    (mfmg_tpu/solve/smoothers.py:203-224).  Host, setup time; dense
    (L unit lower, U upper) in float64."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A_csr).astype(np.float64)
    n = A.shape[0]
    lu = A.toarray()
    pattern = lu != 0
    for i in range(1, n):
        for k in np.nonzero(pattern[i, :i])[0]:
            piv = lu[k, k]
            if piv == 0.0:
                continue
            m = lu[i, k] / piv
            lu[i, k] = m
            upd = pattern[i, k + 1:] & pattern[k, k + 1:]
            lu[i, k + 1:][upd] -= m * lu[k, k + 1:][upd]
    return np.tril(lu, -1) + np.eye(n), np.triu(lu)


def _cheb_coeffs(theta: float, delta: float, degree: int):
    """alpha_i / beta_i of the deal.II PreconditionChebyshev recurrence
    (mfmg_tpu/ops/fused_cycle.py:85-93)."""
    alphas, betas = [1.0 / theta], [0.0]
    for _ in range(2, degree + 1):
        beta = (delta * alphas[-1] / 2.0) ** 2
        alphas.append(1.0 / (theta - beta / alphas[-1]))
        betas.append(beta)
    return tuple(alphas), tuple(betas)


class ChebyshevSmoother(nn.Module):
    """theta = (lmax + lmin) / 2 and delta = (lmax - lmin) / 2 of the D^{-1}A
    interval, held as Python floats rounded to the hierarchy dtype (the
    reference holds them as 0-d arrays of that dtype)."""

    def __init__(self, inv_diag: torch.Tensor, theta: float, delta: float,
                 degree: int = 1):
        super().__init__()
        self.register_buffer("inv_diag", inv_diag)
        self.theta = float(theta)
        self.delta = float(delta)
        self.degree = int(degree)

    def apply(self, op, b, x):
        r = apply_op(op, x) - b          # negative residual
        return x - _chebyshev_vmult(self, op, r)


def _chebyshev_vmult(sm: ChebyshevSmoother, op, src):
    """dst = p_degree(D^{-1}A) D^{-1} src: Chebyshev acceleration of Jacobi
    from a zero initial guess (dealii::PreconditionChebyshev::vmult)."""
    alphas, betas = _cheb_coeffs(sm.theta, sm.delta, sm.degree)
    r = src
    p = x = None
    for i in range(sm.degree):
        z = sm.inv_diag * r
        p = z if i == 0 else z + betas[i] * p
        x = alphas[i] * p if i == 0 else x + alphas[i] * p
        if i < sm.degree - 1:
            r = src - apply_op(op, x)
    return x


class FusedChebyshevSmoother(nn.Module):
    """Whole-step Chebyshev smoother on a symmetric 3-D fine stencil through
    kernel K2 (counterpart of mfmg_tpu FusedChebyshevSmoother,
    solve/smoothers.py:267-322).  coef = [alphas..., betas...] is runtime
    data, a (2*degree,) float32 buffer; semantics identical to
    ChebyshevSmoother."""

    def __init__(self, inv_diag: torch.Tensor, coef: torch.Tensor, degree: int):
        super().__init__()
        self.register_buffer("inv_diag", inv_diag)
        self.register_buffer("coef", coef)
        self.degree = int(degree)

    def _run(self, op, b, x, want_res):
        return stencil_kernels.cheb_smooth(op.planes, x, b, self.inv_diag,
                                           self.coef, op.pos_offsets,
                                           op.grid_shape, self.degree,
                                           want_res=want_res)

    def apply(self, op, b, x):
        return self._run(op, b, x, False)[0]

    def apply_with_residual(self, op, b, x):
        """(smoothed x, A x_s - b) in one K2 call."""
        return self._run(op, b, x, True)


def fuse_chebyshev(sm: ChebyshevSmoother, op):
    """FusedChebyshevSmoother for a float32 smoother on a finalized symmetric
    3-D stencil; None otherwise."""
    from mfmg_torch.ops.stencil import StencilOperator
    if not (isinstance(sm, ChebyshevSmoother) and isinstance(op, StencilOperator)
            and op.sym_pos is not None and op.planes is not None
            and len(op.grid_shape) == 3
            and op.dtype in (torch.float32, torch.bfloat16)
            and sm.inv_diag.dtype == torch.float32):
        return None
    alphas, betas = _cheb_coeffs(sm.theta, sm.delta, sm.degree)
    coef = torch.tensor(alphas + betas, dtype=torch.float32,
                        device=sm.inv_diag.device)
    return FusedChebyshevSmoother(sm.inv_diag, coef, sm.degree)


def greedy_color_plain(cols, vals) -> np.ndarray:
    """The numpy version of native.greedy_color: sequential first-fit
    distance-1 coloring of an (n, L) ELL adjacency, rows in order, entries
    with value 0 and the diagonal skipped."""
    n = cols.shape[0]
    colors = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        nb = cols[i][(vals[i] != 0) & (cols[i] != i)]
        used = set(colors[nb][colors[nb] >= 0].tolist())
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors.astype(np.int32)


def _lattice_colors(shape, base) -> np.ndarray:
    """Lattice color of every point of a C-order grid: the point's index
    modulo base along each axis, folded into one id (before compression)."""
    colors = np.zeros(shape, dtype=np.int64)
    for d, n in enumerate(shape):
        idx = np.arange(n) % base
        colors = colors * base + idx.reshape((-1,) + (1,) * (len(shape) - d - 1))
    return colors


def _color_operator(op):
    """Distance-1 coloring of the operator graph (mfmg_tpu/solve/
    smoothers.py:442-502): (colors (n,) int64 tensor on the operator's
    device, n_colors).  Stencil operators take the closed-form lattice
    coloring ((k+1) colors per axis), block stencils the lattice of the
    agglomerate grid times the component index, ELL matrices the host
    library's sequential greedy coloring.  Colors an axis too short to
    hold are compressed away (np.unique), as in the reference."""
    from mfmg_torch.ops.block_stencil import BlockStencilOperator
    from mfmg_torch.ops.sparse import ELLMatrix
    from mfmg_torch.ops.stencil import StencilOperator

    if isinstance(op, BlockStencilOperator):
        colors = _lattice_colors(op.agg_shape, 2)
        colors = (colors[..., None] * op.n_comp + np.arange(op.n_comp)).reshape(-1)
        device = op.coeffs.device
    elif isinstance(op, StencilOperator):
        base = max(max(abs(o) for o in off) for off in op.offsets) + 1
        colors = _lattice_colors(op.grid_shape, base)
        device = op.center_plane().device
    elif isinstance(op, ELLMatrix):
        from mfmg_torch import native
        colors = native.greedy_color(op.cols.cpu().numpy(),
                                     op.vals.cpu().to(torch.float64).numpy())
        device = op.vals.device
    else:
        raise TypeError(f"cannot color operator type {type(op).__name__}")
    _, colors = np.unique(colors, return_inverse=True)
    colors = colors.reshape(-1)
    return torch.as_tensor(colors, device=device), int(colors.max()) + 1


def dealii_cg_eigenvalue_estimate(apply_fn, diag, n, n_iter: int = 8):
    """deal.II PreconditionChebyshev::estimate_eigenvalues
    (mfmg_tpu/solve/smoothers.py:602-650): exactly n_iter preconditioned-CG
    steps (M = D^{-1}, x0 = 0, rhs v_i = (i % 11) - mean(v)), the Ritz
    values read off the CG tridiagonal (diag_k = 1/alpha_k +
    beta_{k-1}/alpha_{k-1}, offdiag_k = sqrt(beta_k)/alpha_k).  The
    under-converged 8-step estimate is part of the reference's observable
    behaviour: its golden rates depend on it."""
    v = np.arange(n, dtype=np.float64) % 11.0
    v -= v.mean()
    inv_diag = 1.0 / np.where(diag != 0, diag, 1.0)
    r = v.copy()
    z = inv_diag * r
    p = z.copy()
    rz = r @ z
    alphas, betas = [], []
    for _ in range(min(n_iter, n)):
        Ap = apply_fn(p)
        pAp = p @ Ap
        if pAp <= 0.0:
            break
        alpha = rz / pAp
        alphas.append(alpha)
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = r @ z
        if rz_new <= 1e-300:
            break
        betas.append(rz_new / rz)
        p = z + (rz_new / rz) * p
        rz = rz_new
    m = len(alphas)
    if m == 0:
        return 1.0, 1.0
    T_diag = np.empty(m)
    T_diag[0] = 1.0 / alphas[0]
    for k in range(1, m):
        T_diag[k] = 1.0 / alphas[k] + betas[k - 1] / alphas[k - 1]
    T_off = np.array([np.sqrt(betas[k]) / alphas[k] for k in range(m - 1)])
    if m == 1:
        return float(T_diag[0]), float(T_diag[0])
    import scipy.linalg as sla
    ev = sla.eigh_tridiagonal(T_diag, T_off, eigvals_only=True)
    return float(ev[0]), float(ev[-1])


def _host_apply_and_diag(op, A_scipy=None, problem=None):
    """(apply_fn, diag) on the host in float64 for the operator actually
    smoothed: the assembled CSR where the level has one (every ELL level,
    every coarse level), the stencil coefficients as stored
    (bfloat16-rounded planes included, as in the reference), or the
    problem's cell matrices (the matrix-free setup, which never assembles
    the global matrix); (None, None) otherwise."""
    from mfmg_torch.ops.stencil import StencilOperator, full_planes

    if A_scipy is not None:
        return (lambda x: A_scipy @ x), np.asarray(A_scipy.diagonal())
    if isinstance(op, StencilOperator):
        coeffs = full_planes(op).cpu().to(torch.float64).numpy()
        grid_shape, offsets = op.grid_shape, op.offsets
        k = max(max(abs(o) for o in off) for off in offsets)
        center = [i for i, off in enumerate(offsets) if not any(off)]
        n = int(np.prod(grid_shape))
        diag = coeffs[center[0]].reshape(-1) if center else np.ones(n)

        def apply_fn(x):
            xp = np.pad(x.reshape(grid_shape), k)
            y = np.zeros(grid_shape)
            for i, off in enumerate(offsets):
                sl = tuple(slice(k + o, k + o + m)
                           for o, m in zip(off, grid_shape))
                y += coeffs[i] * xp[sl]
            return y.reshape(-1)

        return apply_fn, diag
    if problem is not None:
        cells = problem.mesh.cells
        A_loc = problem.A_loc
        constrained = problem.constrained
        n = problem.diag_raw.shape[0]
        flat = cells.reshape(-1)

        def apply_fn(v):
            # deal.II MatrixFreeOperators::Base convention: constrained rows
            # are identity with value exactly 1 (not the raw diagonal); it
            # enters the estimate's CG coefficients (p^T A p)
            vz = np.where(constrained, 0.0, v)
            y_loc = np.einsum("cij,cj->ci", A_loc, vz[cells])
            y = np.bincount(flat, weights=y_loc.reshape(-1), minlength=n)
            return np.where(constrained, v, y)

        return apply_fn, np.where(constrained, 1.0, problem.diag_raw)
    return None, None


def _host_lanczos_interval(apply_fn, diag, n, n_iter: int, seed: int):
    """(lmin, lmax) of D^{-1}A by host Lanczos on D^{-1/2} A D^{-1/2}, from a
    numpy default_rng(seed) start vector (the same numbers as mfmg_tpu)."""
    n_iter = min(n_iter, n)
    sq = 1.0 / np.sqrt(np.where(diag != 0, diag, 1.0))
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, 1.0, size=n)
    v /= np.linalg.norm(v)
    v_prev = np.zeros(n)
    beta = 0.0
    alphas, betas = [], []
    for _ in range(n_iter):
        w = sq * apply_fn(sq * v)
        alpha = v @ w
        w = w - alpha * v - beta * v_prev
        alphas.append(alpha)
        beta_new = np.linalg.norm(w)
        if beta_new < 1e-30:
            break
        v_prev, v, beta = v, w / beta_new, beta_new
        betas.append(beta_new)
    m = len(alphas)
    T = (np.diag(alphas) + np.diag(betas[: m - 1], 1)
         + np.diag(betas[: m - 1], -1))
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


def _dense_factor_check(kind, n):
    if n > DENSE_FACTOR_MAX_N:
        raise ValueError(f"{kind} stores dense triangular factors (n={n} > "
                         f"{DENSE_FACTOR_MAX_N}); it is the golden-rate parity "
                         f"oracle: use coloring='multicolor' or Chebyshev at "
                         f"scale")


def build_smoother(op, smoother_cfg, dtype=torch.float64, A_scipy=None,
                   problem=None):
    """Factory (analog of HierarchyHelpers::build_smoother;
    mfmg_tpu/solve/smoothers.py:725-825) over any operator of
    operator_diagonal.  A_scipy: the assembled matrix of the level, for the
    host eigenvalue estimate and the dense triangular factors; problem: the
    cell matrices and mesh of level 0 (the matrix-free estimate, the deal.II
    sweep order).  The smoother's tensors live on the operator's device."""
    diag = operator_diagonal(op)
    # 1/diag in float32 for bfloat16 planes, else in the storage dtype, then
    # cast: the reference's numpy promotion of a bfloat16 host plane
    if diag.dtype == torch.bfloat16:
        diag = diag.to(torch.float32)
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag)).to(dtype)
    device = inv_diag.device
    stype = smoother_cfg.type.strip().lower()
    if stype == "jacobi":
        return JacobiSmoother(inv_diag, omega=smoother_cfg.jacobi_omega)
    if stype in ("gauss-seidel", "symmetric gauss-seidel", "sgs", "gs"):
        symmetric = stype in ("symmetric gauss-seidel", "sgs")
        if smoother_cfg.coloring == "lexicographic":
            if A_scipy is None:
                raise ValueError(
                    "lexicographic Gauss-Seidel needs the assembled matrix "
                    "(operator='ell' path); use coloring='multicolor' on "
                    "matrix-free paths")
            _dense_factor_check("lexicographic Gauss-Seidel", A_scipy.shape[0])
            A_d = np.asarray(A_scipy.todense(), dtype=np.float64)
            perm = iperm = None
            if smoother_cfg.ordering == "dealii":
                if problem is None:
                    raise ValueError("ordering='dealii' needs the mesh "
                                     "(available on the finest level only)")
                from mfmg_torch.fem.dealii_order import dealii_dof_numbering
                p = np.argsort(dealii_dof_numbering(problem.mesh))
                A_d = A_d[np.ix_(p, p)]
                perm = torch.as_tensor(p, device=device)
                iperm = torch.as_tensor(np.argsort(p), device=device)

            def dev(a):
                return torch.tensor(a, dtype=dtype, device=device)

            return LexicographicGSSmoother(
                dev(np.tril(A_d)), U=dev(np.triu(A_d)) if symmetric else None,
                diag=dev(np.diag(A_d)) if symmetric else None, perm=perm,
                iperm=iperm, symmetric=symmetric)
        from mfmg_torch.ops.stencil import StencilOperator, full_planes
        colors, n_colors = _color_operator(op)
        return MulticolorGSSmoother(
            inv_diag, colors, n_colors, symmetric=symmetric,
            coeffs=full_planes(op) if isinstance(op, StencilOperator) else None)
    if stype == "ilu":
        if A_scipy is None:
            raise ValueError("ILU smoothing needs the assembled matrix "
                             "(operator='ell' path)")
        _dense_factor_check("ILU(0)", A_scipy.shape[0])
        L, U = _ilu0_factor(A_scipy)
        return ILUSmoother(torch.as_tensor(L, dtype=dtype, device=device),
                           torch.as_tensor(U, dtype=dtype, device=device))
    if stype != "chebyshev":
        raise ValueError(f"unknown smoother type {smoother_cfg.type!r}")
    if smoother_cfg.max_eigenvalue is not None:
        lmax = float(smoother_cfg.max_eigenvalue)
        lmin_est = lmax / 20.0
    else:
        apply_fn, diag_h = _host_apply_and_diag(op, A_scipy=A_scipy,
                                                problem=problem)
        est = smoother_cfg.eig_estimate.strip().lower()
        if est == "dealii_cg" and apply_fn is not None:
            # deal.II parity: exactly eig_cg_n_iterations preconditioned-CG
            # steps from the i%11 start vector
            lmin_est, lmax_est = dealii_cg_eigenvalue_estimate(
                apply_fn, diag_h, diag_h.shape[0],
                n_iter=smoother_cfg.eig_cg_n_iterations)
        elif apply_fn is not None:
            # 16 host Lanczos steps (lmax within 0.8% of the 40-step value
            # at 274k dofs, absorbed by the 1.2 safety factor)
            lmin_est, lmax_est = _host_lanczos_interval(
                apply_fn, diag_h, diag_h.shape[0], n_iter=16, seed=7)
        else:
            # the reference's device Lanczos serves an operator without a
            # host form; every level of a hierarchy has one
            raise NotImplementedError(
                f"the Chebyshev interval of a {type(op).__name__} needs its "
                f"assembled matrix (A_scipy) or the problem's cell matrices")
        lmax = 1.2 * lmax_est          # deal.II safety factor
        lmin_est = max(lmin_est, 1e-12)
    if smoother_cfg.smoothing_range > 1.0:
        lmin = lmax / smoother_cfg.smoothing_range
    else:
        # deal.II: alpha = min(0.9 * max_estimate, min_estimate)
        lmin = min(0.9 * lmax / 1.2, lmin_est)

    def rounded(v):
        return float(torch.tensor(v, dtype=torch.float64).to(dtype))

    return ChebyshevSmoother(inv_diag, theta=rounded((lmax + lmin) / 2.0),
                             delta=rounded((lmax - lmin) / 2.0),
                             degree=smoother_cfg.degree)
