"""Jacobi and Chebyshev smoothers.

Port of the Jacobi and Chebyshev parts of mfmg_tpu/solve/smoothers.py.
Both implement the reference contract (common/smoother.hpp:23-43)
x <- x + B^{-1}(b - A x) through the negative-residual form, as the
reference does (dealii_smoother.cc:69-81, cuda_smoother.cu:39-60).
Chebyshev follows deal.II PreconditionChebyshev: the interval is
[max_ev/smoothing_range, max_ev] when smoothing_range > 1, otherwise
[min_est, max_ev], with max_ev = 1.2 x a host Lanczos estimate.

``FusedChebyshevSmoother`` is the counterpart of the reference's fused
Pallas smoother: the whole step of a symmetric 3-D fine stencil goes
through kernel K2 (ops/stencil_kernels.cheb_smooth).  The hierarchy swaps it
in for the level-0 ``ChebyshevSmoother`` when that level lives on CUDA.
Gauss-Seidel, ILU and the device Lanczos estimate are not ported yet
(ROADMAP Queue 1, Slice E).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mfmg_torch.ops import stencil_kernels
from mfmg_torch.solve.operator import apply_op, operator_diagonal


class JacobiSmoother(nn.Module):
    def __init__(self, inv_diag: torch.Tensor, omega: float = 1.0):
        super().__init__()
        self.register_buffer("inv_diag", inv_diag)
        self.omega = float(omega)

    def apply(self, op, b, x):
        # x += omega * D^{-1} (b - A x)   [negative-residual form]
        r = apply_op(op, x) - b
        return x - self.omega * self.inv_diag * r


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


def _host_apply_and_diag(op, A_scipy=None):
    """(apply_fn, diag) on the host in float64 for the operator actually
    smoothed: the assembled CSR where the level has one (every ELL level,
    every coarse level), or the stencil coefficients as stored
    (bfloat16-rounded planes included, as in the reference)."""
    from mfmg_torch.ops.stencil import StencilOperator

    if A_scipy is not None:
        return (lambda x: A_scipy @ x), np.asarray(A_scipy.diagonal())
    if isinstance(op, StencilOperator):
        coeffs = op.coeffs.to(torch.float64).numpy()
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
    raise NotImplementedError(f"host eigenvalue interval for "
                              f"{type(op).__name__} without an assembled "
                              f"matrix is not ported yet (ROADMAP Queue 1)")


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


def build_smoother(op, smoother_cfg, dtype=torch.float64, A_scipy=None):
    """Factory (analog of HierarchyHelpers::build_smoother), Jacobi and
    Chebyshev, over any operator of operator_diagonal.  A_scipy: the
    assembled matrix of the level (ELL or coarse), for the host eigenvalue
    estimate; the fine stencil level reads its planes."""
    diag = operator_diagonal(op)
    # 1/diag in float32 for bfloat16 planes, else in the storage dtype, then
    # cast: the reference's numpy promotion of a bfloat16 host plane
    if diag.dtype == torch.bfloat16:
        diag = diag.to(torch.float32)
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag)).to(dtype)
    stype = smoother_cfg.type.strip().lower()
    if stype == "jacobi":
        return JacobiSmoother(inv_diag, omega=smoother_cfg.jacobi_omega)
    if stype != "chebyshev":
        raise NotImplementedError(f"smoother {smoother_cfg.type!r} is not "
                                  f"ported yet (ROADMAP Queue 1, Slice E)")
    if smoother_cfg.max_eigenvalue is not None:
        lmax = float(smoother_cfg.max_eigenvalue)
        lmin_est = lmax / 20.0
    else:
        if smoother_cfg.eig_estimate.strip().lower() != "lanczos":
            raise NotImplementedError(
                f"eig_estimate {smoother_cfg.eig_estimate!r} is not ported "
                f"yet (ROADMAP Queue 1, Slice E)")
        apply_fn, diag_h = _host_apply_and_diag(op, A_scipy=A_scipy)
        # 16 host Lanczos steps (lmax within 0.8% of the 40-step value at
        # 274k dofs, absorbed by the 1.2 safety factor)
        lmin_est, lmax_est = _host_lanczos_interval(
            apply_fn, diag_h, diag_h.shape[0], n_iter=16, seed=7)
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
