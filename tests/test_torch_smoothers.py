"""mfmg_torch smoothers and kernel K2's plain version against mfmg_tpu.

K2 (cheb_smooth) is held against mfmg_tpu's pallas_cheb_smooth in interpret
mode and against its plain ChebyshevSmoother, in float32 at 17^3 with the
bounds of tests/test_pallas.py: 1e-5 relative on x and 1e-4 relative on the
residual (f32 recurrences; the operator's summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfmg_tpu.config import SmootherConfig as JSmootherConfig
from mfmg_tpu.fem.laplace import LaplaceProblem as JLaplace
from mfmg_tpu.ops import stencil as jst
from mfmg_tpu.ops.fused_cycle import _cheb_coeffs as j_cheb_coeffs
from mfmg_tpu.ops.pallas_stencil import (pad_planes, pad_vec, pad_vec_host,
                                         pallas_cheb_smooth, unpad_vec)
from mfmg_tpu.solve import smoothers as jsm
from mfmg_tpu.solve.operator import apply_op as j_apply
from mfmg_torch.config import SmootherConfig as TSmootherConfig
from mfmg_torch.fem.laplace import LaplaceProblem as TLaplace
from mfmg_torch.ops import stencil as tst
from mfmg_torch.ops import stencil_kernels as tk
from mfmg_torch.solve import smoothers as tsm

X_TOL, RES_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def f32_case():
    jp = JLaplace.hyper_cube(3, 4, material_property="linear")
    tp = TLaplace.hyper_cube(3, 4, material_property="linear")
    J = jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.float32)
    T = tst.stencil_to_device(tst.stencil_from_cell_matrices(
        tp.mesh, tp.A_loc, tp.constrained, tp.diag_raw, dtype=torch.float32),
        "cpu")
    diag = np.asarray(jp.A.diagonal()).astype(np.float32)
    inv_diag = np.where(diag != 0, 1.0 / diag, 0.0).astype(np.float32)
    # a realistic interval: the f64 host estimate of the reference
    sm64 = jsm.build_smoother(
        jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.float64,
                                       device=False),
        JSmootherConfig(type="chebyshev", degree=2), dtype=jnp.float64)
    theta = float(np.float32(sm64.theta))
    delta = float(np.float32(sm64.delta))
    rng = np.random.default_rng(7)
    x = rng.uniform(size=jp.n_dofs).astype(np.float32)
    b = rng.uniform(size=jp.n_dofs).astype(np.float32)
    return jp, J, T, inv_diag, theta, delta, x, b


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("want_res", [False, True])
def test_cheb_smooth_plain_matches_pallas(f32_case, degree, want_res):
    """The K2 wrapper on CPU tensors (its plain recurrence) against
    mfmg_tpu pallas_cheb_smooth (interpret mode) on the same inputs."""
    jp, J, T, inv_diag, theta, delta, x, b = f32_case
    alphas, betas = j_cheb_coeffs(theta, delta, degree)
    coef = np.asarray(alphas + betas, dtype=np.float32)
    outs = pallas_cheb_smooth(pad_planes(np.asarray(J.coeffs), J.offsets,
                                         J.grid_shape),
                              pad_vec(jnp.asarray(x), J.offsets, J.grid_shape),
                              pad_vec(jnp.asarray(b), J.offsets, J.grid_shape),
                              pad_vec_host(inv_diag, J.offsets, J.grid_shape),
                              jnp.asarray(coef), J.offsets, J.grid_shape,
                              J.sym_pos, degree, want_res=want_res)
    ref = [np.asarray(unpad_vec(o, J.offsets, J.grid_shape)) for o in outs]
    got = tk.cheb_smooth(T.planes, torch.from_numpy(x), torch.from_numpy(b),
                         torch.from_numpy(inv_diag), torch.from_numpy(coef),
                         T.pos_offsets, T.grid_shape, degree,
                         want_res=want_res)
    assert len(got) == len(ref) == (2 if want_res else 1)
    assert _rel(got[0].numpy(), ref[0]) < X_TOL
    if want_res:
        assert _rel(got[1].numpy(), ref[1]) < RES_TOL


def test_cheb_smooth_matches_chebyshev_smoother(f32_case):
    """K2's plain version and the port's FusedChebyshevSmoother against
    mfmg_tpu's plain ChebyshevSmoother.apply and its residual; the port's
    own ChebyshevSmoother against the same."""
    jp, J, T, inv_diag, theta, delta, x, b = f32_case
    jsmoother = jsm.ChebyshevSmoother(inv_diag=jnp.asarray(inv_diag),
                                      theta=jnp.float32(theta),
                                      delta=jnp.float32(delta), degree=2)
    xj = jsmoother.apply(J, jnp.asarray(b), jnp.asarray(x))
    rj = np.asarray(j_apply(J, xj) - jnp.asarray(b))
    xj = np.asarray(xj)

    tsmoother = tsm.ChebyshevSmoother(torch.from_numpy(inv_diag), theta,
                                      delta, degree=2)
    fused = tsm.fuse_chebyshev(tsmoother, T)
    assert isinstance(fused, tsm.FusedChebyshevSmoother)
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    xs_f, res_f = fused.apply_with_residual(T, bt, xt)
    xs_p = tsmoother.apply(T, bt, xt)
    assert _rel(xs_f.numpy(), xj) < X_TOL
    assert _rel(res_f.numpy(), rj) < RES_TOL
    assert _rel(fused.apply(T, bt, xt).numpy(), xj) < X_TOL
    assert _rel(xs_p.numpy(), xj) < X_TOL


def test_cheb_coeffs_match_jax():
    for degree in (1, 2, 3, 5):
        np.testing.assert_allclose(tsm._cheb_coeffs(1.3, 0.7, degree),
                                   j_cheb_coeffs(1.3, 0.7, degree),
                                   rtol=1e-15)


@pytest.mark.parametrize("coeff", ["float64", "bfloat16"])
def test_build_smoother_interval_matches_jax(coeff):
    """build_smoother on the fine stencil: the host Lanczos interval (same
    numpy start vector) gives theta and delta equal to 1e-12 relative on
    float64 planes, and on bfloat16-rounded planes the same bf16 reciprocal
    diagonal and interval (f32 hierarchy)."""
    dt = "float64" if coeff == "float64" else "float32"
    jp = JLaplace.hyper_cube(3, 4, material_property="linear")
    tp = TLaplace.hyper_cube(3, 4, material_property="linear")
    J = jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.dtype(coeff),
                                       device=False)
    T = tst.stencil_from_cell_matrices(tp.mesh, tp.A_loc, tp.constrained,
                                       tp.diag_raw,
                                       dtype=getattr(torch, coeff))
    js = jsm.build_smoother(J, JSmootherConfig(type="chebyshev", degree=2),
                            dtype=jnp.dtype(dt))
    ts = tsm.build_smoother(T, TSmootherConfig(type="chebyshev", degree=2),
                            dtype=getattr(torch, dt))
    rtol = 1e-12 if coeff == "float64" else 1e-7      # f32-rounded values
    assert ts.theta == pytest.approx(float(js.theta), rel=rtol)
    assert ts.delta == pytest.approx(float(js.delta), rel=rtol)
    assert ts.inv_diag.dtype == getattr(torch, dt)
    # f64: the center planes agree to summation-order roundoff; bf16 planes
    # are the same bf16 values, whose reciprocals both packages take in f32
    np.testing.assert_allclose(ts.inv_diag.numpy(), np.asarray(js.inv_diag),
                               rtol=1e-14 if coeff == "float64" else 0)


def test_jacobi_smoother_matches_jax():
    jp = JLaplace.hyper_cube(3, 3, material_property="linear")
    tp = TLaplace.hyper_cube(3, 3, material_property="linear")
    J = jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.float64)
    T = tst.stencil_to_device(tst.stencil_from_cell_matrices(
        tp.mesh, tp.A_loc, tp.constrained, tp.diag_raw, dtype=torch.float64),
        "cpu")
    cfg = dict(type="jacobi", jacobi_omega=0.7)
    js = jsm.build_smoother(J, JSmootherConfig(**cfg), dtype=jnp.float64)
    ts = tsm.build_smoother(T, TSmootherConfig(**cfg), dtype=torch.float64)
    rng = np.random.default_rng(3)
    x, b = rng.uniform(size=(2, jp.n_dofs))
    yj = np.asarray(js.apply(J, jnp.asarray(b), jnp.asarray(x)))
    yt = ts.apply(T, torch.from_numpy(b), torch.from_numpy(x)).numpy()
    assert np.abs(yt - yj).max() <= 1e-12 * np.abs(yj).max()
