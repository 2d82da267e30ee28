"""Gauss-Seidel and ILU(0) smoothers in mfmg_torch against mfmg_tpu on the
CPU, in float64 (the reference's tests/test_smoothers.py and the
matrix-path goldens of tests/test_hierarchy.py and tests/test_ball.py).

- Colorings: proper on the stencil (4 lattice colors for the 9-point Q1
  stencil) and on the ELL matrix; the host library's greedy colors equal
  their plain version and mfmg_tpu's.
- The sublattice sweep equals the masked apply-per-color form (2-D and
  3-D, forward and symmetric) to 1e-13; the sweep of a finalized bf16
  stencil (its negative planes rebuilt from the kept ones) equals
  mfmg_tpu's float32 sweep on the same planes.
- One step of each smoother (multicolor on stencil and ELL; lexicographic
  in natural and deal.II order, forward and symmetric; ILU(0); multicolor
  on a coarse block stencil) and the ILU(0) factors against mfmg_tpu at
  1e-12; the refusals of build_smoother.
- Golden rates, each equal to mfmg_tpu's at RATE_TOL: 0.0235237332 at 1e-6
  (lexicographic GS, deal.II order), the ball's 0.1026 at 5e-3
  (lexicographic GS); and the multicolor SGS and ILU(0) ELL hierarchies'
  rates.

The reference's greedy colors and its ELL Gauss-Seidel depend on whether
mfmg_tpu.native loaded in the process; every test here takes the
reference with its host library from a private build
(tests/_torch_refnative.py), and one test shows that the parity holds when
mfmg_tpu.native was left in its failed-load state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu import native as jnative
from mfmg_tpu.fem import mesh as jmesh
from mfmg_tpu.ops import sparse as jsp
from mfmg_tpu.ops import stencil as jst
from mfmg_tpu.solve import smoothers as jsm
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch import native as tnative
from mfmg_torch.fem import mesh as tmesh
from mfmg_torch.ops import sparse as tsp
from mfmg_torch.ops import stencil as tst
from mfmg_torch.solve import smoothers as tsm
from mfmg_torch.solve.operator import apply_op

from _torch_rates import GOLDEN_MATRIX_SGS_3D, RATE_TOL, both_rates, cfg_3d
from _torch_refnative import (load_reference_native,  # noqa: F401
                              reference_native, reference_native_dir)

pytestmark = pytest.mark.usefixtures("reference_native")

STEP_TOL = 1e-12


@pytest.fixture(scope="module")
def cube3():
    """hyper_cube(3, 2, "linear") in both packages, with rng inputs."""
    tp = TLaplace.hyper_cube(3, 2, material_property="linear")
    jp = JLaplace.hyper_cube(3, 2, material_property="linear")
    rng = np.random.default_rng(7)
    return tp, jp, rng.uniform(size=tp.n_dofs), rng.uniform(size=tp.n_dofs)


def _proper(colors, A):
    A = A.tocoo()
    mask = (A.row != A.col) & (A.data != 0)
    return not np.any(colors[A.row[mask]] == colors[A.col[mask]])


def test_colorings_are_proper_and_match_reference():
    tp = TLaplace.hyper_cube(2, 3)
    jp = JLaplace.hyper_cube(2, 3)
    S = tst.stencil_from_csr(tp.A, tp.mesh, dtype=torch.float64)
    colors, n_colors = tsm._color_operator(S)
    assert n_colors == 4 and _proper(colors.numpy(), tp.A)
    j_colors, j_n = jsm._color_operator(jst.stencil_from_csr(
        jp.A, jp.mesh, dtype=jnp.float64))
    np.testing.assert_array_equal(colors.numpy(), np.asarray(j_colors))
    E = tp.ell_operator(device="cpu")
    colors_e, n_e = tsm._color_operator(E)
    assert _proper(colors_e.numpy(), tp.A)
    j_e, j_ne = jsm._color_operator(jsp.ell_from_scipy(jp.A, dtype=jnp.float64))
    np.testing.assert_array_equal(colors_e.numpy(), np.asarray(j_e))
    assert n_e == j_ne


def test_greedy_color_matches_plain_and_reference(cube3):
    tp, jp, _, _ = cube3
    E = tp.ell_operator(device="cpu")
    cols, vals = E.cols.numpy(), E.vals.numpy()
    colors = tnative.greedy_color(cols, vals)
    np.testing.assert_array_equal(colors, tsm.greedy_color_plain(cols, vals))
    np.testing.assert_array_equal(colors, jnative.greedy_color(cols, vals))
    assert _proper(colors, tp.A) and colors.max() + 1 <= 16


def test_parity_holds_after_a_failed_reference_load(cube3, tmp_path_factory):
    """mfmg_tpu.native forced into the state a worker is left in when it
    loaded a half-written library (_tried set, no library): the helper
    still gives the reference's sequential greedy colors, equal to the
    port's, on hyper_cube(3, 2)."""
    tp, jp, _, _ = cube3
    saved = (jnative._tried, jnative._lib)
    jnative._tried, jnative._lib = True, None
    try:
        assert jnative.greedy_color(np.zeros((1, 1), np.int32),
                                    np.zeros((1, 1))) is None
        restore = load_reference_native(reference_native_dir(tmp_path_factory))
        try:
            E = tp.ell_operator(device="cpu")
            cols, vals = E.cols.numpy(), E.vals.numpy()
            colors = jnative.greedy_color(cols, vals)
            assert colors is not None
            np.testing.assert_array_equal(colors, tnative.greedy_color(cols, vals))
            j_e, _ = jsm._color_operator(jsp.ell_from_scipy(jp.A,
                                                            dtype=jnp.float64))
            np.testing.assert_array_equal(np.asarray(j_e), colors)
        finally:
            restore()
    finally:
        jnative._tried, jnative._lib = saved


@pytest.mark.parametrize("dim,n_ref", [(2, 3), (3, 2)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_sublattice_sweep_matches_masked_form_and_reference(dim, n_ref,
                                                             symmetric):
    tp = TLaplace.hyper_cube(dim, n_ref, material_property="linear")
    jp = JLaplace.hyper_cube(dim, n_ref, material_property="linear")
    S = tst.stencil_from_csr(tp.A, tp.mesh, dtype=torch.float64)
    cfg = dict(type="symmetric gauss-seidel" if symmetric else "gauss-seidel",
               coloring="multicolor")
    sm = tsm.build_smoother(S, tcfg.SmootherConfig(**cfg), dtype=torch.float64)
    assert isinstance(sm, tsm.MulticolorGSSmoother)
    rng = np.random.default_rng(7)
    b, x0 = (torch.from_numpy(rng.uniform(size=tp.n_dofs)) for _ in range(2))
    x_fast = sm.apply(S, b, x0)
    order = list(range(sm.n_colors))
    if symmetric:
        order = order + order[::-1]
    x_ref = x0
    for c in order:
        r = apply_op(S, x_ref) - b
        x_ref = torch.where(sm.colors == c, x_ref - sm.inv_diag * r, x_ref)
    np.testing.assert_allclose(x_fast.numpy(), x_ref.numpy(), rtol=1e-13,
                               atol=1e-13)
    J = jst.stencil_from_csr(jp.A, jp.mesh, dtype=jnp.float64)
    jsmo = jsm.build_smoother(J, jcfg.SmootherConfig(**cfg), dtype=jnp.float64)
    x_j = np.asarray(jsmo.apply(J, jnp.asarray(b.numpy()), jnp.asarray(x0.numpy())))
    np.testing.assert_allclose(x_fast.numpy(), x_j, rtol=0, atol=STEP_TOL)


def test_bf16_sweep_on_finalized_stencil_matches_reference():
    """The main path's planes: bf16, finalized to the center and positive
    planes; the smoother's full planes equal the host planes bit for bit
    and its float32 sweep equals mfmg_tpu's on the same planes."""
    tp = TLaplace.hyper_cube(3, 2, material_property="linear")
    jp = JLaplace.hyper_cube(3, 2, material_property="linear")
    T = tst.stencil_from_cell_matrices(tp.mesh, tp.A_loc, tp.constrained,
                                       tp.diag_raw, dtype=torch.bfloat16)
    host = T.coeffs.clone()
    cfg = dict(type="symmetric gauss-seidel")
    sm = tsm.build_smoother(T, tcfg.SmootherConfig(**cfg), dtype=torch.float32)
    tst.stencil_to_device(T, "cpu")
    assert T.coeffs is None
    assert torch.equal(tst.full_planes(T), host)
    assert torch.equal(sm.coeffs, host)
    J = jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.bfloat16,
                                       device=False)
    jsmo = jsm.build_smoother(J, jcfg.SmootherConfig(**cfg), dtype=jnp.float32)
    J = jst.stencil_to_device(J)
    rng = np.random.default_rng(3)
    b, x0 = (rng.uniform(size=tp.n_dofs).astype(np.float32) for _ in range(2))
    x_t = sm.apply(T, torch.from_numpy(b), torch.from_numpy(x0)).numpy()
    x_j = np.asarray(jsmo.apply(J, jnp.asarray(b), jnp.asarray(x0)))
    assert np.abs(x_t - x_j).max() <= 1e-6 * np.abs(x_j).max()


@pytest.mark.parametrize("kind", ["ell gs", "ell sgs", "lex gs", "lex sgs",
                                  "lex gs dealii", "lex sgs dealii", "ilu"])
def test_one_step_matches_reference(cube3, kind):
    tp, jp, b, x0 = cube3
    words = kind.split()
    cfg = dict(type="ilu" if kind == "ilu" else
               "symmetric gauss-seidel" if "sgs" in words else "gauss-seidel",
               coloring="lexicographic" if "lex" in words else "multicolor",
               ordering="dealii" if "dealii" in words else "natural")
    sm = tsm.build_smoother(tp.ell_operator(device="cpu"),
                            tcfg.SmootherConfig(**cfg), dtype=torch.float64,
                            A_scipy=tp.A, problem=tp)
    jsmo = jsm.build_smoother(jsp.ell_from_scipy(jp.A, dtype=jnp.float64),
                              jcfg.SmootherConfig(**cfg), dtype=jnp.float64,
                              A_scipy=jp.A, problem=jp)
    assert type(sm).__name__ == type(jsmo).__name__
    x_t = sm.apply(tp.ell_operator(device="cpu"), torch.from_numpy(b),
                   torch.from_numpy(x0)).numpy()
    x_j = np.asarray(jsmo.apply(jsp.ell_from_scipy(jp.A, dtype=jnp.float64),
                                jnp.asarray(b), jnp.asarray(x0)))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=STEP_TOL)


def test_ilu0_factors_match_reference(cube3):
    tp, jp, _, _ = cube3
    L, U = tsm._ilu0_factor(tp.A)
    jL, jU = jsm._ilu0_factor(jp.A)
    np.testing.assert_allclose(L, jL, rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(U, jU, rtol=0, atol=STEP_TOL)
    R = L @ U - tp.A.toarray()
    assert np.abs(R[tp.A.toarray() != 0]).max() < 1e-12


def test_gs_smoother_converges_as_solver():
    tp = TLaplace.hyper_cube(2, 2)
    S = tst.stencil_from_csr(tp.A, tp.mesh, dtype=torch.float64)
    sm = tsm.build_smoother(S, tcfg.SmootherConfig(type="symmetric gauss-seidel"),
                            dtype=torch.float64)
    xstar = np.random.default_rng(0).uniform(size=tp.n_dofs)
    xstar[tp.constrained] = 0.0
    b = torch.from_numpy(tp.A @ xstar)
    x = torch.zeros_like(b)
    for _ in range(200):
        x = sm.apply(S, b, x)
    assert np.linalg.norm(x.numpy() - xstar) < 1e-8


def test_build_smoother_refusals(cube3):
    tp, _, _, _ = cube3
    E = tp.ell_operator(device="cpu")
    lex = tcfg.SmootherConfig(type="gauss-seidel", coloring="lexicographic")
    with pytest.raises(ValueError, match="assembled matrix"):
        tsm.build_smoother(E, lex)
    with pytest.raises(ValueError, match="assembled matrix"):
        tsm.build_smoother(E, tcfg.SmootherConfig(type="ilu"))
    lex.ordering = "dealii"
    with pytest.raises(ValueError, match="needs the mesh"):
        tsm.build_smoother(E, lex, A_scipy=tp.A)
    big = TLaplace.hyper_cube(3, 5).A
    assert big.shape[0] > tsm.DENSE_FACTOR_MAX_N
    with pytest.raises(ValueError, match="n=35937 > 8192"):
        tsm.build_smoother(E, tcfg.SmootherConfig(type="ilu"), A_scipy=big)
    with pytest.raises(ValueError, match="unknown smoother"):
        tsm.build_smoother(E, tcfg.SmootherConfig(type="sor"))


def _rates(make_config, mesh_fn=None):
    if mesh_fn is None:
        jp = JLaplace.hyper_cube(3, 2, material_property="constant")
        tp = TLaplace.hyper_cube(3, 2, material_property="constant")
    else:
        jp = JLaplace.from_mesh(mesh_fn(jmesh), "constant")
        tp = TLaplace.from_mesh(mesh_fn(tmesh), "constant")
    return both_rates(jp, tp, make_config)


def test_golden_rate_lexicographic_gs_dealii_order():
    """test_hierarchy.cc:343: the matrix-path golden, sequential GS in
    deal.II's dof numbering."""
    t, j = _rates(lambda c: cfg_3d(c, operator="ell", smoother=c.SmootherConfig(
        type="gauss-seidel", coloring="lexicographic", ordering="dealii")))
    assert t == pytest.approx(GOLDEN_MATRIX_SGS_3D, abs=1e-6), t
    assert abs(t - j) <= RATE_TOL, (t, j)


def test_ball_golden_lexicographic_gs():
    """tests/test_ball.py:105-119: the ball's matrix path, lexicographic GS
    in the mesh's numbering: below the reference's 0.1148148381 and at
    the pinned 0.1026 within 5e-3."""
    t, j = _rates(lambda c: c.Config(
        is_preconditioner=False, operator="ell",
        eigensolver=c.EigensolverConfig(constrained_mode="pin"),
        smoother=c.SmootherConfig(type="gauss-seidel", coloring="lexicographic"),
        agglomeration=c.AgglomerationConfig(nx=2, ny=2, nz=2)),
        mesh_fn=lambda m: m.hyper_ball(3, 2))
    assert t < 0.1148148381 and t == pytest.approx(0.1026, abs=5e-3), t
    assert abs(t - j) <= RATE_TOL, (t, j)


def test_block_stencil_step_matches_reference():
    """Multicolor SGS on a coarse block-stencil level (the agglomerate-grid
    lattice times the component index, the masked form): colors and one
    step against mfmg_tpu on the same Galerkin matrix."""
    from mfmg_tpu.ops import block_stencil as jbs
    from mfmg_torch import Hierarchy as THierarchy
    from mfmg_torch.ops import block_stencil as tbs
    tp = TLaplace.hyper_cube(3, 3, material_property="linear")
    th = THierarchy(tp, cfg_3d(tcfg, operator="stencil"), device="cpu")
    A1, op1 = th._A_per_level[1], th.levels[1].op
    T = tbs.block_stencil_from_csr(A1, op1.agg_shape, op1.n_comp,
                                   dtype=torch.float64)
    J = jbs.block_stencil_from_csr(A1, op1.agg_shape, op1.n_comp,
                                   dtype=jnp.float64)
    cfg = dict(type="symmetric gauss-seidel")
    sm = tsm.build_smoother(T, tcfg.SmootherConfig(**cfg), dtype=torch.float64)
    jsmo = jsm.build_smoother(J, jcfg.SmootherConfig(**cfg), dtype=jnp.float64)
    assert sm.n_colors == jsmo.n_colors == 16 and _proper(sm.colors.numpy(), A1)
    np.testing.assert_array_equal(sm.colors.numpy(), np.asarray(jsmo.colors))
    rng = np.random.default_rng(9)
    b, x0 = (rng.uniform(size=A1.shape[0]) for _ in range(2))
    x_t = sm.apply(T, torch.from_numpy(b), torch.from_numpy(x0)).numpy()
    x_j = np.asarray(jsmo.apply(J, jnp.asarray(b), jnp.asarray(x0)))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=STEP_TOL)


@pytest.mark.parametrize("stype", ["symmetric gauss-seidel", "ilu"])
def test_hierarchy_rates_match_reference(stype):
    """Multicolor SGS (greedy colors) and ILU(0) in a two-level ELL
    hierarchy (tests/test_smoothers.py: SGS below Jacobi's rate and 0.06,
    ILU below 0.05).  The stencil's sweep is held step by step above; its
    V-cycle's count against the reference's runs on the card (chip_smoke.py
    phase 11)."""
    operator = "ell"
    t, j = _rates(lambda c: cfg_3d(c, operator=operator,
                                   smoother=c.SmootherConfig(type=stype)))
    assert t < 0.05, t
    assert abs(t - j) <= RATE_TOL, (t, j)
