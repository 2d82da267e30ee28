"""The matrix-free and sum-factorized operators, fast_ap and the identity /
raw constrained modes in mfmg_torch against mfmg_tpu on the CPU, in float64
(the reference's tests/test_fem.py:76-160, tests/test_adaptive.py:117-158,
tests/test_fast_ap.py and the goldens of tests/test_hierarchy.py and
tests/test_ball.py).

- ``mf_apply`` (local_matrix and quadrature modes, four coefficients) and
  ``sumfac_apply`` (Q1-Q3, 2-D and 3-D, distorted where the reference
  distorts) against the assembled A at 1e-9 and against mfmg_tpu at 1e-12,
  their diagonals, ``compute_metric``; the condensed apply on hanging
  meshes; ``gather_sum`` against ``index_add_``.
- ``fast_multiply_transpose`` equal to A R^T at 1e-9 and to mfmg_tpu's;
  the boundary-layer and halo patches equal mfmg_tpu's.
- The identity and raw constrained modes and more than 8 eigenvectors
  against mfmg_tpu's eigensolves; Chebyshev intervals from the cell
  matrices (Lanczos and deal.II CG) equal mfmg_tpu's.
- Golden rates, each equal to mfmg_tpu's at RATE_TOL: 0.0880045475 at 1e-4
  on the matrix_free, sumfac, stencil and ell operators; the ball's 0.3356
  at 5e-3 (identity mode, the deal.II CG estimate); the matrix-free setup
  never assembles the fine matrix and its PCG count equals the
  reference's, on the cube and on the adaptive (hanging-node) mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge import fast_ap as jfa
from mfmg_tpu.amge.agglomeration import build_agglomerates
from mfmg_tpu.amge.local_problems import build_agglomerate_batch
from mfmg_tpu.amge.restriction import build_restriction
from mfmg_tpu.eigen.batched_eigh import batched_smallest_eigenpairs as j_eig
from mfmg_tpu.fem import adaptive as jad
from mfmg_tpu.fem import geometry as jgeo
from mfmg_tpu.fem import mesh as jmesh
from mfmg_tpu.ops.local_apply import mf_diagonal as j_mf_diagonal
from mfmg_tpu.solve import smoothers as jsm
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge import fast_ap as tfa
from mfmg_torch.amge import local_problems as tlp
from mfmg_torch.eigen.batched_eigh import batched_smallest_eigenpairs as t_eig
from mfmg_torch.fem import adaptive as tad
from mfmg_torch.fem import geometry as tgeo
from mfmg_torch.fem import mesh as tmesh
from mfmg_torch.ops.local_apply import gather_sum, incidence, mf_diagonal
from mfmg_torch.solve import smoothers as tsm
from mfmg_torch.solve.operator import operator_diagonal

from _torch_rates import GOLDEN_MF_CHEBYSHEV_3D, RATE_TOL, both_rates, cfg_3d

ASSEMBLED_TOL = 1e-9      # the reference's MF == matrix oracle
PARITY_TOL = 1e-12


def quadrant(c):
    return np.all(c < 0.5, axis=1)


def _apply(op, x):
    return op(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("material", ["constant", "linear", "linear_x",
                                      "discontinuous"])
def test_matrix_free_equals_assembled_and_reference(material):
    tp = TLaplace.hyper_cube(2, 3, material_property=material)
    jp = JLaplace.hyper_cube(2, 3, material_property=material)
    u = np.random.default_rng(3).uniform(size=tp.n_dofs)
    u[tp.constrained] = 0.0
    y_sp = tp.A @ u
    for mode in ("local_matrix", "quadrature"):
        op = tp.matrix_free_operator(mode=mode, device="cpu")
        jop = jp.matrix_free_operator(mode=mode)
        y = _apply(op, u)
        np.testing.assert_allclose(y, y_sp, rtol=0, atol=ASSEMBLED_TOL)
        np.testing.assert_allclose(y, np.asarray(jop @ jnp.asarray(u)),
                                   rtol=0, atol=PARITY_TOL)
        d = mf_diagonal(op).numpy()
        np.testing.assert_allclose(d, tp.A.diagonal(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(d, np.asarray(j_mf_diagonal(jop)), rtol=0,
                                   atol=PARITY_TOL)


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (2, 3), (3, 1), (3, 2)])
def test_sumfac_equals_assembled_and_reference(dim, degree):
    kw = dict(material_property="linear", distort_random=degree < 3)
    tp = TLaplace.hyper_cube(dim, 2, degree=degree, **kw)
    jp = JLaplace.hyper_cube(dim, 2, degree=degree, **kw)
    np.testing.assert_allclose(tgeo.compute_metric(tp.mesh, tp.coeff_at_q),
                               jgeo.compute_metric(jp.mesh, jp.coeff_at_q),
                               rtol=0, atol=1e-14)
    op = tp.matrix_free_operator(mode="sumfac", device="cpu")
    jop = jp.matrix_free_operator(dtype=jnp.float64, mode="sumfac")
    x = np.random.default_rng(3).standard_normal(tp.n_dofs)
    y = _apply(op, x)
    y_sp = tp.A @ x
    scale = np.abs(y_sp).max()
    np.testing.assert_allclose(y, y_sp, rtol=0, atol=ASSEMBLED_TOL * scale)
    np.testing.assert_allclose(y, np.asarray(jop @ jnp.asarray(x)), rtol=0,
                               atol=PARITY_TOL * scale)
    np.testing.assert_allclose(operator_diagonal(op).numpy(), tp.A.diagonal(),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("dim,n_ref", [(2, 3), (3, 1)])
def test_matrix_free_on_hanging_mesh(dim, n_ref):
    """C^T A C cell-wise against the assembled condensed matrix and
    mfmg_tpu (tests/test_adaptive.py:117-135)."""
    tp = TLaplace.from_mesh(tad.adaptive_cube(dim, n_ref, quadrant), "linear")
    jp = JLaplace.from_mesh(jad.adaptive_cube(dim, n_ref, quadrant), "linear")
    u = np.random.default_rng(2).standard_normal(tp.n_dofs)
    y_ref = tp.A @ u
    for mode in ("local_matrix", "quadrature"):
        op = tp.matrix_free_operator(mode=mode, device="cpu")
        y = _apply(op, u)
        np.testing.assert_allclose(y, y_ref, rtol=0,
                                   atol=ASSEMBLED_TOL * np.abs(y_ref).max())
        jop = jp.matrix_free_operator(mode=mode)
        np.testing.assert_allclose(y, np.asarray(jop @ jnp.asarray(u)), rtol=0,
                                   atol=PARITY_TOL * np.abs(y_ref).max())
        np.testing.assert_allclose(mf_diagonal(op).numpy(), tp.A.diagonal(),
                                   rtol=1e-12)


def test_gather_sum_equals_index_add():
    rng = np.random.default_rng(5)
    index = rng.integers(-1, 50, size=(300,))
    src = torch.from_numpy(rng.standard_normal(300))
    inc = incidence(index, 60)
    keep = torch.from_numpy(index >= 0)
    ref = torch.zeros(60, dtype=src.dtype).index_add_(
        0, torch.from_numpy(index)[keep], src[keep])
    got = gather_sum(src, inc)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-13)
    assert torch.equal(got, gather_sum(src, inc))
    assert inc.shape[1] == np.bincount(index[index >= 0]).max()


@pytest.mark.parametrize("dim,n_ref,material,mode", [
    (2, 3, "constant", "pin"),
    (2, 4, "linear", "identity"),
    (3, 2, "constant", "pin"),
    (2, 4, "discontinuous", "identity"),
])
def test_fast_ap_equals_naive_and_reference(dim, n_ref, material, mode):
    """tests/test_fast_ap.py: AP = A R^T without the global SpGEMM, at 1e-9
    (the port's functions on the port's batch and eigenpairs)."""
    tp = TLaplace.hyper_cube(dim, n_ref, material_property=material)
    agg = build_agglomerates(tp.mesh, jcfg.AgglomerationConfig(nx=2, ny=2, nz=2))
    batch = tlp.build_agglomerate_batch(tp.mesh, tp.A_loc, agg)
    evals, evecs = t_eig(batch, 2, constrained_mode=mode)
    R = build_restriction(batch, evecs, tp.diag_raw, tp.n_dofs)
    AP_naive = (tp.A @ R.T).toarray()
    AP = tfa.fast_multiply_transpose(tp.mesh, tp.A_loc, agg, batch, evals,
                                     evecs, tp.diag_raw)
    err = np.abs(AP.toarray() - AP_naive).max() / np.abs(AP_naive).max()
    assert err < 1e-9, err
    jAP = jfa.fast_multiply_transpose(tp.mesh, tp.A_loc, agg, batch, evals,
                                      evecs, tp.diag_raw)
    np.testing.assert_allclose(AP.toarray(), jAP.toarray(), rtol=0,
                               atol=PARITY_TOL)


def test_boundary_halo_patches_match_reference():
    tp = TLaplace.hyper_cube(2, 2)
    agg = build_agglomerates(tp.mesh, jcfg.AgglomerationConfig(nx=2, ny=2))
    interior, halo = tfa.boundary_and_halo_patches(tp.mesh, agg)
    j_int, j_halo = jfa.boundary_and_halo_patches(tp.mesh, agg)
    assert len(interior) == len(halo) == 4
    for g in range(4):
        np.testing.assert_array_equal(interior[g], j_int[g])
        np.testing.assert_array_equal(halo[g], j_halo[g])
        assert len(interior[g]) == 3 and len(halo[g]) == 5
    np.testing.assert_array_equal(tfa.cell_adjacency(tp.mesh).toarray(),
                                  jfa.cell_adjacency(tp.mesh).toarray())


@pytest.mark.parametrize("mode,n_ev", [("identity", 2), ("raw", 2),
                                       ("pin", 10), ("identity", 10)])
def test_constrained_modes_and_many_vectors_match_reference(mode, n_ev):
    """The host eigensolves of the identity/raw modes (syevx) and of more
    than 8 vectors (the full batched eigh): eigenvalues, and eigenvector
    subspaces up to sign, against mfmg_tpu on the same batch."""
    tp = TLaplace.hyper_cube(3, 2, material_property="linear")
    agg = build_agglomerates(tp.mesh, jcfg.AgglomerationConfig(nx=2, ny=2, nz=2))
    batch = tlp.build_agglomerate_batch(tp.mesh, tp.A_loc, agg)
    ev, V = t_eig(batch, n_ev, constrained_mode=mode)
    j_ev, j_V = j_eig(batch, n_ev, constrained_mode=mode)
    np.testing.assert_allclose(ev, j_ev, rtol=0, atol=1e-10)
    # the projector onto the kept vectors: sign and in-cluster rotation free
    P = np.einsum("aik,ajk->aij", V, V)
    jP = np.einsum("aik,ajk->aij", j_V, j_V)
    np.testing.assert_allclose(P, jP, rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match="unknown constrained_mode"):
        t_eig(batch, n_ev, constrained_mode="shift")


@pytest.mark.parametrize("est", ["lanczos", "dealii_cg"])
def test_chebyshev_interval_from_cell_matrices_matches_reference(est):
    """The problem branch of the host estimate: identity rows of value 1 at
    the constrained dofs (deal.II MatrixFree), not the raw diagonal."""
    tp = TLaplace.hyper_cube(3, 2, material_property="linear")
    jp = JLaplace.hyper_cube(3, 2, material_property="linear")
    cfg = dict(type="chebyshev", degree=2, eig_estimate=est)
    sm = tsm.build_smoother(tp.matrix_free_operator(device="cpu"),
                            tcfg.SmootherConfig(**cfg), problem=tp)
    jsmo = jsm.build_smoother(jp.matrix_free_operator(),
                              jcfg.SmootherConfig(**cfg), dtype=jnp.float64,
                              problem=jp)
    assert sm.theta == pytest.approx(float(jsmo.theta), rel=1e-12)
    assert sm.delta == pytest.approx(float(jsmo.delta), rel=1e-12)
    np.testing.assert_allclose(sm.inv_diag.numpy(), np.asarray(jsmo.inv_diag),
                               rtol=1e-14)


@pytest.mark.parametrize("operator", ["matrix_free", "sumfac", "stencil", "ell"])
def test_golden_rate_mf_chebyshev(operator):
    """test_hierarchy.cc:353: Chebyshev degree 1 with the spectral coarse
    space, 0.0880045475, held at 1e-4 on every operator (the measured gap is
    9.9e-6)."""
    jp = JLaplace.hyper_cube(3, 2, material_property="constant")
    tp = TLaplace.hyper_cube(3, 2, material_property="constant")
    t, j = both_rates(jp, tp, lambda c: cfg_3d(
        c, operator=operator, smoother=c.SmootherConfig(type="chebyshev",
                                                        degree=1)))
    assert t == pytest.approx(GOLDEN_MF_CHEBYSHEV_3D, abs=1e-4), t
    assert abs(t - j) <= RATE_TOL, (t, j)


def test_ball_golden_identity_dealii_cg():
    """tests/test_ball.py:51-102: identity mode with the deal.II CG
    estimate, the pinned 0.3356 at 5e-3, within 0.05 of the reference's
    0.2981146185."""
    jp = JLaplace.from_mesh(jmesh.hyper_ball(3, 2), "constant")
    tp = TLaplace.from_mesh(tmesh.hyper_ball(3, 2), "constant")
    t, j = both_rates(jp, tp, lambda c: c.Config(
        is_preconditioner=False,
        eigensolver=c.EigensolverConfig(constrained_mode="identity"),
        smoother=c.SmootherConfig(type="chebyshev", degree=1,
                                  eig_estimate="dealii_cg"),
        agglomeration=c.AgglomerationConfig(nx=2, ny=2, nz=2)))
    assert t == pytest.approx(0.3356, abs=0.005), t
    assert abs(t - 0.2981146185) < 0.05
    assert abs(t - j) <= RATE_TOL, (t, j)


def _pcg_both(jprob, tprob, make_config, seed):
    b = np.random.default_rng(seed).uniform(size=tprob.n_dofs)
    b[tprob.constrained] = 0.0
    th = THierarchy(tprob, make_config(tcfg), device="cpu")
    jh = JHierarchy(jprob, make_config(jcfg))
    x, info = th.solve_cg(b, tol=1e-8, maxiter=60)
    jx, jinfo = jh.solve_cg(b, tol=1e-8, maxiter=60)
    assert th._A_shapes == jh._A_shapes
    assert info["iterations"] == int(jinfo["iterations"]), (info, jinfo)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(jx)).max())
    return th, x


@pytest.mark.parametrize("operator", ["matrix_free", "sumfac"])
def test_matrix_free_setup_never_assembles_and_matches_reference(operator):
    """tests/test_fast_ap.py:77-97: the matrix-free setup (fast_ap, the
    cell-matrix estimate, the identity mode's host route) never forms the
    global matrix; three levels, PCG count and solution equal to
    mfmg_tpu's."""
    jp = JLaplace.hyper_cube(3, 3, material_property="linear")
    tp = TLaplace.hyper_cube(3, 3, material_property="linear")
    th, _ = _pcg_both(jp, tp, lambda c: c.Config(
        operator=operator, max_levels=3,
        smoother=c.SmootherConfig(type="chebyshev", degree=2),
        agglomeration=c.AgglomerationConfig(nx=2, ny=2, nz=2)), seed=0)
    assert tp._A is None and tp._A_raw is None
    assert th.setup_route == "host" and th._constrained_mode() == "identity"
    assert th.operator_complexity() > 1.0


def test_matrix_free_hierarchy_on_adaptive_mesh():
    """tests/test_adaptive.py:138-158: the condensed cell-wise apply on a
    hanging mesh (fast_ap off: the Galerkin product through the condensed
    A); PCG count equal to mfmg_tpu's, the hanging slaves at 0."""
    jp = JLaplace.from_mesh(jad.adaptive_cube(2, 4, quadrant), "linear")
    tp = TLaplace.from_mesh(tad.adaptive_cube(2, 4, quadrant), "linear")
    _, x = _pcg_both(jp, tp, lambda c: c.Config(
        operator="matrix_free", max_levels=2,
        smoother=c.SmootherConfig(type="chebyshev", degree=3),
        agglomeration=c.AgglomerationConfig(partitioner="metis",
                                            n_agglomerates=16)), seed=3)
    assert np.allclose(x.numpy()[tp.mesh.hanging.slaves], 0.0)
