"""The LOBPCG ("anasazi") and shift-invert ARPACK eigensolvers of mfmg_torch
(eigen/lobpcg.py, eigen/arpack.py) against mfmg_tpu on the CPU, in float64,
on hyper_cube(3, 2) with 2x2x2 agglomerates and on seeded SPD blocks.

- LOBPCG against mfmg_tpu's on seeded SPD blocks without a constrained
  dof, with full_ortho True and False and from a warm start with a dead
  column (use_initial_guess's path): eigenvalues to 1e-10, spans
  (projector difference) to 1e-8, the same loop count and converged
  blocks; every block's own count at most the loop's.  On the cube's
  agglomerates, whose constrained dofs make the first iteration follow
  roundoff (see test_lobpcg_on_cube_agglomerates), both converge to the
  exact eigenvalues.
- The anasazi golden 0.0868251131 (test_hierarchy.cc:370) bounds the rate
  at the reference's loose tolerance 1e-2 from above (+1e-2) in both
  packages, as in tests/test_eigenvectors.py; the converged LOBPCG gives
  the matrix-free golden 0.0880045475 at 1e-2 and mfmg_tpu's rate at
  ANASAZI_RATE_TOL.
- ARPACK equals mfmg_tpu's sequential path (8 agglomerates: both run in
  agglomerate order) to 1e-12, with and without constraints on
  tests/test_eigenvectors.py's diagonal batch; the port's worker processes
  give its sequential path's bits; and the matrix-path golden
  0.0235237332 (test_hierarchy.cc:343, tests/test_hierarchy.py:77) holds
  at 1e-6 with type="arpack", the rate equal to mfmg_tpu's at RATE_TOL.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge import local_problems as jlp
from mfmg_tpu.amge.agglomeration import build_agglomerates as j_agg
from mfmg_tpu.eigen import arpack as ja
from mfmg_tpu.eigen import lobpcg as jlo
from mfmg_tpu.eigen.batched_eigh import batched_smallest_eigenpairs
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge import local_problems as tlp
from mfmg_torch.amge.agglomeration import build_agglomerates as t_agg
from mfmg_torch.eigen import arpack as ta
from mfmg_torch.eigen import lobpcg as tlo

from _torch_rates import (GOLDEN_MATRIX_SGS_3D, GOLDEN_MF_CHEBYSHEV_3D,
                          RATE_TOL, both_rates, cfg_3d,
                          one_torch_thread)  # noqa: F401
from test_torch_lanczos import EVAL_TOL, SPAN_TOL, projector_gap

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN_ANASAZI_MF_3D = 0.0868251131     # test_hierarchy.cc:370
# converged LOBPCG hierarchies (tolerance 1e-6, where the loop stops on
# its cap or near roundoff) against mfmg_tpu's: the coarse spaces agree to
# what the tolerance leaves, not to roundoff (read 1.3e-7 at 1e-10 on this
# problem)
ANASAZI_RATE_TOL = 1e-6


@pytest.fixture(scope="module")
def batches():
    tp = TLaplace.hyper_cube(3, 2)
    jp = JLaplace.hyper_cube(3, 2)
    t = tlp.build_agglomerate_batch(
        tp.mesh, tp.A_loc, t_agg(tp.mesh, tcfg.AgglomerationConfig(nx=2, ny=2, nz=2)))
    j = jlp.build_agglomerate_batch(
        jp.mesh, jp.A_loc, j_agg(jp.mesh, jcfg.AgglomerationConfig(nx=2, ny=2, nz=2)))
    return t, j


def spd_batch(module, n_agg=8, m=24, seed=11):
    """Seeded random SPD blocks (B B^T / m + 0.05 I), no constrained dof."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n_agg, m, m))
    A = B @ np.swapaxes(B, 1, 2) / m + 0.05 * np.eye(m)
    return module.AgglomerateBatch(
        dof_map=np.tile(np.arange(m), (n_agg, 1)), valid=np.ones((n_agg, m), bool),
        A_agg=A, diag=np.einsum("gii->gi", A),
        constrained=np.zeros((n_agg, m), bool), sizes=np.full(n_agg, m))


def _lobpcg_both(tb, jb, mode, guess=None, **kw):
    args = dict(n_eigenvectors=2, max_iterations=300, **kw)
    t = tlo.batched_lobpcg_smallest(tb, tcfg.EigensolverConfig(**args),
                                    constrained_mode=mode, initial_guess=guess,
                                    return_info=True, device="cpu")
    j = jlo.batched_lobpcg_smallest(jb, jcfg.EigensolverConfig(**args),
                                    constrained_mode=mode, initial_guess=guess,
                                    return_info=True)
    return t, j


@pytest.mark.parametrize("tol", [1e-3, 1e-6])
@pytest.mark.parametrize("full_ortho", [True, False])
def test_lobpcg_matches_reference(full_ortho, tol):
    """On blocks without a constrained dof the two iterations agree to
    roundoff: eigenvalues, spans, the loop count and the converged
    blocks."""
    (ev, vec, info), (jev, jvec, jinfo) = _lobpcg_both(
        spd_batch(tlp), spd_batch(jlp), "pin", tolerance=tol,
        full_ortho=full_ortho)
    np.testing.assert_allclose(ev, jev, rtol=0, atol=EVAL_TOL)
    assert projector_gap(vec, jvec) <= SPAN_TOL
    assert info["iterations"] == jinfo["iterations"] < 300
    np.testing.assert_array_equal(info["converged"], jinfo["converged"])
    assert info["converged"].all()
    assert info["block_iterations"].max() == info["iterations"]


def test_lobpcg_warm_start_matches_reference():
    """use_initial_guess's path: the exact vectors perturbed as the start
    block, a dead (zero) column re-drawn from the reference's stream."""
    tb, jb = spd_batch(tlp), spd_batch(jlp)
    _, guess = batched_smallest_eigenpairs(jb, 2, constrained_mode="raw")
    guess = guess + 1e-3 * np.random.default_rng(3).standard_normal(guess.shape)
    guess[0, :, 1] = 0.0
    (ev, vec, info), (jev, jvec, jinfo) = _lobpcg_both(
        tb, jb, "raw", guess=guess, tolerance=1e-6)
    np.testing.assert_allclose(ev, jev, rtol=0, atol=EVAL_TOL)
    assert projector_gap(vec, jvec) <= SPAN_TOL
    assert info["iterations"] == jinfo["iterations"]
    _, _, cold = tlo.batched_lobpcg_smallest(
        tb, tcfg.EigensolverConfig(n_eigenvectors=2, tolerance=1e-6,
                                   max_iterations=300),
        constrained_mode="raw", return_info=True, device="cpu")
    assert info["block_iterations"][1:].max() < cold["block_iterations"][1:].min()


@pytest.mark.parametrize("mode", ["identity", "pin"])
def test_lobpcg_on_cube_agglomerates(batches, mode):
    """hyper_cube(3, 2)'s agglomerates hold constrained dofs, where the
    start block and the Ritz vectors are zero up to roundoff.  The first
    iteration's trial basis [X, R, P] has P = 0, and the QR completes those
    columns with directions whose sign follows that roundoff (a reference
    quirk); they couple to the Ritz problem, so two implementations that
    differ in the last bit take different paths from there (mfmg_tpu's
    totals 103 and 123, the port's 92 and 134 at tolerance 1e-4).  Held
    here: both converge, to the same eigenvalues within what the tolerance
    leaves, and to the exact ones."""
    tb, jb = batches
    (ev, vec, info), (jev, jvec, jinfo) = _lobpcg_both(tb, jb, mode,
                                                       tolerance=1e-4)
    assert info["converged"].all() and jinfo["converged"].all()
    np.testing.assert_allclose(ev, jev, rtol=0, atol=1e-6)
    exact, evecs = batched_smallest_eigenpairs(jb, 2, constrained_mode=mode)
    np.testing.assert_allclose(ev, exact, rtol=0, atol=1e-6)
    assert projector_gap(vec, evecs) <= 1e-2


@pytest.mark.parametrize("tol", [1e-2, 1e-6], ids=["anasazi-bound", "converged"])
def test_anasazi_rates(tol):
    """tests/test_eigenvectors.py: LOBPCG at the reference's loose
    tolerance bounds the anasazi golden from above (the rate may be better,
    never worse), in both packages; converged, it gives the matrix-free
    golden at 1e-2 and mfmg_tpu's rate at ANASAZI_RATE_TOL.  At 1e-2 the
    rate depends on where each LOBPCG stops (see
    test_lobpcg_on_cube_agglomerates: mfmg_tpu 0.0691, the port 0.0808 on
    the CPU), so only the bound holds it there."""
    def make(c):
        return cfg_3d(c, eigensolver=c.EigensolverConfig(
            type="anasazi", n_eigenvectors=2, tolerance=tol,
            constrained_mode="identity"),
            smoother=c.SmootherConfig(type="chebyshev", degree=1,
                                      eig_estimate="dealii_cg"))
    t, j = both_rates(JLaplace.hyper_cube(3, 2), TLaplace.hyper_cube(3, 2), make)
    if tol > 1e-3:
        assert 0.02 < t < GOLDEN_ANASAZI_MF_3D + 1e-2, t
        assert 0.02 < j < GOLDEN_ANASAZI_MF_3D + 1e-2, j
    else:
        assert t == pytest.approx(GOLDEN_MF_CHEBYSHEV_3D, abs=1e-2), t
        assert abs(t - j) <= ANASAZI_RATE_TOL, (t, j)


def diag_batch(module, n=12, n_agg=3, constrained_first=False):
    """tests/test_eigenvectors.py diag_batch: A = diag(1..n) per agglomerate."""
    d = np.arange(1, n + 1, dtype=float)
    constrained = np.zeros((n_agg, n), dtype=bool)
    constrained[:, 0] = constrained_first
    return module.AgglomerateBatch(
        dof_map=np.tile(np.arange(n), (n_agg, 1)),
        valid=np.ones((n_agg, n), dtype=bool),
        A_agg=np.stack([np.diag(d)] * n_agg), diag=np.stack([d] * n_agg),
        constrained=constrained, sizes=np.full(n_agg, n))


@pytest.mark.parametrize("source", ["diagonal", "diagonal-constrained", "cube"])
def test_arpack_matches_reference_sequential_path(batches, source):
    if source == "cube":
        tb, jb = batches
        mode, n_ev = "pin", 2
    else:
        c = source.endswith("constrained")
        tb, jb = diag_batch(tlp, constrained_first=c), diag_batch(jlp, constrained_first=c)
        mode, n_ev = ("identity" if c else "raw"), 5
    args = dict(type="arpack", n_eigenvectors=n_ev, tolerance=1e-12)
    ev, vec = ta.batched_arpack_smallest(tb, tcfg.EigensolverConfig(**args), mode)
    jev, jvec = ja.batched_arpack_smallest(jb, jcfg.EigensolverConfig(**args), mode)
    np.testing.assert_allclose(ev, jev, rtol=0, atol=1e-12)
    np.testing.assert_allclose(vec, jvec, rtol=0, atol=1e-12)
    if source != "cube":
        expect = np.arange(1, 6) + (1 if source.endswith("constrained") else 0)
        np.testing.assert_allclose(ev, np.broadcast_to(expect, ev.shape), atol=1e-9)


def test_arpack_golden_rate():
    """tests/test_hierarchy.py:77: the matrix-path golden with the ARPACK
    eigensolver (lexicographic GS in deal.II's order)."""
    def make(c):
        return cfg_3d(c, operator="ell",
                      eigensolver=c.EigensolverConfig(type="arpack",
                                                      n_eigenvectors=2,
                                                      tolerance=1e-10),
                      smoother=c.SmootherConfig(type="gauss-seidel",
                                                coloring="lexicographic",
                                                ordering="dealii"))
    jp = JLaplace.hyper_cube(3, 2, material_property="constant")
    tp = TLaplace.hyper_cube(3, 2, material_property="constant")
    t, j = both_rates(jp, tp, make)
    assert t == pytest.approx(GOLDEN_MATRIX_SGS_3D, abs=1e-6), t
    assert abs(t - j) <= RATE_TOL, (t, j)


def test_arpack_process_pool_equals_the_sequential_path():
    """A batch large enough for the worker processes (512 agglomerates of
    hyper_cube(3, 4), 4 workers) gives the sequential path's eigenpairs bit
    for bit: every start vector is drawn before the batch is split.  Run in
    a process of its own, without JAX (whose threads a forked worker of
    this process would inherit)."""
    code = """
import os, numpy as np
import mfmg_torch.config as cfg
from mfmg_torch import LaplaceProblem
from mfmg_torch.amge.agglomeration import build_agglomerates
from mfmg_torch.amge.local_problems import build_agglomerate_batch
from mfmg_torch.eigen import arpack
p = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
batch = build_agglomerate_batch(p.mesh, p.A_loc, build_agglomerates(
    p.mesh, cfg.AgglomerationConfig(nx=2, ny=2, nz=2)))
ec = cfg.EigensolverConfig(type="arpack", n_eigenvectors=2, tolerance=1e-8)
os.sched_getaffinity = lambda pid: {0, 1, 2, 3}
pooled = arpack.batched_arpack_smallest(batch, ec, "pin")
os.sched_getaffinity = lambda pid: {0}
in_order = arpack.batched_arpack_smallest(batch, ec, "pin")
assert batch.n_agg == 512
assert all(np.array_equal(a, b) for a, b in zip(pooled, in_order))
print("equal")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=root)
    assert proc.returncode == 0 and "equal" in proc.stdout, proc.stderr[-3000:]
