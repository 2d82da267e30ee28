"""The Lanczos eigensolver of mfmg_torch (eigen/lanczos.py) against mfmg_tpu
on the CPU, in float64.

- The Cullum-Willoughby filter and the convergence schedule equal the
  reference's; the host solve, single and deflated, equals the reference's
  on tests/test_lanczos.py's SimpleOperator (the same numpy code).
- The batched Lanczos (the port's loop of torch.bmm) against mfmg_tpu's
  lax.scan on hyper_cube(3, 2) with 2x2x2 agglomerates, in the identity
  and pin modes, and deflated on two SimpleOperator batches: eigenvalues to
  1e-10, spans (the difference of the projectors) to 1e-8.
- The matrix-free golden 0.0880045475 (test_hierarchy.cc:353) at 1e-2 with
  type="lanczos", the rate equal to mfmg_tpu's at RATE_TOL.
"""

import numpy as np
import pytest

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge import local_problems as jlp
from mfmg_tpu.amge.agglomeration import build_agglomerates as j_agg
from mfmg_tpu.eigen import lanczos as jl
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge import local_problems as tlp
from mfmg_torch.amge.agglomeration import build_agglomerates as t_agg
from mfmg_torch.eigen import lanczos as tl

from _torch_rates import (GOLDEN_MF_CHEBYSHEV_3D, RATE_TOL,  # noqa: F401
                          both_rates, cfg_3d, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EVAL_TOL, SPAN_TOL = 1e-10, 1e-8


def projector_gap(a, b):
    """Largest over the batch of ||P_a - P_b||_2, P the orthogonal projector
    onto the span of each agglomerate's vectors."""
    qa, _ = np.linalg.qr(a)
    qb, _ = np.linalg.qr(b)
    d = qa @ np.swapaxes(qa, 1, 2) - qb @ np.swapaxes(qb, 1, 2)
    return float(np.linalg.norm(d, ord=2, axis=(1, 2)).max())


def simple_operator(n, multiplicity=1):
    """tests/test_lanczos.py: eigenvalues 1 + floor(i / multiplicity)."""
    d = 1.0 + np.arange(n) // multiplicity
    return d, (lambda x: d * x)


def test_cw_filter_and_schedule_match_reference():
    rng = np.random.default_rng(5)
    for n, k in ((1, 1), (2, 1), (7, 2), (30, 4)):
        a = rng.uniform(1, 3, size=n)
        b = rng.uniform(0, 1, size=n - 1)
        if n > 3:
            b[2] = 1e-15          # a decoupled block: repeated values
        t, j = tl.tridiag_eigenpairs_cw(a, b, k), jl.tridiag_eigenpairs_cw(a, b, k)
        for x, y in zip(t, j):
            np.testing.assert_array_equal(x, y)
    assert tl.tridiag_eigenpairs_cw([2.0, 2.0, 2.0], [0.0, 1e-15], 1)[0][0] == \
        pytest.approx(2.0)
    for maxit, po in ((200, 5), (50, 0), (125, 5), (7, 100)):
        assert tl.check_schedule(maxit, po) == jl.check_schedule(maxit, po)


@pytest.mark.parametrize("multiplicity,n_req,deflated",
                         [(1, 4, False), (2, 8, False), (2, 4, True)])
def test_lanczos_solve_matches_reference(multiplicity, n_req, deflated):
    n = 400
    _, mv = simple_operator(n, multiplicity)
    kw = dict(tol=1e-2, maxit=n, percent_overshoot=5, seed_base=42)
    if deflated:
        kw.update(is_deflated=True, num_cycles=2, num_eigenpairs_per_cycle=2)
    ev, vec, it = tl.lanczos_solve(mv, n, n_req, **kw)
    jev, jvec, jit = jl.lanczos_solve(mv, n, n_req, **kw)
    assert it == jit
    np.testing.assert_array_equal(ev, jev)
    np.testing.assert_array_equal(vec, jvec)
    for i in range(n_req):
        assert np.linalg.norm(mv(vec[:, i]) - ev[i] * vec[:, i]) < 5e-2


@pytest.fixture(scope="module")
def batches():
    tp = TLaplace.hyper_cube(3, 2)
    jp = JLaplace.hyper_cube(3, 2)
    t = tlp.build_agglomerate_batch(
        tp.mesh, tp.A_loc, t_agg(tp.mesh, tcfg.AgglomerationConfig(nx=2, ny=2, nz=2)))
    j = jlp.build_agglomerate_batch(
        jp.mesh, jp.A_loc, j_agg(jp.mesh, jcfg.AgglomerationConfig(nx=2, ny=2, nz=2)))
    return t, j


@pytest.mark.parametrize("mode", ["identity", "pin"])
def test_batched_lanczos_matches_reference(batches, mode):
    tb, jb = batches
    kw = dict(type="lanczos", n_eigenvectors=2, tolerance=1e-14,
              max_iterations=200, percent_overshoot=5)
    stats = {}
    ev, vec = tl.batched_lanczos_smallest(tb, tcfg.EigensolverConfig(**kw),
                                          constrained_mode=mode, device="cpu",
                                          stats=stats)
    jev, jvec = jl.batched_lanczos_smallest(jb, jcfg.EigensolverConfig(**kw),
                                            constrained_mode=mode)
    assert ev.shape == jev.shape and vec.shape == jvec.shape
    np.testing.assert_allclose(ev, jev, rtol=0, atol=EVAL_TOL)
    assert projector_gap(vec, jvec) <= SPAN_TOL
    assert stats["iterations"] == [int(tb.sizes.min())]
    assert stats["lanczos_vector_bytes"] == 8 * int(tb.sizes.min()) * vec.shape[0] * vec.shape[1]


def test_batched_deflated_lanczos_matches_reference():
    """Two SimpleOperators of multiplicity 2, deflated over two cycles of
    two pairs (tests/test_lanczos.py): the re-seeded guesses and the
    deflation basis give the reference's eigenpairs."""
    n = 60
    diags = [1.0 + np.arange(n) // 2, 0.5 + 0.5 * (np.arange(n) // 2)]
    arrays = dict(dof_map=np.tile(np.arange(n), (2, 1)),
                  valid=np.ones((2, n), dtype=bool),
                  A_agg=np.stack([np.diag(d) for d in diags]),
                  diag=np.stack(diags),
                  constrained=np.zeros((2, n), dtype=bool),
                  sizes=np.full(2, n, dtype=np.int64))
    kw = dict(type="lanczos", n_eigenvectors=4, tolerance=1e-2,
              max_iterations=n, percent_overshoot=5, is_deflated=True,
              num_cycles=2, num_eigenpairs_per_cycle=2)
    ev, vec = tl.batched_lanczos_smallest(
        tlp.AgglomerateBatch(**arrays), tcfg.EigensolverConfig(**kw),
        constrained_mode="raw", device="cpu")
    jev, jvec = jl.batched_lanczos_smallest(
        jlp.AgglomerateBatch(**arrays), jcfg.EigensolverConfig(**kw),
        constrained_mode="raw")
    np.testing.assert_allclose(ev, jev, rtol=0, atol=EVAL_TOL)
    np.testing.assert_allclose(ev[0], [1, 1, 2, 2], atol=1e-2)
    assert projector_gap(vec, jvec) <= SPAN_TOL


def test_golden_mf_rate_with_lanczos():
    """tests/test_lanczos.py: the matrix-free golden holds with the
    "lanczos" eigensolver (the reference's own MF golden uses it)."""
    def make(c):
        return cfg_3d(c, operator="matrix_free",
                      eigensolver=c.EigensolverConfig(type="lanczos",
                                                      n_eigenvectors=2),
                      smoother=c.SmootherConfig(type="chebyshev", degree=1))
    t, j = both_rates(JLaplace.hyper_cube(3, 2), TLaplace.hyper_cube(3, 2), make)
    assert t == pytest.approx(GOLDEN_MF_CHEBYSHEV_3D, abs=1e-2), t
    assert abs(t - j) <= RATE_TOL, (t, j)
