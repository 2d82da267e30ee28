"""The coarse solvers of mfmg_torch (solve/coarse.py: "cg", "amg"/"amgx" and
"ml") against mfmg_tpu on the CPU, in float64, on the reference's
hyper_cube(2, 5) of tests/test_hierarchy.py:242-350.

- "amg" with one nested level and "ml" with "max levels" 1 degenerate to
  the direct solve: their rates equal the direct hierarchy's at 1e-9.
- A multilevel AMG coarse solve is inexact: its rate is no better than the
  direct one's and below 0.6; so is two-level ML's.  "cg" converges to the
  direct rate.
- Every rate equals mfmg_tpu's at RATE_TOL; parse_ml_params consumes the
  same keys and warns on the same others; the raw smoothed-aggregation
  oracle (ML on the fine matrix as a stationary iteration) contracts below
  0.2, at mfmg_tpu's rate, and the two-level AMGe hierarchy beats it.
- The hierarchies with a CG, AMG or ML coarse solve decline the fused
  coarse tail (its gate wants a direct coarse solve) and take the generic
  recursion; the direct one takes the tail.

Their smoothed-aggregation levels smooth by Gauss-Seidel, so the reference
runs with its host library from a build private to the process
(tests/_torch_refnative.py).
"""

import warnings

import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.solve import coarse as jco
from mfmg_tpu.solve.operator import apply_op as j_apply
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.hierarchy import measure_vcycle_rate as t_rate
from mfmg_torch.ops.fused_cycle import build_fused_tail
from mfmg_torch.solve import coarse as tco

from _torch_rates import RATE_TOL, both_rates, one_torch_thread  # noqa: F401
from _torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native", "one_torch_thread")

CONSISTENCY_TOL = 1e-9          # tests/test_hierarchy.py:258


def base(c, coarse):
    """tests/test_hierarchy.py:252: standalone cycles, Chebyshev degree 2,
    2x2 agglomerates, the given coarse solver."""
    return c.Config(is_preconditioner=False, coarse=coarse(c),
                    smoother=c.SmootherConfig(type="chebyshev", degree=2),
                    agglomeration=c.AgglomerationConfig(nx=2, ny=2))


@pytest.fixture(scope="module")
def problems():
    return JLaplace.hyper_cube(2, 5), TLaplace.hyper_cube(2, 5)


@pytest.fixture(scope="module")
def direct_rate(problems):
    t, j = both_rates(*problems, lambda c: base(c, lambda c: c.CoarseConfig(
        type="direct")))
    assert abs(t - j) <= RATE_TOL, (t, j)
    return t


CASES = {
    "amg-1": lambda c: c.CoarseConfig(type="amg", max_levels=1),
    "ml-1": lambda c: c.CoarseConfig(type="ml", params={"max levels": 1}),
    "amg-3": lambda c: c.CoarseConfig(
        type="amg", max_levels=3,
        params={"aggregation: nodes per aggregate": 16}),
    "ml-2": lambda c: c.CoarseConfig(
        type="ml", params={"max levels": 2,
                           "aggregation: nodes per aggregate": 16}),
    "cg": lambda c: c.CoarseConfig(type="cg"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_coarse_solver_rates_match_reference(problems, direct_rate, case):
    t, j = both_rates(*problems, lambda c: base(c, CASES[case]))
    assert abs(t - j) <= RATE_TOL, (t, j)
    if case in ("amg-1", "ml-1", "cg"):
        assert t == pytest.approx(direct_rate, abs=CONSISTENCY_TOL), (t, direct_rate)
    elif case == "amg-3":
        assert direct_rate <= t + 1e-9 < 0.6, (direct_rate, t)
    else:
        assert direct_rate < t < 0.6, (direct_rate, t)


def test_nested_amg_levels_and_types(problems):
    """"amg" with max_levels 3: two nested AMGe levels below the last outer
    level, packaged as its coarse solver, as in mfmg_tpu."""
    jp, tp = problems
    th = THierarchy(tp, base(tcfg, CASES["amg-3"]), device="cpu")
    jh = JHierarchy(jp, base(jcfg, CASES["amg-3"]))
    assert len(th.levels) == len(jh.levels) == 2
    t_coarse, j_coarse = th.levels[-1].coarse, jh.levels[-1].coarse
    assert isinstance(t_coarse, tco.AMGCoarseSolver)
    assert len(t_coarse.levels) == len(j_coarse.levels) == 3
    assert ([lv.op.shape for lv in t_coarse.levels]
            == [lv.op.shape for lv in j_coarse.levels])
    assert t_coarse.n_smoothing_steps == j_coarse.n_smoothing_steps == 2
    assert th._A_shapes == jh._A_shapes
    assert th.grid_complexity() == jh.grid_complexity()


def test_parse_ml_params_warns_on_the_same_keys(problems):
    params = {"max levels": 2, "smoother: sweeps": 2,
              "smoother: type": "Chebyshev",
              "aggregation: nodes per aggregate": 9, "bogus ml key": 1}
    got = {}
    for name, mod in (("torch", tco), ("jax", jco)):
        cfg_mod = tcfg if name == "torch" else jcfg
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            knobs = mod.parse_ml_params(cfg_mod.CoarseConfig(type="ml",
                                                             params=params))
        got[name] = (knobs, sorted(str(w.message).split("'")[1] for w in rec))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == ["bogus ml key"]
    jp, tp = problems
    cfg = tcfg.Config(is_preconditioner=False,
                      smoother=tcfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=tcfg.AgglomerationConfig(nx=2, ny=2),
                      coarse=tcfg.CoarseConfig(type="ml", params=params))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        th = THierarchy(TLaplace.hyper_cube(2, 4), cfg, device="cpu")
    assert any("bogus ml key" in str(w.message) for w in rec)
    assert th.levels[-1].coarse.n_smoothing_steps == 2
    assert t_rate(th, 10) < 0.6


def test_raw_ml_oracle_matches_reference(problems):
    """tests/test_hierarchy.py:302: smoothed aggregation alone on the fine
    matrix, applied as x <- x - M_SA (A x - b), contracts below 0.2 at
    mfmg_tpu's rate, and the two-level AMGe hierarchy beats it."""
    jp, tp = problems
    params = {"max levels": 6, "aggregation: nodes per aggregate": 9}
    sa_t = tco.build_coarse_solver(
        tp.A, tcfg.CoarseConfig(type="ml", params=params),
        dtype=torch.float64, device="cpu", near_null=np.ones(tp.n_dofs))
    sa_j = jco.build_coarse_solver(
        jp.A, jcfg.CoarseConfig(type="ml", params=params),
        near_null=np.ones(jp.n_dofs))
    assert len(sa_t.levels) == len(sa_j.levels) >= 3
    import jax.numpy as jnp
    op_t, op_j = tp.ell_operator(device="cpu"), jp.ell_operator()
    rates = {}
    for name, apply, solve, arr, norm in (
            ("torch", lambda x: op_t(x), sa_t.apply, torch.from_numpy,
             lambda v: float(torch.linalg.norm(v))),
            ("jax", lambda x: j_apply(op_j, x), sa_j.apply, jnp.asarray,
             lambda v: float(jnp.linalg.norm(v)))):
        x = np.random.default_rng(0).uniform(size=tp.n_dofs)
        x[tp.constrained] = 0.0
        x = arr(x)
        res_prev = rate = None
        for _ in range(20):
            x = x - solve(apply(x))
            res = norm(apply(x))
            if res_prev:
                rate = res / res_prev
            nrm = norm(x)
            x, res_prev = x / nrm, res / nrm
        rates[name] = rate
    assert rates["torch"] < 0.2, rates
    assert abs(rates["torch"] - rates["jax"]) <= RATE_TOL, rates
    amge = t_rate(THierarchy(tp, base(tcfg, lambda c: c.CoarseConfig(
        type="direct")), device="cpu"), 20)
    assert amge < rates["torch"], (amge, rates)


@pytest.mark.parametrize("ctype", ["direct", "cg", "amg", "ml"])
def test_fused_tail_only_with_a_direct_coarse_solve(ctype):
    """The main configuration's three levels (float32 stencil, bf16 planes,
    4x4x4 agglomerates) on hyper_cube(3, 4): build_fused_tail takes the
    levels with a direct coarse solve and declines the others, whose
    V-cycle is then the generic recursion (on the card too:
    _finalize_cuda_kernels calls the same gate)."""
    cfg = tcfg.Config(max_levels=3, operator="stencil", dtype="float32",
                      coeff_dtype="bfloat16",
                      eigensolver=tcfg.EigensolverConfig(n_eigenvectors=2,
                                                         n_eigenvectors_deep=4),
                      smoother=tcfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=tcfg.AgglomerationConfig(nx=4, ny=4, nz=4),
                      coarse=tcfg.CoarseConfig(type=ctype))
    h = THierarchy(TLaplace.hyper_cube(3, 4, material_property="linear"), cfg,
                   device="cpu")
    tail = build_fused_tail(h.levels, 1, reduced_storage=True)
    assert (tail is not None) == (ctype == "direct"), type(h.levels[-1].coarse)
    assert h.levels[0].fused is None
    b = torch.from_numpy(np.random.default_rng(1).uniform(
        size=h.problem.n_dofs).astype(np.float32))
    x, info = h.solve_cg(b, tol=1e-5, maxiter=50)
    assert info["relres"] <= 1e-5 and bool(torch.isfinite(x).all())
