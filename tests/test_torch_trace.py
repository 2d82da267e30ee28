"""The port's tracing (mfmg_torch/utils/trace.py) and its span sites: nothing
recorded and one shared null context while it is off, and a solve's answer
unchanged by it; on a small three-level stencil cube and a three-level ELL
hyper_ball, one ``solve`` root per solve, one ``pcg.iteration`` per PCG
iteration, ``iterations + 3`` host syncs, each V-cycle's level steps in
order with every child inside its parent, the hand count of ELL applies a
V-cycle; and the set-up stages of ``setup_seconds``, "cuda kernels" the
last, tiling the constructor's time."""

import numpy as np
import pytest
import torch

from mfmg_torch import config as C
from mfmg_torch.amge.hierarchy import Hierarchy
from mfmg_torch.fem import mesh as meshes
from mfmg_torch.fem.laplace import LaplaceProblem
from mfmg_torch.ops.fused_cycle import build_fused_tail
from mfmg_torch.utils import trace
from mfmg_torch.utils.timer import TimerOutput

TOL = 1e-5
LEVEL_STEPS = ("smooth.pre", "residual", "restrict", "prolong", "smooth.post")


def cube_problem():
    return LaplaceProblem.hyper_cube(3, 3, material_property="linear")


def cube_config():
    return C.Config(
        max_levels=3, operator="stencil", dtype="float32",
        coeff_dtype="bfloat16",
        eigensolver=C.EigensolverConfig(type="lapack", n_eigenvectors=2,
                                        n_eigenvectors_deep=4),
        smoother=C.SmootherConfig(type="chebyshev", degree=2),
        agglomeration=C.AgglomerationConfig(nx=2, ny=2, nz=2),
        coarse=C.CoarseConfig(type="direct"))


def ball_problem():
    return LaplaceProblem.from_mesh(meshes.hyper_ball(3, 1), "linear")


def ball_config():
    return C.Config(
        max_levels=3, operator="ell", dtype="float32",
        eigensolver=C.EigensolverConfig(type="lapack", n_eigenvectors=2,
                                        n_eigenvectors_deep=4,
                                        constrained_mode="pin"),
        smoother=C.SmootherConfig(type="chebyshev", degree=2,
                                  eig_estimate="lanczos"),
        agglomeration=C.AgglomerationConfig(nx=2, ny=2, nz=2),
        coarse=C.CoarseConfig(type="direct"))


CASES = {"cube": (cube_problem, cube_config), "ball": (ball_problem, ball_config)}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty buffer."""
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


@pytest.fixture(scope="module")
def hierarchies():
    torch.manual_seed(0)
    out = {}
    for name, (problem, config) in CASES.items():
        p = problem()
        out[name] = (p, Hierarchy(p, config(), device="cpu"))
    return out


def rhs(problem, seed=0):
    b = np.random.default_rng(seed).uniform(size=problem.n_dofs)
    b[problem.constrained] = 0.0
    return torch.as_tensor(b, dtype=torch.float32)


def traced(fn):
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.take()


def descendants(spans, root):
    """Indices of the spans under spans[root], in start order."""
    inside = {root}
    out = []
    for i in range(root + 1, len(spans)):
        if spans[i].parent in inside:
            inside.add(i)
            out.append(i)
    return out


def assert_nested(spans):
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.request == p.request


def test_off_records_nothing_and_changes_nothing(hierarchies):
    p, h = hierarchies["cube"]
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b") is trace.request("c")
    b = rhs(p)
    x_off, info_off = h.solve_cg(b, tol=TOL, maxiter=50)
    assert trace.take() == [] and trace.counts() == {}
    (x_on, info_on), spans = traced(lambda: h.solve_cg(b, tol=TOL, maxiter=50))
    assert spans and info_on == info_off
    assert torch.equal(x_on, x_off)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_spans(hierarchies, case):
    p, h = hierarchies[case]
    (x, info), spans = traced(lambda: h.solve_cg(rhs(p, 1), tol=TOL, maxiter=50))
    assert info["relres"] <= TOL          # stopped on the tolerance
    its = info["iterations"]
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert roots == [0] and spans[0].name == "solve" and spans[0].request > 0
    assert {s.request for s in spans} == {spans[0].request}
    assert_nested(spans)
    names = [s.name for s in spans]
    assert names.count("pcg.iteration") == its
    assert names.count("sync") == its + 3
    assert names.count("vcycle") == its + 1
    assert names.count("pcg.operator") == its + 1
    # the loop's tests and b's norm sit directly under the solve
    assert all(spans[s.parent].name == "solve" for s in spans if s.name == "sync")

    n_levels = len(h.levels)
    want = []
    for level in range(n_levels - 1):
        want += [f"L{level}.{step}" for step in LEVEL_STEPS[:3]]
    want.append("coarse")
    for level in reversed(range(n_levels - 1)):
        want += [f"L{level}.{step}" for step in LEVEL_STEPS[3:]]
    steps = set(want)
    nss = h.config.smoother.n_smoothing_steps
    degree = h.config.smoother.degree
    for v in (i for i, s in enumerate(spans) if s.name == "vcycle"):
        under = descendants(spans, v)
        assert [names[i] for i in under if names[i] in steps] == want
        n_ell = sum(names[i] == "ell.apply" for i in under)
        if case == "ball":
            # every level above the coarsest: nss Chebyshev steps of
            # `degree` applies before and after, the residual, R and R^T
            assert n_ell == (n_levels - 1) * (2 * nss * degree + 3)
    if case == "ball":
        # and one apply of the outer CG's operator a pcg.operator span
        assert names.count("ell.apply") == ((its + 1) * (n_levels - 1)
                                            * (2 * nss * degree + 3) + its + 1)
        assert trace.counts() == {}


def test_counts_and_vmult_request(hierarchies):
    p, h = hierarchies["ball"]
    trace.enable()
    h.vmult(rhs(p))
    h.apply(rhs(p, 2))
    trace.disable()
    counts = trace.counts()
    spans = trace.take()
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["vmult", "vmult"]
    assert roots[0].request != roots[1].request
    assert counts == {n: sum(s.name == n for s in spans) for n in counts}
    assert counts["vcycle"] == 2 and counts["coarse"] == 2


def test_fused_tail_span():
    """With the fused coarse tail on level 0 a V-cycle runs its smoothers
    around one ``tail`` span."""
    p = cube_problem()
    h = Hierarchy(p, cube_config(), device="cpu")
    h.levels[0].fused = build_fused_tail(h.levels, 1, reduced_storage=True)
    _, spans = traced(lambda: h.vmult(rhs(p)))
    assert [s.name for s in spans] == ["vmult", "vcycle", "L0.smooth.pre",
                                       "L0.residual", "tail", "L0.smooth.post"]
    assert_nested(spans)


def test_setup_stages_tile_the_set_up():
    """The stages of ``setup_seconds`` follow each other from the start of
    the set-up to the last, "cuda kernels", inside the constructor's time;
    with tracing on the driver's timer section is a span of that time."""
    def build():
        timer = TimerOutput()
        with timer.section("Setup: hierarchy"):
            h = Hierarchy(ball_problem(), ball_config(), device="cpu")
        return h, timer
    (h, timer), spans = traced(build)
    stages = h.setup_seconds
    assert list(stages)[-1] == "cuda kernels"
    assert list(stages)[:1] == ["fine operator"]
    assert all(v >= 0 for v in stages.values())
    total = timer.totals["Setup: hierarchy"]
    assert 0 < sum(stages.values()) <= total
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["Setup: hierarchy"]
    assert (roots[0].end_ns - roots[0].start_ns) / 1e9 <= total
    assert not any(s.name.startswith("setup.") for s in spans)
    assert_nested(spans)


def test_profiler_ranges_hold_the_spans(hierarchies):
    """Under a recording profiler every span opens a record_function range
    of its name, which holds the span's own interval."""
    from torch.profiler import ProfilerActivity, profile
    p, h = hierarchies["ball"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, spans = traced(lambda: h.vmult(rhs(p)))
    names = {s.name for s in spans}
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert set(ranges) == names
    for s in spans:
        assert any(a <= s.start_ns and s.end_ns <= b for a, b in ranges[s.name])
    # and none where tracing is on without them
    trace.enable(profiler_ranges=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        h.vmult(rhs(p))
    trace.disable()
    assert {s.name for s in trace.take()} == names
    assert not names & {e.name() for e in prof.profiler.kineto_results.events()}


def test_bounded_buffer(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    trace.enable()
    with trace.request("r"):
        for _ in range(4):
            with trace.span("s"):
                pass
    trace.disable()
    assert trace.dropped() == 2 and trace.counts() == {"r": 1, "s": 4}
    spans = trace.take()
    assert [s.name for s in spans] == ["r", "s", "s"]
    assert trace.dropped() == 0 and trace.counts() == {}
    with pytest.raises(RuntimeError):
        with trace.span("open"):
            trace.enable()
            with trace.span("inner"):
                trace.take()
