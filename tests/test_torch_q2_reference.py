"""The benchmark's plain Q2 reference (portbench/reference/hyper_cube_q2.py)
against the port, and the matrix-free operators' spans.

- The reference's eliminated Q2 operator equals the port's sum-factorised
  apply and its assembled ``LaplaceProblem.A`` on hyper_cube(3, 2,
  degree=2) with the "linear" material, within 1e-12 relative: both
  integrate the same bilinear form by the same 3x3x3 Gauss rule on affine
  cells in float64, so only the order of the sums differs.
- Alone, the reference is a Laplace operator: rows whose cells hold no
  Dirichlet dof vanish on a linear function's interpolant (constant
  coefficient: the rule integrates grad(phi_i) . g exactly) and sum to
  zero (any coefficient), it is symmetric and no cell is inverted.
- The port's Q2 mesh reads 0 on every mesh reading of ``fem.Problem``.
- The benchmark's configuration (portbench/configs/cube_q2_sumfac.json) at
  its dry size, through ``portbench/system.py``: a float32 sum-factorised
  hierarchy's solves meet the cell's true-residual limit under the
  reference's float64 operator.
- Each apply of the sum-factorised (Q2) and the matrix-free (Q1) operator
  opens one "sumfac.apply" / "mf.apply" span while tracing is on: 5 a
  V-cycle (Chebyshev degree 2 from zero before, degree 2 after, the
  residual), 1 + 5 for each preconditioner application of a solve; none
  while tracing is off.
- The benchmark's readers of them (portbench/metrics/sumfac_*.solve.py)
  on a hand-made stretch, None without a card or without the spans (an
  older program), and the work of a Q2 apply (portbench/work_mf.py) at
  65^3 by hand.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mfmg_torch import config as C
from mfmg_torch.amge.hierarchy import Hierarchy
from mfmg_torch.fem.laplace import LaplaceProblem
from mfmg_torch.utils import trace
from portbench.reference.fem import Problem

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/cube_q2_sumfac.json").read_text())
LIMITS = json.loads((ROOT / "portbench/limits/cube_q2_sumfac.solve.json").read_text())
# float64 roundoff of sums over 27 x 27 cell matrices in another order
REL_TOL = 1e-12


def reference(material, n_ref=2):
    """(the port's problem, the reference's problem on its mesh)."""
    p = LaplaceProblem.hyper_cube(3, n_ref, degree=2, material_property=material)
    cfg = dict(CONFIG, material_property={"type": material})
    return p, Problem(cfg, n_ref, p.mesh.nodes, p.constrained, "cpu")


def ref_apply(ref, X):
    """The reference's A X in the program's numbering, X (n, k) numpy."""
    return ref.to_program(ref.op.apply(ref.to_ref(torch.from_numpy(X)))).numpy()


@pytest.mark.parametrize("side", ["sumfac", "assembled"])
def test_reference_matches_the_port(side):
    p, ref = reference("linear")
    X = np.random.default_rng(18).standard_normal((p.n_dofs, 3))
    if side == "sumfac":
        op = p.matrix_free_operator(dtype=torch.float64, mode="sumfac",
                                    device="cpu")
        Y = np.stack([op(torch.from_numpy(X[:, j])).numpy() for j in range(3)], 1)
    else:
        Y = p.A @ X
    R = ref_apply(ref, X)
    assert np.abs(R - Y).max() <= REL_TOL * np.abs(Y).max()


def deep_rows(ref):
    """Reference dofs none of whose cells holds a Dirichlet dof."""
    cells, fixed = ref.op.cells, ref.op.constrained
    touched = fixed[cells].any(1)
    deep = torch.ones(ref.op.n, dtype=torch.bool)
    deep[cells[touched].reshape(-1)] = False
    return deep


@pytest.mark.parametrize("check", ["linear", "row sums", "symmetric", "det_min"])
def test_reference_is_a_laplace_operator(check):
    _, ref = reference("constant" if check == "linear" else "linear", n_ref=3)
    op = ref.op
    if check == "det_min":
        assert op.det_min == pytest.approx(0.125 ** 3, rel=1e-12)
        return
    if check == "symmetric":
        M = op.assembled()
        assert abs(M - M.T).max() <= REL_TOL * abs(M).max()
        return
    deep = deep_rows(ref)
    assert int(deep.sum()) == 11 ** 3        # nodes 3..13 of 0..16 a side
    if check == "linear":
        u = 0.3 + op.nodes @ torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    else:
        u = torch.ones(op.n, dtype=torch.float64)
    y = op.apply(u)
    scale = float(op.diag.abs().max() * u.abs().max())
    assert float(y[deep].abs().max()) <= REL_TOL * scale
    assert float(y[~deep & ~op.constrained].abs().max()) > 1e-3 * scale


@pytest.mark.parametrize("n_ref", [2, 3])
def test_mesh_readings_of_the_port_are_zero(n_ref):
    _, ref = reference("linear", n_ref)
    assert ref.readings == {k: 0.0 for k in ("dofs_gap", "mesh_numbering_defect",
                                             "mesh_node_gap",
                                             "mesh_boundary_mismatch",
                                             "mesh_inverted")}


@pytest.fixture(scope="module")
def dry_system():
    """The benchmark's configuration at its dry size, as portbench builds it."""
    from portbench.system import System
    return System(CONFIG, torch.device("cpu"), CONFIG["dry"]["n_refinements"])


def rhs(system, k, seed):
    B = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(k, system.n))).to(torch.float32)
    B[:, torch.as_tensor(system.problem.constrained)] = 0
    return B


def test_float32_sumfac_solves_meet_the_reference(dry_system):
    s = dry_system
    assert s.levels == CONFIG["dry"]["levels"] and s.dtype == torch.float32
    assert type(s.hier.levels[0].op).__name__ == "SumFactoredOperator"
    B = rhs(s, 3, 5)
    X = []
    for b in B:
        x, info = s.hier.solve_cg(b, tol=CONFIG["solver"]["tolerance"], maxiter=50)
        assert info["relres"] <= CONFIG["solver"]["tolerance"]
        X.append(x)
    nodes, _, constrained = s.mesh()
    ref = Problem(CONFIG, CONFIG["dry"]["n_refinements"], nodes, constrained, "cpu")
    Bd, Xd = ref.to_ref(B.T.double()), ref.to_ref(torch.stack(X).T.double())
    rel = torch.linalg.norm(Bd - ref.op.apply(Xd), dim=0) / torch.linalg.norm(Bd, dim=0)
    assert float(rel.max()) <= LIMITS["true_relres_max"]["limit"]


def matrix_free_q1_hierarchy():
    p = LaplaceProblem.hyper_cube(3, 3, material_property="linear")
    cfg = C.Config(max_levels=3, operator="matrix_free", dtype="float32",
                   eigensolver=C.EigensolverConfig(type="lapack",
                                                   n_eigenvectors=2,
                                                   n_eigenvectors_deep=4),
                   smoother=C.SmootherConfig(type="chebyshev", degree=2),
                   agglomeration=C.AgglomerationConfig(nx=2, ny=2, nz=2))
    return Hierarchy(p, cfg, device="cpu")


@pytest.mark.parametrize("kind", ["sumfac", "mf"])
def test_applies_open_one_span_and_count_one(kind, dry_system):
    if kind == "sumfac":
        hier, n = dry_system.hier, dry_system.n
        b = rhs(dry_system, 1, 6)[0]
    else:
        hier = matrix_free_q1_hierarchy()
        n = hier.problem.n_dofs
        b = torch.rand(n, generator=torch.Generator().manual_seed(6))
        b[torch.as_tensor(hier.problem.constrained)] = 0
    name = f"{kind}.apply"
    trace.take()
    trace.enable()
    try:
        hier.vmult(b)
        cycle = trace.counts().get(name, 0)
        trace.take()
        _, info = hier.solve_cg(b, tol=1e-5, maxiter=50)
        solve = trace.counts().get(name, 0)
        spans = trace.take()
    finally:
        trace.disable()
    assert cycle == 5
    k = info["iterations"]
    assert solve == (k + 1) * 6
    # each apply inside the operator's or a V-cycle's step, never a root
    assert all(s.parent >= 0 for s in spans if s.name == name)
    hier.vmult(b)
    assert trace.counts() == {} and trace.take() == []


def hand_stretch(with_applies=True):
    """Two solves in a stretch of 200 ns: three operator applies, one inside
    a V-cycle; five device operations, three launched inside an apply, one
    with no launch."""
    S = trace.Span
    name = "sumfac.apply" if with_applies else "pcg.iteration"
    s = [S("solve", 0, 100, -1, 1), S("pcg.operator", 5, 20, 0, 1),
         S(name, 6, 19, 1, 1), S("vcycle", 30, 80, 0, 1),
         S(name, 35, 45, 3, 1), S("solve", 100, 200, -1, 2),
         S(name, 110, 120, 5, 2)]
    device = [(10, 30, "a", 7), (40, 50, "a", 36), (55, 60, "b", 50),
              (120, 125, "a", 115), (130, 131, "c", None)]
    counts = {}
    for sp in s:
        counts[sp.name] = counts.get(sp.name, 0) + 1
    from portbench import spans
    return spans.Stretch(2, 0, 200, s, counts, device)


@pytest.mark.parametrize("case", ["hand", "older program", "cpu"])
def test_sumfac_readers(case, dry_system):
    from types import SimpleNamespace

    from portbench.core import load_reader
    st = hand_stretch(with_applies=case != "older program")
    ctx = SimpleNamespace(cuda=case != "cpu", notes={}, system=dry_system,
                          _spans={"host": st, "device": st})
    got = {m: load_reader(m)(ctx) for m in ("sumfac_device_ms.solve",
                                            "sumfac_applies.solve",
                                            "sumfac_apply_roofline.solve")
           if case == "cpu" or m != "sumfac_apply_roofline.solve"}
    if case == "hand":
        # 20 + 10 + 5 ns launched inside an apply, over two solves
        assert got == {"sumfac_device_ms.solve": pytest.approx(17.5e-6),
                       "sumfac_applies.solve": 1.5}
    else:
        assert all(v is None for v in got.values())


def test_sumfac_work_at_65_cubed():
    from portbench import work, work_mf
    n, n_cells = 65 ** 3, 32 ** 3
    b, f = work_mf.sumfac_work(n, n_cells, 3, 3, 3, 4, 4, 8)
    # u, y and the diagonal at 4 bytes, a flag byte, the metric (27 points x
    # 3 x 3 at 4 bytes) and the cells (27 int64) a cell
    assert b == 13 * n + n_cells * (27 * 9 * 4 + 27 * 8) == 42_498_509
    # a direction: 3 contractions of 27 outputs x 3 multiply-adds each way;
    # the metric's 9 multiply-adds at 27 points; the sums at 27 nodes x 3
    assert f == n_cells * (2 * 3 * 2 * 3 * 81 + 2 * 9 * 27 + 3 * 27)
    sec, by = work.bound(b, f)
    assert by == "bytes" and sec == pytest.approx(12.686e-6, rel=1e-4)
