"""Kernels K1-K5 and the fused coarse tail on the card against their plain
PyTorch versions.

Marked ``cuda``: each test takes the ``cuda`` fixture, which skips when
torch.cuda.is_available() is False (every CPU-only host).  On a machine with
an NVIDIA H100 run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py configures JAX, which that machine
does not need and may not have; this file imports no JAX.)

K2 is held in both forms: the blocked form on Q1 planes (17^3, 33^3, a
ragged 19x23x37 grid; its rule takes it only at 129^3, which chip_smoke.py
runs), the chain where the rule sends these grids, on Q1 planes and the Q2
cube's 62 pairs, and with K1 at 171 pairs on a symmetrized Q3 stencil.
K1/K3's tiled kernel is held on ragged grids (x extents no multiple of a
16-byte chunk), radius 1-3, dense and sparse offsets, row segments and a
one-slice grid, and repeats its bits.  The unstructured meshes (a
hyper_ball with the block walk, an adaptive cube with hanging nodes and RCB
parts, ELL at every level) are held against the CPU port: level sizes and
PCG counts equal, the float64 V-cycle rate within 1e-6.  The matrix-free
and sum-factorized applies repeat their bits; the multicolor colorings are
proper on the card; the MF-Chebyshev golden (four operators), the
lexicographic GS golden, ILU(0) and multicolor SGS hold in float64 on the
card, each rate equal to the CPU port's within 1e-10.

Tolerances: K1 and K3 1e-5 ||y||_inf (float accumulation, the kernel
contracts multiply-adds into FMAs); K2 1e-5 relative on x and 1e-4 relative
on the residual (the bounds of tests/test_pallas.py); K4/K5 and the fused
tail 1e-5 relative (2-norm), the bound tests/test_fused_cycle.py holds the
reference's kernel to: float sums over the same operands in another order.
The windowed random tails' coarse correction is ~0.13% of their output
(a hierarchy's 4-69%, scripts/tail_share.py), so a bf16 rounding of that
form that flips under the other order stays at roundoff there; the tails
whose correction is a hierarchy-like share (HIERARCHY_INV2_SCALE) are held
instead to the float64 plain version with the same rounding points, under
the limit _torch_tails.rounding_limit measures on each input.
"""

import copy
import itertools

import numpy as np
import pytest
import torch

import mfmg_torch.config as tcfg
from _torch_stencils import cube_offsets, symmetrize
import _torch_tails as tt
from _torch_tails import UNSTAGED_TAILS, random_tail
from mfmg_torch import Hierarchy, LaplaceProblem
from mfmg_torch.amge.hierarchy import LevelData
from mfmg_torch.ops import fused_cycle as tfc
from mfmg_torch.ops import stencil as tst
from mfmg_torch.ops import stencil_kernels as tk
from mfmg_torch.ops import transfer_kernels as ttk
from mfmg_torch.ops.structured_transfer import (GeneralWindowTransfer,
                                               StructuredTransfer)
from mfmg_torch.solve.smoothers import (ChebyshevSmoother,
                                        FusedChebyshevSmoother, build_smoother,
                                        fuse_chebyshev)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _op(n_ref, dtype, device):
    p = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear")
    host = tst.stencil_from_cell_matrices(p.mesh, p.A_loc, p.constrained,
                                          p.diag_raw, dtype=dtype)
    sm = build_smoother(host, tcfg.SmootherConfig(type="chebyshev", degree=2),
                        dtype=torch.float32)
    return p, tst.stencil_to_device(host, device), sm.to(device)


@pytest.mark.parametrize("n_ref", [4, 5], ids=["17^3", "33^3"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_matches_plain(cuda, n_ref, dtype):
    p, op, _ = _op(n_ref, dtype, cuda)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, p.n_dofs).astype(np.float32)).to(cuda)
    before = tk.LAUNCHES["stencil_apply_sym"]
    y = tk.stencil_apply_sym(op.planes, x, op.pos_offsets, op.grid_shape)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["stencil_apply_sym"] == before + 1
    ref = tk.stencil_apply_sym_plain(op.planes, x, op.pos_offsets, op.grid_shape)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _random_sym_planes(grid, pos, dtype, device, seed):
    """Random positive planes of a symmetric stencil with a dominant
    center, the reciprocal diagonal, and a Chebyshev recurrence."""
    rng = np.random.default_rng(seed)
    planes = rng.uniform(-1.0, 0.0, (1 + len(pos),) + grid)
    planes[0] = 2.0 * len(pos) + rng.uniform(0.0, 1.0, grid)
    planes = torch.from_numpy(planes.astype(np.float32)).to(dtype)
    inv_diag = 1.0 / planes[0].to(torch.float32).reshape(-1)
    return planes.to(device), inv_diag.to(device)


def _k2_case(case, dtype, degree, device):
    """(planes, pos_offsets, grid, inv_diag, coef, n): the Q1 main-path
    stencil at 17^3 or 33^3 with its smoother, or random Q1 planes on a
    ragged 19x23x37 grid."""
    if case == "ragged":
        grid = (19, 23, 37)
        pos = tuple(o for o in itertools.product((-1, 0, 1), repeat=3)
                    if o > (0, 0, 0))
        planes, inv_diag = _random_sym_planes(grid, pos, dtype, device, degree)
        coef = torch.tensor([0.9, 0.7, 0.5][:degree] + [0.0, 0.2, 0.1][:degree],
                            dtype=torch.float32, device=device)
        return planes, pos, grid, inv_diag, coef, int(np.prod(grid))
    p, op, sm = _op(4 if case == "17^3" else 5, dtype, device)
    sm.degree = degree
    fused = fuse_chebyshev(sm, op)
    return (op.planes, op.pos_offsets, op.grid_shape, fused.inv_diag, fused.coef,
            p.n_dofs)


def _hold_k2(planes, pos, grid, inv_diag, coef, n, degree, device, form=None):
    """K2 with and without the residual against its plain version: x to
    1e-5, the residual to 1e-4 (relative 2-norms); through its rule, or in
    the given form."""
    rng = np.random.default_rng(1)
    x, b = (torch.from_numpy(rng.uniform(size=n).astype(np.float32)).to(device)
            for _ in range(2))
    for want_res in (False, True):
        args = (planes, x, b, inv_diag, coef, pos, grid, degree, want_res)
        got = tk.cheb_smooth(*args) if form is None else tk._cheb_smooth(form, *args)
        ref = tk.cheb_smooth_plain(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(got[0]).all()
        assert _rel(got[0], ref[0]) <= 1e-5
        if want_res:
            assert _rel(got[1], ref[1]) <= 1e-4


@pytest.mark.parametrize("case", ["17^3", "33^3", "ragged"])
@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_matches_plain(cuda, case, degree, dtype):
    """K2's blocked form on Q1 planes, one launch per call."""
    planes, pos, grid, inv_diag, coef, n = _k2_case(case, dtype, degree, cuda)
    before = dict(tk.LAUNCHES)
    _hold_k2(planes, pos, grid, inv_diag, coef, n, degree, cuda, form="blocked")
    assert tk.LAUNCHES["cheb_smooth_blocked"] == before["cheb_smooth_blocked"] + 2
    assert tk.LAUNCHES["cheb_smooth_chain"] == before["cheb_smooth_chain"]


@pytest.mark.parametrize("case", ["Q2-cube-33^3", "Q1-33^3"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_chain_matches_plain(cuda, case, dtype):
    """The chain form, where the rule sends K2 at 33^3: on Q1 planes and
    at the Q2 cube's 62 pairs (its cell matrices symmetrized, so that every
    host gives the pair planes)."""
    if case == "Q1-33^3":
        planes, pos, grid, inv_diag, coef, n = _k2_case("33^3", dtype, 2, cuda)
    else:
        p = LaplaceProblem.hyper_cube(3, 4, degree=2, material_property="linear")
        A_sym = 0.5 * (p.A_loc + np.swapaxes(p.A_loc, 1, 2))
        host = tst.stencil_from_cell_matrices(p.mesh, A_sym, p.constrained,
                                              p.diag_raw, dtype=dtype)
        assert host.sym_pos is not None and len(host.sym_pos) == 62
        sm = build_smoother(host, tcfg.SmootherConfig(type="chebyshev", degree=2),
                            dtype=torch.float32)
        op = tst.stencil_to_device(host, cuda)
        fused = fuse_chebyshev(sm.to(cuda), op)
        planes, pos, grid = op.planes, op.pos_offsets, op.grid_shape
        inv_diag, coef, n = fused.inv_diag, fused.coef, p.n_dofs
    assert all(tk.k2_form(tuple(pos), 2, r, tuple(grid)) == "chain"
               for r in (False, True))
    before = dict(tk.LAUNCHES)
    _hold_k2(planes, pos, grid, inv_diag, coef, n, 2, cuda)
    assert tk.LAUNCHES["cheb_smooth_chain"] == before["cheb_smooth_chain"] + 2
    assert tk.LAUNCHES["cheb_smooth_blocked"] == before["cheb_smooth_blocked"]


def _q3_symmetric(dtype, device):
    """The Q3 13^3 operator with its planes symmetrized (171 positive
    offsets of radius 3) and its degree-2 smoother, fused."""
    p = LaplaceProblem.hyper_cube(3, 2, degree=3, material_property="linear")
    host = tst.stencil_from_cell_matrices(p.mesh, p.A_loc, p.constrained,
                                          p.diag_raw, dtype=torch.float64)
    c = symmetrize(host.coeffs.numpy(), host.offsets, host.grid_shape)
    host = tst.StencilOperator(torch.from_numpy(c).to(dtype), host.offsets,
                               host.grid_shape,
                               tst.detect_symmetry(c, host.offsets, host.grid_shape))
    assert host.sym_pos is not None and len(host.sym_pos) == 171
    sm = build_smoother(host, tcfg.SmootherConfig(type="chebyshev", degree=2),
                        dtype=torch.float32)
    op = tst.stencil_to_device(host, device)
    return p, op, fuse_chebyshev(sm.to(device), op)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_symmetric_q3_on_the_card(cuda, dtype):
    """K1 and K2's chain at 171 pairs (a symmetrized Q3 stencil, radius 3)
    against their plain versions: K1 to 1e-5 ||y||_inf, K2 1e-5 on x and
    1e-4 on the residual; one launch each per call."""
    p, op, fused = _q3_symmetric(dtype, cuda)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, p.n_dofs).astype(np.float32)).to(cuda)
    before = dict(tk.LAUNCHES)
    y = op(x)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["stencil_apply_sym"] == before["stencil_apply_sym"] + 1
    ref = tk.stencil_apply_sym_plain(op.planes, x, op.pos_offsets, op.grid_shape)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    _hold_k2(op.planes, op.pos_offsets, op.grid_shape, fused.inv_diag, fused.coef,
             p.n_dofs, 2, cuda)
    assert tk.LAUNCHES["cheb_smooth_chain"] == before["cheb_smooth_chain"] + 2


K13_CASES = {
    # name: (grid, radius, symmetric pairs (K1) or one-sided (K3), sparse)
    "K3-r1-19x23x37": ((19, 23, 37), 1, False, False),
    "K3-r2-19x23x37": ((19, 23, 37), 2, False, False),
    "K3-r3-sparse-11x9x13": ((11, 9, 13), 3, False, True),
    "K3-r2-row-segments-3x5x1100": ((3, 5, 1100), 2, False, False),
    "K1-r1-19x23x37": ((19, 23, 37), 1, True, False),
    "K1-r2-sparse-19x23x37": ((19, 23, 37), 2, True, True),
    "K1-r3-13x7x29": ((13, 7, 29), 3, True, False),
    "K1-r1-one-slice-1x5x6": ((1, 5, 6), 1, True, False),
}


@pytest.mark.parametrize("case", list(K13_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k13_tiles_match_plain(cuda, case, dtype):
    """K1/K3's tiles on ragged grids whose x extent is no multiple of the
    16-byte chunk (bf16 and f32 planes start at every phase of it), radius
    1-3, dense and sparse offsets, whole-row tiles and row segments, one z
    slice: random planes against the plain versions, 1e-5 ||y||_inf; two
    launches give the same bits (fixed summation order, no atomics)."""
    grid, radius, sym, sparse = K13_CASES[case]
    offsets = cube_offsets(radius, sym, sparse)
    rng = np.random.default_rng(len(offsets))
    n = int(np.prod(grid))
    n_planes = 1 + len(offsets) if sym else len(offsets)
    planes = torch.from_numpy(rng.uniform(-1, 1, (n_planes,) + grid)
                              .astype(np.float32)).to(dtype).to(cuda)
    x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda)
    fn, plain, key = ((tk.stencil_apply_sym, tk.stencil_apply_sym_plain,
                       "stencil_apply_sym") if sym else
                      (tk.stencil_apply, tk.stencil_apply_plain, "stencil_apply"))
    before = tk.LAUNCHES[key]
    y, again = fn(planes, x, offsets, grid), fn(planes, x, offsets, grid)
    ref = plain(planes, x, offsets, grid)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[key] == before + 2
    assert torch.equal(y, again)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# A V-cycle with the bf16-weight tail against the generic recursion: the bf16
# storage alone, 1.1e-3 to 1.6e-3 at 17^3 and 33^3 on the CPU
# (tests/test_torch_fused_cycle.py::test_bf16_tail_gap_to_generic_recursion).
BF16_STORAGE_GAP = 2e-3


def test_cuda_hierarchy_matches_cpu(cuda):
    """The main-path configuration at 17^3 on the card against the same
    hierarchy on the CPU (plain versions; the card's bf16-weight fused tail
    attached to the CPU levels too; both set up by the host route): same
    PCG iteration count, V-cycle within 1e-5 relative, and all three
    kernels launched.  The card's V-cycle is also held to the CPU generic
    recursion (no tail) within BF16_STORAGE_GAP."""
    cfg = _main_config(backend="host")
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    hc, hg = Hierarchy(prob, cfg, device="cpu"), Hierarchy(prob, cfg)
    assert hc.setup_route == hg.setup_route == "host"
    b = np.random.default_rng(2).uniform(size=prob.n_dofs).astype(np.float32)
    y_generic = hc.vmult(b)
    hc.levels[0].fused = tfc.build_fused_tail(hc.levels, 1, reduced_storage=True)
    tk.reset_launch_counts()
    _, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    assert all(tk.LAUNCHES[k] > 0
               for k in ("stencil_apply_sym", "cheb_smooth", "fused_tail"))
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]
    yc, yg = hc.vmult(b), hg.vmult(b).cpu()
    assert float(torch.linalg.norm(yg - yc)) <= 1e-5 * float(torch.linalg.norm(yc))
    assert _rel(yg, y_generic) <= BF16_STORAGE_GAP


@pytest.mark.parametrize("degree,n_ref", [(1, 4), (2, 3), (2, 4), (3, 2)],
                         ids=["Q1-17^3", "Q2-17^3", "Q2-33^3", "Q3-13^3"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_matches_plain(cuda, degree, n_ref, dtype):
    """K3 on one-sided operators (Q1 with all 27 planes, Q2 125, Q3 343)
    against its plain version; one launch per call, through the dispatch."""
    p = LaplaceProblem.hyper_cube(3, n_ref, degree=degree,
                                  material_property="linear")
    host = tst.stencil_from_cell_matrices(p.mesh, p.A_loc, p.constrained,
                                          p.diag_raw, dtype=dtype)
    op = tst.stencil_to_device(tst.StencilOperator(
        host.coeffs, host.offsets, host.grid_shape, None), cuda)
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, p.n_dofs).astype(np.float32)).to(cuda)
    before = tk.LAUNCHES["stencil_apply"]
    y = op(x)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["stencil_apply"] == before + 1
    ref = tk.stencil_apply_plain(op.coeffs, x, op.offsets, op.grid_shape)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("shape", ["Q1-33^3", "Q2-33^3", "ragged-5^3"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k4_k5_match_plain(cuda, shape, bf16):
    """K4 and K5 against their plain versions on the level-0 transfer of a
    main-path hierarchy (5^3 or 9^3 windows) and on random weights over a
    3x4x5 agglomerate grid (5^3 windows), float32 and bf16 weights; one
    launch each; adjoint to 1e-5."""
    if shape == "ragged-5^3":
        agg = (3, 4, 5)
        W = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (2, 5, 5, 5) + agg).astype(np.float32)).to(cuda)
        tr = StructuredTransfer(W, (5, 5, 5), agg, tuple(4 * a + 1 for a in agg))
    else:
        tr = (_hier(5) if shape.startswith("Q1") else _hier_q2(4)).levels[0].transfer
    W = tr.W.to(torch.bfloat16) if bf16 else tr.W
    g = (tr.window_shape, tr.agg_shape, tr.grid_shape)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(tr.shape[1]).astype(np.float32)).to(cuda)
    xc = torch.from_numpy(rng.standard_normal(tr.shape[0]).astype(np.float32)).to(cuda)
    before = dict(tk.LAUNCHES)
    rx, py = ttk.structured_restrict(W, x, *g), ttk.structured_prolong(W, xc, *g)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["structured_restrict"] == before["structured_restrict"] + 1
    assert tk.LAUNCHES["structured_prolong"] == before["structured_prolong"] + 1
    assert _rel(rx, ttk.structured_restrict_plain(W, x, *g)) <= 1e-5
    assert _rel(py, ttk.structured_prolong_plain(W, xc, *g)) <= 1e-5
    lhs, rhs = float(torch.dot(rx, xc)), float(torch.dot(x, py))
    assert abs(lhs - rhs) <= 1e-5 * float(torch.linalg.norm(rx) * torch.linalg.norm(xc))


# K4 at the geometries of its plans (ops/transfer_kernels.py restrict_plan;
# the CPU model tests/test_torch_kernel_plans.py holds the same ones): the
# 129^3 shape (blocks marching over 4 slabs with float32 W, one slab with
# bf16) and the distorted-Q2 shape, a gx no multiple of 4
# (the scalar path), uneven gy (a plan for 1 SM, which puts 6 agglomerate
# rows in a block over 7), marching with ragged runs in y and z (a plan for
# 2 SMs, 3 slabs per block over 7), rows of 12 agglomerates (a plan for 1
# SM: 3 copies of W per row, the copy loop without a fixed lane per chunk),
# c = 1, 3, 4 and 5 (scalar); (window, agglomerates, c, SMs of the plan or
# None for the card's own, slabs per block or None for the plan's rule)
K4_CASES = {
    "129^3": ((5, 5, 5), (32, 32, 32), 2, None, None),
    "distorted-Q2": ((9, 9, 9), (8, 8, 8), 2, None, None),
    "ragged-gx": ((5, 5, 5), (3, 4, 5), 2, None, None),
    "uneven-gy": ((3, 3, 3), (3, 7, 8), 2, 1, None),
    "march-ragged": ((5, 5, 5), (7, 4, 8), 2, 2, 3),
    "three-chunks": ((3, 3, 3), (2, 3, 12), 2, 1, None),
    "c1": ((5, 5, 5), (2, 3, 8), 1, None, None),
    "c3": ((3, 4, 5), (2, 5, 4), 3, None, None),
    "c4": ((9, 9, 9), (2, 2, 4), 4, None, None),
    "c5-scalar": ((3, 3, 3), (4, 3, 6), 5, None, None),
}


@pytest.mark.parametrize("case", list(K4_CASES))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k4_matches_plain_at_its_plans(cuda, case, bf16):
    """K4 against its plain version, one launch per call, two launches with
    the same bits (every sum in a fixed order, no atomics)."""
    ws, agg, c, n_sm, nzc = K4_CASES[case]
    grid = tuple(a * (w - 1) + 1 for a, w in zip(agg, ws))
    rng = np.random.default_rng(8)
    W = torch.from_numpy(rng.standard_normal((c,) + ws + agg).astype(np.float32)).to(cuda)
    if bf16:
        W = W.to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal(int(np.prod(grid))).astype(np.float32)).to(cuda)
    g = (ws, agg, grid)
    if n_sm is None:
        run = lambda: ttk.structured_restrict(W, x, *g)          # noqa: E731
    else:
        plan = ttk.restrict_plan(ws, agg, c, ttk.restrict_vec(W, c, agg[2]),
                                 W.element_size(), n_sm, nzc)
        assert {"uneven-gy": plan.nay == 6, "march-ragged": plan.nzc == 3,
                "three-chunks": plan.nax == 12}[case]
        run = lambda: ttk._restrict_with_plan(plan, W, x, *g)    # noqa: E731
    before = tk.LAUNCHES["structured_restrict"]
    first, second = run(), run()
    torch.cuda.synchronize()
    assert tk.LAUNCHES["structured_restrict"] == before + 2
    assert torch.equal(first, second)
    assert _rel(first, ttk.structured_restrict_plain(W, x, *g)) <= 1e-5


def test_overflowing_tail_runs_the_kernel(cuda):
    """A tail whose block vectors and x2 do not fit an H100 block's shared
    memory (64^3 level-1 sites, c = 8, 16,384 coarse rows): the builder
    gives its levels a tail, the plan places x2 in global scratch, and the
    kernel matches its plain version and repeats its bits."""
    ft0 = random_tail(**tt.OVERFLOW_TAIL, device=cuda)
    levels = tt.levels_of_tail(ft0)
    levels[0].fused = tfc.build_fused_tail(levels, 1, reduced_storage=True)
    ft = levels[0].fused
    del ft0
    assert ft is not None and ft.n2 == 16384
    p = tfc.plan_of(ft, tk._sm_count(cuda))
    assert (p.stage_vecs, p.stage_x2, p.stage_vb) == (1, 0, 1)
    b1 = torch.from_numpy(np.random.default_rng(9).standard_normal(ft.n1)
                          .astype(np.float32)).to(cuda)
    before = tk.LAUNCHES["fused_tail"]
    got, again = tfc.fused_subcycle_apply(ft, b1), tfc.fused_subcycle_apply(ft, b1)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["fused_tail"] == before + 2
    assert torch.equal(got, again)
    assert _rel(got, tfc.fused_subcycle_apply_plain(ft, b1)) <= TAIL_TOL


@pytest.mark.parametrize("grid", [(32, 32, 32), (13, 17, 11)], ids=["32^3", "13x17x11"])
def test_windowed_bf16_tail_within_its_rounding_limit(cuda, grid):
    """Windowed bf16 random tails whose coarse correction is a hierarchy-like
    share of their output (>= 50%; the 129^3 shape and a ragged grid), on
    seeds 7-11, all five: the kernel within the rounding check's limit of
    the float64 plain version with the same rounding points
    (_torch_tails.rounding_limit)."""
    ft = random_tail(grid, dense=False, inv2_scale=tt.HIERARCHY_INV2_SCALE, device=cuda)
    for seed in (7, 8, 9, 10, 11):
        b1 = torch.from_numpy(np.random.default_rng(seed).standard_normal(ft.n1)
                              .astype(np.float32)).to(cuda)
        assert tt.correction_share(ft, b1) >= 0.5
        ref, limit, _ = tt.rounding_limit(ft, b1)
        got = tfc.fused_subcycle_apply(ft, b1)
        assert tt.rel_inf(got, ref) <= limit


def test_q2_hierarchy_runs_its_kernels(cuda):
    """The main configuration on the Q2 cube at 33^3: the full-mode tail (9^3
    windows) once per V-cycle; the fine applies through K1/K2 where the
    host's numpy sums the cell matrices into bit-symmetric planes, else all
    through K3; the V-cycle equal to the CPU one with the same tail, the same
    PCG count; the generic recursion launches K4 and K5 once each.  Both
    set up by the host route."""
    prob = LaplaceProblem.hyper_cube(3, 4, degree=2, material_property="linear")
    hg = Hierarchy(prob, _main_config(backend="host"))
    ft = hg.levels[0].fused
    assert ft is not None and ft.fine_window == (9, 9, 9)
    hc = Hierarchy(hg.problem, _main_config(), device="cpu")
    hc.levels[0].fused = tfc.build_fused_tail(hc.levels, 1, reduced_storage=True)
    b = np.random.default_rng(7).uniform(size=hg.problem.n_dofs).astype(np.float32)
    tk.reset_launch_counts()
    _, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    n = ig["iterations"] + 1
    assert tk.LAUNCHES["fused_tail"] == n
    if hg.levels[0].op.sym_pos is None:
        # 5 per V-cycle (two per degree-2 smooth, the residual) and one per
        # CG apply (the initial residual and one per iteration)
        assert tk.LAUNCHES["stencil_apply"] == 6 * n
        assert tk.LAUNCHES["stencil_apply_sym"] == tk.LAUNCHES["cheb_smooth"] == 0
    else:
        assert tk.LAUNCHES["cheb_smooth"] == 2 * n
        assert tk.LAUNCHES["stencil_apply_sym"] == n
        assert tk.LAUNCHES["stencil_apply"] == 0
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]
    assert _rel(hg.vmult(b).cpu(), hc.vmult(b)) <= 1e-5
    hg.levels[0].fused = None
    try:
        tk.reset_launch_counts()
        hg.vmult(b)
        torch.cuda.synchronize()
    finally:
        hg.levels[0].fused = ft
    assert tk.LAUNCHES["structured_restrict"] == 1
    assert tk.LAUNCHES["structured_prolong"] == 1


def _one_sided(prob, dtype):
    host = tst.stencil_from_cell_matrices(prob.mesh, prob.A_loc, prob.constrained,
                                          prob.diag_raw, dtype=dtype)
    return tst.stencil_to_device(tst.StencilOperator(
        host.coeffs, host.offsets, host.grid_shape, None), "cpu")


def test_one_sided_q2_cube_runs_k3_and_the_tail(cuda):
    """The Q2 cube at 33^3 with its fine operator kept one-sided, as the
    reference runs it wherever the host sums the planes asymmetrically: the
    plain Chebyshev smoother stays, six K3 launches per V-cycle and CG
    apply, the full-mode tail (9^3 windows) once per V-cycle, no K1/K2; the
    V-cycle (1e-5) and the PCG count as on the CPU with the same operator
    and tail."""
    prob = LaplaceProblem.hyper_cube(3, 4, degree=2, material_property="linear")
    h = Hierarchy(prob, _main_config(), device="cpu")
    h.levels[0].op = _one_sided(prob, torch.bfloat16)
    h._exact_op_cache = _one_sided(prob, torch.float32)
    b = np.random.default_rng(9).uniform(size=prob.n_dofs).astype(np.float32)
    h.levels[0].fused = tfc.build_fused_tail(h.levels, 1, reduced_storage=True)
    yc = h.vmult(b)
    _, ic = h.solve_cg(b, tol=1e-5, maxiter=50)
    h.levels[0].fused = None
    h.to(cuda)
    assert isinstance(h.levels[0].smoother, ChebyshevSmoother)
    ft = h.levels[0].fused
    assert ft is not None and ft.fine_window == (9, 9, 9)
    tk.reset_launch_counts()
    _, ig = h.solve_cg(b, tol=1e-5, maxiter=50)
    n = ig["iterations"] + 1
    assert tk.LAUNCHES["stencil_apply"] == 6 * n
    assert tk.LAUNCHES["fused_tail"] == n
    assert tk.LAUNCHES["stencil_apply_sym"] == tk.LAUNCHES["cheb_smooth"] == 0
    assert ig["iterations"] == ic["iterations"]
    assert _rel(h.vmult(b).cpu(), yc) <= 1e-5


def test_distorted_q2_runs_k3_k4_k5(cuda):
    """The distorted Q2 cube (seed 0) at 33^3 with two levels, one-sided on
    every host: six K3 launches per V-cycle and CG apply, K4 and K5 once
    per V-cycle, no K1/K2 or tail; PCG count and V-cycle (1e-5) as on the
    CPU."""
    cfg = _main_config()
    cfg.max_levels = 2
    prob = LaplaceProblem.hyper_cube(3, 4, degree=2, material_property="linear",
                                     distort_random=True, seed=0)
    hg, hc = Hierarchy(prob, cfg), Hierarchy(prob, cfg, device="cpu")
    assert hg.levels[0].op.sym_pos is None and hg.levels[0].fused is None
    b = np.random.default_rng(8).uniform(size=prob.n_dofs).astype(np.float32)
    tk.reset_launch_counts()
    _, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    n = ig["iterations"] + 1
    assert tk.LAUNCHES["stencil_apply"] == 6 * n
    assert tk.LAUNCHES["structured_restrict"] == tk.LAUNCHES["structured_prolong"] == n
    assert tk.LAUNCHES["stencil_apply_sym"] == tk.LAUNCHES["cheb_smooth"] == 0
    assert tk.LAUNCHES["fused_tail"] == 0
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]
    assert _rel(hg.vmult(b).cpu(), hc.vmult(b)) <= 1e-5


def test_hierarchy_to_moves_every_level(cuda):
    """A CPU-built hierarchy moved with Hierarchy.to: every buffer on the
    card, the kernels finalized as by the constructor (K2 smoother, the
    bf16-weight tail, each launched by a V-cycle), and the V-cycle equal to
    the CPU one with the same tail and within BF16_STORAGE_GAP of the CPU
    generic recursion."""
    cfg = tcfg.Config(max_levels=3, operator="stencil", dtype="float32",
                      coeff_dtype="bfloat16",
                      eigensolver=tcfg.EigensolverConfig(n_eigenvectors_deep=4),
                      smoother=tcfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    h = Hierarchy(prob, cfg, device="cpu")
    b = np.random.default_rng(3).uniform(size=prob.n_dofs).astype(np.float32)
    y_generic = h.vmult(b)
    h.levels[0].fused = tfc.build_fused_tail(h.levels, 1, reduced_storage=True)
    yc = h.vmult(b)
    h.levels[0].fused = None
    h.to(cuda)
    assert all(t.is_cuda for lv in h.levels for t in lv.buffers())
    assert isinstance(h.levels[0].smoother, FusedChebyshevSmoother)
    ft = h.levels[0].fused
    assert ft is not None and ft.coeffs.dtype == torch.bfloat16
    before = dict(tk.LAUNCHES)
    yg = h.vmult(b).cpu()
    assert tk.LAUNCHES["fused_tail"] == before["fused_tail"] + 1
    assert tk.LAUNCHES["cheb_smooth"] > before["cheb_smooth"]
    assert _rel(yg, yc) <= 1e-5
    assert _rel(yg, y_generic) <= BF16_STORAGE_GAP


TAIL_TOL = 1e-5


def _main_config(backend="auto", dtype="float32", coeff_dtype="bfloat16"):
    return tcfg.Config(max_levels=3, operator="stencil", dtype=dtype,
                       coeff_dtype=coeff_dtype,
                       eigensolver=tcfg.EigensolverConfig(n_eigenvectors=2,
                                                          n_eigenvectors_deep=4,
                                                          backend=backend),
                       smoother=tcfg.SmootherConfig(type="chebyshev", degree=2),
                       agglomeration=tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))


_HIER = {}


def _hier(n_ref, degree=1):
    if (n_ref, degree) not in _HIER:
        prob = LaplaceProblem.hyper_cube(3, n_ref, degree=degree,
                                         material_property="linear")
        _HIER[n_ref, degree] = Hierarchy(prob, _main_config())
    return _HIER[n_ref, degree]


def _hier_q2(n_ref):
    return _hier(n_ref, degree=2)


def _tail(levels, windowed, reduced):
    if windowed:
        tr = levels[1].transfer
        win = GeneralWindowTransfer(tr.W, tr.window_shape, tr.t0, tr.stride,
                                    tr.in_grid, tr.out_grid, tr.n_in, tr.n_out)
        levels = [levels[0], LevelData(levels[1].op, smoother=levels[1].smoother,
                                       transfer=win), levels[2]]
    ft = tfc.build_fused_tail(levels, 1, reduced_storage=reduced)
    assert (ft.Rd is None) == windowed and ft.fine_grid is not None
    return ft


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


# Random tails (_torch_tails.random_tail) beside the hierarchies' own: a
# ragged level-1 grid (13 x 17 x 11 sites: 128 blocks of 19, the last of
# 18) and a grid of 12 sites over 9^3 fine windows, at degrees 1-3 and two
# smoothing steps; and tails whose plan leaves the coefficients, Rd or both
# in global memory (UNSTAGED_TAILS, c = 4, bf16 weights, 3^3 fine windows).
_SMALL_WINDOWS = dict(window=(4, 4, 4), stride=(2, 2, 2), t0=(-1, -1, -1))
_RANDOM_TAILS = {
    f"ragged-{'dense' if dense else 'windowed'}-{'bf16' if bf16 else 'f32'}-d{d}-nss{nss}":
    dict(grid=(13, 17, 11), fine_window=(5, 5, 5), dense=dense, bf16=bf16, degree=d,
         nss=nss, **_SMALL_WINDOWS)
    for dense, bf16 in itertools.product((True, False), (False, True))
    for d, nss in ((1, 1), (3, 1), (2, 2))
}
_RANDOM_TAILS["2x3x2-9^3-dense-bf16"] = dict(grid=(2, 3, 2), fine_window=(9, 9, 9),
                                             **_SMALL_WINDOWS)
_RANDOM_TAILS.update({f"unstaged-{k}": dict(fine_window=(3, 3, 3), **kw)
                      for k, (kw, _) in UNSTAGED_TAILS.items()})
_TAIL_CASES = [f"{n}-{r}-{w}" for n in ("17^3", "33^3") for r in ("f32", "bf16")
               for w in ("dense", "windowed")] + list(_RANDOM_TAILS)


def _tail_case(case, cuda):
    if case in _RANDOM_TAILS:
        ft = random_tail(device=cuda, **_RANDOM_TAILS[case])
        if case.startswith("unstaged-"):
            p = tfc.plan_of(ft, tk._sm_count(cuda))
            staged = UNSTAGED_TAILS[case.removeprefix("unstaged-")][1]
            assert (p.stage_coeffs, p.stage_rd) == staged
        return ft
    n, r, w = case.split("-")
    h = _hier({"17^3": 4, "33^3": 5}[n])
    return _tail(list(h.levels), w == "windowed", r == "bf16")


def _tail_inputs(ft, seed, cuda):
    rng = np.random.default_rng(seed)
    b1 = torch.from_numpy(rng.standard_normal(ft.n1).astype(np.float32)).to(cuda)
    x, res = (torch.from_numpy(v.astype(np.float32)).to(cuda) for v in
              (rng.uniform(size=ft.n_fine), rng.standard_normal(ft.n_fine)))
    return b1, x, res


@pytest.mark.parametrize("case", _TAIL_CASES)
def test_fused_tail_matches_plain(cuda, case):
    """Both modes (sub-cycle, full tail) of one tail against the plain
    versions on the same card tensors; one launch per call.  The tails of
    the 17^3 and 33^3 hierarchies (dense and windowed L1 -> L2, f32 and bf16
    weights) and random tails over a ragged level-1 grid at degrees 1-3 and
    two smoothing steps, and tails that leave weights in global memory."""
    ft = _tail_case(case, cuda)
    b1, x, res = _tail_inputs(ft, 4, cuda)
    before = tk.LAUNCHES["fused_tail"]
    got = tfc.fused_subcycle_apply(ft, b1)
    out = tfc.fused_correction_apply(ft, x, res)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["fused_tail"] == before + 2
    assert _rel(got, tfc.fused_subcycle_apply_plain(ft, b1)) <= TAIL_TOL
    assert _rel(out, tfc.fused_correction_apply_plain(ft, x, res)) <= TAIL_TOL


@pytest.mark.parametrize("case", ["33^3-bf16-dense", "33^3-bf16-windowed",
                                  "ragged-windowed-bf16-d2-nss2"]
                         + [f"unstaged-{k}" for k in UNSTAGED_TAILS])
def test_fused_tail_repeats_bit_for_bit(cuda, case):
    """Every sum of the kernel runs in a fixed order without atomics: two
    launches on the same inputs give the same bits, in both modes."""
    ft = _tail_case(case, cuda)
    b1, x, res = _tail_inputs(ft, 5, cuda)
    for run in (lambda: tfc.fused_subcycle_apply(ft, b1),
                lambda: tfc.fused_correction_apply(ft, x, res)):
        first, second = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_cuda_hierarchy_runs_the_tail(cuda):
    """A float32 V-cycle hierarchy on the card carries the full-mode tail
    with bf16 weights, and a V-cycle launches it once."""
    h = _hier(4)
    ft = h.levels[0].fused
    assert ft is not None and ft.fine_grid is not None
    assert ft.coeffs.dtype == torch.bfloat16 and ft.invd.dtype == torch.float32
    b = np.random.default_rng(4).uniform(size=h.problem.n_dofs).astype(np.float32)
    before = tk.LAUNCHES["fused_tail"]
    h.vmult(b)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["fused_tail"] == before + 1


def test_fused_tail_wrappers_raise_on_mismatch(cuda):
    """A CUDA tail refuses a vector on the CPU, a float64 vector, and a
    vector of the wrong length; a CPU tail refuses a CUDA vector."""
    ft = _hier(4).levels[0].fused
    n1, n = ft.n1, ft.n_fine
    with pytest.raises(ValueError):
        tfc.fused_subcycle_apply(ft, torch.zeros(n1))
    with pytest.raises(ValueError):
        tfc.fused_subcycle_apply(ft, torch.zeros(n1, dtype=torch.float64,
                                                 device=cuda))
    with pytest.raises(ValueError):
        tfc.fused_correction_apply(ft, torch.zeros(n, device=cuda),
                                   torch.zeros(n - 1, device=cuda))
    with pytest.raises(ValueError):
        tfc.fused_subcycle_apply(copy.deepcopy(ft).to("cpu"),
                                 torch.zeros(n1, device=cuda))


# The device setup route (eigen/device_eig.py) on the card.  A 17^3 V-cycle
# set up by the route against the same pipeline on the CPU fed the card's
# probe block: 1e-4 relative (read 4.5e-6 on an H100, chip_smoke.py phase 4,
# PERF.md: cuSOLVER's float32 roundoff against LAPACK's through the
# level-0 and level-1 eigenvectors).  The pipeline against host ssyevx at
# 33^3: the limits of chip_smoke.py phase 8.
DEVICE_ROUTE_VCYCLE_TOL = 1e-4


def test_device_route_matches_the_cpu_pipeline(cuda, monkeypatch):
    from mfmg_torch.eigen import device_eig
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    hg = Hierarchy(prob, _main_config())
    assert hg.setup_route == "device"
    supports, probe = device_eig.supports, device_eig.probe_block
    monkeypatch.setattr(device_eig, "supports", lambda mesh, ids, device,
                        geom=None: supports(mesh, ids, cuda, geom))
    monkeypatch.setattr(device_eig, "probe_block", lambda n, m, p, device:
                        probe(n, m, p, cuda).to(device))
    hc = Hierarchy(prob, _main_config(), device="cpu")
    assert hc.setup_route == "device"
    hc.levels[0].fused = tfc.build_fused_tail(hc.levels, 1, reduced_storage=True)
    b = np.random.default_rng(3).uniform(size=prob.n_dofs).astype(np.float32)
    assert _rel(hg.vmult(b).cpu(), hc.vmult(b)) <= DEVICE_ROUTE_VCYCLE_TOL
    _, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]


def test_float64_hierarchy_keeps_the_host_route(cuda):
    """The device pipeline is float32: a float64 hierarchy on the card sets
    up by the host route, with the CPU's coarse operators bit for bit and
    its V-cycle to 1e-10."""
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    cfg = _main_config(dtype="float64", coeff_dtype=None)
    hg = Hierarchy(prob, cfg)
    hc = Hierarchy(prob, cfg, device="cpu")
    assert hg.setup_route == "host" == hc.setup_route
    for level in (1, 2):
        assert (hg._A_per_level[level] != hc._A_per_level[level]).nnz == 0
    b = np.random.default_rng(4).uniform(size=prob.n_dofs)
    assert _rel(hg.vmult(b).cpu(), hc.vmult(b)) <= 1e-10


def test_own_cell_matrices_keep_the_host_route(cuda):
    """A problem with its own local_matrix_fn sets up by the host route on
    the card (the pipeline rebuilds only the Laplace form)."""
    from mfmg_torch.fem.geometry import local_stiffness_matrices

    def reaction_diffusion(mesh, geom, coeff_at_q):
        A = local_stiffness_matrices(mesh, geom, coeff_at_q)
        return A + 1e-2 * np.eye(A.shape[-1])

    mesh = LaplaceProblem.hyper_cube(3, 4).mesh
    prob = LaplaceProblem.from_mesh(mesh, "linear",
                                    local_matrix_fn=reaction_diffusion)
    assert Hierarchy(prob, _main_config()).setup_route == "host"


def test_device_pipeline_against_host_syevx(cuda):
    import chip_smoke
    prob = LaplaceProblem.hyper_cube(3, 5, material_property="linear")
    r = chip_smoke.check_setup_pipeline("33^3", prob, cuda)
    assert r["n_agg"] == 512 and r["k_err"] <= chip_smoke.SETUP_K_TOL


# ELL operators and deeper hierarchies on the card.  Each is held against
# the same configuration on the CPU: float64 V-cycle rates to 1e-6 (sums in
# another order), float32 V-cycles to 1e-5 (the bound of the hierarchy
# tests above), and DEVICE_ROUTE_VCYCLE_TOL where the card's level 0 takes
# the device route.


def test_default_config_on_the_card(cuda):
    """The library's default Config (ELL, float64, Jacobi, two levels):
    every level on the card as ELL, its V-cycle rate equal to the CPU's."""
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate
    from mfmg_torch.ops.sparse import ELLMatrix, ELLTransfer
    prob = LaplaceProblem.hyper_cube(3, 2, material_property="constant")
    cfg = tcfg.Config(is_preconditioner=False)
    hg, hc = Hierarchy(prob, cfg), Hierarchy(prob, cfg, device="cpu")
    assert isinstance(hg.levels[0].op, ELLMatrix)
    assert isinstance(hg.levels[0].transfer, ELLTransfer)
    assert all(t.is_cuda for lv in hg.levels for t in lv.buffers())
    assert abs(measure_vcycle_rate(hg) - measure_vcycle_rate(hc)) <= 1e-6


def test_distorted_q2_three_levels_on_the_card(cuda):
    """The distorted Q2 cube (n_ref 3, seed 0) at three levels: K3 and
    K4/K5 at level 0, ELL R/R^T at level 1, an ELL level 2, no tail."""
    from mfmg_torch.ops.sparse import ELLMatrix, ELLTransfer
    prob = LaplaceProblem.hyper_cube(3, 3, degree=2, material_property="linear",
                                     distort_random=True, seed=0)
    hg, hc = Hierarchy(prob, _main_config()), Hierarchy(prob, _main_config(),
                                                         device="cpu")
    assert hg.levels[0].fused is None
    assert isinstance(hg.levels[1].transfer, ELLTransfer)
    assert isinstance(hg.levels[2].op, ELLMatrix)
    b = np.random.default_rng(10).uniform(size=prob.n_dofs).astype(np.float32)
    tk.reset_launch_counts()
    _, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    n = ig["iterations"] + 1
    assert tk.LAUNCHES["stencil_apply"] == 6 * n
    assert tk.LAUNCHES["structured_restrict"] == tk.LAUNCHES["structured_prolong"] == n
    assert tk.LAUNCHES["fused_tail"] == 0
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]
    assert _rel(hg.vmult(b).cpu(), hc.vmult(b)) <= 1e-5


def test_four_level_q1_on_the_card(cuda):
    """Q1 17^3 at four levels, both set up by the host route: K1, K2 and
    K4/K5, window transfers at levels 1-2, no tail."""
    cfg = _main_config(backend="host")
    cfg.max_levels = 4
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    hg, hc = Hierarchy(prob, cfg), Hierarchy(prob, cfg, device="cpu")
    assert len(hg.levels) == 4 and hg.levels[0].fused is None
    assert hg.per_cell_levels == [2]
    assert isinstance(hg.levels[0].smoother, FusedChebyshevSmoother)
    b = np.random.default_rng(11).uniform(size=prob.n_dofs).astype(np.float32)
    tk.reset_launch_counts()
    _, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    n = ig["iterations"] + 1
    assert tk.LAUNCHES["stencil_apply_sym"] == n
    assert tk.LAUNCHES["cheb_smooth"] == 2 * n
    assert tk.LAUNCHES["structured_restrict"] == tk.LAUNCHES["structured_prolong"] == n
    assert tk.LAUNCHES["fused_tail"] == 0
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]
    assert _rel(hg.vmult(b).cpu(), hc.vmult(b)) <= 1e-5


def test_ell_float32_on_the_card(cuda, monkeypatch):
    """operator="ell" in float32 at 17^3: the device route without Galerkin
    blocks (its batch freed), level 1 through the per-cell patch path,
    every level ELL on the card; against the same pipeline on the CPU fed
    the card's probe block."""
    from mfmg_torch.eigen import device_eig
    from mfmg_torch.ops.sparse import ELLMatrix
    cfg = _main_config()
    cfg.operator = "ell"
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    hg = Hierarchy(prob, cfg)
    assert hg.setup_route == "device" and hg._device_A is None
    assert hg.per_cell_levels == [1]
    assert all(isinstance(lv.op, ELLMatrix) and lv.op.vals.is_cuda
               for lv in hg.levels)
    supports, probe = device_eig.supports, device_eig.probe_block
    monkeypatch.setattr(device_eig, "supports", lambda mesh, ids, device,
                        geom=None: supports(mesh, ids, cuda, geom))
    monkeypatch.setattr(device_eig, "probe_block", lambda n, m, p, device:
                        probe(n, m, p, cuda).to(device))
    hc = Hierarchy(prob, cfg, device="cpu")
    assert hc.setup_route == "device"
    b = np.random.default_rng(12).uniform(size=prob.n_dofs).astype(np.float32)
    assert _rel(hg.vmult(b).cpu(), hc.vmult(b)) <= DEVICE_ROUTE_VCYCLE_TOL
    _, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]


def _unstructured_config(mesh, dtype="float32"):
    """chip_smoke.py's phase-10 configuration: the main configuration with
    operator="ell", the 4x4x4 walk on a ball, n_cells // 64 RCB parts on an
    adaptive cube."""
    cfg = _main_config(dtype=dtype, coeff_dtype=None)
    cfg.operator = "ell"
    if mesh.hanging is not None:
        cfg.agglomeration = tcfg.AgglomerationConfig(
            partitioner="rcb", n_agglomerates=mesh.n_cells // 64)
    return cfg


@pytest.mark.parametrize("case", ["ball", "adaptive"])
def test_unstructured_meshes_on_the_card(cuda, case):
    """hyper_ball(3, 3) with the 4x4x4 walk and adaptive_cube(3, 3) with
    RCB parts (ragged, hanging nodes) on the card against the CPU port:
    level sizes and PCG counts equal, the float64 V-cycle rate within 1e-6,
    the hanging slaves of the solution at 0."""
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate
    from mfmg_torch.fem.adaptive import adaptive_cube
    from mfmg_torch.fem.mesh import hyper_ball
    from mfmg_torch.ops.sparse import ELLMatrix
    mesh = (hyper_ball(3, 3) if case == "ball" else
            adaptive_cube(3, 3, lambda c: np.all(c < 0.5, axis=1)))
    prob = LaplaceProblem.from_mesh(mesh, "linear")
    cfg = _unstructured_config(mesh)
    hg, hc = Hierarchy(prob, cfg), Hierarchy(prob, cfg, device="cpu")
    assert hg.setup_route == hc.setup_route == "host"
    assert hg._A_shapes == hc._A_shapes and len(hg.levels) == 3
    assert all(isinstance(lv.op, ELLMatrix) and lv.op.vals.is_cuda
               for lv in hg.levels)
    b = np.random.default_rng(13).uniform(size=prob.n_dofs).astype(np.float32)
    b[prob.constrained] = 0.0
    xg, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]
    if mesh.hanging is not None:
        assert float(xg[mesh.hanging.slaves].abs().max()) <= 1e-8
    cfg64 = _unstructured_config(mesh, dtype="float64")
    cfg64.is_preconditioner = False
    rg = measure_vcycle_rate(Hierarchy(prob, cfg64))
    rc = measure_vcycle_rate(Hierarchy(prob, cfg64, device="cpu"))
    assert abs(rg - rc) <= 1e-6, (rg, rc)


def _cfg_3d(**kw):
    base = dict(is_preconditioner=False,
                eigensolver=tcfg.EigensolverConfig(type="lapack",
                                                   n_eigenvectors=2),
                agglomeration=tcfg.AgglomerationConfig(nx=2, ny=2, nz=2))
    base.update(kw)
    return tcfg.Config(**base)


@pytest.mark.parametrize("mesh,mode", [
    ("cube", "local_matrix"), ("cube", "quadrature"), ("cube", "sumfac"),
    ("hanging", "local_matrix"), ("hanging", "quadrature")])
def test_matrix_free_applies_repeat_their_bits(cuda, mesh, mode):
    """The matrix-free and sum-factorized applies sum by gather in a fixed
    order: two applies give the same bits, and the card's apply equals the
    CPU's within float64 roundoff (the sum-factorized operator has no
    hanging-node form, in the reference neither)."""
    from mfmg_torch.fem.adaptive import adaptive_cube
    m = (adaptive_cube(3, 2, lambda c: np.all(c < 0.5, axis=1))
         if mesh == "hanging" else None)
    p = (LaplaceProblem.from_mesh(m, "linear") if m is not None else
         LaplaceProblem.hyper_cube(3, 3, degree=2 if mode == "sumfac" else 1,
                                   material_property="linear"))
    x = np.random.default_rng(4).standard_normal(p.n_dofs)
    for dtype in (torch.float32, torch.float64):
        op = p.matrix_free_operator(dtype=dtype, mode=mode, device=cuda)
        xd = torch.from_numpy(x).to(cuda, dtype)
        y1, y2 = op(xd), op(xd)
        assert torch.equal(y1, y2)
    y_cpu = p.matrix_free_operator(mode=mode, device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(y1.cpu().numpy(), y_cpu.numpy(), rtol=0,
                               atol=1e-12 * float(y_cpu.abs().max()))


def test_multicolor_colors_on_the_card(cuda):
    """Lattice colors of the stencil (8 in 3-D), greedy colors of the ELL
    matrix (the host library), block-stencil colors of level 1: each a
    proper coloring, on the card with the operator."""
    p = LaplaceProblem.hyper_cube(3, 3, material_property="linear")
    sgs = tcfg.SmootherConfig(type="symmetric gauss-seidel")
    # the host setup route on both sides, so that the bases are LAPACK's
    h = Hierarchy(p, tcfg.Config(operator="stencil", dtype="float32",
                                 coeff_dtype="bfloat16", smoother=sgs,
                                 eigensolver=tcfg.EigensolverConfig(
                                     backend="host"),
                                 agglomeration=tcfg.AgglomerationConfig(
                                     nx=2, ny=2, nz=2)))
    assert h.levels[0].smoother.n_colors == 8
    assert h.levels[0].smoother.colors.is_cuda
    E = p.ell_operator(device=cuda)
    sm = build_smoother(E, sgs, dtype=torch.float64)
    A = p.A.tocoo()
    colors = sm.colors.cpu().numpy()
    off = (A.row != A.col) & (A.data != 0)
    assert not np.any(colors[A.row[off]] == colors[A.col[off]])
    # the sublattice sweep on the card against the CPU on the same planes
    b = np.random.default_rng(1).uniform(size=p.n_dofs).astype(np.float32)
    x_gpu = h.vmult(torch.from_numpy(b).to(cuda)).cpu()
    h_cpu = Hierarchy(p, h.config, device="cpu")
    x_cpu = h_cpu.vmult(torch.from_numpy(b))
    assert float((x_gpu - x_cpu).abs().max() / x_cpu.abs().max()) <= 1e-4


@pytest.mark.parametrize("operator", ["matrix_free", "sumfac", "stencil", "ell"])
def test_golden_mf_chebyshev_on_the_card(cuda, operator):
    """0.0880045475 (test_hierarchy.cc:353) at 1e-4 on every operator, in
    float64 on the card, equal to the CPU port's rate within 1e-10."""
    p = LaplaceProblem.hyper_cube(3, 2, material_property="constant")
    cfg = _cfg_3d(operator=operator,
                  smoother=tcfg.SmootherConfig(type="chebyshev", degree=1))
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate
    r = measure_vcycle_rate(Hierarchy(p, cfg))
    assert abs(r - 0.0880045475) <= 1e-4, r
    assert abs(r - measure_vcycle_rate(Hierarchy(p, cfg, device="cpu"))) <= 1e-10


@pytest.mark.parametrize("smoother", ["gs-lex-dealii", "ilu", "sgs"])
def test_matrix_path_smoothers_on_the_card(cuda, smoother):
    """Lexicographic GS in deal.II order (the golden 0.0235237332 at 1e-6),
    ILU(0) and multicolor SGS, float64 on the card, each rate equal to the
    CPU port's within 1e-10."""
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate
    sc = {"gs-lex-dealii": tcfg.SmootherConfig(
              type="gauss-seidel", coloring="lexicographic", ordering="dealii"),
          "ilu": tcfg.SmootherConfig(type="ilu"),
          "sgs": tcfg.SmootherConfig(type="symmetric gauss-seidel")}[smoother]
    p = LaplaceProblem.hyper_cube(3, 2, material_property="constant")
    cfg = _cfg_3d(operator="ell", smoother=sc)
    r = measure_vcycle_rate(Hierarchy(p, cfg))
    if smoother == "gs-lex-dealii":
        assert abs(r - 0.0235237332) <= 1e-6, r
    assert abs(r - measure_vcycle_rate(Hierarchy(p, cfg, device="cpu"))) <= 1e-10
