"""The ELL operator path (the library's default ``Config()``) against
mfmg_tpu on the CPU.

- ``ELLMatrix`` apply and diagonal against ``mfmg_tpu.ops.sparse`` on random
  CSR matrices (empty rows, an empty matrix, ``pad_to``), float64 to 1e-12;
  ``native.ell_pack`` against its plain version (the reference's numpy
  fill) exactly; ``ELLTransfer`` against R and R^T.
- The ELL kernel's plan (``ell_plan``) at every pairing of 0, 1, 7 and
  232,609 rows with widths 0 to 1,000: within the card's limits, every row
  in one block, and (``tests/_torch_ell.py``'s model of the kernel's
  passes and lanes) every entry of a block read once and summed once; the
  plain apply and the kernel's model against scipy in float32 and float64
  within the rounding bound of a sum of L products; a CPU apply launches
  nothing.
- The default ``Config(is_preconditioner=False)`` on ``hyper_cube(3, 2,
  "constant")`` (ELL, float64, Jacobi, two levels): its V-cycle rate equals
  the reference's to 1e-10, and the pinned 0.0876 of tests/test_hierarchy.py
  (0.0875589); one V-cycle on the reference's levels carried across to
  1e-12.
- ``operator="ell"`` in float32 at 17^3 with the main configuration
  otherwise (ELL at every level, R/R^T as ELL, the host SpGEMM Galerkin
  product): V-cycle within float32 roundoff, the rate to 1e-5, PCG
  iterations equal; and the same path through both packages' level-0
  device pipelines (the light batch without Galerkin blocks, so level 1
  takes the per-cell patch path), coarse operators up to basis signs.
- grid and operator complexity against the reference on three paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.hierarchy import measure_vcycle_rate as j_rate
from mfmg_tpu.amge.hierarchy import vcycle as j_vcycle
from mfmg_tpu.eigen import device_eig as jde
from mfmg_tpu.ops import sparse as jsp
from mfmg_tpu.solve.operator import operator_diagonal as j_diag
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch import native
from mfmg_torch.amge.hierarchy import levels_from_arrays
from mfmg_torch.amge.hierarchy import measure_vcycle_rate as t_rate
from mfmg_torch.amge.hierarchy import vcycle as t_vcycle
from mfmg_torch.eigen import device_eig as tde
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import sparse as tsp
from mfmg_torch.ops.sparse import ELLMatrix, ELLTransfer
from mfmg_torch.solve.operator import operator_diagonal as t_diag
from mfmg_torch.solve.smoothers import JacobiSmoother

from _torch_carry import flatten_levels, jax_probe, main_path_config
from _torch_ell import (ell_block_model, ell_block_rows, ell_kernel_model,
                        random_csr as _random_csr)

APPLY_TOL = 1e-12          # float64 row sums of the same products
# the pinned golden of tests/test_hierarchy.py::test_rate_jacobi_beats_cuda_golden
DEFAULT_RATE = 0.0875589
RATE_TOL = 1e-10
CARRY_TOL = 1e-12
# float32 ELL hierarchies of both packages: float32 LAPACK on float32
# batches and float32 applies in another order; the V-cycle read 4e-8 and
# the rate 2e-7 at 17^3
F32_VCYCLE_TOL, F32_RATE_TOL = 1e-5, 1e-5
# coarse operators through both device pipelines with the same probe
# (float32 level-0 roundoff through the level-1 eigensolves), as
# tests/test_torch_device_setup.py holds the stencil path
PIPE_A_TOL = 5e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", ["square", "rect", "empty", "pad"])
def test_ell_apply_and_diagonal_match_the_reference(case):
    A, pad_to = _random_csr(case)
    x = np.random.default_rng(9).standard_normal(A.shape[1])
    t = tsp.ell_from_scipy(A, dtype=torch.float64, pad_to=pad_to)
    j = jsp.ell_from_scipy(A, dtype=jnp.float64, pad_to=pad_to)
    assert t.shape == j.shape == A.shape
    assert t.vals.shape == j.vals.shape and t.cols.dtype == torch.int32
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    y_t = t(torch.from_numpy(x)).numpy()
    y_j = np.asarray(jsp.ell_spmv(j, jnp.asarray(x)))
    if A.nnz == 0:
        assert not y_t.any() and not y_j.any()
        return
    assert _rel_max(y_t, y_j) <= APPLY_TOL
    assert _rel_max(y_t, A @ x) <= APPLY_TOL
    if A.shape[0] == A.shape[1]:
        d_t = t_diag(t).numpy()
        np.testing.assert_array_equal(d_t, np.asarray(j_diag(j)))
        np.testing.assert_array_equal(d_t, A.diagonal())


@pytest.mark.parametrize("case", ["square", "rect", "pad"])
def test_ell_pack_matches_its_plain_version(case):
    A, pad_to = _random_csr(case)
    L = max(int(np.diff(A.indptr).max()), pad_to or 0)
    vals, cols = native.ell_pack(A.indptr, A.indices, A.data, A.shape[0], L)
    p_vals, p_cols = tsp.ell_pack_plain(A.indptr, A.indices, A.data,
                                        A.shape[0], L)
    assert vals.dtype == p_vals.dtype and cols.dtype == p_cols.dtype
    np.testing.assert_array_equal(vals, p_vals)
    np.testing.assert_array_equal(cols, p_cols)
    with pytest.raises(ValueError, match="more than L"):
        native.ell_pack(A.indptr, A.indices, A.data, A.shape[0], L - 6)


# the kernel's launch limits without the opt-in to more shared memory
MAX_THREADS, MAX_STATIC_SMEM = 1024, 48 * 1024


@pytest.mark.parametrize("L", [0, 1, 2, 27, 31, 33, 128, 1000])
@pytest.mark.parametrize("n_rows", [0, 1, 7, 232_609])
def test_ell_plan_covers_every_row_once(n_rows, L):
    for elem in (4, 8):
        V = 16 // elem
        p = tsp.ell_plan(n_rows, L, elem)
        assert p.threads == tsp.ELL_THREADS and p.threads % 32 == 0
        assert p.threads <= MAX_THREADS
        assert p.chunk == p.threads * tsp.ELL_UNITS * V
        assert V <= p.rows <= p.chunk and p.rows % V == 0
        assert 1 <= p.lanes <= 32 and p.lanes & (p.lanes - 1) == 0
        assert p.smem == elem * (p.chunk + p.chunk // 32 + p.rows) <= MAX_STATIC_SMEM
        starts = np.arange(p.blocks) * p.rows
        ends = np.minimum(starts + p.rows, n_rows)
        assert np.array_equal(starts[1:], ends[:-1]) and (ends > starts).all()
        assert (p.blocks == 0) if n_rows == 0 else (starts[0] == 0 and
                                                     ends[-1] == n_rows)
        if n_rows == 0 or L == 0:
            continue
        # each entry of a block read once, each term summed once (products
        # of 1: every row's total is L exactly)
        for b in {0, p.blocks // 2, p.blocks - 1}:
            _, nr = ell_block_rows(p, n_rows, b)
            acc, reads = ell_block_model(np.ones(nr * L), L, p)
            assert (reads == 1).all() and (acc == L).all(), (b, elem)


TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _rounding_bound(A, x, L, dtype):
    """|y - A x| for any order of a row's sums in ``dtype``, gamma_L |A| |x|,
    plus as much for the float64 reference's own sums."""
    u = np.finfo(dtype).eps / 2
    return 2 * L * u / (1 - L * u) * (abs(A) @ np.abs(x))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["square", "rect", "empty", "pad", "long"])
def test_ell_plain_and_kernel_model_match_scipy(case, dtype):
    """The plain apply and the kernel's order of sums (the model, whose
    "long" rows run over several passes) against scipy in float64 on the
    same stored values."""
    A, pad_to = _random_csr(case)
    E = tsp.ell_from_scipy(A, dtype=TORCH_DTYPE[dtype], pad_to=pad_to)
    vals, cols = E.vals.numpy(), E.cols.numpy()
    x = np.random.default_rng(9).standard_normal(A.shape[1]).astype(dtype)
    A_stored = sp.csr_matrix(A.astype(dtype).astype(np.float64))
    ref = A_stored @ x.astype(np.float64)
    L = vals.shape[1]
    bound = _rounding_bound(A_stored, x, L, dtype)
    y_plain = E(torch.from_numpy(x)).numpy()
    p = tsp.ell_plan(*vals.shape, vals.itemsize)
    y_model = ell_kernel_model(vals, cols, x, p)
    assert y_plain.dtype == y_model.dtype == dtype
    if case == "long":
        assert p.rows * L > p.chunk
    for y in (y_plain, y_model):
        assert (np.abs(y - ref) <= bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_cpu_apply_launches_nothing(dtype):
    A, _ = _random_csr("square")
    E = tsp.ell_from_scipy(A, dtype=dtype)
    cl.reset_launch_counts()
    y = E(torch.ones(A.shape[1], dtype=dtype))
    assert y.dtype == dtype and y.shape == (A.shape[0],)
    assert cl.LAUNCHES["ell_spmv"] == 0


def test_ell_transfer_restricts_and_prolongs():
    A, _ = _random_csr("rect")
    tr = tsp.ell_transfer_from_scipy(A, dtype=torch.float64)
    rng = np.random.default_rng(4)
    x, xc = rng.standard_normal(A.shape[1]), rng.standard_normal(A.shape[0])
    assert tr.shape == A.shape
    assert _rel_max(tr.restrict(torch.from_numpy(x)).numpy(), A @ x) <= APPLY_TOL
    assert _rel_max(tr.prolong(torch.from_numpy(xc)).numpy(), A.T @ xc) <= APPLY_TOL
    moved = tr.to(torch.float32)
    assert moved.R.vals.dtype == torch.float32
    assert moved.RT.cols.dtype == torch.int32


def test_default_config_rate_matches_the_reference():
    """The library's default Config (ELL, float64, Jacobi, max_levels=2)
    with is_preconditioner=False: the V-cycle rate of tests/test_hierarchy.py
    on the CPU, through the port's normal entry point."""
    th = THierarchy(TLaplace.hyper_cube(3, 2, material_property="constant"),
                    tcfg.Config(is_preconditioner=False), device="cpu")
    jh = JHierarchy(JLaplace.hyper_cube(3, 2, material_property="constant"),
                    jcfg.Config(is_preconditioner=False))
    assert isinstance(th.levels[0].op, ELLMatrix)
    assert isinstance(th.levels[0].transfer, ELLTransfer)
    assert isinstance(th.levels[0].smoother, JacobiSmoother)
    assert [lv.op.shape[0] for lv in th.levels] == [125, 16]
    rate = t_rate(th)
    assert rate == pytest.approx(j_rate(jh), rel=RATE_TOL)
    assert rate == pytest.approx(DEFAULT_RATE, abs=1e-7)
    x0 = np.random.default_rng(5).uniform(size=th.problem.n_dofs)
    b = np.random.default_rng(6).uniform(size=th.problem.n_dofs)
    y_j = np.asarray(j_vcycle(jh.levels, jnp.asarray(b), jnp.asarray(x0),
                              is_preconditioner=False))
    assert _rel(th.apply(b, x0).numpy(), y_j) <= RATE_TOL
    levels = levels_from_arrays(*flatten_levels(jh.levels), "cpu")
    y_c = t_vcycle(levels, torch.from_numpy(b), torch.from_numpy(x0),
                   is_preconditioner=False)
    assert _rel(y_c.numpy(), y_j) <= CARRY_TOL
    b[th.problem.constrained] = 0.0
    _, ti = th.solve_cg(b, tol=1e-10)
    _, ji = jh.solve_cg(b, tol=1e-10)
    assert ti["iterations"] == int(ji["iterations"])


def _ell_config(mod):
    cfg = main_path_config(mod, "float32")
    cfg.operator = "ell"
    return cfg


def test_ell_float32_hierarchy_matches_the_reference():
    """operator="ell", float32, the main configuration otherwise, at 17^3:
    4,913 -> 128 -> 4 dofs, ELL at every level, no tail."""
    th = THierarchy(TLaplace.hyper_cube(3, 4, material_property="linear"),
                    _ell_config(tcfg), device="cpu")
    jh = JHierarchy(JLaplace.hyper_cube(3, 4, material_property="linear"),
                    _ell_config(jcfg))
    assert not th._fast_ap and th.setup_route == "host"
    assert "galerkin product L0" in th.setup_seconds
    assert all(isinstance(lv.op, ELLMatrix) and lv.op.vals.dtype == torch.float32
               for lv in th.levels)
    assert all(isinstance(lv.transfer, ELLTransfer) for lv in th.levels[:2])
    assert th._exact_fine_op() is th.levels[0].op
    assert t_rate(th) == pytest.approx(j_rate(jh), rel=F32_RATE_TOL)
    b = np.random.default_rng(7).uniform(size=th.problem.n_dofs).astype(np.float32)
    y_j = np.asarray(j_vcycle(jh.levels, jnp.asarray(b), jnp.zeros_like(b)))
    assert _rel(th.vmult(b).numpy(), y_j) <= F32_VCYCLE_TOL
    levels = levels_from_arrays(*flatten_levels(jh.levels), "cpu")
    y_c = t_vcycle(levels, torch.from_numpy(b), torch.zeros(len(b)))
    assert _rel(y_c.numpy(), y_j) <= F32_VCYCLE_TOL
    _, ti = th.solve_cg(b, tol=1e-5, maxiter=50)
    _, ji = jh.solve_cg(b, tol=1e-5, maxiter=50)
    assert ti["iterations"] == int(ji["iterations"])


def test_ell_float32_through_both_device_pipelines(monkeypatch):
    """The same path through both packages' level-0 device pipelines on the
    CPU (patched in the test, with the reference's probe, as
    tests/test_torch_device_setup.py does for the stencil path): the light
    batch and no Galerkin blocks, so level 1 takes the per-cell patch path
    in both; A_1, A_2 up to basis signs, PCG iterations equal."""
    run = jde.device_smallest_eigenpairs

    def pipeline(*args, **kwargs):
        with jax.enable_x64(False):
            return run(*args, **kwargs)

    monkeypatch.setattr(jde, "supports", lambda *a, **k: True)
    monkeypatch.setattr(jde, "device_smallest_eigenpairs", pipeline)
    supports = tde.supports
    monkeypatch.setattr(tde, "supports", lambda mesh, agg_ids, device,
                        geom=None: supports(mesh, agg_ids, "cuda", geom))
    monkeypatch.setattr(tde, "probe_block", lambda n, m, p, device: torch.from_numpy(
        jax_probe(n, m, p)).to(device))
    import mfmg_torch.amge.multilevel as tml
    per_cell, orig = [], tml._super_blocks_per_cell
    monkeypatch.setattr(tml, "_super_blocks_per_cell",
                        lambda *a, **k: per_cell.append(1) or orig(*a, **k))
    monkeypatch.setattr(tml, "_super_blocks_per_agg",
                        lambda *a, **k: pytest.fail("per-agglomerate path"))
    th = THierarchy(TLaplace.hyper_cube(3, 4, material_property="linear"),
                    _ell_config(tcfg), device="cpu")
    jh = JHierarchy(JLaplace.hyper_cube(3, 4, material_property="linear"),
                    _ell_config(jcfg))
    assert th.setup_route == "device" and th._device_A is None
    assert th._level0_eigendata[0].A_agg is None and per_cell == [1]
    assert th.per_cell_levels == [1]
    assert jh._level0_eigendata[0].A_agg is None
    for level in (1, 2):
        a = th._A_per_level[level].toarray()
        b = jh._A_per_level[level].toarray()
        assert _rel_max(np.abs(a), np.abs(b)) <= PIPE_A_TOL
        assert _rel_max(np.linalg.eigvalsh(a), np.linalg.eigvalsh(b)) <= PIPE_A_TOL
    b = np.random.default_rng(8).uniform(size=th.problem.n_dofs).astype(np.float32)
    assert th.solve_cg(b, tol=1e-5, maxiter=50)[1]["iterations"] == int(
        jh.solve_cg(b, tol=1e-5, maxiter=50)[1]["iterations"])


@pytest.mark.parametrize("path", ["default", "ell-f32", "stencil-4-levels"])
def test_complexities_match_the_reference(path):
    def config(mod):
        if path == "default":
            return mod.Config()
        cfg = main_path_config(mod, "float32" if path == "ell-f32" else "float64")
        if path == "ell-f32":
            cfg.operator = "ell"
        else:
            cfg.max_levels = 4
        return cfg

    n_ref = 2 if path == "default" else 4
    th = THierarchy(TLaplace.hyper_cube(3, n_ref, material_property="linear"),
                    config(tcfg), device="cpu")
    jh = JHierarchy(JLaplace.hyper_cube(3, n_ref, material_property="linear"),
                    config(jcfg))
    assert th._A_shapes == jh._A_shapes
    assert th._A_nnzs == jh._A_nnzs
    assert th.grid_complexity() == jh.grid_complexity()
    assert th.operator_complexity() == jh.operator_complexity()


def test_unported_operators_raise_naming_their_item():
    """Every operator, eigensolver and coarse solver is ported
    (tests/test_torch_matrix_free.py, test_torch_lanczos.py,
    test_torch_lobpcg_arpack.py, test_torch_coarse.py), and so is the
    distributed setup (tests/test_torch_dist_setup.py): in a world of one
    (no process group) ``distributed_setup=True`` builds the same hierarchy
    as False, as the reference's ``_distributed()`` does.  An unknown
    eigensolver or coarse solver raises the reference's ValueError."""
    prob = TLaplace.hyper_cube(3, 2)
    hd = THierarchy(prob, tcfg.Config(distributed_setup=True), device="cpu")
    h = THierarchy(prob, tcfg.Config(), device="cpu")
    assert not hd._distributed() and hd._dist_slab is None
    assert hd._A_shapes == h._A_shapes and hd._A_nnzs == h._A_nnzs
    assert (hd._R_composed != h._R_composed).nnz == 0
    b = torch.from_numpy(np.random.default_rng(0).uniform(size=prob.n_dofs))
    assert torch.equal(hd.vmult(b), h.vmult(b))
    cases = ((dict(eigensolver=tcfg.EigensolverConfig(type="bogus")),
              "unknown eigensolver type 'bogus'"),
             (dict(coarse=tcfg.CoarseConfig(type="bogus")),
              "unknown coarse solver type 'bogus'"))
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            THierarchy(prob, tcfg.Config(**kw), device="cpu")
