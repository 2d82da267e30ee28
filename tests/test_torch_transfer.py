"""mfmg_torch transfers, block stencil and coarse solver against mfmg_tpu.

A float64 main-path hierarchy built by mfmg_tpu at 17^3 supplies the arrays
(structured fine transfer, dense-Rd level-1 transfer, level-1 block stencil,
coarse pseudoinverse); they are carried into the port unchanged and both
packages apply them to the same numpy vectors: 1e-12 relative (float64,
exact f32/f64 matmuls on the CPU; only summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.ops import block_stencil as jbs
from mfmg_tpu.ops import structured_transfer as jtr
from mfmg_tpu.solve.coarse import build_coarse_solver as j_coarse
from mfmg_torch.amge.hierarchy import levels_from_arrays
from mfmg_torch.ops import block_stencil as tbs
from mfmg_torch.ops import structured_transfer as ttr
from mfmg_torch.solve.coarse import build_coarse_solver as t_coarse

from _torch_carry import flatten_levels, main_path_config

TOL = 1e-12


@pytest.fixture(scope="module")
def carried():
    prob = JLaplace.hyper_cube(3, 4, material_property="linear")
    jh = JHierarchy(prob, main_path_config(jcfg, "float64"))
    arrays, meta = flatten_levels(jh.levels)
    return jh, levels_from_arrays(arrays, meta, "cpu")


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("level", [0, 1])
def test_restrict_prolong_match_jax(carried, level):
    jh, tl = carried
    jt, tt = jh.levels[level].transfer, tl[level].transfer
    assert isinstance(tt, ttr.StructuredTransfer if level == 0
                      else ttr.GeneralWindowTransfer)
    n_c, n_f = jh.levels[level + 1].op.shape[0], jh.levels[level].op.shape[0]
    x, xc = _vec(n_f, 1), _vec(n_c, 2)
    _close(tt.restrict(torch.from_numpy(x)), jt.restrict(jnp.asarray(x)))
    _close(tt.prolong(torch.from_numpy(xc)), jt.prolong(jnp.asarray(xc)))


@pytest.mark.parametrize("level", [0, 1])
def test_prolong_is_adjoint_of_restrict(carried, level):
    """<R x, y> = <x, P y> to 1e-12 (prolong is the exact transpose)."""
    jh, tl = carried
    tt = tl[level].transfer
    n_c, n_f = jh.levels[level + 1].op.shape[0], jh.levels[level].op.shape[0]
    x, y = torch.from_numpy(_vec(n_f, 3)), torch.from_numpy(_vec(n_c, 4))
    lhs = float(torch.dot(tt.restrict(x), y))
    rhs = float(torch.dot(x, tt.prolong(y)))
    assert abs(lhs - rhs) <= TOL * (float(torch.linalg.norm(tt.restrict(x)))
                                    * float(torch.linalg.norm(y)))


def test_windowed_general_transfer_matches_jax(carried):
    """The windowed level-1 transfer (the form used beyond the dense cap),
    Rd stripped on both sides: restrict against mfmg_tpu _gwt_restrict,
    prolong against its linear transpose, both against the dense Rd."""
    import dataclasses
    jh, tl = carried
    jt = dataclasses.replace(jh.levels[1].transfer, Rd=None)
    tt = tl[1].transfer
    tw = ttr.GeneralWindowTransfer(tt.W, tt.window_shape, tt.t0, tt.stride,
                                   tt.in_grid, tt.out_grid, tt.n_in, tt.n_out)
    n_c, n_f = jh.levels[2].op.shape[0], jh.levels[1].op.shape[0]
    x, xc = _vec(n_f, 7), _vec(n_c, 8)
    _close(tw.restrict(torch.from_numpy(x)), jt.restrict(jnp.asarray(x)))
    _close(tw.prolong(torch.from_numpy(xc)), jt.prolong(jnp.asarray(xc)))
    _close(tw.restrict(torch.from_numpy(x)), tt.restrict(torch.from_numpy(x)))
    _close(tw.prolong(torch.from_numpy(xc)), tt.prolong(torch.from_numpy(xc)))


@pytest.mark.parametrize("level", [1, 2])
def test_block_stencil_apply_matches_jax(carried, level):
    jh, tl = carried
    jop, top = jh.levels[level].op, tl[level].op
    assert isinstance(top, tbs.BlockStencilOperator)
    x = _vec(jop.shape[0], 5)
    y_ref = np.asarray(jbs.block_stencil_apply(jop, jnp.asarray(x)))
    _close(top(torch.from_numpy(x)), y_ref)
    _close(y_ref, jh._A_per_level[level] @ x)


def test_direct_coarse_solver_matches_jax(carried):
    jh, tl = carried
    b = _vec(jh.levels[2].op.shape[0], 6)
    _close(tl[2].coarse.apply(torch.from_numpy(b)),
           jh.levels[2].coarse.apply(jnp.asarray(b)))


def test_builders_match_jax(carried):
    """The port's block_stencil_from_csr, general_window_transfer_from_csr
    and build_coarse_solver on mfmg_tpu's own coarse CSR matrices."""
    jh, _ = carried
    A1, A2 = jh._A_per_level[1], jh._A_per_level[2]
    jb = jbs.block_stencil_from_csr(A1, jh.levels[1].op.agg_shape, 2,
                                    dtype=jnp.float64)
    tb = tbs.block_stencil_from_csr(A1, jh.levels[1].op.agg_shape, 2,
                                    dtype=torch.float64)
    assert tb.offsets == jb.offsets
    np.testing.assert_array_equal(tb.coeffs.numpy(), np.asarray(jb.coeffs))
    assert tbs.block_stencil_from_csr(A1, (3, 3, 3), 2) is None
    for ctype in ("direct",):
        ji = np.asarray(j_coarse(A2, jcfg.CoarseConfig(type=ctype),
                                 dtype=jnp.float64).inv)
        ti = t_coarse(A2, tcfg.CoarseConfig(type=ctype),
                      dtype=torch.float64, device="cpu").inv.numpy()
        np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-12 * np.abs(ji).max())
    gt = jh.levels[1].transfer
    Rd = np.asarray(gt.Rd)
    import scipy.sparse as sp
    R1 = sp.csr_matrix(Rd)
    jg = jtr.general_window_transfer_from_csr(R1, gt.in_grid, gt.n_in,
                                              gt.out_grid, gt.n_out,
                                              gt.stride, dtype=jnp.float64)
    tg = ttr.general_window_transfer_from_csr(R1, gt.in_grid, gt.n_in,
                                              gt.out_grid, gt.n_out,
                                              gt.stride, dtype=torch.float64)
    assert (tg.window_shape, tg.t0, tg.stride) == (jg.window_shape, jg.t0,
                                                   jg.stride)
    np.testing.assert_array_equal(tg.W.numpy(), np.asarray(jg.W))
    np.testing.assert_array_equal(tg.Rd.numpy(), Rd)


def test_direct_coarse_solver_cholesky_branch_matches_jax():
    """The n >= 2048 float32 branch (jittered Cholesky inverse), on an SPD
    matrix made from a seed."""
    import scipy.sparse as sp
    rng = np.random.default_rng(8)
    n = 2048
    B = rng.standard_normal((n, 64)) / 8.0
    A = sp.csr_matrix(B @ B.T + np.eye(n))
    ji = np.asarray(j_coarse(A, jcfg.CoarseConfig(type="direct"),
                             dtype=jnp.float32).inv)
    ti = t_coarse(A, tcfg.CoarseConfig(type="direct"),
                  dtype=torch.float32, device="cpu").inv.numpy()
    np.testing.assert_array_equal(ti, ji)
