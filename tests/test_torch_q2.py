"""The Q2 slice of the port against mfmg_tpu on the CPU.

Q2 (fe_degree 2) elements give fine stencils of 125 offsets; where the
host's BLAS leaves the cell matrices bit-asymmetric (as on the CPU these
tests were written on) the planes are one-sided, every fine apply of the
port goes through K3's wrapper (its plain version on CPU tensors) and the
level-0 smoother is the plain Chebyshev smoother; the fine transfer windows
are 9^3 at stride 8.  Both packages build the
main-path configuration (float32, bf16 preconditioner planes) on the same
Q2 problem and take the same numpy right-hand side.

Tolerances: V-cycle 1e-5 relative (2-norm), the float32 bound of
tests/test_torch_hierarchy.py (observed 1.0e-7 at 17^3, 1.3e-7 at 33^3);
PCG iteration counts equal and relres within 1e-6 (observed 1e-10); the
fused tail at Q2 shapes 1e-5 relative (float sums over the same operands in
another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.hierarchy import vcycle as j_vcycle
from mfmg_tpu.ops import fused_cycle as jfc
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.hierarchy import levels_from_arrays
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import fused_cycle as tfc
from mfmg_torch.solve.smoothers import ChebyshevSmoother

from _torch_carry import flatten_levels, main_path_config

PCG_TOL = 1e-5
VCYCLE_TOL = 1e-5
TAIL_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(n_ref):
    cfg = ("float32", "bfloat16")
    jh = JHierarchy(JLaplace.hyper_cube(3, n_ref, degree=2,
                                        material_property="linear"),
                    main_path_config(jcfg, *cfg))
    th = THierarchy(TLaplace.hyper_cube(3, n_ref, degree=2,
                                        material_property="linear"),
                    main_path_config(tcfg, *cfg), device="cpu")
    return jh, th


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_ref", [3, 4], ids=["17^3", "33^3"])
def test_q2_slice_matches_jax(n_ref):
    jh, th = _pair(n_ref)
    op = th.levels[0].op
    # both packages read the same bits on one host; here the planes come
    # out one-sided (another host's BLAS may sum them symmetrically)
    assert op.sym_pos == jh.levels[0].op.sym_pos
    assert len(op.offsets) == 125
    if op.sym_pos is None:
        assert op.coeffs.dtype == torch.bfloat16 and op.planes is None
        assert th._exact_fine_op().sym_pos is None
    assert isinstance(th.levels[0].smoother, ChebyshevSmoother)
    assert th.levels[0].transfer.window_shape == (9, 9, 9)
    assert ([lv.op.shape[0] for lv in th.levels]
            == [lv.op.shape[0] for lv in jh.levels])
    n = th.problem.n_dofs
    b = np.random.default_rng(0).uniform(size=n).astype(np.float32)
    yj = j_vcycle(jh.levels, jnp.asarray(b), jnp.zeros(n, dtype=jnp.float32))
    assert _rel(th.vmult(b).numpy(), yj) <= VCYCLE_TOL
    _, t_info = th.solve_cg(b, tol=PCG_TOL, maxiter=50)
    _, j_info = jh.solve_cg(b, tol=PCG_TOL, maxiter=50)
    assert t_info["iterations"] == int(j_info["iterations"])
    assert t_info["relres"] <= PCG_TOL
    assert abs(t_info["relres"] - float(j_info["relres"])) <= 1e-6
    assert all(v == 0 for v in cl.LAUNCHES.values())


@pytest.mark.parametrize("reduced", [False, True], ids=["f32", "bf16"])
def test_q2_tail_matches_jax(reduced):
    """The full-mode tail at Q2 shapes (9^3 fine windows over a 4^3
    agglomerate grid, 33^3 nodes) built from the reference's levels carried
    into the port: its plain version against mfmg_tpu's tail kernel in
    interpret mode, both modes."""
    jh, _ = _pair(4)
    tl = levels_from_arrays(*flatten_levels(jh.levels), "cpu")
    ft = tfc.build_fused_tail(tl, 1, reduced_storage=reduced)
    fj = jfc.build_fused_tail(jh.levels, 1, reduced_storage=reduced)
    assert ft.fine_window == (9, 9, 9) and ft.fine_grid == fj.fine_grid
    rng = np.random.default_rng(1)
    b1 = rng.standard_normal(ft.n1).astype(np.float32)
    x = rng.uniform(size=ft.n_fine).astype(np.float32)
    res = rng.standard_normal(ft.n_fine).astype(np.float32)
    assert _rel(tfc.fused_subcycle_apply(ft, torch.from_numpy(b1)),
                jfc.fused_subcycle_apply(fj, jnp.asarray(b1))) <= TAIL_TOL
    assert _rel(tfc.fused_correction_apply(ft, torch.from_numpy(x),
                                           torch.from_numpy(res)),
                jfc.fused_correction_apply(fj, jnp.asarray(x),
                                           jnp.asarray(res))) <= TAIL_TOL


def test_distorted_q2_two_levels_matches_jax():
    """The distorted Q2 cube (deal.II distort_random, seed 0) with two
    levels, the Q2 configuration that stays one-sided on every host (its
    general cell Jacobians leave the cell matrices bit-asymmetric; its
    level-1 agglomerates are not windowed, hence two levels): the fine
    applies through K3's wrapper, the fine transfer through K4/K5's, the
    V-cycle to VCYCLE_TOL (observed 8.6e-8), the same PCG count."""
    def build(pkg_laplace, pkg_hier, pkg_cfg, **kw):
        cfg = main_path_config(pkg_cfg, "float32", "bfloat16")
        cfg.max_levels = 2
        prob = pkg_laplace.hyper_cube(3, 3, degree=2, material_property="linear",
                                      distort_random=True, seed=0)
        return pkg_hier(prob, cfg, **kw)

    jh = build(JLaplace, JHierarchy, jcfg)
    th = build(TLaplace, THierarchy, tcfg, device="cpu")
    np.testing.assert_array_equal(th.problem.mesh.nodes, jh.problem.mesh.nodes)
    assert th.levels[0].op.sym_pos is None and len(th.levels) == 2
    n = th.problem.n_dofs
    b = np.random.default_rng(3).uniform(size=n).astype(np.float32)
    yj = j_vcycle(jh.levels, jnp.asarray(b), jnp.zeros(n, dtype=jnp.float32))
    assert _rel(th.vmult(b).numpy(), yj) <= VCYCLE_TOL
    _, t_info = th.solve_cg(b, tol=PCG_TOL, maxiter=50)
    _, j_info = jh.solve_cg(b, tol=PCG_TOL, maxiter=50)
    assert t_info["iterations"] == int(j_info["iterations"])
    assert abs(t_info["relres"] - float(j_info["relres"])) <= 1e-6


def test_q2_main_path_tail_takes_full_mode():
    """The full-tail gate at the 65^3 Q2 main path's shapes (8^3
    agglomerates, 9^3 windows, 65^3 nodes): (2+1) 72^3 + 3 65^3 floats,
    7.8 MB in float32, under the 30 MB gate, so the card runs the full
    tail there."""
    assert tfc.full_tail_fits(2, (8,) * 3, (9,) * 3, (65,) * 3, 4)
