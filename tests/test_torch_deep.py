"""The per-cell patch path and hierarchies deeper than three levels, and the
distorted Q2 cube at three levels, against mfmg_tpu on the CPU.

- ``_super_blocks_per_cell`` (chunked over cells) against the reference's
  on the inputs of the reference's own 4-level float64 Q1 hierarchy at
  17^3: level 2 (one super-agglomerate) and level 1 (the path a light
  level-0 batch takes), in one chunk and in many (the assembly is additive
  over cells: chunks change only the summation order).  The 33^3 cases are
  in tests/test_torch_deep_33.py, so that a run that spreads files over
  workers spreads them.
- ``build_recursive_restriction`` on the reference's level-2 inputs: R_l
  to 1e-12 of its largest entry, each row up to its sign (the
  eigensolver's choice).
- Whole hierarchies, float64: Q1 17^3 at max_levels=4 (window transfers at
  levels 1-2, the per-cell path at level 2; the reference's hierarchy is
  the one the cases above record) and the distorted Q2 cube at n_ref 3
  with max_levels=3 (an ELL R/R^T at level 1, an ELL level 2):
  measure_vcycle_rate and one V-cycle to 1e-10, PCG iterations equal, one
  V-cycle on the reference's levels carried across to 1e-12.  No tail on
  either structure, in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.amge.multilevel as tml
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.hierarchy import measure_vcycle_rate as j_rate
from mfmg_tpu.amge.hierarchy import vcycle as j_vcycle
from mfmg_tpu.ops.fused_cycle import build_fused_tail as j_build_fused_tail
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.hierarchy import levels_from_arrays
from mfmg_torch.amge.hierarchy import measure_vcycle_rate as t_rate
from mfmg_torch.amge.hierarchy import vcycle as t_vcycle
from mfmg_torch.ops.fused_cycle import build_fused_tail as t_build_fused_tail
from mfmg_torch.ops.sparse import ELLMatrix, ELLTransfer
from mfmg_torch.ops.structured_transfer import GeneralWindowTransfer

from _torch_carry import flatten_levels
from _torch_deep import (ASSEMBLY_TOL, check_super_blocks, deep_config,
                         recorded, rel_max)

# whole float64 hierarchies: the reference's numbers through another
# summation order at every level (the bound of tests/test_torch_hierarchy.py)
HIERARCHY_TOL = 1e-10
CARRY_TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("n_ref,level,chunk_bytes", [
    (4, 2, tml.CELL_CHUNK_BYTES), (4, 2, 1 << 16), (4, 1, 1 << 16)],
    ids=["17^3-L2", "17^3-L2-many-chunks", "17^3-L1-many-chunks"])
def test_super_blocks_per_cell_match_the_reference(n_ref, level, chunk_bytes):
    """A1, the Gram and the member tables of the chunked per-cell assembly
    against the reference's."""
    check_super_blocks(n_ref, level, chunk_bytes)


def test_recursive_restriction_per_cell_matches_the_reference():
    """Level 2 of the 17^3 4-level hierarchy: R_l (each row up to its
    sign), the super-agglomerates and their grid."""
    tp, _, calls = recorded(4)
    args, (R_ref, cs_ref, grid_ref) = calls[1]
    _, _, cell_agg, R_prev, A_prev, bd, n_ev, bdims = args
    R, cs, grid = tml.build_recursive_restriction(
        tp.mesh, tp.A_loc, cell_agg, R_prev, A_prev, bd, n_ev, bdims)
    np.testing.assert_array_equal(cs, cs_ref)
    assert grid == grid_ref and R.shape == R_ref.shape
    R, R_ref = R.toarray(), R_ref.toarray()
    sign = np.sign(np.einsum("ij,ij->i", R, R_ref))
    assert np.all(sign != 0)
    assert rel_max(R * sign[:, None], R_ref) <= ASSEMBLY_TOL


def _j_cycle(jh, b):
    return np.asarray(j_vcycle(jh.levels, jnp.asarray(b, dtype=jh.dtype),
                               jnp.zeros(len(b), dtype=jh.dtype)))


def _against_reference(th, jh, seed):
    """measure_vcycle_rate, one V-cycle and the PCG count of two float64
    hierarchies, and one V-cycle on the reference's levels carried across."""
    assert t_rate(th) == pytest.approx(j_rate(jh), rel=HIERARCHY_TOL)
    b = np.random.default_rng(seed).uniform(size=th.problem.n_dofs)
    y_j = _j_cycle(jh, b)
    assert _rel(th.vmult(b).numpy(), y_j) <= HIERARCHY_TOL
    _, ti = th.solve_cg(b, tol=1e-8, maxiter=100)
    _, ji = jh.solve_cg(b, tol=1e-8, maxiter=100)
    assert ti["iterations"] == int(ji["iterations"])
    levels = levels_from_arrays(*flatten_levels(jh.levels), "cpu")
    y_c = t_vcycle(levels, torch.from_numpy(b), torch.zeros(len(b),
                                                             dtype=torch.float64))
    assert _rel(y_c.numpy(), y_j) <= CARRY_TOL


def test_four_level_q1_hierarchy_matches_the_reference():
    """Q1 17^3 at max_levels=4: 4,913 -> 128 -> 4 -> 4 dofs, window
    transfers at levels 1 and 2, no tail."""
    tp, jh, _ = recorded(4)
    th = THierarchy(tp, deep_config(tcfg), device="cpu")
    assert [lv.op.shape[0] for lv in th.levels] == [4913, 128, 4, 4]
    assert th.per_cell_levels == [2]
    assert all(isinstance(th.levels[i].transfer, GeneralWindowTransfer)
               for i in (1, 2))
    assert t_build_fused_tail(list(th.levels), 1) is None
    assert j_build_fused_tail(jh.levels, 1) is None
    _against_reference(th, jh, 2)


def test_distorted_q2_three_levels_matches_the_reference():
    """The distorted Q2 cube (n_ref 3, seed 0) at max_levels=3: its level-1
    transfer is not windowed, so R/R^T are ELL there, and level 2 is an ELL
    operator larger than level 1 (centroid-layer grouping on a distorted
    mesh, a deviation of the reference that the port mirrors); no tail."""
    kw = dict(degree=2, material_property="linear", distort_random=True, seed=0)
    th = THierarchy(TLaplace.hyper_cube(3, 3, **kw), deep_config(tcfg, 3),
                    device="cpu")
    jh = JHierarchy(JLaplace.hyper_cube(3, 3, **kw), deep_config(jcfg, 3))
    sizes = [lv.op.shape[0] for lv in th.levels]
    assert sizes == [jl.op.shape[0] for jl in jh.levels]
    assert sizes[2] > sizes[1]
    assert isinstance(th.levels[1].transfer, ELLTransfer)
    assert jh.levels[1].transfer is None and jh.levels[1].R is not None
    assert isinstance(th.levels[2].op, ELLMatrix)
    assert th.per_cell_levels == []
    assert t_build_fused_tail(list(th.levels), 1) is None
    assert j_build_fused_tail(jh.levels, 1) is None
    _against_reference(th, jh, 3)
