"""Test helper: the reference's recorded build_recursive_restriction calls
in its 4-level float64 Q1 hierarchies, and the per-cell patch path's inputs
taken from them, for tests/test_torch_deep*.py.

It imports mfmg_tpu (and so jax), which the port itself never does; it
lives under tests/ for that reason.
"""

import numpy as np

import mfmg_tpu.amge.multilevel as jml
import mfmg_tpu.config as jcfg
import mfmg_torch.amge.multilevel as tml
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_torch import LaplaceProblem as TLaplace

from _torch_carry import main_path_config

# float64 assemblies of the same terms in another order (chunks, BLAS
# calls), relative to the largest entry
ASSEMBLY_TOL = 1e-12


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def deep_config(mod, max_levels=4):
    cfg = main_path_config(mod, "float64")
    cfg.max_levels = max_levels
    return cfg


_RECORDED = {}


def recorded(n_ref):
    """(the port's problem, the reference's 4-level float64 Q1 hierarchy at
    n_ref, its build_recursive_restriction calls as (arguments, results),
    levels 1 and 2), built once per n_ref."""
    if n_ref not in _RECORDED:
        calls, recursive = [], jml.build_recursive_restriction

        def spy(*args, **kwargs):
            out = recursive(*args, **kwargs)
            calls.append((args, out))
            return out

        jml.build_recursive_restriction = spy
        try:
            jh = JHierarchy(JLaplace.hyper_cube(3, n_ref,
                                                material_property="linear"),
                            deep_config(jcfg))
        finally:
            jml.build_recursive_restriction = recursive
        tp = TLaplace.hyper_cube(3, n_ref, material_property="linear")
        np.testing.assert_array_equal(tp.mesh.cells, calls[0][0][0].cells)
        np.testing.assert_array_equal(tp.A_loc, calls[0][0][1])
        _RECORDED[n_ref] = (tp, jh, calls)
    return _RECORDED[n_ref]


def per_cell_inputs(n_ref, level):
    """The per-cell path's inputs at ``level`` (the reference's own level-2
    call; at level 1 the same path over the level-0 agglomerates, which the
    reference takes there when its batch is light) and the reference's
    _super_blocks_per_cell on them."""
    tp, _, calls = recorded(n_ref)
    _, cell_agg, R_prev, A_prev, bd, _, bdims = calls[level - 1][0][1:]
    super_of_agg, _ = tml.group_agglomerates(tp.mesh, cell_agg, bdims)
    cell_super = super_of_agg[cell_agg]
    dof_rows, dof_vals = tml._dof_row_structure(R_prev.tocsr())
    args = (cell_super, dof_rows, dof_vals, bd, A_prev.shape[0],
            int(cell_super.max()) + 1)
    ref = jml._super_blocks_per_cell(calls[0][0][0], tp.A_loc, *args)
    return tp, args, ref


def check_super_blocks(n_ref, level, chunk_bytes):
    """A1, the Gram and the member tables of the chunked per-cell assembly
    against the reference's: A1 and the Gram to ASSEMBLY_TOL of their
    largest entry, the member tables exactly.  chunk_bytes below the
    default must give more than two chunks."""
    tp, args, ref = per_cell_inputs(n_ref, level)
    cells, q = tp.mesh.cells.shape[0], args[1].shape[1]
    if chunk_bytes < tml.CELL_CHUNK_BYTES:
        assert cells > 2 * chunk_bytes // (6 * 8 * tp.mesh.cells.shape[1] * q)
    A1, M, m1s, member_pad = tml._super_blocks_per_cell(
        tp.mesh, tp.A_loc, *args, chunk_bytes=chunk_bytes)
    np.testing.assert_array_equal(m1s, ref[2])
    np.testing.assert_array_equal(member_pad, ref[3])
    assert rel_max(A1, ref[0]) <= ASSEMBLY_TOL
    assert rel_max(M, ref[1]) <= ASSEMBLY_TOL
