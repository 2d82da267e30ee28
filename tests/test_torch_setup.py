"""mfmg_torch host setup against mfmg_tpu at 17^3 and 33^3 (float64).

Both packages build the main-path hierarchy from the same problem; the
setup is host numpy/scipy in both, and both call the same LAPACK ``dsyevx``,
so the eigenvectors, restrictions and Galerkin operators agree to
summation-order roundoff: 1e-10 relative.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.agglomeration import build_agglomerates as j_aggs
from mfmg_tpu.amge.local_problems import build_agglomerate_batch as j_batch
from mfmg_tpu.eigen.batched_eigh import batched_smallest_eigenpairs as j_eig
from mfmg_tpu.fem import mesh as jmesh
from mfmg_tpu.fem.dealii_order import dealii_cell_order
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.agglomeration import build_agglomerates as t_aggs
from mfmg_torch.amge.local_problems import build_agglomerate_batch as t_batch
from mfmg_torch.eigen.batched_eigh import batched_smallest_eigenpairs as t_eig
from mfmg_torch.fem import mesh as tmesh

from _torch_carry import main_path_config

TOL = 1e-10


@pytest.fixture(scope="module", params=[4, 5], ids=["17^3", "33^3"])
def built(request):
    n_ref = request.param
    jp = JLaplace.hyper_cube(3, n_ref, material_property="linear")
    tp = TLaplace.hyper_cube(3, n_ref, material_property="linear")
    jh = JHierarchy(jp, main_path_config(jcfg, "float64"))
    th = THierarchy(tp, main_path_config(tcfg, "float64"), device="cpu")
    return jp, tp, jh, th


def _rel_close(a, b, tol=TOL):
    """max|a - b| <= tol * max|b| for arrays or scipy sparse matrices (the
    sparse ones are compared without densifying)."""
    assert a.shape == b.shape
    if sp.issparse(a) or sp.issparse(b):
        diff, scale = abs(sp.csr_matrix(a) - sp.csr_matrix(b)).max(), abs(b).max()
    else:
        a, b = np.asarray(a), np.asarray(b)
        diff, scale = np.abs(a - b).max(), np.abs(b).max()
    assert diff <= tol * max(scale, 1e-300)


def test_problem_matches_jax(built):
    jp, tp, _, _ = built
    np.testing.assert_array_equal(tp.mesh.cells, jp.mesh.cells)
    np.testing.assert_array_equal(tp.mesh.nodes, jp.mesh.nodes)
    np.testing.assert_array_equal(tp.constrained, jp.constrained)
    assert tp.mesh.structured_shape == jp.mesh.structured_shape
    np.testing.assert_array_equal(tp.A_loc, jp.A_loc)
    np.testing.assert_array_equal(tp.diag_raw, jp.diag_raw)
    _rel_close(tp.A, jp.A, 1e-15)


def test_agglomerates_and_eigenpairs_match_jax(built):
    """Same agglomerates; eigenvalues to 1e-10 and the eigenvector basis to
    1e-10 (same LAPACK call on the same host)."""
    jp, tp, _, _ = built
    ja = j_aggs(jp.mesh, jcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    ta = t_aggs(tp.mesh, tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    np.testing.assert_array_equal(ta, ja)
    jb, tb = j_batch(jp.mesh, jp.A_loc, ja), t_batch(tp.mesh, tp.A_loc, ta)
    np.testing.assert_array_equal(tb.dof_map, jb.dof_map)
    np.testing.assert_array_equal(tb.constrained, jb.constrained)
    _rel_close(tb.A_agg, jb.A_agg, 1e-14)
    _rel_close(tb.diag, jb.diag, 1e-14)
    jw, jv = j_eig(jb, 2, constrained_mode="pin")
    tw, tv = t_eig(tb, 2, constrained_mode="pin")
    _rel_close(tw, jw)
    _rel_close(tv, jv)


def test_block_partition_matches_reference_goldens():
    """The literal agglomerate goldens of the reference (test_agglomerate.cc,
    tests/data/agglomerate_goldens.json: hyper_cube refine 3, block dims
    2x3x4, deal.II cell order) describe the same partition as the port's
    block partitioner, up to agglomerate numbering."""
    goldens = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                          "agglomerate_goldens.json")))
    for dim, key in [(2, "simple_2d"), (3, "simple_3d")]:
        ours = t_aggs(tmesh.hyper_cube(dim, 3),
                      tcfg.AgglomerationConfig(nx=2, ny=3, nz=4))
        ours = ours[dealii_cell_order(jmesh.hyper_cube(dim, 3))]
        gold = np.asarray(goldens[key])
        pairs = {(a, g) for a, g in zip(ours, gold)}
        assert len(pairs) == len(set(ours)) == len(set(gold.tolist()))


def test_restrictions_and_coarse_operators_match_jax(built):
    """R (composed through level 1) and the Galerkin operators A_1, A_2 to
    1e-10 relative; the coarse block stencils and transfers built from them
    carry the same shapes."""
    _, _, jh, th = built
    _rel_close(th._R_composed, jh._R_composed)
    for level in (1, 2):
        _rel_close(th._A_per_level[level], jh._A_per_level[level])
        assert th.levels[level].op.agg_shape == jh.levels[level].op.agg_shape
        assert th.levels[level].op.offsets == jh.levels[level].op.offsets
    assert th.levels[0].transfer.agg_shape == jh.levels[0].transfer.agg_shape
    _rel_close(th.levels[0].transfer.W.numpy(), jh.levels[0].transfer.W)
    _rel_close(th.levels[1].transfer.Rd.numpy(), jh.levels[1].transfer.Rd)
    _rel_close(th.levels[2].coarse.inv.numpy(), jh.levels[2].coarse.inv, 1e-8)
    for level in (0, 1):
        ts, js = th.levels[level].smoother, jh.levels[level].smoother
        assert ts.theta == pytest.approx(float(js.theta), rel=TOL)
        assert ts.delta == pytest.approx(float(js.delta), rel=TOL)
