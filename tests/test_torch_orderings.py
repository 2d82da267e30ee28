"""deal.II orderings and dof renumbering in mfmg_torch against mfmg_tpu on
the CPU (the reference's tests/test_dealii_order.py and the reordering
sweep of tests/test_hierarchy.py:398-470).

- ``dealii_cell_order`` and ``dealii_dof_numbering`` equal mfmg_tpu's on
  2-D and 3-D cubes, with their refusals; the "block_dealii" partitioner
  equals mfmg_tpu's ids and the literal agglomerate-id goldens
  (tests/data/agglomerate_goldens.json), and raises the reference's
  ValueError on the ball.
- ``renumber_dofs`` with Reverse Cuthill-McKee and King: the same nodes,
  cells and boundary mask as mfmg_tpu; its refusals.
- A renumbered mesh takes the generic agglomerate batch (equal to
  mfmg_tpu's) and ``operator="stencil"`` refuses it, as in the reference.
- The reordering sweep: lexicographic Gauss-Seidel on the RCM and King
  meshes and matrix-free Chebyshev on the RCM mesh hold the goldens at the
  reference's 1e-2, each rate equal to mfmg_tpu's at RATE_TOL.
"""

import json
import os

import numpy as np
import pytest

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge import agglomeration as jagg
from mfmg_tpu.amge import local_problems as jlp
from mfmg_tpu.fem import dealii_order as jdo
from mfmg_tpu.fem import mesh as jmesh
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge import agglomeration as tagg
from mfmg_torch.amge import local_problems as tlp
from mfmg_torch.fem import dealii_order as tdo
from mfmg_torch.fem import mesh as tmesh

from _torch_rates import (GOLDEN_MATRIX_SGS_3D, GOLDEN_MF_CHEBYSHEV_3D,
                          RATE_TOL, both_rates, cfg_3d)

GOLDENS = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                      "agglomerate_goldens.json")))
RENUMBERINGS = ("Reverse Cuthill_McKee", "King")


@pytest.mark.parametrize("dim,n_ref", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_dealii_orders_match_reference(dim, n_ref):
    t, j = tmesh.hyper_cube(dim, n_ref), jmesh.hyper_cube(dim, n_ref)
    order = tdo.dealii_cell_order(t)
    np.testing.assert_array_equal(order, jdo.dealii_cell_order(j))
    numbering = tdo.dealii_dof_numbering(t)
    np.testing.assert_array_equal(numbering, jdo.dealii_dof_numbering(j))
    assert np.array_equal(np.sort(numbering), np.arange(t.n_nodes))
    # first touch: the first cell in deal.II order owns dofs 0 .. 2^dim - 1
    np.testing.assert_array_equal(numbering[t.cells[order[0]]],
                                  np.arange(2 ** dim))


def test_dealii_orders_refuse_what_the_reference_refuses():
    with pytest.raises(NotImplementedError, match="Q1"):
        tdo.dealii_dof_numbering(tmesh.hyper_cube(2, 2, degree=2))
    with pytest.raises(ValueError, match="power of two"):
        tdo.dealii_cell_order(tmesh.structured_cube(2, (3, 3)))
    with pytest.raises(ValueError, match="equal cells per dimension"):
        tdo.dealii_cell_order(tmesh.structured_cube(2, (2, 4)))
    with pytest.raises(ValueError, match="structured hyper_cube meshes only"):
        tdo.dealii_cell_order(tmesh.hyper_ball(2, 1))


@pytest.mark.parametrize("dim,key", [(2, "simple_2d"), (3, "simple_3d")])
def test_block_dealii_ids_match_reference_and_goldens(dim, key):
    """test_agglomerate.cc:79-160: hyper_cube refine_global(3), the block
    partitioner nx=2 ny=3 nz=4 walked in deal.II's cell order."""
    kw = dict(partitioner="block_dealii", nx=2, ny=3, nz=4)
    t_mesh = tmesh.hyper_cube(dim, 3)
    agg = tagg.build_agglomerates(t_mesh, tcfg.AgglomerationConfig(**kw))
    np.testing.assert_array_equal(agg, jagg.build_agglomerates(
        jmesh.hyper_cube(dim, 3), jcfg.AgglomerationConfig(**kw)))
    np.testing.assert_array_equal(agg[tdo.dealii_cell_order(t_mesh)] + 1,
                                  GOLDENS[key])


def test_block_dealii_same_partition_as_block_when_dividing():
    mesh = tmesh.hyper_cube(2, 3)
    a = tagg.build_agglomerates(mesh, tcfg.AgglomerationConfig(
        partitioner="block", nx=2, ny=2))
    b = tagg.build_agglomerates(mesh, tcfg.AgglomerationConfig(
        partitioner="block_dealii", nx=2, ny=2))
    pairs = {(x, y) for x, y in zip(a, b)}
    assert len(pairs) == len(set(a)) == len(set(b))


@pytest.mark.parametrize("method", RENUMBERINGS)
@pytest.mark.parametrize("dim,n_ref,degree", [(2, 3, 1), (3, 2, 1), (2, 2, 2)])
def test_renumber_dofs_matches_reference(method, dim, n_ref, degree):
    t = tmesh.renumber_dofs(tmesh.hyper_cube(dim, n_ref, degree=degree), method)
    j = jmesh.renumber_dofs(jmesh.hyper_cube(dim, n_ref, degree=degree), method)
    assert t.dof_renumbered and t.is_structured
    np.testing.assert_array_equal(t.cells, j.cells)
    np.testing.assert_array_equal(t.nodes, j.nodes)
    np.testing.assert_array_equal(t.boundary_dofs, j.boundary_dofs)
    assert not np.array_equal(t.cells, tmesh.hyper_cube(dim, n_ref,
                                                        degree=degree).cells)


def test_renumber_dofs_refusals():
    from mfmg_torch.fem.adaptive import adaptive_cube
    mesh = tmesh.hyper_cube(3, 1)
    assert tmesh.renumber_dofs(mesh, "None") is mesh
    with pytest.raises(ValueError, match="unsupported reordering"):
        tmesh.renumber_dofs(mesh, "Reverse minimum degree")
    hanging = adaptive_cube(2, 2, lambda c: np.all(c < 0.5, axis=1))
    with pytest.raises(ValueError, match="hanging-node"):
        tmesh.renumber_dofs(hanging, "King")


def test_renumbered_mesh_takes_the_generic_batch_and_refuses_the_stencil():
    """The closed-form dof paths decline a renumbered mesh
    (mfmg_tpu/amge/local_problems.py:106, mfmg_tpu/ops/stencil.py:264):
    the batch is the generic one, equal to mfmg_tpu's, and the stencil
    operator raises the reference's ValueError."""
    t_mesh = tmesh.renumber_dofs(tmesh.hyper_cube(3, 2), "Reverse Cuthill_McKee")
    j_mesh = jmesh.renumber_dofs(jmesh.hyper_cube(3, 2), "Reverse Cuthill_McKee")
    tp, jp = TLaplace.from_mesh(t_mesh, "linear"), JLaplace.from_mesh(j_mesh, "linear")
    cfg = tcfg.AgglomerationConfig(nx=2, ny=2, nz=2)
    ids = tagg.build_agglomerates(t_mesh, cfg)
    assert tlp._structured_layout(t_mesh, ids) is None
    with pytest.raises(ValueError, match="not the closed-form"):
        tlp.block_layout(t_mesh, ids)
    tb = tlp.build_agglomerate_batch(t_mesh, tp.A_loc, ids)
    jb = jlp.build_agglomerate_batch(j_mesh, jp.A_loc, ids)
    np.testing.assert_array_equal(tb.dof_map, jb.dof_map)
    np.testing.assert_allclose(tb.A_agg, jb.A_agg, rtol=0, atol=1e-14)
    np.testing.assert_allclose(tb.diag, jb.diag, rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match="lexicographic dof numbering"):
        THierarchy(tp, cfg_3d(tcfg, operator="stencil"), device="cpu")


@pytest.mark.parametrize("method", RENUMBERINGS)
def test_reordering_sweep_lexicographic_gs(method):
    """tests/test_hierarchy.py:398-470: lexicographic Gauss-Seidel in the
    new numbering holds the matrix-path golden at 1e-2."""
    meshes = (tmesh.renumber_dofs(tmesh.hyper_cube(3, 2), method),
              jmesh.renumber_dofs(jmesh.hyper_cube(3, 2), method))
    t, j = both_rates(
        JLaplace.from_mesh(meshes[1], "constant"),
        TLaplace.from_mesh(meshes[0], "constant"),
        lambda c: cfg_3d(c, operator="ell", smoother=c.SmootherConfig(
            type="gauss-seidel", coloring="lexicographic")))
    assert t == pytest.approx(GOLDEN_MATRIX_SGS_3D, abs=1e-2), t
    assert abs(t - j) <= RATE_TOL, (t, j)


def test_reordering_sweep_matrix_free():
    meshes = (tmesh.renumber_dofs(tmesh.hyper_cube(3, 2), "Reverse Cuthill_McKee"),
              jmesh.renumber_dofs(jmesh.hyper_cube(3, 2), "Reverse Cuthill_McKee"))
    t, j = both_rates(
        JLaplace.from_mesh(meshes[1], "constant"),
        TLaplace.from_mesh(meshes[0], "constant"),
        lambda c: cfg_3d(c, operator="matrix_free", smoother=c.SmootherConfig(
            type="chebyshev", degree=1)))
    assert t == pytest.approx(GOLDEN_MF_CHEBYSHEV_3D, abs=1e-2), t
    assert abs(t - j) <= RATE_TOL, (t, j)
