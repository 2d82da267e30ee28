"""Adaptive (hanging-node) meshes in mfmg_torch against mfmg_tpu on the CPU.

- ``adaptive_cube`` (2-D and 3-D) and the reference's multi-sweep cases of
  tests/test_adaptive.py (a sweep away from the interface in 2-D and 3-D,
  a sweep that releases it): nodes, cells, boundary and constrained masks
  equal, the constraints (slaves, masters, weights, n_masters) equal with
  the weights to 0; a 2-irregular sweep raises in both.
- ``condense``, ``distribute``, ``A_raw``, ``A``, ``assemble_rhs`` and
  ``l2_error`` on the same meshes to 1e-13; the condensed operator
  reproduces a global linear function at every free dof.
- Hierarchies on hanging meshes (fast_ap off, the Galerkin product through
  the condensed A): the adaptive cube (2, 4) with 16 METIS parts and
  (3, 3) with RCB, at two and three levels: level shapes, the float64
  V-cycle rate to 1e-10, float32 PCG counts equal, and the slaves of the
  solution at 0 (tests/test_adaptive.py:116).
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.fem import adaptive as jad
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.fem import adaptive as tad

from _torch_unstructured import compare_hierarchies, quadrant, unstructured_config

NODE_TOL = 1e-14
COND_TOL = 1e-13        # scipy products of the same matrices in both packages


def _far_corner_2d(centers):
    return np.all(centers > 1.0 - 1.0 / 8, axis=1)


def _far_corner_3d(centers):
    return np.all(centers > 0.5, axis=1)


def _not_quadrant(centers):
    return ~quadrant(centers)


# (dim, n_ref, second sweep's marks or None): tests/test_adaptive.py's
# meshes, the multi-sweep ones of its lines 176-250 included
MESHES = {
    "2d_2": (2, 2, None),
    "2d_3": (2, 3, None),
    "3d_1": (3, 1, None),
    "3d_2": (3, 2, None),
    "keep_2d": (2, 3, _far_corner_2d),
    "release_2d": (2, 2, _not_quadrant),
    "keep_3d": (3, 1, _far_corner_3d),
}


def _mesh(mod, case):
    dim, n_ref, second = MESHES[case]
    m = mod.adaptive_cube(dim, n_ref, quadrant)
    return m if second is None else mod.refine_mesh(m, second)


def _pair(case):
    return _mesh(tad, case), _mesh(jad, case)


@pytest.mark.parametrize("case", list(MESHES))
def test_adaptive_mesh_and_constraints_match_the_reference(case):
    t, j = _pair(case)
    assert t.structured_shape is None
    np.testing.assert_array_equal(t.cells, j.cells)
    np.testing.assert_allclose(t.nodes, j.nodes, rtol=0, atol=NODE_TOL)
    np.testing.assert_array_equal(t.boundary_dofs, j.boundary_dofs)
    np.testing.assert_array_equal(t.constrained_mask, j.constrained_mask)
    if j.hanging is None or j.hanging.n == 0:
        assert t.hanging is None or t.hanging.n == 0
        assert case == "release_2d"
        return
    for name in ("slaves", "masters", "n_masters", "weights"):
        np.testing.assert_array_equal(getattr(t.hanging, name),
                                      getattr(j.hanging, name))
    assert not np.any(t.boundary_dofs[t.hanging.slaves])


def test_two_irregular_sweep_raises_in_both():
    for mod in (tad, jad):
        m1 = mod.adaptive_cube(2, 2, quadrant)
        touching = np.any(m1.cells == int(m1.hanging.slaves[0]), axis=1)
        marks = np.zeros(m1.n_cells, dtype=bool)
        marks[np.nonzero(touching)[0][0]] = True
        with pytest.raises(ValueError, match="2-irregular"):
            mod.refine_mesh(m1, marks)


def _sparse_close(a, b, tol):
    d = abs(a - b)
    assert d.max() <= tol * abs(b).max(), d.max()


@pytest.mark.parametrize("case", ["2d_3", "3d_2", "keep_2d", "keep_3d"])
def test_condensed_system_matches_the_reference(case):
    t, j = _pair(case)
    tp, jp = TLaplace.from_mesh(t, "linear"), JLaplace.from_mesh(j, "linear")
    _sparse_close(tp.A_raw, jp.A_raw, COND_TOL)
    _sparse_close(t.hanging.matrix(t.n_nodes), j.hanging.matrix(j.n_nodes), 0.0)
    _sparse_close(t.hanging.condense(tp.A_raw), j.hanging.condense(jp.A_raw),
                  COND_TOL)
    _sparse_close(tp.A, jp.A, COND_TOL)
    assert abs(tp.A - tp.A.T).max() < 1e-12

    u = np.random.default_rng(5).standard_normal(t.n_nodes)
    np.testing.assert_allclose(tp.distribute(u), jp.distribute(u),
                               rtol=0, atol=COND_TOL)

    def exact(p):
        return np.sin(np.pi * p[..., 0]) * np.sin(np.pi * p[..., 1])

    def source(p):
        return 2.0 * np.pi ** 2 * exact(p)

    rhs = tp.assemble_rhs(source)
    np.testing.assert_allclose(rhs, jp.assemble_rhs(source), rtol=0,
                               atol=COND_TOL * np.abs(rhs).max())
    assert not rhs[t.constrained_mask].any()
    x = tp.distribute(spla.spsolve(tp.A.tocsc(), rhs))
    hh = t.hanging
    w = np.where(np.arange(hh.masters.shape[1])[None] < hh.n_masters[:, None],
                 hh.weights, 0.0)
    np.testing.assert_allclose(x[hh.slaves], (w * x[hh.masters]).sum(1),
                               rtol=0, atol=1e-14)
    assert tp.l2_error(x, exact) == pytest.approx(jp.l2_error(x, exact),
                                                  rel=COND_TOL)

    # a global linear function is reproduced: the condensed operator
    # vanishes at every free dof (tests/test_adaptive.py _linear_patch_residual)
    C = hh.matrix(t.n_nodes)
    A_raw = TLaplace.from_mesh(t, "constant").A_raw
    r = (C.T @ A_raw @ C) @ t.nodes[:, 0]
    assert np.abs(r[~t.constrained_mask]).max() < 1e-10


def test_metis_hierarchy_on_the_adaptive_square():
    """tests/test_adaptive.py::test_hierarchy_on_adaptive_mesh's mesh and
    partition (16 METIS parts), at two and three levels."""
    for levels in (2, 3):
        x, prob, th = compare_hierarchies(
            jad.adaptive_cube(2, 4, quadrant), tad.adaptive_cube(2, 4, quadrant),
            jcfg, tcfg, partitioner="metis", n_agglomerates=16,
            max_levels=levels)
        assert th._fast_ap is False
        assert np.abs(x[prob.mesh.hanging.slaves]).max() <= 1e-8


def test_rcb_hierarchy_on_the_adaptive_cube():
    """The adaptive cube (3, 3) with n_cells // 8 RCB parts: ragged parts
    on a hanging mesh, as chip_smoke.py's phase 10 runs at (3, 5)."""
    n_parts = jad.adaptive_cube(3, 3, quadrant).n_cells // 8
    for levels in (2, 3):
        x, prob, th = compare_hierarchies(
            jad.adaptive_cube(3, 3, quadrant), tad.adaptive_cube(3, 3, quadrant),
            jcfg, tcfg, partitioner="rcb", n_agglomerates=n_parts,
            max_levels=levels)
        assert th._fast_ap is False
        batch = th._level0_eigendata[0]
        assert batch.sizes.min() < batch.sizes.max()
        assert np.abs(x[prob.mesh.hanging.slaves]).max() <= 1e-8


def test_hanging_mesh_takes_the_condensed_galerkin_product():
    """fast_ap=True is overridden on a hanging mesh, as in the reference:
    the coarse operator is R A R^T of the condensed A."""
    mesh = tad.adaptive_cube(2, 3, quadrant)
    prob = TLaplace.from_mesh(mesh, "linear")
    cfg = unstructured_config(tcfg, "float64", partitioner="rcb",
                              n_agglomerates=12, max_levels=2)
    cfg.fast_ap = True
    h = THierarchy(prob, cfg, device="cpu")
    assert h._fast_ap is False
    R = h._R_composed
    A_c = (R @ prob.A @ R.T).toarray()
    np.testing.assert_allclose(h._A_per_level[1].toarray(), A_c, rtol=0,
                               atol=1e-13 * np.abs(A_c).max())

