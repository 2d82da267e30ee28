"""Unstructured meshes in mfmg_torch against mfmg_tpu on the CPU: the
hyper_ball, its face table and block walk, the RCB and METIS-style
partitioners, and the generic (ragged) agglomerate batch.

- ``hyper_ball`` (2-D and 3-D, Q1 and Q2, distorted): nodes to 1e-14, the
  cell table and boundary mask equal; the ball's base complex, refinement
  and boundary vertices equal; curved-cell geometry (no shared Jacobian)
  and load vectors to 1e-14.
- ``face_neighbors`` and the unstructured block walk: identical arrays on
  the ball, the distorted ball and an adaptive cube; a face in three
  cells raises.  The vectorized ball refinement and boundary-face count
  against the reference's loops, bit for bit.
- RCB and METIS parts: identical ids on the ball (3, 2) and the adaptive
  cube (2, 4).
- The generic batch (dof_map, valid, sizes, constrained, A_agg, diag) on
  ragged RCB and METIS parts, and its float32 cast, to 1e-14;
  its eigenpairs by host syevx and by the padded batched eigh.
- The ball (3, 2) hierarchy with 2x2x2 blocks (the walk's full blocks,
  unstructured centroid grouping at level 2): level shapes, the float64
  V-cycle rate to 1e-10, float32 PCG counts equal.
- The coarse pseudoinverse of a consistent-singular matrix (the ball's
  level 2 is one) by ``torch.linalg.eigh`` against the reference's host
  eigh, to 1e-10.
- The disk Poisson problem of tests/test_ball.py through the port's
  ``cg_solve`` (max error < 5e-3), ``LaplaceProblem.ell_operator``'s card
  default; the stencil and "block_dealii" refusing the ball, and the
  identity and raw constrained modes on it against mfmg_tpu.

The ball goldens of tests/test_ball.py are held in
tests/test_torch_gauss_seidel.py and tests/test_torch_matrix_free.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge import agglomeration as jagg
from mfmg_tpu.amge import local_problems as jlp
from mfmg_tpu.fem import adaptive as jad
from mfmg_tpu.fem import ball as jball
from mfmg_tpu.fem import geometry as jgeo
from mfmg_tpu.fem import mesh as jmesh
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge import agglomeration as tagg
from mfmg_torch.amge import local_problems as tlp
from mfmg_torch.fem import adaptive as tad
from mfmg_torch.fem import ball as tball
from mfmg_torch.fem import geometry as tgeo
from mfmg_torch.fem import mesh as tmesh
from mfmg_torch.solve.cg import cg_solve

from _torch_unstructured import (RATE_TOL, compare_hierarchies, quadrant,
                                 unstructured_config)

NODE_TOL = 1e-14        # the same float64 expressions in the same order
BATCH_TOL = 1e-14       # the same scatter-adds of the same cell matrices

BALLS = {
    "2d": dict(dim=2, n_refinements=2),
    "3d": dict(dim=3, n_refinements=2),
    "3d_q2": dict(dim=3, n_refinements=1, degree=2),
    "2d_distorted": dict(dim=2, n_refinements=3, distort_random=True),
    "3d_distorted": dict(dim=3, n_refinements=2, distort_random=True, seed=3),
}


def _ball(mod, case):
    return mod.hyper_ball(**BALLS[case])


def _assert_same_mesh(t, j):
    assert t.dim == j.dim and t.degree == j.degree
    assert t.structured_shape is None and j.structured_shape is None
    np.testing.assert_array_equal(t.cells, j.cells)
    assert t.cells.dtype == j.cells.dtype
    np.testing.assert_array_equal(t.boundary_dofs, j.boundary_dofs)
    np.testing.assert_allclose(t.nodes, j.nodes, rtol=0, atol=NODE_TOL)


@pytest.mark.parametrize("case", list(BALLS))
def test_hyper_ball_matches_the_reference(case):
    t, j = _ball(tmesh, case), _ball(jmesh, case)
    _assert_same_mesh(t, j)
    assert t.hanging is None
    np.testing.assert_array_equal(t.constrained_mask, j.constrained_mask)


@pytest.mark.parametrize("dim", [2, 3])
def test_ball_complex_and_refinement_match_the_reference(dim):
    tv, tc = tball.hyper_ball_base(dim, 1.5)
    jv, jc = jball.hyper_ball_base(dim, 1.5)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    assert tball._cell_faces(dim) == jball._cell_faces(dim)
    for _ in range(2):
        tv, tc = tball.refine_ball(tv, tc, 1.5)
        jv, jc = jball.refine_ball(jv, jc, 1.5)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=NODE_TOL)
    np.testing.assert_array_equal(tc, jc)
    r = np.linalg.norm(tv, axis=1)
    assert np.allclose(r[jball.boundary_vertex_mask(tv, tc)], 1.5, atol=1e-12)


@pytest.mark.parametrize("dim,steps", [(2, 4), (3, 3)])
def test_refine_ball_steps_match_the_reference(dim, steps):
    """Each refinement step of the vectorized walk against the reference's
    loop, from the same complex: the same vertex numbering, cell table and
    coordinates bit for bit."""
    v, c = tball.hyper_ball_base(dim, 1.3)
    for _ in range(steps):
        vv, cv = tball.refine_ball(v, c, 1.3)
        v, c = jball.refine_ball(v, c, 1.3)
        assert cv.dtype == c.dtype == np.int64
        np.testing.assert_array_equal(cv, c)
        np.testing.assert_array_equal(vv, v)


@pytest.mark.parametrize("case", ["3d", "3d_q2", "2d_distorted"])
def test_curved_geometry_and_load_match_the_reference(case):
    t, j = _ball(tmesh, case), _ball(jmesh, case)
    tg, jg = tgeo.compute_geometry(t), jgeo.compute_geometry(j)
    assert tg.G_shared is None and jg.G_shared is None
    for name in ("G", "JxW", "qpoints_phys"):
        np.testing.assert_allclose(getattr(tg, name), getattr(jg, name),
                                   rtol=0, atol=NODE_TOL * 10)
    assert np.all(tg.JxW > 0)

    def f(p):
        return 1.0 + p[..., 0] * p[..., -1]

    np.testing.assert_allclose(
        tgeo.local_mass_rhs(t, tg, f(tg.qpoints_phys)),
        jgeo.local_mass_rhs(j, jg, f(jg.qpoints_phys)), rtol=0, atol=NODE_TOL)


@pytest.mark.parametrize("case", ["ball", "adaptive"])
def test_boundary_faces_match_the_reference(case):
    """from_cell_complex's face count against the reference's loop, through
    the boundary dofs of both packages' meshes of one complex: the ball's,
    and an adaptive complex whose hanging interfaces are interior although
    one cell holds them."""
    if case == "ball":
        v, c = tball.hyper_ball_base(3)
        for _ in range(2):
            v, c = tball.refine_ball(v, c, 1.0)
        interior = None
    else:
        m = tmesh.hyper_cube(3, 2)
        v, c, _, interior = tad.refine_adaptive(
            m.nodes, m.cells, quadrant(m.nodes[m.cells].mean(axis=1)))
    assert len(tmesh.boundary_faces(c, interior)[0]) > 0
    for degree in (1, 2):
        t = tmesh.from_cell_complex(v, c, degree, interior_faces=interior)
        j = jmesh.from_cell_complex(v, c, degree, interior_faces=interior)
        np.testing.assert_array_equal(t.boundary_dofs, j.boundary_dofs)
        np.testing.assert_array_equal(t.cells, j.cells)


def _face_meshes(case):
    if case == "adaptive":
        return (tad.adaptive_cube(3, 2, quadrant),
                jad.adaptive_cube(3, 2, quadrant))
    return _ball(tmesh, case), _ball(jmesh, case)


@pytest.mark.parametrize("case", ["3d", "3d_distorted", "3d_q2", "2d",
                                  "adaptive"])
def test_face_neighbors_and_walk_match_the_reference(case):
    t, j = _face_meshes(case)
    nb = tagg.face_neighbors(t)
    np.testing.assert_array_equal(nb, jagg.face_neighbors(j))
    for block in ((2, 2, 2), (4, 4, 4), (3, 2, 1)):
        bd = block[:t.dim]
        t_ids = tagg.build_agglomerates_block(t, bd)
        np.testing.assert_array_equal(t_ids, jagg.build_agglomerates_block(j, bd))
        assert t_ids.dtype == np.int64 and t_ids.min() == 0


def test_face_in_three_cells_raises():
    """A face in more than two cells has no pairing: face_neighbors raises
    (no mesh of the package makes one)."""
    v, c = tball.hyper_ball_base(3)
    mesh = tmesh.from_cell_complex(v, np.vstack([c, c[:1]]))
    with pytest.raises(ValueError, match="shared by 3 cells"):
        tagg.face_neighbors(mesh)


def test_ball_walk_gives_full_blocks():
    """tests/test_ball.py::test_ball_block_walk_produces_full_blocks through
    the port's dispatch: every refined parent cell is one agglomerate."""
    mesh = tmesh.hyper_ball(3, 2)
    agg = tagg.build_agglomerates(mesh, tcfg.AgglomerationConfig(nx=2, ny=2, nz=2))
    counts = np.bincount(agg)
    assert len(counts) == 56 and np.all(counts == 8)


def _partition_meshes(case):
    if case == "ball":
        return tmesh.hyper_ball(3, 2), jmesh.hyper_ball(3, 2)
    return tad.adaptive_cube(2, 4, quadrant), jad.adaptive_cube(2, 4, quadrant)


@pytest.mark.parametrize("partitioner", ["rcb", "zoltan", "metis"])
@pytest.mark.parametrize("case", ["ball", "adaptive"])
def test_partitioners_match_the_reference(case, partitioner):
    t, j = _partition_meshes(case)
    n_parts = 16 if partitioner == "metis" else 23
    t_ids = tagg.build_agglomerates(t, tcfg.AgglomerationConfig(
        partitioner=partitioner, n_agglomerates=n_parts))
    j_ids = jagg.build_agglomerates(j, jcfg.AgglomerationConfig(
        partitioner=partitioner, n_agglomerates=n_parts))
    np.testing.assert_array_equal(t_ids, j_ids)
    assert int(t_ids.max()) + 1 == n_parts


@pytest.mark.parametrize("partitioner", ["rcb", "metis"])
@pytest.mark.parametrize("case", ["ball", "adaptive", "cube"])
def test_generic_batch_matches_the_reference(case, partitioner):
    if case == "cube":       # a structured mesh whose parts are not blocks
        tp = TLaplace.hyper_cube(2, 3, material_property="linear")
        jp = JLaplace.hyper_cube(2, 3, material_property="linear")
    else:
        t, j = _partition_meshes(case)
        tp, jp = TLaplace.from_mesh(t, "linear"), JLaplace.from_mesh(j, "linear")
    ids = jagg.build_agglomerates(jp.mesh, jcfg.AgglomerationConfig(
        partitioner=partitioner, n_agglomerates=13))
    tb = tlp.build_agglomerate_batch(tp.mesh, tp.A_loc, ids)
    jb = jlp.build_agglomerate_batch(jp.mesh, jp.A_loc, ids)
    assert tb.sizes.min() < tb.sizes.max(), "the parts are not ragged"
    for name in ("dof_map", "valid", "sizes", "constrained"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    for name in ("A_agg", "diag"):
        np.testing.assert_allclose(getattr(tb, name), getattr(jb, name),
                                   rtol=0, atol=BATCH_TOL)
    pad = ~tb.valid
    assert np.all(tb.dof_map[pad] == -1)
    assert np.all(tb.A_agg[:, np.arange(tb.m_max), np.arange(tb.m_max)][pad] == 1.0)

    ts = tlp.build_agglomerate_batch(tp.mesh, tp.A_loc, ids,
                                     batch_dtype=np.float32)
    js = jlp.build_agglomerate_batch(jp.mesh, jp.A_loc, ids,
                                     batch_dtype=np.float32)
    assert ts.A_agg.dtype == js.A_agg.dtype == np.float32
    np.testing.assert_array_equal(ts.A_agg, js.A_agg)
    np.testing.assert_array_equal(ts.dof_map, js.dof_map)
    np.testing.assert_array_equal(ts.diag, js.diag)


@pytest.mark.parametrize("use_device", [False, True], ids=["syevx", "eigh"])
def test_ragged_eigenpairs_match_the_reference(use_device):
    """The ragged METIS batch of the adaptive cube through both packages'
    eigensolvers: host syevx on each agglomerate's unpadded block, and the
    padded batch through one batched eigh (padding pinned above the
    spectrum): eigenvalues to 1e-10, each agglomerate's subspace (the
    projector V V^T) to 1e-8, zero on the padding."""
    from mfmg_tpu.eigen.batched_eigh import batched_smallest_eigenpairs as j_eig
    from mfmg_torch.eigen.batched_eigh import batched_smallest_eigenpairs as t_eig
    t, j = _partition_meshes("adaptive")
    tp, jp = TLaplace.from_mesh(t, "linear"), JLaplace.from_mesh(j, "linear")
    ids = jagg.build_agglomerates(j, jcfg.AgglomerationConfig(
        partitioner="metis", n_agglomerates=13))
    tb = tlp.build_agglomerate_batch(tp.mesh, tp.A_loc, ids)
    jb = jlp.build_agglomerate_batch(jp.mesh, jp.A_loc, ids)
    tw, tv = t_eig(tb, 2, use_device=use_device, device="cpu")
    jw, jv = j_eig(jb, 2, use_device=use_device)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-10 * np.abs(jw).max())
    assert not tv[~tb.valid].any()
    np.testing.assert_allclose(np.einsum("gik,gjk->gij", tv, tv),
                               np.einsum("gik,gjk->gij", jv, jv),
                               rtol=0, atol=1e-8)


def test_ball_hierarchy_matches_the_reference():
    compare_hierarchies(jmesh.hyper_ball(3, 2), tmesh.hyper_ball(3, 2),
                        jcfg, tcfg, block=2)


def test_coarse_pseudoinverse_by_torch_eigh():
    import scipy.sparse as sp

    from mfmg_tpu.solve.coarse import build_coarse_solver as j_coarse
    from mfmg_torch.solve.coarse import build_coarse_solver as t_coarse
    rng = np.random.default_rng(21)
    B = rng.standard_normal((300, 240))
    A = sp.csr_matrix(B @ B.T)                  # rank 240: singular
    want = np.asarray(j_coarse(A, jcfg.CoarseConfig(), dtype=jnp.float64).inv)
    got = t_coarse(A, tcfg.CoarseConfig(), dtype=torch.float64,
                   device="cpu").inv.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


def test_disk_poisson_exact_solution():
    """tests/test_ball.py::test_disk_poisson_exact_solution through the
    port: -Laplace u = 1 on the unit disk, u = (1 - r^2)/4."""
    prob = TLaplace.from_mesh(tmesh.hyper_ball(2, 3), "constant")
    jprob = JLaplace.from_mesh(jmesh.hyper_ball(2, 3), "constant")
    rhs = prob.assemble_rhs(lambda p: np.ones(p.shape[:-1]))
    np.testing.assert_allclose(
        rhs, jprob.assemble_rhs(lambda p: np.ones(p.shape[:-1])),
        rtol=0, atol=1e-15)
    x, info = cg_solve(prob.ell_operator(device="cpu"), torch.from_numpy(rhs),
                       tol=1e-12, maxiter=2000)
    r2 = (prob.mesh.nodes ** 2).sum(1)
    err = np.abs(x.numpy() - (1.0 - r2) / 4.0).max()
    assert err < 5e-3, err
    exact = prob.l2_error(x.numpy(), lambda p: (1.0 - (p ** 2).sum(-1)) / 4.0)
    assert exact == pytest.approx(jprob.l2_error(
        x.numpy(), lambda p: (1.0 - (p ** 2).sum(-1)) / 4.0), rel=1e-12)


def test_ell_operator_defaults_to_the_card():
    prob = TLaplace.from_mesh(tmesh.hyper_ball(2, 2), "linear")
    jprob = JLaplace.from_mesh(jmesh.hyper_ball(2, 2), "linear")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            prob.ell_operator()
    op = prob.ell_operator(device="cpu")
    assert op.vals.device.type == "cpu" and op.vals.dtype == torch.float64
    j = jprob.ell_operator(dtype=jnp.float64)
    np.testing.assert_array_equal(op.cols.numpy(), np.asarray(j.cols))
    np.testing.assert_array_equal(op.vals.numpy(), np.asarray(j.vals))


def test_unsupported_configurations_raise_naming_their_reason():
    """The stencil and "block_dealii" (deal.II's cell order) refuse the ball
    with the reference's ValueError; the identity and raw constrained
    modes build on it and give mfmg_tpu's V-cycle rate."""
    prob = TLaplace.from_mesh(tmesh.hyper_ball(3, 1), "linear")
    with pytest.raises(ValueError, match="structured mesh"):
        THierarchy(prob, tcfg.Config(operator="stencil"), device="cpu")
    cfg = unstructured_config(tcfg, "float64")
    cfg.agglomeration.partitioner = "block_dealii"
    with pytest.raises(ValueError, match="structured hyper_cube meshes only"):
        THierarchy(prob, cfg, device="cpu")
    with pytest.raises(ValueError, match="structured hyper_cube meshes only"):
        tagg.build_agglomerates(prob.mesh, cfg.agglomeration)
    from mfmg_tpu import Hierarchy as JHierarchy
    from mfmg_tpu.amge.hierarchy import measure_vcycle_rate as j_rate
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate as t_rate
    jprob = JLaplace.from_mesh(jmesh.hyper_ball(3, 1), "linear")
    for mode in ("identity", "raw"):
        cfgs = [unstructured_config(c, "float64", max_levels=2) for c in (tcfg, jcfg)]
        for c in cfgs:
            c.eigensolver.constrained_mode = mode
        th = THierarchy(prob, cfgs[0], device="cpu")
        assert th._constrained_mode() == mode and th.setup_route == "host"
        t, j = t_rate(th), j_rate(JHierarchy(jprob, cfgs[1]))
        assert abs(t - j) <= RATE_TOL, (mode, t, j)
