"""The port's distributed setup (mfmg_torch/parallel/dist_setup.py and its
hooks) against the replicated setup and against mfmg_tpu on the CPU, in
float64, over gloo.

- Counterpart of tests/test_multiprocess.py / tests/_multiproc_worker.py
  in worlds of 2 and 4 spawned ranks (tests/_torch_spmd_worker.py
  ``setup_world``): ``distributed_setup=True`` at three levels with
  ``n_eigenvectors_deep=2`` builds each rank's slab (smaller than the
  batch, one index set per rank, the full batch light); R within 1e-11 and
  A_c at levels 1 and 2 within 1e-10 of the replicated setup, rates within
  1e-9 of it and within the port's bound against mfmg_tpu's rate; the
  distributed hierarchy's slab-sharded V-cycle (and (2, 2) pencils in the
  world of 4) against the replicated single-process V-cycle;
  ``distributed_eigensolve`` on each rank's super-aligned slab against the
  whole batch's eigenpairs.
- The setup hooks against mfmg_tpu's on the same inputs: ``super_partition``
  (and its refusal of more ranks than supers), ``agg_range`` in the
  structured and the generic batch, ``super_range`` and
  ``local_space="interior"`` in ``build_recursive_restriction``, and the
  stencil builder's ``raw_planes``.
- ``Config(distributed_setup=True)`` in a world of one is the ordinary
  hierarchy (tests/test_torch_ell.py).
"""

import dataclasses

import numpy as np
import pytest

import mfmg_tpu.amge.local_problems as jlp
import mfmg_tpu.amge.multilevel as jml
import mfmg_tpu.config as jcfg
import mfmg_tpu.parallel.dist_setup as jds
import mfmg_torch.amge.local_problems as tlp
import mfmg_torch.amge.multilevel as tml
import mfmg_torch.config as tcfg
import mfmg_torch.parallel.dist_setup as tds
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.hierarchy import measure_vcycle_rate as j_rate
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.agglomeration import build_agglomerates
from mfmg_torch.parallel import launch

from _torch_refnative import reference_native  # noqa: F401
from _torch_spmd_worker import setup_world

R_TOL, A_TOL, RATE_TOL = 1e-11, 1e-10, 1e-9
# the port's own hierarchy against mfmg_tpu's (tests/test_torch_deep.py)
HIERARCHY_TOL = 1e-10
SLAB_TOL = 1e-12
ASSEMBLY_TOL = 1e-12


def _config(cfg):
    return cfg.Config(operator="stencil", dtype="float64", is_preconditioner=False,
                      max_levels=3,
                      smoother=cfg.SmootherConfig(type="chebyshev", degree=2),
                      eigensolver=cfg.EigensolverConfig(n_eigenvectors=2,
                                                        n_eigenvectors_deep=2),
                      agglomeration=cfg.AgglomerationConfig(nx=2, ny=2, nz=2))


@pytest.fixture(scope="module")
def worlds():
    prob = TLaplace.hyper_cube(3, 3, material_property="linear")
    rng = np.random.default_rng(0)
    b, x0 = rng.uniform(size=prob.n_dofs), rng.uniform(size=prob.n_dofs)
    b[prob.constrained] = x0[prob.constrained] = 0.0
    cfg = dataclasses.asdict(_config(tcfg))
    return {n: launch(setup_world, n, args=(cfg, b, x0), device="cpu",
                     timeout=240)
            for n in (2, 4)}


@pytest.fixture(scope="module")
def reference_rate():
    jh = JHierarchy(JLaplace.hyper_cube(3, 3, material_property="linear"),
                    _config(jcfg))
    return j_rate(jh, n_cycles=10, seed=0)


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_setup_matches_replicated(worlds, n):
    for r in worlds[n]:
        assert r["distributed"] and r["route"] == "host"
        assert r["slab_n_agg"] < r["n_agg"] and r["n_sels"] == n and r["light"]
        assert r["R_shapes"][0] == r["R_shapes"][1]
        assert r["dR"] < R_TOL
        assert max(r["dA"]) < A_TOL, r["dA"]
        assert abs(r["rates"][0] - r["rates"][1]) < RATE_TOL
        # distributed_eigensolve: the ranks' slabs gathered, the full
        # batch's eigenpairs
        assert r["eig_gap"] < R_TOL
    # every rank built the same hierarchy
    assert len({r["rates"][1] for r in worlds[n]}) == 1


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_rate_matches_the_reference(worlds, reference_rate, n):
    assert worlds[n][0]["rates"][1] == pytest.approx(reference_rate,
                                                     rel=HIERARCHY_TOL)


@pytest.mark.parametrize("n,kind", [(2, "slab"), (4, "slab"), (4, "pencil")])
def test_distributed_hierarchy_sharded_vcycle(worlds, n, kind):
    for r in worlds[n]:
        ref = r["ref"]
        np.testing.assert_allclose(r[kind], ref, rtol=0,
                                   atol=SLAB_TOL * np.abs(ref).max())


def _supers(cfg, pkg_lp, pkg_ml, prob):
    agg = build_agglomerates(prob.mesh, cfg.agglomeration)
    return agg, pkg_ml.group_agglomerates(prob.mesh, agg,
                                          cfg.agglomeration.block_dims(3))[0]


def test_super_partition_matches_the_reference():
    prob = TLaplace.hyper_cube(3, 3, material_property="linear")
    _, sup = _supers(_config(tcfg), tlp, tml, prob)
    n_super = int(sup.max()) + 1
    for nproc in (1, 2, 3, 4, n_super):
        for pid in range(nproc):
            t, j = (m.super_partition(sup, nproc=nproc, pid=pid) for m in (tds, jds))
            np.testing.assert_array_equal(t[0], j[0])
            assert t[1] == j[1]
            np.testing.assert_array_equal(t[2], j[2])
            for a, b in zip(t[3], j[3]):
                np.testing.assert_array_equal(a, b)
    for m in (tds, jds):
        with pytest.raises(ValueError, match="needs process_count <= n_super"):
            m.super_partition(sup, nproc=n_super + 1, pid=0)


@pytest.mark.parametrize("layout", ["structured", "generic"])
def test_agg_range_batches_match_the_reference(layout):
    """A slab of agglomerates (a (lo, hi) tuple and an index array) in the
    closed-form block batch and in the generic one (block ids renumbered,
    which the closed form declines)."""
    tp = TLaplace.hyper_cube(3, 2, material_property="linear")
    jp = JLaplace.hyper_cube(3, 2, material_property="linear")
    ids = build_agglomerates(tp.mesh, tcfg.AgglomerationConfig(nx=2, ny=2, nz=2))
    if layout == "generic":
        ids = np.random.default_rng(1).permutation(int(ids.max()) + 1)[ids]
    for sel in ((2, 6), np.array([7, 0, 3])):
        t = tlp.build_agglomerate_batch(tp.mesh, tp.A_loc, ids, agg_range=sel)
        j = jlp.build_agglomerate_batch(jp.mesh, jp.A_loc, ids, agg_range=sel)
        for f in ("dof_map", "valid", "A_agg", "diag", "constrained", "sizes"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        full = tlp.build_agglomerate_batch(tp.mesh, tp.A_loc, ids)
        rows = np.arange(*sel) if isinstance(sel, tuple) else sel
        np.testing.assert_array_equal(t.A_agg, full.A_agg[rows])


def _level1_inputs():
    """The level-1 restrictor's inputs from a port-built float64 hierarchy
    (level-0 batch, blocks, R and A_c)."""
    prob = TLaplace.hyper_cube(3, 3, material_property="linear")
    cfg = dataclasses.replace(_config(tcfg), max_levels=2)
    h = THierarchy(prob, cfg, device="cpu")
    batch = h._level0_eigendata[0]
    return prob, cfg, h, batch


def _same_rows(t, j):
    """R_l of both packages, each row up to its sign (the eigensolver's)."""
    assert t.shape == j.shape
    t, j = t.toarray(), j.toarray()
    sign = np.sign(np.einsum("ij,ij->i", t, j))
    sign[sign == 0] = 1
    err = np.abs(t * sign[:, None] - j).max() / np.abs(j).max()
    assert err <= ASSEMBLY_TOL, err


@pytest.mark.usefixtures("reference_native")
def test_recursive_restriction_slab_and_interior_match_the_reference():
    """super_range (a slab of supers from its slab batch and blocks, empty
    rows kept) and local_space="interior" (owned rows, unit weights) against
    mfmg_tpu's build_recursive_restriction on the same inputs."""
    prob, cfg, h, batch = _level1_inputs()
    args = (prob.mesh, prob.A_loc, h._cell_agg, h._R_composed, h._A_per_level[1],
            prob.constrained, 2, cfg.agglomeration.block_dims(3))
    for local_space in ("overlap", "interior"):
        kw = dict(prev_batch=batch, prev_blocks=h._level0_blocks,
                  local_space=local_space)
        t = tml.build_recursive_restriction(*args, **kw)
        j = jml.build_recursive_restriction(*args, **kw)
        np.testing.assert_array_equal(t[1], j[1])
        _same_rows(t[0], j[0])
    _, sup = _supers(cfg, tlp, tml, prob)
    agg_sel, s_range, _, _ = tds.super_partition(sup, nproc=3, pid=1)
    slab = tlp.build_agglomerate_batch(prob.mesh, prob.A_loc, h._cell_agg,
                                       agg_range=agg_sel)
    dof_rows, dof_vals = tml._dof_row_structure(h._R_composed)
    blocks = tml.agg_galerkin_blocks(slab, dof_rows, dof_vals,
                                     h._R_composed.shape[0], eliminate=False)
    kw = dict(prev_batch=slab, prev_blocks=blocks, super_range=s_range)
    t = tml.build_recursive_restriction(*args, **kw)
    j = jml.build_recursive_restriction(*args, **kw)
    assert t[0].shape[0] == (s_range[1] - s_range[0]) * 2
    _same_rows(t[0], j[0])
    with pytest.raises(ValueError, match="super_range needs the matching slab batch"):
        tml.build_recursive_restriction(*args, prev_batch=batch,
                                        super_range=s_range)


def test_stencil_raw_planes_match_the_reference():
    """Planes summed from two cell ranges go through the same elimination
    as the reference's."""
    from mfmg_torch import native
    from mfmg_tpu.ops.stencil import stencil_from_cell_matrices as j_build
    from mfmg_torch.ops.stencil import stencil_from_cell_matrices as t_build
    from mfmg_torch.ops.stencil import stencil_layout
    p = TLaplace.hyper_cube(3, 2, material_property="linear")
    offsets, oid_ab, _, n_nodes = stencil_layout(p.mesh)
    half = p.mesh.n_cells // 2
    raw = sum(native.stencil_scatter(p.mesh.cells[s], oid_ab, p.A_loc[s],
                                     len(offsets), n_nodes)
              for s in (slice(0, half), slice(half, None)))
    t = t_build(p.mesh, p.A_loc, p.constrained, p.diag_raw, raw_planes=raw)
    j = j_build(p.mesh, p.A_loc, p.constrained, p.diag_raw, device=False,
                raw_planes=raw)
    assert t.offsets == tuple(tuple(o) for o in j.offsets)
    np.testing.assert_array_equal(t.coeffs.numpy(), np.asarray(j.coeffs))
    plain = t_build(p.mesh, p.A_loc, p.constrained, p.diag_raw)
    np.testing.assert_allclose(t.coeffs.numpy(), plain.coeffs.numpy(),
                               rtol=0, atol=1e-14)
