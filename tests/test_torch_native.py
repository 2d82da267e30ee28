"""The port's host library (mfmg_torch/native.py) against its numpy plain
versions and against mfmg_tpu.native, on inputs made from a numpy seed over
the agglomerate layouts of the 17^3 and 33^3 Q1 cubes.

Integer outputs match exactly; float64 outputs to 1e-12 relative to the
largest entry (the plain versions sum in another order); float32 batches
to 2 float32 ulps of the largest entry (the same float32 additions, in the
same order, through another compiler).  mfmg_tpu.native is loaded from a
build private to the process (tests/_torch_refnative.py), so that its
functions never return the None of a failed load.
"""

import os

import numpy as np
import pytest

from mfmg_tpu import native as jnative
from mfmg_torch import native
from mfmg_torch.amge import multilevel as ml
from mfmg_torch.amge.agglomeration import build_agglomerates
from mfmg_torch.amge.local_problems import (assemble_plain, block_layout,
                                            build_agglomerate_batch)
from mfmg_torch.amge.restriction import build_restriction
from mfmg_torch.config import AgglomerationConfig
from mfmg_torch.fem.laplace import LaplaceProblem
from mfmg_torch.ops import stencil as st

from _torch_refnative import reference_native  # noqa: F401,E402

pytestmark = pytest.mark.usefixtures("reference_native")

F64_TOL = 1e-12
F32_ULPS = 2 * 2.0 ** -23


@pytest.fixture(scope="module", params=[4, 5], ids=["17^3", "33^3"])
def cube(request):
    n_ref = request.param
    prob = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear")
    rng = np.random.default_rng(100 + n_ref)
    # cell matrices from the seed (random values, the cube's structure)
    A_loc = rng.standard_normal(prob.A_loc.shape)
    agg_ids = build_agglomerates(prob.mesh, AgglomerationConfig(nx=4, ny=4, nz=4))
    return prob, A_loc, agg_ids, rng


def _close(a, b, tol=F64_TOL):
    assert a.shape == b.shape and a.dtype == b.dtype
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a.astype(np.float64) - b).max()) <= tol * scale


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_assemble_agglomerate_batch(cube, dtype):
    prob, A_loc, agg_ids, _ = cube
    lay = block_layout(prob.mesh, agg_ids)
    args = (lay.cells_per_agg, lay.local_cells, A_loc, len(lay.cells_per_agg),
            lay.m)
    got = native.assemble_agglomerate_batch_uniform(*args, dtype=dtype)
    tol = F64_TOL if dtype == np.float64 else F32_ULPS
    _close(got, assemble_plain(*args, dtype=dtype), tol)
    _close(got, jnative.assemble_agglomerate_batch_uniform(*args, dtype=dtype),
           tol)


def test_stencil_scatter(cube):
    prob, A_loc, _, _ = cube
    offsets, oid_ab, _, n_nodes = st.stencil_layout(prob.mesh)
    args = (prob.mesh.cells, oid_ab, A_loc, len(offsets), n_nodes)
    got = native.stencil_scatter(*args)
    _close(got, st.stencil_scatter_plain(*args))
    _close(got, jnative.stencil_scatter(*args))


@pytest.mark.parametrize("eliminate", [False, True], ids=["valid", "keep"])
def test_agg_row_count_and_blocks(cube, eliminate):
    """A restriction with the level-0 sparsity and seeded values: the row
    counts and sorted rows exactly, the dense blocks to 1e-12."""
    prob, _, agg_ids, rng = cube
    batch = build_agglomerate_batch(prob.mesh, prob.A_loc, agg_ids,
                                    assemble_operator=False)
    evecs = rng.standard_normal((batch.n_agg, batch.m_max, 2))
    R = build_restriction(batch, evecs, prob.diag_raw, prob.n_dofs)
    dof_rows, dof_vals = ml._dof_row_structure(R)
    dm = batch.dof_map
    keep = batch.valid & ~batch.constrained if eliminate else batch.valid
    t_s = native.agg_row_count(dm, batch.valid, dof_rows)
    arows, t_s2, Rb = native.agg_row_blocks(dm, batch.valid, keep, dof_rows,
                                            dof_vals)
    p_arows, p_t_s, p_Rb = ml.agg_row_blocks_plain(dm, batch.valid, keep,
                                                   dof_rows, dof_vals,
                                                   R.shape[0])
    j_arows, j_t_s, j_Rb = jnative.agg_row_blocks(dm, batch.valid, keep,
                                                  dof_rows, dof_vals)
    for ref in (p_t_s, j_t_s, t_s2):
        np.testing.assert_array_equal(t_s, ref)
    for ref in (p_arows, j_arows):
        np.testing.assert_array_equal(arows, ref)
    _close(Rb, p_Rb)
    _close(Rb, j_Rb)
    assert np.all(Rb[~np.broadcast_to(keep[:, None, :], Rb.shape)] == 0)


@pytest.mark.parametrize("kdt", [np.float32, np.float64], ids=["K f32", "K f64"])
def test_scatter_super_blocks(cube, kdt):
    """Seeded blocks scattered into the padded per-super batches, with the
    dump slot (m1p - 1) used as padding."""
    prob, _, agg_ids, rng = cube
    n_agg = int(agg_ids.max()) + 1
    n_super, t_max = max(1, n_agg // 8), 24
    m1p = t_max * 4 + 1
    g_of = rng.integers(0, n_super, size=n_agg)
    gpos = rng.integers(0, m1p, size=(n_agg, t_max))
    K = rng.standard_normal((n_agg, t_max, t_max)).astype(kdt)
    Mb = rng.standard_normal((n_agg, t_max, t_max)).astype(np.float32)
    got = native.scatter_super_blocks(g_of, gpos, K, Mb, n_super, m1p)
    plain = ml.scatter_super_blocks_plain(g_of, gpos, K, Mb, n_super, m1p)
    ref = jnative.scatter_super_blocks(g_of, gpos, K, Mb, n_super, m1p)
    for g, p, r in zip(got, plain, ref):
        _close(g, p)
        _close(g, r)


def test_host_threads_follow_the_affinity_mask():
    n = native.host_threads()
    assert 1 <= n <= (os.cpu_count() or 1)
    if hasattr(os, "sched_getaffinity"):
        assert n == len(os.sched_getaffinity(0))


def test_build_is_keyed_stably():
    """The build's key (source, flags, -march=native's expansion) is the
    same from call to call: one build per host, reused."""
    path = native.build_host_library()
    assert path.exists() and native.build_host_library() == path


def test_failed_build_raises(tmp_path, monkeypatch):
    """No numpy fallback: a source g++ refuses raises RuntimeError."""
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" { int broken( }\n')
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.host_threads()
