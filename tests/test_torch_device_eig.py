"""The port's level-0 device pipeline (mfmg_torch/eigen/device_eig.py) on
the CPU, against mfmg_tpu's device pipeline, host syevx and the host
Galerkin blocks, at 17^3 and 33^3 (the hierarchies through it:
tests/test_torch_device_setup.py).

The reference's pipeline runs float32 throughout on its accelerator, so it
is called here with x64 off (under x64 its Gram jitter promotes to float64
and lax.triangular_solve refuses the mixed types).  Tolerances, from the
readings noted beside them:

* fed the reference's probe block, the port repeats the reference: the
  batch to 1e-6 of its largest entry (read 1.2e-9, 6e-10), the eigenvalues
  to 1e-5 of the largest (read 4.3e-7, 7.1e-7) and the eigenvectors, their
  signs aligned, to 2e-3 (read 1.3e-5, 2.6e-4: a second eigenvector picked
  inside a cluster of three within 1% turns with the float32 roundoff);
* with its own probe, against host ssyevx: eigenvalues to 1e-2 of the
  largest (read 1.2e-3, 1.7e-3, the eight-step iteration's residual); the
  pipeline's subspace inside the host's n_ev + 2 smallest eigenvectors (the
  cluster): smallest singular value of V_host^T V_dev >= 0.98 (read 0.994 at
  33^3); the smallest eigenvector itself, |v_dev . v_host| >= 0.999;
* the Galerkin blocks on the same R: rows and counts exactly, Rb exactly,
  K to 1e-5 of its largest entry (float32 products over another assembly
  of the batch).
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import mfmg_torch.config as tcfg
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.local_problems import build_agglomerate_batch as j_batch
from mfmg_tpu.eigen import device_eig as jde
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.agglomeration import build_agglomerates
from mfmg_torch.amge.local_problems import build_agglomerate_batch
from mfmg_torch.amge.multilevel import _dof_row_structure, agg_galerkin_blocks
from mfmg_torch.amge.restriction import build_restriction
from mfmg_torch.eigen import device_eig as tde
from mfmg_torch.eigen.batched_eigh import batched_smallest_eigenpairs as t_eig

from _torch_carry import jax_probe

N_EV = 2
REF_A_TOL, REF_EVAL_TOL, REF_EVEC_TOL = 1e-6, 1e-5, 2e-3
SYEVX_EVAL_TOL, CLUSTER_SV_MIN, V1_DOT_MIN = 1e-2, 0.98, 0.999
K_TOL = 1e-5


def _jax_probe_block(n_agg, m, n_probe, device):
    return torch.from_numpy(jax_probe(n_agg, m, n_probe)).to(device)


def _rel_max(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(np.asarray(b, np.float64)).max())


@pytest.fixture(scope="module", params=[4, 5], ids=["17^3", "33^3"])
def cube(request):
    n_ref = request.param
    tp = TLaplace.hyper_cube(3, n_ref, material_property="linear")
    jp = JLaplace.hyper_cube(3, n_ref, material_property="linear")
    ids = build_agglomerates(tp.mesh, tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    light = build_agglomerate_batch(tp.mesh, tp.A_loc, ids,
                                    batch_dtype=np.float32,
                                    assemble_operator=False)
    return tp, jp, ids, light


def test_light_batch_matches_reference(cube):
    tp, jp, ids, light = cube
    jl = j_batch(jp.mesh, jp.A_loc, ids, batch_dtype=np.float32,
                 assemble_operator=False)
    assert light.A_agg is None and jl.A_agg is None
    for f in ("dof_map", "valid", "diag", "constrained", "sizes"):
        np.testing.assert_array_equal(getattr(light, f), getattr(jl, f))
    full = build_agglomerate_batch(tp.mesh, tp.A_loc, ids, batch_dtype=np.float32)
    np.testing.assert_array_equal(full.diag, light.diag)


def test_pipeline_matches_reference_with_its_probe(cube, monkeypatch):
    tp, jp, ids, light = cube
    jl = j_batch(jp.mesh, jp.A_loc, ids, batch_dtype=np.float32,
                 assemble_operator=False)
    with jax.enable_x64(False):
        jw, jv, jA = jde.device_smallest_eigenpairs(jp, ids, jl, N_EV,
                                                    keep_A=True)
    monkeypatch.setattr(tde, "probe_block", _jax_probe_block)
    tw, tv, tA = tde.device_smallest_eigenpairs(tp, ids, light, N_EV,
                                                keep_A=True, device="cpu")
    assert tw.dtype == tv.dtype == np.float64 and tA.dtype == torch.float32
    assert tv.shape == np.asarray(jv).shape
    assert _rel_max(tA.numpy(), np.asarray(jA)) <= REF_A_TOL
    assert _rel_max(tw, jw) <= REF_EVAL_TOL
    sign = np.sign(np.einsum("aik,aik->ak", tv, jv))
    assert float(np.abs(tv * sign[:, None, :] - jv).max()) <= REF_EVEC_TOL
    assert np.all(tv[light.constrained] == 0)


def test_pipeline_against_host_syevx(cube):
    """The port's own probe: the eigenvalues and subspaces of host ssyevx
    on the assembled batch."""
    tp, _, ids, light = cube
    tw, tv = tde.device_smallest_eigenpairs(tp, ids, light, N_EV, device="cpu")
    full = build_agglomerate_batch(tp.mesh, tp.A_loc, ids, batch_dtype=np.float32)
    hw, hv = t_eig(full, N_EV + 2, host_dtype=np.float32)
    assert _rel_max(tw, hw[:, :N_EV]) <= SYEVX_EVAL_TOL
    sv = np.linalg.svd(np.einsum("aik,ail->akl", tv, hv), compute_uv=False)
    assert sv.min() >= CLUSTER_SV_MIN
    assert np.abs(np.einsum("ai,ai->a", tv[:, :, 0], hv[:, :, 0])).min() >= V1_DOT_MIN
    nrm = np.linalg.norm(tv, axis=1)
    np.testing.assert_allclose(nrm, 1.0, atol=1e-6)


def test_galerkin_blocks_against_host(cube):
    """device_galerkin_blocks on the kept batch against agg_galerkin_blocks
    on the assembled float32 batch, for the same R."""
    tp, _, ids, light = cube
    tw, tv, A_dev = tde.device_smallest_eigenpairs(tp, ids, light, N_EV,
                                                   keep_A=True, device="cpu")
    R = build_restriction(light, tv, tp.diag_raw, tp.n_dofs)
    dof_rows, dof_vals = _dof_row_structure(R)
    got = tde.device_galerkin_blocks(light, A_dev, dof_rows, dof_vals, R.shape[0])
    full = build_agglomerate_batch(tp.mesh, tp.A_loc, ids, batch_dtype=np.float32)
    ref = agg_galerkin_blocks(full, dof_rows, dof_vals, R.shape[0],
                              eliminate=False)
    np.testing.assert_array_equal(got.arows, ref.arows)
    np.testing.assert_array_equal(got.t_s, ref.t_s)
    np.testing.assert_array_equal(got.Rb, ref.Rb)
    assert got.K.dtype == np.float32
    assert _rel_max(got.K, ref.K) <= K_TOL


def test_supports_routes_by_structure(cube):
    tp, _, ids, light = cube
    geom = tp.geom
    assert tde.supports(tp.mesh, ids, "cuda", geom=geom)
    assert not tde.supports(tp.mesh, ids, "cpu", geom=geom)
    # a uniform-size partition that is not the block partition: two cells
    # of agglomerates 0 and 1 swapped
    swapped = ids.copy()
    c0, c1 = np.flatnonzero(ids == 0)[-1], np.flatnonzero(ids == 1)[0]
    swapped[c0], swapped[c1] = 1, 0
    assert np.all(np.bincount(swapped) == np.bincount(ids))
    assert not tde.supports(tp.mesh, swapped, "cuda", geom=geom)
    unstructured = dataclasses.replace(tp.mesh, structured_shape=None)
    assert not tde.supports(unstructured, None, "cuda")
    distorted = TLaplace.hyper_cube(3, 3, material_property="linear",
                                    distort_random=True, seed=0)
    d_ids = build_agglomerates(distorted.mesh,
                               tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    d_light = build_agglomerate_batch(distorted.mesh, distorted.A_loc, d_ids,
                                      assemble_operator=False)
    assert not tde.supports(distorted.mesh, d_ids, "cuda", geom=distorted.geom)
    with pytest.raises(ValueError, match="translation-invariant"):
        tde.device_smallest_eigenpairs(distorted, d_ids, d_light, N_EV,
                                       device="cpu")


def test_non_finite_and_failed_factorizations_raise(cube, monkeypatch):
    """No fallback: a NaN probe in one agglomerate, or a block that is not
    positive definite, raises and names the agglomerate."""
    tp, _, ids, light = cube
    bad = 3

    def nan_probe(n_agg, m, n_probe, device):
        x = torch.randn((n_agg, m, n_probe), dtype=torch.float32, device=device)
        x[bad, 0, 0] = float("nan")
        return x

    with monkeypatch.context() as mp:
        mp.setattr(tde, "probe_block", nan_probe)
        with pytest.raises(FloatingPointError, match=f"the first {bad}$"):
            tde.device_smallest_eigenpairs(tp, ids, light, N_EV, device="cpu")
    neg = copy.copy(tp)
    neg.coeff_at_q = tp.coeff_at_q.copy()
    neg.coeff_at_q[ids == 5] *= -1.0
    with pytest.raises(FloatingPointError, match="Cholesky.*the first 5$"):
        tde.device_smallest_eigenpairs(neg, ids, light, N_EV, device="cpu")


def test_eigh_batched_in_chunks(monkeypatch):
    """The batched eigh runs EIGH_BATCH matrices per call (cuSOLVER's
    batched syev refuses 32,768 on the card): a ragged split gives the
    unsplit result."""
    from mfmg_torch.eigen import batched_eigh as be
    M = torch.from_numpy(np.random.default_rng(3).standard_normal((37, 8, 8)))
    M = M @ M.mT
    w, v = torch.linalg.eigh(M)
    monkeypatch.setattr(be, "EIGH_BATCH", 10)
    wc, vc = be.eigh_batched(M)
    assert torch.equal(wc, w) and torch.equal(vc, v)
