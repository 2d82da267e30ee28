"""Both packages' hierarchies through their level-0 device setup routes on
the CPU, and backend="device" where the pipeline does not apply, at 17^3
and 33^3 (the pipeline itself: tests/test_torch_device_eig.py).

The CPU has no device route (``supports`` is False there), so the tests
route both packages through their pipelines by patching, in the test only:
the port's ``device_eig.supports`` answers for a CUDA device and its probe
block is the reference's (``_torch_carry.jax_probe``); the reference's
``supports`` answers True, its pipeline runs with x64 off (its
accelerator's types; under x64 its hierarchy would fall back to the host
without a word) and MFMG_DEVICE_GALERKIN makes it form the Galerkin blocks
against the kept batch.  Each eigenvector's sign is its eigensolver's
choice, so coarse operators are compared up to basis signs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.local_problems import build_agglomerate_batch as j_batch
from mfmg_tpu.eigen import device_eig as jde
from mfmg_tpu.eigen.batched_eigh import batched_smallest_eigenpairs as j_eig
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.agglomeration import build_agglomerates
from mfmg_torch.amge.local_problems import build_agglomerate_batch
from mfmg_torch.eigen import device_eig as tde
from mfmg_torch.eigen.batched_eigh import batched_smallest_eigenpairs as t_eig
from mfmg_torch.fem.geometry import local_stiffness_matrices

from _torch_carry import jax_probe, main_path_config

N_EV = 2
# the hierarchy through both pipelines with the same probe, float32 with
# bf16 planes: A_1 and A_2 up to their basis signs to 5e-4 of their largest
# entry (read 1.3e-6 and 5.0e-7 at 17^3, 2.2e-5 and 6.5e-5 at 33^3: float32
# level-0 roundoff through the level-1 eigensolves); float64 through
# backend="device" (one batched float64 eigh in both): 1e-10 (read 4.6e-13)
PIPE_A_TOL, STEP4_A_TOL = 5e-4, 1e-10


def _jax_probe_block(n_agg, m, n_probe, device):
    return torch.from_numpy(jax_probe(n_agg, m, n_probe)).to(device)


def _rel_max(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(np.asarray(b, np.float64)).max())


def _same_up_to_signs(a, b, tol):
    """Coarse operators whose basis vectors may differ in sign (each
    eigenvector's sign is the eigensolver's choice): |A| entrywise and the
    spectrum, each to tol of its largest entry."""
    a = a.toarray().astype(np.float64)
    b = b.toarray().astype(np.float64)
    assert _rel_max(np.abs(a), np.abs(b)) <= tol
    assert _rel_max(np.linalg.eigvalsh(a), np.linalg.eigvalsh(b)) <= tol



def _patched_to_cuda(monkeypatch):
    """supports answers as for a CUDA device (the pipeline then runs on the
    CPU, as the route would run it on the card)."""
    orig = tde.supports
    monkeypatch.setattr(tde, "supports", lambda mesh, agg_ids, device,
                        geom=None: orig(mesh, agg_ids, "cuda", geom))


def _route_reference_through_pipeline(monkeypatch):
    """mfmg_tpu's hierarchy through its device pipeline on the CPU: supports
    patched to True, the pipeline run with x64 off (its accelerator's
    types), the Galerkin blocks against the kept batch."""
    run = jde.device_smallest_eigenpairs

    def pipeline(*args, **kwargs):
        with jax.enable_x64(False):
            return run(*args, **kwargs)

    monkeypatch.setattr(jde, "supports", lambda *a, **k: True)
    monkeypatch.setattr(jde, "device_smallest_eigenpairs", pipeline)
    monkeypatch.setenv("MFMG_DEVICE_GALERKIN", "1")


@pytest.mark.parametrize("n_ref", [4, 5], ids=["17^3", "33^3"])
def test_hierarchy_through_both_pipelines(n_ref, monkeypatch):
    """Both packages set up the float32/bf16 main path through their device
    pipelines with the same probe: A_1 and A_2 agree and PCG takes as many
    iterations."""
    _route_reference_through_pipeline(monkeypatch)
    _patched_to_cuda(monkeypatch)
    monkeypatch.setattr(tde, "probe_block", _jax_probe_block)
    jh = JHierarchy(JLaplace.hyper_cube(3, n_ref, material_property="linear"),
                    main_path_config(jcfg, "float32", "bfloat16"))
    th = THierarchy(TLaplace.hyper_cube(3, n_ref, material_property="linear"),
                    main_path_config(tcfg, "float32", "bfloat16"), device="cpu")
    assert th.setup_route == "device"
    assert jh._level0_eigendata[0].A_agg is None          # the light batch
    assert th._level0_eigendata[0].A_agg is None
    assert {"light batch L0", "device Galerkin blocks L0"} | {
        f"device eigensolve L0: {stage}" for stage in (
            "upload", "assembly", "Cholesky", "inverse iteration",
            "Rayleigh-Ritz")} <= set(th.setup_seconds)
    for level in (1, 2):
        _same_up_to_signs(th._A_per_level[level], jh._A_per_level[level],
                          PIPE_A_TOL)
    b = np.random.default_rng(0).uniform(size=th.problem.n_dofs).astype(np.float32)
    _, ti = th.solve_cg(b, tol=1e-5, maxiter=50)
    _, ji = jh.solve_cg(b, tol=1e-5, maxiter=50)
    assert ti["iterations"] == int(ji["iterations"])


def test_backend_device_takes_the_batched_eigh():
    """backend="device" where the pipeline does not apply (the CPU): one
    batched eigh of the padded, shifted, pinned batch, against the
    reference's use_device=True, float64 at 17^3 and 33^3."""
    for n_ref in (4, 5):
        tp = TLaplace.hyper_cube(3, n_ref, material_property="linear")
        jp = JLaplace.hyper_cube(3, n_ref, material_property="linear")
        ids = build_agglomerates(tp.mesh, tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
        tb = build_agglomerate_batch(tp.mesh, tp.A_loc, ids)
        jb = j_batch(jp.mesh, jp.A_loc, ids)
        tw, tv = t_eig(tb, N_EV, use_device=True, device="cpu")
        jw, jv = j_eig(jb, N_EV, use_device=True)
        assert _rel_max(tw, jw) <= 1e-10
        sign = np.sign(np.einsum("aik,aik->ak", tv, jv))
        assert float(np.abs(tv * sign[:, None, :] - jv).max()) <= 1e-8
    cfg = {m: dataclasses.replace(
        main_path_config(m, "float64"),
        eigensolver=m.EigensolverConfig(type="lapack", n_eigenvectors=2,
                                        n_eigenvectors_deep=4, backend="device"))
        for m in (tcfg, jcfg)}
    th = THierarchy(TLaplace.hyper_cube(3, 4, material_property="linear"),
                    cfg[tcfg], device="cpu")
    jh = JHierarchy(JLaplace.hyper_cube(3, 4, material_property="linear"),
                    cfg[jcfg])
    assert th.setup_route == "host" and "host eigensolve L0" in th.setup_seconds
    for level in (1, 2):
        _same_up_to_signs(th._A_per_level[level], jh._A_per_level[level],
                          STEP4_A_TOL)
    b = np.random.default_rng(1).uniform(size=th.problem.n_dofs)
    assert th.solve_cg(b, tol=1e-8)[1]["iterations"] == int(
        jh.solve_cg(b, tol=1e-8)[1]["iterations"])


def test_float64_hierarchy_keeps_the_host_route(monkeypatch):
    """The pipeline is float32 throughout: a float64 hierarchy keeps the host
    route (float64 eigenpairs and Galerkin blocks) where supports holds, and
    its coarse operators are those of the unpatched CPU setup, bit for
    bit."""
    prob = TLaplace.hyper_cube(3, 4, material_property="linear")
    ref = THierarchy(prob, main_path_config(tcfg, "float64"), device="cpu")
    _patched_to_cuda(monkeypatch)
    th = THierarchy(prob, main_path_config(tcfg, "float64"), device="cpu")
    assert th.setup_route == "host" and "host eigensolve L0" in th.setup_seconds
    for level in (1, 2):
        assert (th._A_per_level[level] != ref._A_per_level[level]).nnz == 0
    assert THierarchy(prob, main_path_config(tcfg, "float32"),
                      device="cpu").setup_route == "device"


def test_own_cell_matrices_keep_the_host_route(monkeypatch):
    """A problem built with its own local_matrix_fn (here a reaction term
    added to the Laplace form) keeps the host route, whose batch is its
    A_loc; the pipeline, which rebuilds the Laplace form from geom and
    coeff_at_q, refuses it."""
    mesh = TLaplace.hyper_cube(3, 4).mesh

    def reaction_diffusion(mesh, geom, coeff_at_q):
        A = local_stiffness_matrices(mesh, geom, coeff_at_q)
        return A + 1e-2 * np.eye(A.shape[-1])

    prob = TLaplace.from_mesh(mesh, "linear", local_matrix_fn=reaction_diffusion)
    assert not prob.laplace_form
    assert TLaplace.from_mesh(mesh, "linear").laplace_form
    _patched_to_cuda(monkeypatch)
    th = THierarchy(prob, main_path_config(tcfg, "float32", "bfloat16"),
                    device="cpu")
    assert th.setup_route == "host"
    ids = build_agglomerates(mesh, tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    light = build_agglomerate_batch(mesh, prob.A_loc, ids, batch_dtype=np.float32,
                                    assemble_operator=False)
    with pytest.raises(ValueError, match="local_matrix_fn"):
        tde.device_smallest_eigenpairs(prob, ids, light, 2, device="cpu")
