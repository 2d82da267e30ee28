"""The mfmg_torch hierarchy end to end against mfmg_tpu on the CPU.

(a) carry-across: an mfmg_tpu float64 main-path hierarchy at 17^3 goes
    through levels_from_arrays; one V-cycle matches mfmg_tpu's vcycle to
    1e-12 and PCG takes the same number of iterations;
(b) a port-built hierarchy against an mfmg_tpu-built one at 17^3 and 33^3,
    float64: V-cycle to 1e-10, PCG iterations equal, measure_vcycle_rate to
    1e-8;
(c) the float32 + bfloat16 main-path configuration at 33^3: PCG iterations
    equal and the V-cycle within the f32 bound recorded below;
(d) ``import mfmg_torch`` does not import jax;
and the W/F recursions, a standalone cycle, and a 2-D distorted-mesh
hierarchy against mfmg_tpu.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.hierarchy import measure_vcycle_rate as j_rate
from mfmg_tpu.amge.hierarchy import vcycle as j_vcycle
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.hierarchy import levels_from_arrays
from mfmg_torch.amge.hierarchy import measure_vcycle_rate as t_rate
from mfmg_torch.amge.hierarchy import vcycle as t_vcycle
from mfmg_torch.solve.cg import cg_solve

from _torch_carry import flatten_levels, main_path_config

PCG_TOL = 1e-5          # the main path's solve tolerance (bench.py)
# f32 + bf16 V-cycle, port against reference on the same problem: both
# setups run float32 LAPACK on float32 batches that agree to roundoff, and
# the cycle runs in f32 with another summation order; the observed
# difference at 33^3 is 1.3e-7 relative (2-norm, three right-hand sides),
# the bound 1e-5 leaves two decades for other BLAS builds.
F32_VCYCLE_TOL = 1e-5


def _rhs(n, seed=0):
    return np.random.default_rng(seed).uniform(size=n)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _j_cycle(jh, b):
    return np.asarray(j_vcycle(jh.levels, jnp.asarray(b, dtype=jh.dtype),
                               jnp.zeros(len(b), dtype=jh.dtype)))


@pytest.fixture(scope="module")
def jax17():
    prob = JLaplace.hyper_cube(3, 4, material_property="linear")
    return JHierarchy(prob, main_path_config(jcfg, "float64"))


def test_carry_across_vcycle_and_pcg(jax17):
    jh = jax17
    arrays, meta = flatten_levels(jh.levels)
    levels = levels_from_arrays(arrays, meta, "cpu")
    b = _rhs(jh.problem.n_dofs)
    y_t = t_vcycle(levels, torch.from_numpy(b), torch.zeros(len(b),
                                                            dtype=torch.float64))
    assert _rel(y_t.numpy(), _j_cycle(jh, b)) <= 1e-12

    _, j_info = jh.solve_cg(b, tol=PCG_TOL, maxiter=50)

    def precond(r):
        return t_vcycle(levels, r, torch.zeros_like(r))

    _, t_info = cg_solve(levels[0].op, torch.from_numpy(b),
                         preconditioner=precond, tol=PCG_TOL, maxiter=50)
    assert t_info["iterations"] == int(j_info["iterations"])
    assert t_info["relres"] == pytest.approx(float(j_info["relres"]), rel=1e-8)

    # the W and F recursions of the same levels, and a standalone cycle from
    # a nonzero x (is_preconditioner=False)
    x0 = _rhs(len(b), 9)
    for cycle_type in ("w", "f"):
        y_t = t_vcycle(levels, torch.from_numpy(b),
                       torch.zeros(len(b), dtype=torch.float64),
                       cycle_type=cycle_type)
        y_j = j_vcycle(jh.levels, jnp.asarray(b), jnp.zeros(len(b)),
                       cycle_type=cycle_type)
        assert _rel(y_t.numpy(), y_j) <= 1e-12
    y_t = t_vcycle(levels, torch.from_numpy(b), torch.from_numpy(x0),
                   is_preconditioner=False)
    y_j = j_vcycle(jh.levels, jnp.asarray(b), jnp.asarray(x0),
                   is_preconditioner=False)
    assert _rel(y_t.numpy(), y_j) <= 1e-12


def test_2d_distorted_hierarchy_matches_jax():
    """A 2-D two-level hierarchy on a randomly distorted 33^2 mesh (general
    Jacobians, 2-D stencil and transfer paths), float64: V-cycle to 1e-10
    and equal PCG iterations."""
    def cfg(mod):
        return mod.Config(max_levels=2, operator="stencil", dtype="float64",
                          smoother=mod.SmootherConfig(type="chebyshev", degree=3),
                          agglomeration=mod.AgglomerationConfig(nx=4, ny=4))
    jh = JHierarchy(JLaplace.hyper_cube(2, 5, material_property="linear",
                                        distort_random=True, seed=3), cfg(jcfg))
    th = THierarchy(TLaplace.hyper_cube(2, 5, material_property="linear",
                                        distort_random=True, seed=3), cfg(tcfg),
                    device="cpu")
    np.testing.assert_array_equal(th.problem.mesh.nodes, jh.problem.mesh.nodes)
    b = _rhs(th.problem.n_dofs, 4)
    assert _rel(th.vmult(b).numpy(), _j_cycle(jh, b)) <= 1e-10
    _, t_info = th.solve_cg(b, tol=1e-8, maxiter=50)
    _, j_info = jh.solve_cg(b, tol=1e-8, maxiter=50)
    assert t_info["iterations"] == int(j_info["iterations"])


@pytest.fixture(scope="module", params=[4, 5], ids=["17^3", "33^3"])
def both64(request):
    n_ref = request.param
    jh = JHierarchy(JLaplace.hyper_cube(3, n_ref, material_property="linear"),
                    main_path_config(jcfg, "float64"))
    th = THierarchy(TLaplace.hyper_cube(3, n_ref, material_property="linear"),
                    main_path_config(tcfg, "float64"), device="cpu")
    return jh, th


def test_port_built_hierarchy_matches_jax(both64):
    jh, th = both64
    b = _rhs(th.problem.n_dofs, 1)
    assert _rel(th.vmult(b).numpy(), _j_cycle(jh, b)) <= 1e-10
    assert torch.equal(th.apply(b), th.vmult(b))     # is_preconditioner=True
    x_t, t_info = th.solve_cg(b, tol=PCG_TOL, maxiter=50)
    _, j_info = jh.solve_cg(b, tol=PCG_TOL, maxiter=50)
    assert t_info["iterations"] == int(j_info["iterations"])
    assert t_info["relres"] <= PCG_TOL
    true_res = np.linalg.norm(b - th.problem.A @ x_t.numpy()) / np.linalg.norm(b)
    assert true_res == pytest.approx(t_info["relres"], rel=1e-6)
    assert t_rate(th, n_cycles=10) == pytest.approx(j_rate(jh, n_cycles=10),
                                                    rel=1e-8)


def test_f32_bf16_main_path_matches_jax():
    jh = JHierarchy(JLaplace.hyper_cube(3, 5, material_property="linear"),
                    main_path_config(jcfg, "float32", "bfloat16"))
    th = THierarchy(TLaplace.hyper_cube(3, 5, material_property="linear"),
                    main_path_config(tcfg, "float32", "bfloat16"), device="cpu")
    assert th.levels[0].op.planes.dtype == torch.bfloat16
    assert th._exact_fine_op().planes.dtype == torch.float32
    b = _rhs(th.problem.n_dofs, 2).astype(np.float32)
    assert _rel(th.vmult(b).numpy(), _j_cycle(jh, b)) <= F32_VCYCLE_TOL
    x_t, t_info = th.solve_cg(b, tol=PCG_TOL, maxiter=50)
    _, j_info = jh.solve_cg(b, tol=PCG_TOL, maxiter=50)
    assert t_info["iterations"] == int(j_info["iterations"]) == 7
    assert t_info["relres"] <= PCG_TOL
    assert x_t.dtype == torch.float32 and bool(torch.isfinite(x_t).all())


def test_import_mfmg_torch_leaves_jax_out():
    code = ("import sys, mfmg_torch, mfmg_torch.amge.hierarchy, "
            "mfmg_torch.ops.stencil_kernels, mfmg_torch.driver, "
            "mfmg_torch.eigen.lanczos, mfmg_torch.eigen.lobpcg, "
            "mfmg_torch.eigen.arpack, mfmg_torch.solve.coarse, "
            "mfmg_torch.utils.serialize, mfmg_torch.utils.io, "
            "mfmg_torch.utils.info_parser, mfmg_torch.utils.timer, "
            "mfmg_torch.parallel, mfmg_torch.parallel.process, "
            "mfmg_torch.parallel.sharding, mfmg_torch.parallel.spmd, "
            "mfmg_torch.parallel.dist_setup; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('mfmg_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_without_cuda_raises():
    """device='cuda' never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    prob = TLaplace.hyper_cube(3, 2, material_property="linear")
    with pytest.raises(RuntimeError, match="CUDA"):
        THierarchy(prob, main_path_config(tcfg, "float32", "bfloat16"),
                   device="cuda")


def test_default_device_is_cuda(monkeypatch):
    """Hierarchy and levels_from_arrays default to the card: without CUDA,
    a call that names no device raises before any setup on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    prob = TLaplace.hyper_cube(3, 2, material_property="linear")
    built = []
    monkeypatch.setattr(THierarchy, "_setup", lambda self: built.append(self))
    with pytest.raises(RuntimeError, match="CUDA"):
        THierarchy(prob, main_path_config(tcfg, "float32", "bfloat16"))
    assert not built
    with pytest.raises(RuntimeError, match="CUDA"):
        levels_from_arrays({}, {"levels": []})


def test_to_cuda_without_cuda_raises():
    """Hierarchy.to('cuda') refuses as the constructor does and leaves the
    hierarchy on the CPU; .to('cpu') builds no tail (the CPU cycle stays the
    generic recursion)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    prob = TLaplace.hyper_cube(3, 4, material_property="linear")
    h = THierarchy(prob, main_path_config(tcfg, "float32", "bfloat16"),
                   device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        h.to("cuda")
    assert h.device.type == "cpu"
    assert h.to("cpu") is h and h.levels[0].fused is None
