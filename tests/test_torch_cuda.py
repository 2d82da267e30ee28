"""Kernels K1 and K2 on the card against their plain PyTorch versions.

Marked ``cuda``: each test takes the ``cuda`` fixture, which skips when
torch.cuda.is_available() is False (every CPU-only host).  On a machine with
an NVIDIA H100 run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py configures JAX, which that machine
does not need and may not have; this file imports no JAX.)

Tolerances: K1 1e-5 ||y||_inf (float accumulation, the kernel contracts
multiply-adds into FMAs); K2 1e-5 relative on x and 1e-4 relative on the
residual (the bounds of tests/test_pallas.py).
"""

import numpy as np
import pytest
import torch

import mfmg_torch.config as tcfg
from mfmg_torch import Hierarchy, LaplaceProblem
from mfmg_torch.ops import stencil as tst
from mfmg_torch.ops import stencil_kernels as tk
from mfmg_torch.solve.smoothers import build_smoother, fuse_chebyshev

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _op(n_ref, dtype, device):
    p = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear")
    host = tst.stencil_from_cell_matrices(p.mesh, p.A_loc, p.constrained,
                                          p.diag_raw, dtype=dtype)
    sm = build_smoother(host, tcfg.SmootherConfig(type="chebyshev", degree=2),
                        dtype=torch.float32)
    return p, tst.stencil_to_device(host, device), sm.to(device)


@pytest.mark.parametrize("n_ref", [4, 5], ids=["17^3", "33^3"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_matches_plain(cuda, n_ref, dtype):
    p, op, _ = _op(n_ref, dtype, cuda)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, p.n_dofs).astype(np.float32)).to(cuda)
    before = tk.LAUNCHES["stencil_apply_sym"]
    y = tk.stencil_apply_sym(op.planes, x, op.pos_offsets, op.grid_shape)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["stencil_apply_sym"] == before + 1
    ref = tk.stencil_apply_sym_plain(op.planes, x, op.pos_offsets, op.grid_shape)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("n_ref", [4, 5], ids=["17^3", "33^3"])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_k2_matches_plain(cuda, n_ref, degree):
    p, op, sm = _op(n_ref, torch.bfloat16, cuda)
    sm.degree = degree
    fused = fuse_chebyshev(sm, op)
    rng = np.random.default_rng(1)
    x, b = (torch.from_numpy(rng.uniform(size=p.n_dofs).astype(np.float32)).to(cuda)
            for _ in range(2))
    for want_res in (False, True):
        got = tk.cheb_smooth(op.planes, x, b, fused.inv_diag, fused.coef,
                             op.pos_offsets, op.grid_shape, degree, want_res)
        ref = tk.cheb_smooth_plain(op.planes, x, b, fused.inv_diag, fused.coef,
                                   op.pos_offsets, op.grid_shape, degree,
                                   want_res)
        torch.cuda.synchronize()
        assert float(torch.linalg.norm(got[0] - ref[0])) <= \
            1e-5 * float(torch.linalg.norm(ref[0]))
        if want_res:
            assert float(torch.linalg.norm(got[1] - ref[1])) <= \
                1e-4 * float(torch.linalg.norm(ref[1]))


def test_cuda_hierarchy_matches_cpu(cuda):
    """The main-path configuration at 17^3 on the card against the same
    hierarchy on the CPU (plain versions): same PCG iteration count, V-cycle
    within 1e-5 relative, and both kernels launched."""
    cfg = tcfg.Config(max_levels=3, operator="stencil", dtype="float32",
                      coeff_dtype="bfloat16",
                      eigensolver=tcfg.EigensolverConfig(n_eigenvectors=2,
                                                         n_eigenvectors_deep=4),
                      smoother=tcfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    hc, hg = Hierarchy(prob, cfg), Hierarchy(prob, cfg, device="cuda")
    b = np.random.default_rng(2).uniform(size=prob.n_dofs).astype(np.float32)
    tk.reset_launch_counts()
    _, ig = hg.solve_cg(b, tol=1e-5, maxiter=50)
    assert tk.LAUNCHES["stencil_apply_sym"] > 0 and tk.LAUNCHES["cheb_smooth"] > 0
    _, ic = hc.solve_cg(b, tol=1e-5, maxiter=50)
    assert ig["iterations"] == ic["iterations"]
    yc, yg = hc.vmult(b), hg.vmult(b).cpu()
    assert float(torch.linalg.norm(yg - yc)) <= 1e-5 * float(torch.linalg.norm(yc))


def test_one_sided_stencil_on_cuda_raises(cuda):
    """A non-symmetric stencil on a CUDA tensor has no kernel yet: it raises
    instead of running the plain version."""
    p = LaplaceProblem.hyper_cube(3, 2, material_property="linear")
    host = tst.stencil_from_cell_matrices(p.mesh, p.A_loc, p.constrained,
                                          p.diag_raw, dtype=torch.float32)
    one = tst.StencilOperator(host.coeffs, host.offsets, host.grid_shape,
                              None).to(cuda)
    with pytest.raises(NotImplementedError):
        one(torch.zeros(p.n_dofs, device=cuda))


def test_hierarchy_to_moves_every_level(cuda):
    """A CPU-built hierarchy moved with Hierarchy.to: every buffer on the
    card, and the V-cycle equal to the CPU one."""
    cfg = tcfg.Config(max_levels=3, operator="stencil", dtype="float32",
                      coeff_dtype="bfloat16",
                      eigensolver=tcfg.EigensolverConfig(n_eigenvectors_deep=4),
                      smoother=tcfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    h = Hierarchy(prob, cfg)
    b = np.random.default_rng(3).uniform(size=prob.n_dofs).astype(np.float32)
    yc = h.vmult(b)
    h.to(cuda)
    assert all(t.is_cuda for lv in h.levels for t in lv.buffers())
    yg = h.vmult(b).cpu()
    assert float(torch.linalg.norm(yg - yc)) <= 1e-5 * float(torch.linalg.norm(yc))
