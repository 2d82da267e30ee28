"""Kernels K4/K5 (the fine windowed restriction and prolongation) against
mfmg_tpu on the CPU.

The fixture of tests/test_pallas_transfer.py (17^3 Q1 grid, 2x2x2-cell
agglomerates: 3^3 windows at stride 2 over an 8^3 agglomerate grid, two
eigenvectors, float32) supplies the weights; the port's wrappers on CPU
tensors (their plain versions) are held against mfmg_tpu's z-tiled Pallas
pair tiled_restrict / tiled_prolong in interpret mode, with float32 weights
and with bf16 weights (``reduced=True`` on the reference's side, the same
rounded weights on the port's).  A Q2 transfer (9^3 windows at stride 8) is
held against the reference's XLA chain, whose Pallas form does not tile it.

Tolerance: 1e-6 relative (2-norm).  Both sides sum exact float32 products of
the same weights and values (the port's gathers and the reference's 0/1
selections are exact, its CPU matmuls run in float32) in another order; observed 5e-8 to 1.1e-7.
Adjointness <R x, y> = <x, R^T y> to 1e-6 of ||R x|| ||y||.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfmg_tpu import Config, Hierarchy, LaplaceProblem
from mfmg_tpu.config import (AgglomerationConfig, CoarseConfig,
                             EigensolverConfig, SmootherConfig)
from mfmg_tpu.ops.pallas_transfer import (build_transfer_tiled, tiled_prolong,
                                          tiled_restrict)
from mfmg_tpu.ops.structured_transfer import (structured_prolong,
                                              structured_restrict)
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import transfer_kernels as tt
from mfmg_torch.ops.structured_transfer import StructuredTransfer

TOL = 1e-6


def _jax_transfer(n_ref, degree, block):
    prob = LaplaceProblem.hyper_cube(3, n_ref, degree=degree,
                                     material_property="linear")
    cfg = Config(operator="stencil", dtype="float32", max_levels=2,
                 eigensolver=EigensolverConfig(n_eigenvectors=2),
                 smoother=SmootherConfig(type="chebyshev", degree=2),
                 agglomeration=AgglomerationConfig(nx=block, ny=block, nz=block),
                 coarse=CoarseConfig(type="direct"))
    return prob, Hierarchy(prob, cfg).levels[0].transfer


@pytest.fixture(scope="module")
def transfer():
    """The fixture of tests/test_pallas_transfer.py."""
    return _jax_transfer(4, 1, 2)


def _port_W(tr, bf16):
    W = torch.from_numpy(np.asarray(tr.W).astype(np.float32))
    return W.to(torch.bfloat16) if bf16 else W


def _geom(tr):
    return tr.window_shape, tr.agg_shape, tr.grid_shape


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_restrict_plain_matches_tiled(transfer, bf16):
    """Row 6 (pallas_restrict_tiled)."""
    prob, tr = transfer
    ops = build_transfer_tiled(tr, reduced=bf16)
    assert ops is not None and (ops.Wr.dtype == jnp.bfloat16) == bf16
    x = np.random.default_rng(0).standard_normal(prob.n_dofs).astype(np.float32)
    ref = np.asarray(tiled_restrict(ops, jnp.asarray(x)))
    out = tt.structured_restrict(_port_W(tr, bf16), torch.from_numpy(x),
                                 *_geom(tr))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert _rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_prolong_plain_matches_tiled(transfer, bf16):
    """Row 7 (pallas_prolong_tiled)."""
    prob, tr = transfer
    ops = build_transfer_tiled(tr, reduced=bf16)
    xc = np.random.default_rng(1).standard_normal(tr.shape[0]).astype(np.float32)
    ref = np.asarray(tiled_prolong(ops, jnp.asarray(xc)))
    out = tt.structured_prolong(_port_W(tr, bf16), torch.from_numpy(xc),
                                *_geom(tr))
    assert out.shape == (prob.n_dofs,)
    assert _rel(out.numpy(), ref) <= TOL


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_prolong_is_adjoint_of_restrict(transfer, bf16):
    prob, tr = transfer
    W = _port_W(tr, bf16)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(prob.n_dofs).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(tr.shape[0]).astype(np.float32))
    rx = tt.structured_restrict(W, x, *_geom(tr))
    lhs = float(torch.dot(rx.double(), y.double()))
    rhs = float(torch.dot(x.double(),
                          tt.structured_prolong(W, y, *_geom(tr)).double()))
    assert abs(lhs - rhs) <= TOL * float(torch.linalg.norm(rx)) * \
        float(torch.linalg.norm(y))


def test_q2_windows_match_jax():
    """A Q2 transfer (8^3 Q2 cells in 4x4x4-cell agglomerates: 9^3 windows
    at stride 8 over a 2^3 agglomerate grid, the 9^3 windows of the 65^3 Q2
    main path) against the reference's XLA chain, both directions."""
    prob, tr = _jax_transfer(3, 2, 4)
    assert tr.window_shape == (9, 9, 9) and tr.agg_shape == (2, 2, 2)
    assert build_transfer_tiled(tr) is None      # no legal TPU tiling
    rng = np.random.default_rng(3)
    x = rng.standard_normal(prob.n_dofs).astype(np.float32)
    xc = rng.standard_normal(tr.shape[0]).astype(np.float32)
    W = _port_W(tr, False)
    assert _rel(tt.structured_restrict(W, torch.from_numpy(x), *_geom(tr)),
                structured_restrict(tr, jnp.asarray(x))) <= TOL
    assert _rel(tt.structured_prolong(W, torch.from_numpy(xc), *_geom(tr)),
                structured_prolong(tr, jnp.asarray(xc))) <= TOL


def test_structured_transfer_dispatch(transfer, monkeypatch):
    """A 3-D float32 StructuredTransfer goes through the K4/K5 wrappers
    (which take their plain versions on CPU tensors); float64 goes straight
    to the plain versions, as the reference runs XLA there; nothing
    launches on the CPU."""
    prob, tr = transfer
    st = StructuredTransfer(_port_W(tr, False), *_geom(tr))
    calls = []
    for name in ("structured_restrict", "structured_prolong"):
        orig = getattr(tt, name)

        def counted(*a, _orig=orig, _name=name):
            calls.append(_name)
            return _orig(*a)

        monkeypatch.setattr(tt, name, counted)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        prob.n_dofs).astype(np.float32))
    xc = st.restrict(x)
    st.prolong(xc)
    assert calls == ["structured_restrict", "structured_prolong"]
    st64 = StructuredTransfer(st.W.double(), *_geom(tr))
    y64 = st64.prolong(st64.restrict(x.double()))
    assert len(calls) == 2 and y64.dtype == torch.float64
    assert cl.LAUNCHES["structured_restrict"] == 0
    assert cl.LAUNCHES["structured_prolong"] == 0


def test_transfer_wrappers_reject_bad_inputs(transfer):
    """dtype, shape, contiguity and window geometry are checked before
    anything runs."""
    prob, tr = transfer
    W = _port_W(tr, False)
    x = torch.zeros(prob.n_dofs)
    xc = torch.zeros(tr.shape[0])
    g = _geom(tr)
    with pytest.raises(ValueError):
        tt.structured_restrict(W, x.double(), *g)
    with pytest.raises(ValueError):
        tt.structured_restrict(W, x[:-1], *g)
    with pytest.raises(ValueError):
        tt.structured_restrict(W.double(), x, *g)
    with pytest.raises(ValueError):
        tt.structured_prolong(W, torch.zeros(2 * tr.shape[0])[::2], *g)
    with pytest.raises(ValueError):
        tt.structured_prolong(W.transpose(1, 2), xc, *g)
    with pytest.raises(ValueError, match="do not tile"):
        tt.structured_prolong(W, xc, g[0], g[1], (18, 17, 17))
