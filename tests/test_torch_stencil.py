"""mfmg_torch stencil extraction and applies against mfmg_tpu on the CPU.

The same problems (Q1 "linear" Laplace on 9^3 and 17^3 grids) are built by
both packages; the same inputs, made with numpy from a seed, go through the
port's plain versions of kernel K1 and through mfmg_tpu's Pallas kernel
pallas_stencil_apply_sym (interpret mode on the CPU) and its XLA slice-sum;
K1's plain version also against the z-tiled pallas_stencil_apply_tiled_sym,
the fine apply of the 129^3 main path, which K1 stands for.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mfmg_tpu.fem.laplace import LaplaceProblem as JLaplace
from mfmg_tpu.ops import stencil as jst
from mfmg_tpu.ops.pallas_stencil import (pad_planes_tiled_sym,
                                         pallas_stencil_apply_sym,
                                         pallas_stencil_apply_tiled_sym,
                                         tiled_sym_geom, tiled_sym_supported)
from mfmg_torch.fem.laplace import LaplaceProblem as TLaplace
from mfmg_torch.ops import stencil as tst
from mfmg_torch.ops import stencil_kernels as tk


@pytest.fixture(scope="module", params=[3, 4], ids=["9^3", "17^3"])
def pair(request):
    n_ref = request.param
    jp = JLaplace.hyper_cube(3, n_ref, material_property="linear")
    tp = TLaplace.hyper_cube(3, n_ref, material_property="linear")
    J = jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.float64)
    T = tst.stencil_from_cell_matrices(tp.mesh, tp.A_loc, tp.constrained,
                                       tp.diag_raw, dtype=torch.float64)
    return jp, J, T


def _x(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=n).astype(dtype)


def test_stencil_from_cell_matrices_matches_jax(pair):
    """Planes to 1e-13 relative (both scatter the same cell matrices; the
    reference may sum them in another order through its native scatter)."""
    _, J, T = pair
    assert T.offsets == J.offsets
    assert T.grid_shape == J.grid_shape
    assert T.sym_pos == J.sym_pos and T.sym_pos is not None
    Jc = np.asarray(J.coeffs)
    np.testing.assert_allclose(T.coeffs.numpy(), Jc, rtol=0,
                               atol=1e-13 * np.abs(Jc).max())


def test_plain_applies_match_jax_f64(pair):
    """The port's plain symmetric-pair and one-sided applies against
    mfmg_tpu's Pallas kernel (interpret) and XLA slice-sum, float64:
    ||dy||_inf <= 1e-12 ||y||_inf (only summation order differs)."""
    jp, J, T = pair
    x = _x(jp.n_dofs, 0)
    y_pal = np.asarray(pallas_stencil_apply_sym(J.coeffs, jnp.asarray(x),
                                                J.offsets, J.grid_shape,
                                                J.sym_pos))
    y_xla = np.asarray(jst._stencil_apply_xla(J, jnp.asarray(x)))
    scale = np.abs(y_xla).max()
    planes = tst._gather_planes(T)
    y_sym = tk.stencil_apply_sym_plain(planes, torch.from_numpy(x),
                                       T.pos_offsets, T.grid_shape).numpy()
    y_one = tk.stencil_apply_plain(T.coeffs, torch.from_numpy(x), T.offsets,
                                   T.grid_shape).numpy()
    for y in (y_sym, y_one):
        assert np.abs(y - y_pal).max() <= 1e-12 * scale
        assert np.abs(y - y_xla).max() <= 1e-12 * scale
    assert np.abs(y_xla - jp.A @ x).max() <= 1e-12 * scale


def test_bf16_planes_f32_x_match_jax(pair):
    """bf16 planes with f32 x (the preconditioner operator): the port's K1
    wrapper on a CPU tensor (its plain version) against mfmg_tpu's Pallas
    kernel on the same bf16-rounded planes: 1e-6 relative (both accumulate
    in f32; only the summation order differs)."""
    jp, J, T = pair
    c16 = np.asarray(J.coeffs).astype(ml_dtypes.bfloat16)
    x = _x(jp.n_dofs, 1, np.float32)
    y_pal = np.asarray(pallas_stencil_apply_sym(
        jnp.asarray(c16), jnp.asarray(x), J.offsets, J.grid_shape, J.sym_pos))
    T16 = tst.stencil_to_device(tst.StencilOperator(
        torch.from_numpy(c16.astype(np.float32)).to(torch.bfloat16),
        T.offsets, T.grid_shape, T.sym_pos), "cpu")
    assert T16.planes.dtype == torch.bfloat16 and T16.coeffs is None
    y = tst.stencil_apply(T16, torch.from_numpy(x)).numpy()
    assert np.abs(y - y_pal).max() <= 1e-6 * np.abs(y_pal).max()


def test_stencil_apply_dispatch_cpu(pair):
    """stencil_apply on CPU tensors: a finalized symmetric operator reads
    only its gathered planes; a one-sided operator (sym_pos None) takes the
    one-sided plain version; both equal the assembled matrix."""
    jp, _, T = pair
    x = _x(jp.n_dofs, 2)
    ref = jp.A @ x
    fin = tst.stencil_to_device(tst.StencilOperator(
        T.coeffs.clone(), T.offsets, T.grid_shape, T.sym_pos), "cpu")
    assert fin.planes.shape == (1 + len(T.sym_pos),) + T.grid_shape
    one = tst.StencilOperator(T.coeffs, T.offsets, T.grid_shape, None)
    for op in (fin, one):
        y = op(torch.from_numpy(x)).numpy()
        assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()


def test_kernel_wrappers_reject_bad_inputs(pair):
    """The K1/K2 wrappers check dtype, shape, contiguity and device before
    anything runs."""
    jp, _, T = pair
    planes = tst._gather_planes(T).to(torch.float32)
    x = torch.from_numpy(_x(jp.n_dofs, 3, np.float32))
    with pytest.raises(ValueError):
        tk.stencil_apply_sym(planes, x.double(), T.pos_offsets, T.grid_shape)
    with pytest.raises(ValueError):
        tk.stencil_apply_sym(planes[1:], x, T.pos_offsets, T.grid_shape)
    with pytest.raises(ValueError):
        tk.stencil_apply_sym(planes.double(), x, T.pos_offsets, T.grid_shape)
    coef = torch.ones(4, dtype=torch.float32)
    with pytest.raises(ValueError):
        tk.cheb_smooth(planes, x, x, x, coef[:3], T.pos_offsets, T.grid_shape, 2)
    with pytest.raises(ValueError):
        tk.cheb_smooth(planes, x, x[:-1], x, coef, T.pos_offsets, T.grid_shape, 2)


@pytest.mark.parametrize("n_tiles", [2, 3])
@pytest.mark.parametrize("n_ref", [4, 5], ids=["17^3", "33^3"])
def test_k1_plain_matches_tiled_sym(n_ref, n_tiles):
    """K1's plain version against mfmg_tpu's z-tiled symmetric kernel
    (interpret mode) on grids cut into 2 and 3 z-tiles, inside its envelope
    (tiled_sym_supported), float64: ||dy||_inf <= 1e-12 ||y||_inf (only the
    summation order differs)."""
    jp = JLaplace.hyper_cube(3, n_ref, material_property="linear")
    tp = TLaplace.hyper_cube(3, n_ref, material_property="linear")
    J = jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.float64)
    T = tst.stencil_from_cell_matrices(tp.mesh, tp.A_loc, tp.constrained,
                                       tp.diag_raw, dtype=torch.float64)
    assert tiled_sym_supported(J.grid_shape, J.offsets, J.sym_pos)
    bz = tiled_sym_geom(J.grid_shape, n_tiles)[0]
    assert (n_tiles - 1) * bz < J.grid_shape[0] <= n_tiles * bz   # every tile used
    ct = pad_planes_tiled_sym(np.asarray(J.coeffs), J.offsets, J.grid_shape,
                              n_tiles=n_tiles)
    x = _x(jp.n_dofs, 4)
    y_pal = np.asarray(pallas_stencil_apply_tiled_sym(
        ct, jnp.asarray(x), J.offsets, J.grid_shape, J.sym_pos, n_tiles=n_tiles))
    y = tk.stencil_apply_sym_plain(tst._gather_planes(T), torch.from_numpy(x),
                                   T.pos_offsets, T.grid_shape).numpy()
    assert np.abs(y - y_pal).max() <= 1e-12 * np.abs(y_pal).max()
