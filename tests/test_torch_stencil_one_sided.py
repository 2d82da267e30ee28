"""Kernel K3 (the one-sided stencil apply) and the z-tiled TPU kernels it
and K2 cover, against mfmg_tpu on the CPU.

The same operators go through K3's plain version (the port's wrapper on a
CPU tensor) and through mfmg_tpu's Pallas kernels in interpret mode:
pallas_stencil_apply (resident) for Q1 operators read from the assembled
matrix (one-sided), Q2 (125 offsets) and Q3 (343 offsets) operators from the
cell matrices, and pallas_stencil_apply_tiled (z-tiled, ragged last tile)
for Q1.  cheb_smooth_plain (K2's plain version) is held against the z-tiled
pallas_cheb_smooth_tiled at 1-3 tiles and degrees 1 and 2; at degree 3 the
tiled TPU kernel does not trace (test_cheb_tiled_degree_3_fails_in_reference),
and K2's plain version is held to the resident pallas_cheb_smooth there
(tests/test_torch_smoothers.py).

Tolerances: float64 planes and x 1e-12 ||y||_inf (only the summation order
differs); bf16 or float32 planes with float32 x 1e-6 ||y||_inf (both
accumulate in float32 on the same planes); the Chebyshev step 1e-5 relative on x and
1e-4 on the residual, the bounds tests/test_pallas.py holds the tiled kernel
to against the plain smoother (float32, chained applies).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mfmg_tpu.fem.laplace import LaplaceProblem as JLaplace
from mfmg_tpu.ops import stencil as jst
from mfmg_tpu.ops.fused_cycle import _cheb_coeffs
from mfmg_tpu.ops.pallas_stencil import (cheb_tiled_geom, cheb_tiled_supported,
                                         pad_planes_cheb, pad_vec_cheb,
                                         pad_vec_cheb_host,
                                         pallas_cheb_smooth_tiled,
                                         pallas_stencil_apply,
                                         pallas_stencil_apply_tiled,
                                         unpad_vec_cheb)
from _torch_stencils import symmetrize
from mfmg_tpu.solve import smoothers as jsm
from mfmg_torch.fem.laplace import LaplaceProblem as TLaplace
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import stencil as tst
from mfmg_torch.ops import stencil_kernels as tk

CASES = {
    # name: (degree, n_ref, from the assembled matrix)
    "Q1-csr-5^3": (1, 2, True),
    "Q1-csr-9^3": (1, 3, True),
    "Q2-9^3": (2, 2, False),
    "Q2-17^3": (2, 3, False),
    "Q3-13^3": (3, 2, False),
}


def _jax_op(name, dtype=jnp.float64):
    degree, n_ref, csr = CASES[name]
    jp = JLaplace.hyper_cube(3, n_ref, degree=degree, material_property="linear")
    if csr:
        return jp, jst.stencil_from_csr(jp.A, jp.mesh, dtype=dtype)
    return jp, jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                              jp.diag_raw, dtype=dtype)


def _x(n, seed, dtype=np.float64):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=n).astype(dtype)


def _port_op(coeffs: np.ndarray, J):
    """The port's finalized one-sided operator on the reference's planes."""
    if coeffs.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(coeffs.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(coeffs))
    return tst.stencil_to_device(
        tst.StencilOperator(t, J.offsets, J.grid_shape, None), "cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_k3_plain_matches_pallas_apply_f64(name):
    """Row 8 (pallas_stencil_apply, resident): float64, 1e-12."""
    jp, J = _jax_op(name)
    degree = CASES[name][0]
    assert len(J.offsets) == (2 * degree + 1) ** 3
    x = _x(jp.n_dofs, 0)
    y_pal = np.asarray(pallas_stencil_apply(J.coeffs, jnp.asarray(x), J.offsets,
                                            J.grid_shape))
    T = _port_op(np.asarray(J.coeffs), J)
    assert T.planes is None and T.coeffs.is_contiguous()
    y = tst.stencil_apply(T, torch.from_numpy(x)).numpy()
    scale = np.abs(y_pal).max()
    assert np.abs(y - y_pal).max() <= 1e-12 * scale
    assert np.abs(y - jp.A @ x).max() <= 1e-12 * scale


@pytest.mark.parametrize("name", [n for n in CASES if not n.startswith("Q3")])
def test_k3_bf16_planes_match_pallas_apply(name):
    """Row 8 with bf16 planes and float32 x, the preconditioner's operator:
    the K3 wrapper on CPU tensors against the Pallas kernel on the same
    rounded planes, 1e-6."""
    jp, J = _jax_op(name)
    c16 = np.asarray(J.coeffs).astype(ml_dtypes.bfloat16)
    x = _x(jp.n_dofs, 1, np.float32)
    y_pal = np.asarray(pallas_stencil_apply(jnp.asarray(c16), jnp.asarray(x),
                                            J.offsets, J.grid_shape))
    T = _port_op(c16, J)
    assert T.coeffs.dtype == torch.bfloat16
    y = tst.stencil_apply(T, torch.from_numpy(x)).numpy()
    assert np.abs(y - y_pal).max() <= 1e-6 * np.abs(y_pal).max()


@pytest.mark.parametrize("degree,n_ref,one_sided",
                         [(2, 2, False), (2, 3, True), (3, 2, False)],
                         ids=["Q2-9^3", "Q2-17^3", "Q3-13^3"])
def test_port_extracts_the_same_one_sided_stencil(degree, n_ref, one_sided):
    """The port's extraction from the cell matrices at Q2/Q3 gives the
    reference's offsets and planes (1e-13) and the same symmetry verdict.
    The verdict is the host BLAS's: here the Q2 17^3 cell matrices come out
    bit-asymmetric, so both find no symmetric-pair form; then K3 carries
    every fine apply."""
    jp = JLaplace.hyper_cube(3, n_ref, degree=degree, material_property="linear")
    tp = TLaplace.hyper_cube(3, n_ref, degree=degree, material_property="linear")
    J = jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.float64)
    T = tst.stencil_from_cell_matrices(tp.mesh, tp.A_loc, tp.constrained,
                                       tp.diag_raw, dtype=torch.float64)
    assert T.sym_pos == J.sym_pos
    assert (T.sym_pos is None) == one_sided
    assert T.offsets == J.offsets and T.grid_shape == J.grid_shape
    Jc = np.asarray(J.coeffs)
    np.testing.assert_allclose(T.coeffs.numpy(), Jc, rtol=0,
                               atol=1e-13 * np.abs(Jc).max())
    x = _x(tp.n_dofs, 2)
    y = tst.stencil_apply(tst.stencil_to_device(T, "cpu"),
                          torch.from_numpy(x)).numpy()
    ref = tp.A @ x
    assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("bz", [8, 16])
@pytest.mark.parametrize("dtype", ["f64", "bf16", "f32"])
def test_k3_plain_matches_tiled(bz, dtype):
    """Row 9 (pallas_stencil_apply_tiled, the one-sided apply over z-tiles,
    bz 8 and 16 on the 17^3 grid with its ragged last tile), as
    tests/test_pallas.py runs it: K3's plain version on the same planes;
    float64 1e-12; bf16 planes (the preconditioner's) and float32 planes
    (the outer CG's) with float32 x 1e-6."""
    jp = JLaplace.hyper_cube(3, 4, material_property="linear")
    J = jst.stencil_from_csr(jp.A, jp.mesh, dtype=jnp.float64)
    assert J.grid_shape[0] % bz != 0
    c = np.asarray(J.coeffs)
    if dtype in ("bf16", "f32"):
        c = c.astype(ml_dtypes.bfloat16 if dtype == "bf16" else np.float32)
        x, tol = _x(jp.n_dofs, 3, np.float32), 1e-6
    else:
        x, tol = _x(jp.n_dofs, 3), 1e-12
    y_pal = np.asarray(pallas_stencil_apply_tiled(jnp.asarray(c), jnp.asarray(x),
                                                  J.offsets, J.grid_shape, bz))
    y = tst.stencil_apply(_port_op(c, J), torch.from_numpy(x)).numpy()
    assert np.abs(y - y_pal).max() <= tol * np.abs(y_pal).max()


@pytest.mark.parametrize("degree,n_tiles,want_res",
                         [(2, 1, True), (2, 1, False), (2, 2, True),
                          (2, 2, False), (2, 3, True), (2, 3, False),
                          (1, 2, True)])
def test_cheb_plain_matches_tiled(degree, n_tiles, want_res):
    """Row 10 (pallas_cheb_smooth_tiled, the whole Chebyshev step over
    z-tiles with chained halo applies), as tests/test_pallas.py runs it on
    the 17^3 Q1 operator: K2's plain version on the gathered center +
    positive planes, x 1e-5 and residual 1e-4 relative."""
    _cheb_tiled_case(degree, n_tiles, want_res)


@pytest.mark.parametrize("n_tiles", [1, 2])
def test_cheb_tiled_degree_3_fails_in_reference(n_tiles):
    """cheb_tiled_supported admits degree 3, but the tiled TPU kernel
    does not trace there (its chained margins give mismatched shapes), so
    row 10 is held at degrees 1 and 2; a reference that traces at degree 3
    fails this test, and the parity case above then takes degree 3."""
    with pytest.raises(TypeError, match="incompatible shapes"):
        _cheb_tiled_case(3, n_tiles, False)


def _cheb_tiled_case(degree, n_tiles, want_res):
    jp = JLaplace.hyper_cube(3, 4, material_property="linear")
    tp = TLaplace.hyper_cube(3, 4, material_property="linear")
    J = jst.stencil_from_cell_matrices(jp.mesh, jp.A_loc, jp.constrained,
                                       jp.diag_raw, dtype=jnp.float32)
    T = tst.stencil_to_device(tst.stencil_from_cell_matrices(
        tp.mesh, tp.A_loc, tp.constrained, tp.diag_raw, dtype=torch.float32),
        "cpu")
    assert cheb_tiled_supported(J.grid_shape, J.offsets, J.sym_pos, degree)
    assert T.pos_offsets == tuple(J.offsets[i] for i in J.sym_pos)
    bz = cheb_tiled_geom(J.grid_shape, n_tiles)[0]
    assert (n_tiles - 1) * bz < J.grid_shape[0] <= n_tiles * bz
    diag = jp.A.diagonal().astype(np.float32)
    inv_diag = np.where(diag != 0, 1.0 / diag, 0.0).astype(np.float32)
    alphas, betas = _cheb_coeffs(1.1, 0.9, degree)
    coef = np.asarray(alphas + betas, np.float32)
    rng = np.random.default_rng(7)
    x = rng.uniform(size=jp.n_dofs).astype(np.float32)
    b = rng.uniform(size=jp.n_dofs).astype(np.float32)

    cpt = pad_planes_cheb(np.asarray(J.coeffs), J.offsets, J.grid_shape,
                          J.sym_pos, n_tiles=n_tiles)
    outs = pallas_cheb_smooth_tiled(
        cpt, pad_vec_cheb(jnp.asarray(x), J.grid_shape, n_tiles),
        pad_vec_cheb(jnp.asarray(b), J.grid_shape, n_tiles),
        pad_vec_cheb_host(inv_diag, J.grid_shape, n_tiles), jnp.asarray(coef),
        J.offsets, J.grid_shape, J.sym_pos, degree, want_res=want_res,
        n_tiles=n_tiles)
    got = tk.cheb_smooth_plain(T.planes, torch.from_numpy(x), torch.from_numpy(b),
                               torch.from_numpy(inv_diag), torch.from_numpy(coef),
                               T.pos_offsets, T.grid_shape, degree, want_res)
    x_ref = np.asarray(unpad_vec_cheb(outs[0], J.grid_shape))
    assert np.linalg.norm(got[0].numpy() - x_ref) <= 1e-5 * np.linalg.norm(x_ref)
    if want_res:
        r_ref = np.asarray(unpad_vec_cheb(outs[1], J.grid_shape))
        assert np.linalg.norm(got[1].numpy() - r_ref) <= \
            1e-4 * np.linalg.norm(r_ref)


def test_k3_wrapper_rejects_bad_inputs():
    """dtype, shape, contiguity, offset count and radius are checked before
    anything runs."""
    jp, J = _jax_op("Q2-9^3", jnp.float32)
    planes = torch.from_numpy(np.array(J.coeffs))
    x = torch.from_numpy(_x(jp.n_dofs, 4, np.float32))
    args = (J.offsets, J.grid_shape)
    with pytest.raises(ValueError):
        tk.stencil_apply(planes, x.double(), *args)
    with pytest.raises(ValueError):
        tk.stencil_apply(planes[1:], x, *args)
    with pytest.raises(ValueError):
        tk.stencil_apply(planes.double(), x, *args)
    with pytest.raises(ValueError):
        tk.stencil_apply(planes, x[:-1], *args)
    with pytest.raises(ValueError):
        tk.stencil_apply(planes.transpose(1, 2), x, *args)
    far = ((4, 0, 0),) + tuple(J.offsets[1:])
    with pytest.raises(ValueError):
        tk.stencil_apply(planes, x, far, J.grid_shape)
    assert cl.LAUNCHES["stencil_apply"] == 0


# A symmetric Q3 stencil through K1's float32 path: the K1 wrapper's plain
# version sums the 171 pairs, the reference its 343 one-sided planes in
# another order.  The terms' absolute sum is up to 2.1 ||y||_inf here, so
# 343 float32 roundings (6e-8 each) give at worst 4e-5 ||y||_inf and as a
# random walk ~3e-6; observed 3.9e-7.
SYM_Q3_F32_TOL = 2e-5


def _symmetric_q3(np_dtype):
    """The Q3-13^3 operator symmetrized (C_{-o}[i] := C_o[i - o]) in both
    packages, on the same numpy planes: (jp, reference op, port op)."""
    jp, J = _jax_op("Q3-13^3")
    c = symmetrize(np.asarray(J.coeffs), J.offsets, J.grid_shape).astype(np_dtype)
    pos = jst.detect_symmetry(c, J.offsets, J.grid_shape)
    assert pos is not None and len(pos) == 171
    Js = jst.StencilOperator(jnp.asarray(c), J.offsets, J.grid_shape, pos)
    T = tst.StencilOperator(torch.from_numpy(c), J.offsets, J.grid_shape,
                            tst.detect_symmetry(c, J.offsets, J.grid_shape))
    T = tst.stencil_to_device(T, "cpu")
    assert T.sym_pos == pos and T.planes.shape[0] == 1 + 171
    return jp, Js, T


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_symmetric_q3_applies_with_171_pairs(dtype):
    """The 171 positive planes of a symmetric Q3 stencil (radius 3) apply
    through the port's dispatch: float32 x reaches the K1 wrapper (its CPU
    branch, which refused more than 62 pairs before), float64 x the plain
    version; both against mfmg_tpu's stencil_apply on the same planes,
    1e-12 ||y||_inf in float64, SYM_Q3_F32_TOL in float32."""
    np_dt = np.float64 if dtype == "f64" else np.float32
    jp, Js, T = _symmetric_q3(np_dt)
    x = _x(jp.n_dofs, 6, np_dt)
    y_ref = np.asarray(jst.stencil_apply(Js, jnp.asarray(x)))
    y = tst.stencil_apply(T, torch.from_numpy(x)).numpy()
    tol = 1e-12 if dtype == "f64" else SYM_Q3_F32_TOL
    assert np.abs(y - y_ref).max() <= tol * np.abs(y_ref).max()
    assert cl.LAUNCHES["stencil_apply_sym"] == 0


@pytest.mark.parametrize("want_res", [False, True], ids=["no-res", "res"])
def test_symmetric_q3_chebyshev_step(want_res):
    """One degree-2 Chebyshev step with 171 pairs: the K2 wrapper (its
    plain version on CPU tensors) against mfmg_tpu's ChebyshevSmoother on
    the same float32 planes, x 1e-5 and the residual 1e-4 relative (the
    bounds of tests/test_torch_smoothers.py)."""
    jp, Js, T = _symmetric_q3(np.float32)
    inv_diag = (1.0 / T.planes[0].reshape(-1)).contiguous()
    theta, delta = 1.1, 0.9
    alphas, betas = _cheb_coeffs(theta, delta, 2)
    coef = torch.tensor(list(alphas) + list(betas), dtype=torch.float32)
    rng = np.random.default_rng(8)
    x, b = (rng.uniform(size=jp.n_dofs).astype(np.float32) for _ in range(2))
    sm = jsm.ChebyshevSmoother(inv_diag=jnp.asarray(inv_diag.numpy()),
                               theta=jnp.float32(theta), delta=jnp.float32(delta),
                               degree=2)
    xj = sm.apply(Js, jnp.asarray(b), jnp.asarray(x))
    rj = np.asarray(jst.stencil_apply(Js, xj) - jnp.asarray(b))
    got = tk.cheb_smooth(T.planes, torch.from_numpy(x), torch.from_numpy(b),
                         inv_diag, coef, T.pos_offsets, T.grid_shape, 2, want_res)
    xj = np.asarray(xj)
    assert np.linalg.norm(got[0].numpy() - xj) <= 1e-5 * np.linalg.norm(xj)
    if want_res:
        assert np.linalg.norm(got[1].numpy() - rj) <= 1e-4 * np.linalg.norm(rj)
