"""The port's fused coarse tail against mfmg_tpu's fused kernels on the CPU.

An mfmg_tpu float32 main-path hierarchy at 17^3 (the oracle hierarchy of
tests/test_fused_cycle.py) is carried into the port with levels_from_arrays;
both packages build their tail from the same levels and take the same numpy
inputs.  The JAX side runs its Pallas kernels in interpret mode, the port
its plain versions (the wrappers on CPU tensors).

Tolerance: 1e-5 relative (2-norm) throughout, the bound tests/
test_fused_cycle.py holds the reference's own kernel to against its
recursion.  Both sides compute in float32 with the same operands and differ
only in summation order (matmul chains and rolls there, einsum and slice
sums here); observed differences are ~1e-7.  The two wider bounds
(BF16_ROUNDING_GAP, BF16_STORAGE_GAP) give their reasons beside them.
"""

import copy
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.hierarchy import vcycle as j_vcycle
from mfmg_tpu.ops import fused_cycle as jfc
import mfmg_torch.config as tcfg
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.hierarchy import levels_from_arrays
from mfmg_torch.amge.hierarchy import vcycle as t_vcycle
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import fused_cycle as tfc
from mfmg_torch.ops.structured_transfer import GeneralWindowTransfer

import _torch_tails as tt
from _torch_carry import flatten_levels, main_path_config

TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _built(n_ref):
    """(mfmg_tpu levels, port levels) of one float32 hierarchy."""
    prob = JLaplace.hyper_cube(3, n_ref, material_property="linear")
    jh = JHierarchy(prob, main_path_config(jcfg, "float32"))
    arrays, meta = flatten_levels(jh.levels)
    return tuple(jh.levels), levels_from_arrays(arrays, meta, "cpu")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _vec(n, seed, uniform=False):
    rng = np.random.default_rng(seed)
    v = rng.uniform(size=n) if uniform else rng.standard_normal(n)
    return v.astype(np.float32)


def _strip_rd(jl, tl):
    """Both hierarchies with the level-1 dense Rd removed: the windowed
    L1 -> L2 form, as at 129^3 (test_fused_cycle.py:67-93)."""
    jtr = dataclasses.replace(jl[1].transfer, Rd=None)
    jw = (jl[0], dataclasses.replace(jl[1], transfer=jtr), jl[2])
    tt = tl[1].transfer
    ttr = GeneralWindowTransfer(tt.W, tt.window_shape, tt.t0, tt.stride,
                                tt.in_grid, tt.out_grid, tt.n_in, tt.n_out)
    tw = [tl[0], type(tl[1])(tl[1].op, smoother=tl[1].smoother, transfer=ttr),
          tl[2]]
    return jw, tw


def test_subcycle_dense_matches_jax():
    jl, tl = _built(4)
    fj, ft = jfc.build_fused_tail(jl, 1), tfc.build_fused_tail(tl, 1)
    assert ft is not None and ft.Rd is not None and ft.W2 is None
    assert ft.fine_grid == fj.fine_grid
    b1 = _vec(tl[1].op.shape[0], 0)
    xj = jfc.fused_subcycle_apply(fj, jnp.asarray(b1))
    xt = tfc.fused_subcycle_apply(ft, torch.from_numpy(b1))
    assert _rel(xt.numpy(), xj) <= TOL


@pytest.mark.parametrize("n_ref", [4, 5], ids=["17^3", "33^3"])
def test_subcycle_windowed_matches_jax(n_ref):
    """The windowed form at 17^3 and 33^3, against the reference's windowed
    kernel and against the port's own dense form."""
    jl, tl = _built(n_ref)
    jw, tw = _strip_rd(jl, tl)
    fj, ft = jfc.build_fused_tail(jw, 1), tfc.build_fused_tail(tw, 1)
    assert fj.Rdp is None and ft.Rd is None and ft.W2 is not None
    b1 = _vec(tl[1].op.shape[0], 3)
    xj = jfc.fused_subcycle_apply(fj, jnp.asarray(b1))
    xt = tfc.fused_subcycle_apply(ft, torch.from_numpy(b1))
    assert _rel(xt.numpy(), xj) <= TOL
    xd = tfc.fused_subcycle_apply(tfc.build_fused_tail(tl, 1),
                                  torch.from_numpy(b1))
    assert _rel(xt.numpy(), xd.numpy()) <= TOL


def test_full_tail_matches_jax():
    jl, tl = _built(4)
    fj, ft = jfc.build_fused_tail(jl, 1), tfc.build_fused_tail(tl, 1)
    n = tl[0].op.shape[0]
    x, res = _vec(n, 1, uniform=True), _vec(n, 2)
    oj = jfc.fused_correction_apply(fj, jnp.asarray(x), jnp.asarray(res))
    ot = tfc.fused_correction_apply(ft, torch.from_numpy(x),
                                    torch.from_numpy(res))
    assert _rel(ot.numpy(), oj) <= TOL


def _bf16_rounded(jl):
    """The reference's levels with the weights the reduced tail stores in
    bf16 (fine W, level-1 coefficients, level-1 W and Rd) rounded to bf16
    and kept in float32."""
    def rnd(a):
        return None if a is None else jnp.asarray(a).astype(
            jnp.bfloat16).astype(jnp.float32)
    l0, l1, l2 = jl
    tr0 = dataclasses.replace(l0.transfer, W=rnd(l0.transfer.W))
    tr1 = dataclasses.replace(l1.transfer, W=rnd(l1.transfer.W),
                              Rd=rnd(l1.transfer.Rd))
    op1 = dataclasses.replace(l1.op, coeffs=rnd(l1.op.coeffs))
    return (dataclasses.replace(l0, transfer=tr0),
            dataclasses.replace(l1, op=op1, transfer=tr1), l2)


# The reference's reduced windowed tail on the CPU also rounds four of the
# correction's vectors (r1, b2, x2, the prolonged planes summed over the z
# and y windows) to bf16: its _match (fused_cycle.py:112-124) casts the data
# down where a bf16 0/1 selection matrix is the first matmul operand.  The
# port rounds at the same points, so against the reference's reduced tail
# it is held to TOL (observed 1.1e-7 to 2.7e-7 at 17^3 and 33^3: float32
# roundoff; a rounding that flips under the other summation order moves one
# value by one bf16 ulp, and perturbing b1 by 1e-7 moves the output by
# 1.5e-7, so such flips stay at roundoff level).  Against the reference's
# tail on bf16-rounded weights with float32 vectors the gap is that
# rounding itself: observed 2.4e-4 on the sub-cycle and 1.2e-4 on the full
# tail at 17^3.
BF16_ROUNDING_GAP = 1e-3


@pytest.mark.parametrize("windowed", [False, True], ids=["dense", "windowed"])
def test_reduced_storage_matches_jax(windowed):
    """bf16 weights (L1 coefficients, Rd or W2, fine W) with float32 invd,
    inv2 and Chebyshev coefficients: float32 sums on the bf16-rounded
    weights, and in the windowed form the reference's bf16 rounding of four
    correction vectors.  Held to 1e-5 against the reference's reduced
    storage, and against the reference's tail on the same rounded weights
    with float32 vectors (1e-5 dense, BF16_ROUNDING_GAP windowed)."""
    jl, tl = _built(4)
    if windowed:
        jl, tl = _strip_rd(jl, tl)
    fr = jfc.build_fused_tail(_bf16_rounded(jl), 1)
    fj = jfc.build_fused_tail(jl, 1, reduced_storage=True)
    ft = tfc.build_fused_tail(tl, 1, reduced_storage=True)
    assert ft.coeffs.dtype == torch.bfloat16 and ft.W.dtype == torch.bfloat16
    assert (ft.W2 if windowed else ft.Rd).dtype == torch.bfloat16
    assert ft.invd.dtype == ft.inv2.dtype == ft.cheb_coef.dtype == torch.float32
    fr_tol = BF16_ROUNDING_GAP if windowed else TOL
    b1 = _vec(tl[1].op.shape[0], 5)
    xt = tfc.fused_subcycle_apply(ft, torch.from_numpy(b1)).numpy()
    assert _rel(xt, jfc.fused_subcycle_apply(fr, jnp.asarray(b1))) <= fr_tol
    assert _rel(xt, jfc.fused_subcycle_apply(fj, jnp.asarray(b1))) <= TOL
    n = tl[0].op.shape[0]
    x, res = _vec(n, 6, uniform=True), _vec(n, 7)
    ot = tfc.fused_correction_apply(ft, torch.from_numpy(x),
                                    torch.from_numpy(res)).numpy()
    for fs, tol in ((fr, fr_tol), (fj, TOL)):
        oj = jfc.fused_correction_apply(fs, jnp.asarray(x), jnp.asarray(res))
        assert _rel(ot, oj) <= tol


# The card's main-path configuration (bf16 fine planes and a bf16-weight
# tail over float32 coarse levels) against the port's generic recursion on
# the same levels: the gap is the bf16 storage of the tail's weights alone
# (observed 1.56e-3 at 17^3, 1.13e-3 at 33^3).  tests/test_torch_cuda.py and
# chip_smoke.py hold the card's V-cycle to the CPU generic recursion at this
# bound.
BF16_STORAGE_GAP = 2e-3


@pytest.mark.parametrize("n_ref", [4, 5], ids=["17^3", "33^3"])
def test_bf16_tail_gap_to_generic_recursion(n_ref):
    cfg = tcfg.Config(max_levels=3, operator="stencil", dtype="float32",
                      coeff_dtype="bfloat16",
                      eigensolver=tcfg.EigensolverConfig(n_eigenvectors=2,
                                                         n_eigenvectors_deep=4),
                      smoother=tcfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=tcfg.AgglomerationConfig(nx=4, ny=4, nz=4))
    prob = TLaplace.hyper_cube(3, n_ref, material_property="linear")
    h = THierarchy(prob, cfg, device="cpu")
    b = _vec(prob.n_dofs, 2, uniform=True)
    y_generic = h.vmult(b).numpy()
    h.levels[0].fused = tfc.build_fused_tail(h.levels, 1)
    assert _rel(h.vmult(b).numpy(), y_generic) <= TOL
    h.levels[0].fused = tfc.build_fused_tail(h.levels, 1, reduced_storage=True)
    assert _rel(h.vmult(b).numpy(), y_generic) <= BF16_STORAGE_GAP


def test_fused_vcycle_matches_jax():
    """The V-cycle through the fused tail (full mode, and the sub-cycle
    branch around the fine transfer) against mfmg_tpu's vcycle with its
    tail; the wrapper is called once per cycle."""
    jl, tl = _built(4)
    fj, ft = jfc.build_fused_tail(jl, 1), tfc.build_fused_tail(tl, 1)
    jf = [dataclasses.replace(jl[0], fused=fj)] + list(jl[1:])
    n = tl[0].op.shape[0]
    b, x0 = _vec(n, 8, uniform=True), _vec(n, 9, uniform=True)
    yj = j_vcycle(jf, jnp.asarray(b), jnp.asarray(x0), n_smoothing_steps=1,
                  is_preconditioner=False)
    calls = []
    orig = tfc.fused_correction_apply_plain

    def counted(*a):
        calls.append(1)
        return orig(*a)

    tl[0].fused = ft
    try:
        tfc.fused_correction_apply_plain = counted
        yt = t_vcycle(tl, torch.from_numpy(b), torch.from_numpy(x0),
                      is_preconditioner=False)
        assert len(calls) == 1
        # the sub-cycle branch: a tail without its fine transfer
        tl[0].fused = tfc.FusedTail(
            ft.coeffs, ft.offsets, ft.grid, ft.n_comp, ft.invd, ft.cheb_coef,
            ft.degree, ft.nss, ft.inv2, Rd=ft.Rd)
        ys = t_vcycle(tl, torch.from_numpy(b), torch.from_numpy(x0),
                      is_preconditioner=False)
    finally:
        tfc.fused_correction_apply_plain = orig
        tl[0].fused = None
    assert len(calls) == 1
    assert _rel(yt.numpy(), yj) <= TOL
    assert _rel(ys.numpy(), yj) <= TOL
    assert cl.LAUNCHES["fused_tail"] == 0          # CPU tensors: plain only


def test_nss_mismatch_takes_generic_recursion():
    """A tail built for one smoothing step leaves a two-step cycle to the
    generic recursion (hierarchy.py:91-104): exactly the tail-free result,
    and the reference's two-step cycle to 1e-5."""
    jl, tl = _built(4)
    n = tl[0].op.shape[0]
    b, x0 = _vec(n, 10, uniform=True), _vec(n, 11, uniform=True)
    plain = t_vcycle(tl, torch.from_numpy(b), torch.from_numpy(x0),
                     n_smoothing_steps=2, is_preconditioner=False)
    tl[0].fused = tfc.build_fused_tail(tl, 1)
    try:
        y2 = t_vcycle(tl, torch.from_numpy(b), torch.from_numpy(x0),
                      n_smoothing_steps=2, is_preconditioner=False)
    finally:
        tl[0].fused = None
    assert torch.equal(y2, plain)
    yj = j_vcycle(jl, jnp.asarray(b), jnp.asarray(x0), n_smoothing_steps=2,
                  is_preconditioner=False)
    assert _rel(y2.numpy(), yj) <= TOL


@pytest.mark.parametrize("nss", [1, 2])
def test_two_smoothing_steps_match_jax(nss):
    """A tail built for nss smoothing steps against the reference's tail of
    the same nss (the pre-smooth loop and both post-smooths)."""
    jl, tl = _built(4)
    fj, ft = jfc.build_fused_tail(jl, nss), tfc.build_fused_tail(tl, nss)
    b1 = _vec(tl[1].op.shape[0], 12)
    xj = jfc.fused_subcycle_apply(fj, jnp.asarray(b1))
    xt = tfc.fused_subcycle_apply(ft, torch.from_numpy(b1))
    assert _rel(xt.numpy(), xj) <= TOL


def test_full_tail_gate_by_size():
    """The full-tail gate (fused_cycle.py:565-570) holds at the 65^3 main
    path's shapes (16^3 agglomerates, 5^3 windows) and fails at 129^3's
    (32^3), in float32; in float64 65^3 still fits."""
    assert tfc.full_tail_fits(2, (16,) * 3, (5,) * 3, (65,) * 3, 4)
    assert tfc.full_tail_fits(2, (16,) * 3, (5,) * 3, (65,) * 3, 8)
    assert not tfc.full_tail_fits(2, (32,) * 3, (5,) * 3, (129,) * 3, 4)


def test_build_declines_other_structures():
    """Not three levels, or a level-1 coarse solver missing: no tail."""
    _, tl = _built(4)
    assert tfc.build_fused_tail(tl[:2], 1) is None
    assert tfc.build_fused_tail([tl[0], tl[1], type(tl[2])(tl[2].op)], 1) is None


def test_wrappers_reject_bad_inputs():
    """dtype, shape, contiguity and device are checked before anything runs;
    a tail without a fine transfer refuses the full-tail call."""
    _, tl = _built(4)
    ft = tfc.build_fused_tail(tl, 1)
    n1, n = ft.n1, ft.n_fine
    b1 = torch.zeros(n1)
    with pytest.raises(ValueError):
        tfc.fused_subcycle_apply(ft, b1.double())
    with pytest.raises(ValueError):
        tfc.fused_subcycle_apply(ft, b1[:-1])
    with pytest.raises(ValueError):
        tfc.fused_subcycle_apply(ft, torch.zeros(2 * n1)[::2])
    with pytest.raises(ValueError):
        tfc.fused_correction_apply(ft, torch.zeros(n), torch.zeros(n1))
    sub = tfc.FusedTail(ft.coeffs, ft.offsets, ft.grid, ft.n_comp, ft.invd,
                        ft.cheb_coef, ft.degree, ft.nss, ft.inv2, Rd=ft.Rd)
    with pytest.raises(ValueError):
        tfc.fused_correction_apply(sub, torch.zeros(n), torch.zeros(n))


def test_reduced_windowed_tail_rounds_like_jax_at_33():
    """The windowed form with bf16 weights at 33^3, both modes: the port's
    rounding of r1, b2, x2 and the z/y-summed prolonged values against the
    reference's reduced tail to TOL (observed 2e-7 to 2.7e-7), and
    BF16_ROUNDING_GAP away from float32 vectors on the same weights."""
    jl, tl = _strip_rd(*_built(5))
    fr = jfc.build_fused_tail(_bf16_rounded(jl), 1)
    fj = jfc.build_fused_tail(jl, 1, reduced_storage=True)
    ft = tfc.build_fused_tail(tl, 1, reduced_storage=True)
    assert ft.W2.dtype == torch.bfloat16
    b1 = _vec(ft.n1, 11)
    xt = tfc.fused_subcycle_apply(ft, torch.from_numpy(b1)).numpy()
    assert _rel(xt, jfc.fused_subcycle_apply(fj, jnp.asarray(b1))) <= TOL
    assert _rel(xt, jfc.fused_subcycle_apply(fr, jnp.asarray(b1))) <= \
        BF16_ROUNDING_GAP
    x, res = _vec(ft.n_fine, 12, uniform=True), _vec(ft.n_fine, 13)
    ot = tfc.fused_correction_apply(ft, torch.from_numpy(x),
                                    torch.from_numpy(res)).numpy()
    assert _rel(ot, jfc.fused_correction_apply(fj, jnp.asarray(x),
                                               jnp.asarray(res))) <= TOL


def test_float64_hierarchy_takes_the_generic_recursion_in_both():
    """A float64 hierarchy runs the generic recursion in both packages: the
    reference builds its tail only on a TPU backend (hierarchy.py:405-406),
    the port only for float32 on CUDA (the gate is reached here by setting
    the device type without touching a card).  Their V-cycles agree to
    1e-12 at 17^3."""
    prob = JLaplace.hyper_cube(3, 4, material_property="linear")
    jh = JHierarchy(prob, main_path_config(jcfg, "float64"))
    assert jh.levels[0].fused is None
    arrays, meta = flatten_levels(jh.levels)
    tl = levels_from_arrays(arrays, meta, "cpu")
    b = np.random.default_rng(14).uniform(size=prob.n_dofs)
    yj = j_vcycle(jh.levels, jnp.asarray(b), jnp.zeros(prob.n_dofs))
    yt = t_vcycle(tl, torch.from_numpy(b), torch.zeros(prob.n_dofs,
                                                       dtype=torch.float64))
    assert _rel(yt.numpy(), yj) <= 1e-12
    th = THierarchy(TLaplace.hyper_cube(3, 4, material_property="linear"),
                    main_path_config(tcfg, "float64"), device="cpu")
    sm = th.levels[0].smoother
    th.device = torch.device("cuda")
    th._finalize_cuda_kernels()
    assert th.levels[0].fused is None and th.levels[0].smoother is sm


def test_tail_smaller_than_shared_memory_is_still_built(monkeypatch):
    """build_fused_tail gives every matching structure its tail: where an
    H100 block's shared memory (shrunk here to 520 bytes) holds neither the
    block's vectors, x2 nor the gather buffer, the plan places them in
    global scratch, and the tail is built as before."""
    _, tl = _built(4)
    ref = tfc.build_fused_tail(tl, 1, reduced_storage=True)
    # the fine window's 125 offsets (512 bytes) stay; nothing else fits
    monkeypatch.setattr(tfc, "H100_SMEM_PER_BLOCK", 520)
    tfc.tail_plan.cache_clear()
    try:
        ft = tfc.build_fused_tail(tl, 1, reduced_storage=True)
        assert ft is not None
        p = tfc.plan_of(ft)
        assert (p.stage_vecs, p.stage_x2, p.stage_vb) == (0, 0, 0)
        assert p.smem_bytes == 512
    finally:
        tfc.tail_plan.cache_clear()
    b1 = torch.from_numpy(_vec(ft.n1, 15))
    assert torch.equal(tfc.fused_subcycle_apply(ft, b1),
                       tfc.fused_subcycle_apply(ref, b1))


# ------------------------------------------- the windowed bf16 tail's check

def _hierarchy_like_tail(grid):
    """A windowed bf16 random tail whose coarse correction is a hierarchy-
    like share of its output (_torch_tails.HIERARCHY_INV2_SCALE)."""
    return tt.random_tail(grid, dense=False, inv2_scale=tt.HIERARCHY_INV2_SCALE)


def test_plain64_rounds_where_the_plain_version_rounds():
    """fused_subcycle_apply_plain64 is the plain version's arithmetic in
    float64 with the same four bf16 rounding points: equal bit for bit to
    the plain version on float64 input, unchanged by an identity
    perturbation, and moved by more than a 1e-3 of its largest output
    without those roundings (the same bf16 weights held in float64)."""
    ft = _hierarchy_like_tail((12, 12, 12))
    b1 = torch.from_numpy(_vec(ft.n1, 7))
    ref = tfc.fused_subcycle_apply_plain64(ft, b1)
    assert ref.dtype == torch.float64
    assert torch.equal(ref, tfc.fused_subcycle_apply_plain(ft, b1.double()))
    assert torch.equal(ref, tfc.fused_subcycle_apply_plain64(
        ft, b1, lambda point, v, mag: v))
    unrounded = copy.deepcopy(ft)
    unrounded.W2 = ft.W2.double()
    assert tt.rel_inf(tfc.fused_subcycle_apply_plain64(unrounded, b1), ref) > 1e-3


@pytest.mark.parametrize("grid", [(12, 12, 12), (16, 16, 16)], ids=["12^3", "16^3"])
def test_rounding_check_holds_the_float32_plain_version(grid):
    """On hierarchy-like windowed bf16 tails (coarse share >= 50%) and on
    seeds 7-11, all five, the float32 plain version lies within the check's
    limit of the float64 one, and the limit is a few bf16 ulps of the
    output, not more (ROUNDING_MARGIN x the largest reading <= 2.5e-2)."""
    ft = _hierarchy_like_tail(grid)
    for seed in (7, 8, 9, 10, 11):
        b1 = torch.from_numpy(_vec(ft.n1, seed))
        assert tt.correction_share(ft, b1) >= 0.5
        ref, limit, readings = tt.rounding_limit(ft, b1)
        assert tt.rel_inf(tfc.fused_subcycle_apply_plain(ft, b1), ref) <= limit
        assert limit <= tt.TAIL_TOL + tt.ROUNDING_MARGIN * 2.0 ** -7


def test_rounding_check_fails_on_an_indexing_error():
    """The same check refuses an output with one wrong site (the largest
    output replaced by its neighbour site's value) and one computed with the
    level-1 -> 2 windows one site off (t0 shifted by one)."""
    ft = _hierarchy_like_tail((12, 12, 12))
    b1 = torch.from_numpy(_vec(ft.n1, 7))
    ref, limit, _ = tt.rounding_limit(ft, b1)
    c = ft.n_comp
    i = int(ref.abs().argmax())
    j = i + c if i + c < ref.numel() else i - c
    wrong_site = ref.clone()
    wrong_site[i] = ref[j]
    assert tt.rel_inf(wrong_site, ref) > limit
    shifted = copy.deepcopy(ft)
    shifted.win = dict(ft.win, t0=tuple(t + 1 for t in ft.win["t0"]))
    off = tfc.fused_subcycle_apply_plain(shifted, b1)
    assert tt.rel_inf(off, ref) > limit


# ------------------------------ the windowed bf16 tail's check, full mode

def _full_tail(grid):
    """A windowed bf16 random tail with a fine transfer of 5^3 windows (the
    4 x 4 x 4 agglomerates' full mode) whose coarse correction is a
    hierarchy-like share of its sub-cycle's output."""
    return tt.random_tail(grid, dense=False, fine_window=(5, 5, 5),
                          inv2_scale=tt.HIERARCHY_INV2_SCALE)


def _full_inputs(ft, seed):
    """(x, res) as chip_smoke.py's full-mode rounding check draws them."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in
                 (rng.uniform(size=ft.n_fine), rng.standard_normal(ft.n_fine)))


def test_correction_plain64_rounds_where_the_plain_version_rounds():
    """correction_plain64 is the full mode's plain arithmetic in float64 with
    the sub-cycle's bf16 rounding points: x minus it equals the plain
    version on float64 input bit for bit, and an identity perturbation
    leaves it unchanged."""
    ft = _full_tail((12, 12, 12))
    x, res = _full_inputs(ft, 7)
    corr = tt.correction_plain64(ft, res)
    assert corr.dtype == torch.float64
    assert torch.equal(x.double() - corr, tfc.fused_correction_apply_plain(
        ft, x.double(), res.double()))
    assert torch.equal(corr, tt.correction_plain64(ft, res,
                                                   lambda point, v, mag: v))


@pytest.mark.parametrize("grid", [(12, 12, 12), (16, 16, 16)], ids=["12^3", "16^3"])
def test_full_rounding_check_holds_the_float32_plain_version(grid):
    """On seeds 7-11, all five, the float32 plain version's correction lies
    within rounding_limit_full of the float64 one, and the limit is a few
    bf16 ulps of the correction, not more (<= TAIL_TOL + 4 x 2^-7).
    Readings (CPU, both grids): the float32 gap 7.1e-7..2.8e-3 (a bf16
    rounding flips in float32 on some seeds), the draws' largest
    1.5e-4..4.2e-3, the limit 6.0e-4..1.7e-2."""
    ft = _full_tail(grid)
    for seed in (7, 8, 9, 10, 11):
        x, res = _full_inputs(ft, seed)
        ref, limit, _ = tt.rounding_limit_full(ft, x, res)
        out = tfc.fused_correction_apply_plain(ft, x, res)
        assert tt.rel_inf(tt.correction_of(x, out), ref) <= limit
        assert limit <= tt.TAIL_TOL + tt.ROUNDING_MARGIN * 2.0 ** -7


def _faulty_tails(ft):
    """The tail with one planted fault each: the level-1 -> 2 windows one
    site off (t0 shifted by one), the fine windows' weights one agglomerate
    off along x, the fine weights' components swapped."""
    shifted = copy.deepcopy(ft)
    shifted.win = dict(ft.win, t0=tuple(t + 1 for t in ft.win["t0"]))
    rolled = copy.deepcopy(ft)
    rolled.W = torch.roll(ft.W, 1, dims=-1)
    swapped = copy.deepcopy(ft)
    swapped.W = ft.W.flip(0)
    return {"window t0 + 1": shifted, "fine W rolled": rolled,
            "fine W components swapped": swapped}


def test_full_rounding_check_fails_on_indexing_errors():
    """rounding_limit_full refuses, on every seed 7-11, a correction with one
    wrong site (its largest entry replaced by its neighbour's), and the full
    outputs of a tail with a planted fault (_faulty_tails).  Readings (CPU,
    12^3): the wrong site 0.34-0.77, the faulty tails 0.59-1.09, against
    limits of 6.0e-4..9.8e-3; x is 0.14-0.17 of the correction's size."""
    ft = _full_tail((12, 12, 12))
    faulty = _faulty_tails(ft)
    for seed in (7, 8, 9, 10, 11):
        x, res = _full_inputs(ft, seed)
        ref, limit, _ = tt.rounding_limit_full(ft, x, res)
        i = int(ref.abs().argmax())
        wrong_site = ref.clone()
        wrong_site[i] = ref[i + 1 if i + 1 < ref.numel() else i - 1]
        assert tt.rel_inf(wrong_site, ref) > limit
        for name, bad in faulty.items():
            out = tfc.fused_correction_apply_plain(bad, x, res)
            assert tt.rel_inf(tt.correction_of(x, out), ref) > limit, (name, seed)
