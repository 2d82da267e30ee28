"""The coarse tail of a 3-level hierarchy in one CUDA kernel launch.

Port of mfmg_tpu/ops/fused_cycle.py.  Below level 0 the V-cycle is the
fine restriction, the level-1 Chebyshev sub-cycle (pre-smooth from zero,
residual, level-1 -> 2 correction with the coarse pseudoinverse,
post-smooth) and the prolongation: a chain of small launches in the
generic recursion.  Two wrappers run it as one launch of
``csrc/fused_tail.cu``:

* ``fused_correction_apply(ft, x, res)`` = x - P . subcycle(R . res), the
  whole tail (full mode), counterpart of the reference's function of that
  name (fused_cycle.py:402);
* ``fused_subcycle_apply(ft, b1)`` = subcycle(b1), the level-1 sub-cycle
  alone (fused_cycle.py:376), for fine grids beyond the full-tail gate.

The level-1 -> 2 correction is the dense ``Rd`` up to
FUSED_DENSE_MAX_ELEMS entries, else the windowed weights ``W2``
(fused_cycle.py:542-552).  ``FusedTail`` holds the operands in the port's
own layout: site-major vectors v[s * c + e] as at every public function of
the port; the reference's (c, gx, gz*gy) planes and 0/1 selection matrices
existed for Mosaic's legal-op set and are not ported.

Each wrapper runs its plain PyTorch version for a tensor on the CPU,
launches the kernel for a CUDA tensor, and raises on anything else; each
launch counts in ``cuda_library.LAUNCHES["fused_tail"]``.  The launch
follows ``tail_plan`` (which block owns which level-1 sites, lanes per
output, the shared-memory layout).  The plain versions compute the
reference's ``_subcycle_math`` literally with the port's block-stencil and
transfer math, on the stored (possibly bf16-rounded) operands in the
vectors' dtype.  With bf16 weights the
windowed level-1 -> 2 correction also rounds four of its vectors to bf16,
where the reference's reduced tail rounds them (``_windowed_correction``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops.block_stencil import (BlockStencilOperator,
                                          block_stencil_apply_coeffs)
from mfmg_torch.ops.structured_transfer import (GeneralWindowTransfer,
                                                StructuredTransfer, _gwt_prolong)
from mfmg_torch.solve.coarse import DirectCoarseSolver
from mfmg_torch.solve.smoothers import ChebyshevSmoother, _cheb_coeffs

# The dense form's cap on Rd entries (fused_cycle.py:542); beyond it the
# windowed form.
FUSED_DENSE_MAX_ELEMS = 4_000_000
# The full-tail gate of fused_cycle.py:565-570: the fine weights and their
# windows, x, res and out in bytes of the hierarchy dtype.  It sized the
# reference's VMEM residency; the card has no such limit, but the gate is
# kept so that each size takes the reference's branch (65^3 the full tail,
# 129^3 the sub-cycle; lifting it is a ROADMAP question).
FULL_TAIL_MAX_BYTES = 30 * 1024 * 1024
MAX_OFFSETS = 27                  # MFMG_TAIL_MAX_OFF in csrc/fused_tail.cu
TAIL_THREADS = 512                # kTailThreads in csrc/fused_tail.cu
# Shared memory a block may use on an H100 (227 KB of the SM's 256 KB).
H100_SMEM_PER_BLOCK = 232_448


def full_tail_fits(n_comp, agg_shape, window_shape, grid_shape,
                   itemsize) -> bool:
    """The reference's full-tail gate (fused_cycle.py:565-570)."""
    windows = int(np.prod([a * w for a, w in zip(agg_shape, window_shape)]))
    n_fine = int(np.prod(grid_shape))
    return ((n_comp + 1) * windows + 3 * n_fine) * itemsize < FULL_TAIL_MAX_BYTES


class FusedTail(nn.Module):
    """Operands of the fused coarse tail.

    Buffers: ``coeffs`` (n_off, gz, gy, gx, c, c) level-1 block stencil;
    ``invd`` (n1,) level-1 inverse diagonal; ``cheb_coef`` (2 * degree,)
    [alphas..., betas...], runtime data as in the reference; ``inv2``
    (n2, n2) coarse pseudoinverse; either ``Rd`` (n2, n1) or ``W2``
    (n_S, n2e, wz, wy, wx, c), the windowed level-1 -> 2 weights regrouped
    per output super-site (``win`` holds their window_shape, t0, stride,
    out_grid, n_out); and, in full mode, ``W`` (c, tz, ty, tx, gz, gy, gx)
    the fine transfer weights with ``fine_window`` and ``fine_grid``.
    """

    def __init__(self, coeffs, offsets, grid, n_comp, invd, cheb_coef,
                 degree, nss, inv2, Rd=None, W2=None, win=None, W=None,
                 fine_window=None, fine_grid=None):
        super().__init__()
        self.register_buffer("coeffs", coeffs)
        self.register_buffer("invd", invd)
        self.register_buffer("cheb_coef", cheb_coef)
        self.register_buffer("inv2", inv2)
        self.register_buffer("Rd", Rd)
        self.register_buffer("W2", W2)
        self.register_buffer("W", W)
        self.offsets = tuple(tuple(int(v) for v in off) for off in offsets)
        self.grid = tuple(int(v) for v in grid)
        self.n_comp = int(n_comp)
        self.degree = int(degree)
        self.nss = int(nss)
        self.win = win
        self.fine_window = None if fine_window is None else tuple(fine_window)
        self.fine_grid = None if fine_grid is None else tuple(fine_grid)

    @property
    def n1(self) -> int:
        return int(np.prod(self.grid)) * self.n_comp

    @property
    def n2(self) -> int:
        return self.inv2.shape[0]

    @property
    def n_fine(self) -> int:
        return int(np.prod(self.fine_grid))

    def coarse_transfer(self, dtype) -> GeneralWindowTransfer:
        """The windowed level-1 -> 2 transfer over W2, in the layout of
        GeneralWindowTransfer (n_out, window, n_in, out_grid)."""
        w = self.win
        oz, oy, ox = w["out_grid"]
        W = self.W2.reshape((oz, oy, ox, w["n_out"]) + w["window_shape"]
                            + (self.n_comp,))
        W = W.permute(3, 4, 5, 6, 7, 0, 1, 2).to(dtype)
        return GeneralWindowTransfer(W, w["window_shape"], w["t0"],
                                     w["stride"], self.grid, w["out_grid"],
                                     self.n_comp, w["n_out"])

    def fine_transfer(self, dtype) -> StructuredTransfer:
        return StructuredTransfer(self.W.to(dtype), self.fine_window,
                                  self.grid, self.fine_grid).to(self.W.device)


def build_fused_tail(levels, n_smoothing_steps: int = 1,
                     reduced_storage: bool = False):
    """Pattern-match a 3-level tail (structured fine transfer + block-stencil
    L1 + Chebyshev + window transfer + direct coarse L2) and bake the fused
    operands on the levels' device (fused_cycle.py:492-614).  Returns None
    when the structure does not match, as the reference does (the generic
    recursion stays); every tail that matches has a plan (``tail_plan``
    places in global memory what an H100 block's shared memory does not
    hold).

    reduced_storage: the level-1 coefficients, Rd / W2 and the fine W are
    stored in bfloat16; invd, inv2 and the Chebyshev coefficients stay in
    the hierarchy dtype, and every sum runs in the vectors' dtype on the
    bf16-rounded weights (the reference's CPU semantics)."""
    if len(levels) != 3:
        return None
    l0, l1, l2 = levels
    op, sm, tr = l1.op, l1.smoother, l1.transfer
    if not (isinstance(op, BlockStencilOperator)
            and isinstance(sm, ChebyshevSmoother)
            and isinstance(tr, GeneralWindowTransfer)
            and isinstance(l2.coarse, DirectCoarseSolver)):
        return None
    if len(op.agg_shape) != 3:
        return None
    dtype = op.coeffs.dtype
    if dtype not in (torch.float32, torch.float64):
        return None
    grid, c = op.agg_shape, op.n_comp
    wdt = torch.bfloat16 if reduced_storage else dtype

    Rd = W2 = win = None
    inv2 = l2.coarse.inv.to(dtype)
    if tr.Rd is not None and tr.Rd.numel() <= FUSED_DENSE_MAX_ELEMS:
        Rd = tr.Rd.to(wdt)
    else:
        # _windowed_operands (fused_cycle.py:617-682) without its 60 MB
        # VMEM budget, a TPU limit
        n2 = tr.n_out * int(np.prod(tr.out_grid))
        if (len(tr.in_grid) != 3 or tuple(tr.in_grid) != grid
                or tr.n_in != c or tuple(inv2.shape) != (n2, n2)):
            return None
        oz, oy, ox = tr.out_grid
        # (n_out, wz, wy, wx, n_in, oz, oy, ox) -> (n_S, n_out, wz, wy, wx, n_in)
        W2 = tr.W.permute(5, 6, 7, 0, 1, 2, 3, 4).reshape(
            (oz * oy * ox, tr.n_out) + tuple(tr.window_shape) + (c,))
        W2 = W2.to(wdt).contiguous()
        win = dict(window_shape=tuple(tr.window_shape), t0=tuple(tr.t0),
                   stride=tuple(tr.stride), out_grid=tuple(tr.out_grid),
                   n_out=tr.n_out)

    alphas, betas = _cheb_coeffs(sm.theta, sm.delta, sm.degree)
    cheb_coef = torch.tensor(alphas + betas, dtype=dtype,
                             device=op.coeffs.device)

    W = fine_window = fine_grid = None
    ftr = l0.transfer
    if (isinstance(ftr, StructuredTransfer) and ftr.n_ev == c
            and len(ftr.agg_shape) == 3 and ftr.agg_shape == grid
            and full_tail_fits(c, grid, ftr.window_shape, ftr.grid_shape,
                               torch.finfo(dtype).bits // 8)):
        W = ftr.W.to(wdt)
        fine_window, fine_grid = ftr.window_shape, ftr.grid_shape

    return FusedTail(op.coeffs.to(wdt), op.offsets, grid, c,
                     sm.inv_diag.to(dtype), cheb_coef, sm.degree,
                     n_smoothing_steps, inv2, Rd=Rd, W2=W2, win=win, W=W,
                     fine_window=fine_window, fine_grid=fine_grid)


# ------------------------------------------------------------ plain versions

def fused_subcycle_apply_plain(ft: FusedTail, b1: torch.Tensor) -> torch.Tensor:
    """_subcycle_math (fused_cycle.py:289-350) on site-major vectors, in b1's
    dtype."""
    return _subcycle_math(ft, b1)


def fused_subcycle_apply_plain64(ft: FusedTail, b1: torch.Tensor,
                                 perturb=None) -> torch.Tensor:
    """The plain version in float64, rounding to bf16 at exactly the points
    the float32 one rounds (``_windowed_correction``: r1, b2, x2 and the
    prolonged z/y sums, where the weights are bf16): the reference against
    which a float32 kernel's distance is its own float32 error plus the
    roundings that error flips.  ``perturb(point, v, mag)``, a measurement
    hook, returns the value to round in place of v at each rounding point
    ("r1", "b2", "x2", "zy"), mag being the sum of the magnitudes of the
    terms that made v (the scale of a float32 sum's error)."""
    return _subcycle_math(ft, b1.to(torch.float64), perturb)


def _subcycle_math(ft: FusedTail, b1: torch.Tensor, perturb=None) -> torch.Tensor:
    dt = b1.dtype
    d = ft.degree
    coef = ft.cheb_coef.to(dt)
    alphas = [coef[i] for i in range(d)]
    betas = [coef[d + i] for i in range(d)]
    invd = ft.invd.to(dt)

    def apply_A(v, coeffs=ft.coeffs):
        return block_stencil_apply_coeffs(coeffs, ft.offsets, ft.grid,
                                          ft.n_comp, v)

    def cheb_vmult(src):
        # x = p_degree(D^-1 A) D^-1 src, zero initial guess
        z = invd * src
        p = z
        x = alphas[0] * z
        for i in range(1, d):
            r = src - apply_A(x)
            z = invd * r
            p = z + betas[i] * p
            x = x + alphas[i] * p
        return x

    def smooth(x):
        return x - cheb_vmult(apply_A(x) - b1)

    x1 = cheb_vmult(b1)               # pre-smooth from zero: -cheb(-b1)
    for _ in range(ft.nss - 1):
        x1 = smooth(x1)
    r1 = apply_A(x1) - b1
    inv2 = ft.inv2.to(dt)
    if ft.Rd is not None:
        Rd = ft.Rd.to(dt)
        corr = (inv2 @ (Rd @ r1)) @ Rd
    else:
        mag = None
        if perturb is not None:
            mag = apply_A(x1.abs(), ft.coeffs.abs()) + b1.abs()
        corr = _windowed_correction(ft, r1, inv2, perturb, mag)
    x1 = x1 - corr
    for _ in range(ft.nss):
        x1 = smooth(x1)
    return x1


def _windowed_correction(ft: FusedTail, r1, inv2, perturb=None, r1_mag=None):
    """R2^T inv2 R2 r1 through the windowed weights W2.  With bf16 weights
    it rounds (to nearest even) where the reference's reduced tail rounds on
    the CPU, whose ``_match`` casts the data down when a bf16 0/1 selection
    matrix is the first matmul operand (fused_cycle.py:256, 268, 272, 285):
    r1, b2, x2, and the prolonged values once summed over the z and y
    windows, before the x windows are added.  ``perturb``: see
    fused_subcycle_apply_plain64 (r1_mag, r1's magnitude, with it)."""
    dt = r1.dtype
    tr = ft.coarse_transfer(dt)
    on = ft.W2.dtype == torch.bfloat16

    def rnd(v):
        return v.to(torch.bfloat16).to(dt) if on else v

    if perturb is None:
        x2 = rnd(inv2 @ rnd(tr.restrict(rnd(r1))))
        return _gwt_prolong(tr, x2, between=rnd)
    # the same, each value perturbed before its rounding; mag from the same
    # sums over the terms' magnitudes
    tabs = GeneralWindowTransfer(tr.W.abs(), tr.window_shape, tr.t0, tr.stride,
                                 tr.in_grid, tr.out_grid, tr.n_in, tr.n_out)
    r1 = rnd(perturb("r1", r1, r1_mag))
    b2 = tr.restrict(r1)
    b2 = rnd(perturb("b2", b2, tabs.restrict(r1.abs())))
    x2 = inv2 @ b2
    x2 = rnd(perturb("x2", x2, inv2.abs() @ b2.abs()))
    mags = []
    _gwt_prolong(tabs, x2.abs(), between=lambda m: mags.append(m) or m)
    return _gwt_prolong(tr, x2, between=lambda v: rnd(perturb("zy", v, mags[0])))


def fused_correction_apply_plain(ft: FusedTail, x: torch.Tensor,
                                 res: torch.Tensor) -> torch.Tensor:
    """x - P . subcycle(R . res) through the fine structured transfer."""
    fine = ft.fine_transfer(x.dtype)
    return x - fine.prolong(fused_subcycle_apply_plain(ft, fine.restrict(res)))


# --------------------------------------------------------------------- plan

class TailPlan(NamedTuple):
    """The decomposition of csrc/fused_tail.cu (its struct Plan, in order).

    ``blocks`` of TAIL_THREADS, block b owning the level-1 sites
    [b * sites, (b + 1) * sites) (the last block ragged); lanes per output
    (each a power of two <= 32): ``group`` per site gathering an apply's
    neighbour values, ``fine_group`` per (e, a) in the fine restriction,
    ``row_parts`` per coarse row in the dense partial restriction,
    ``col_parts`` per column in the dense prolongation.  Shared memory
    (bytes): the block's own b1, residual and p at 0, x2 at ``off_x2``, the
    fine window's entry offsets at ``off_tab`` (full mode), the applies'
    gathered neighbour values at ``off_vb`` (n_off * c floats per group),
    and, where staged, the coefficient chunks (``cstride`` apart, one per
    offset) at ``off_coef`` and the Rd column chunks (``rstride`` apart,
    one per coarse row) at ``off_rd``; a chunk is the 16-byte-aligned cover
    of its bytes.  ``stage_vecs``, ``stage_x2``, ``stage_vb``: 1 where the
    block's own vectors, x2 and the gather buffer lie in shared memory (at
    0, ``off_x2`` and ``off_vb``), 0 where they lie in global scratch
    (``scratch_floats``)."""
    blocks: int
    sites: int
    group: int
    fine_group: int
    row_parts: int
    col_parts: int
    stage_coeffs: int
    stage_rd: int
    cstride: int
    rstride: int
    off_coef: int
    off_rd: int
    off_x2: int
    off_tab: int
    off_vb: int
    smem_bytes: int
    stage_vecs: int
    stage_x2: int
    stage_vb: int


def _lanes(n_threads: int, n_items: int) -> int:
    """The largest power of two <= 32 with n_items groups of it in
    n_threads lanes (at least 1)."""
    g = 1
    while g < 32 and 2 * g * n_items <= n_threads:
        g *= 2
    return g


def _r16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=None)
def tail_plan(grid, n_comp: int, n_off: int, n2: int, dense: bool,
              weight_bytes: int, table: int = 0,
              n_sm: int = cl.H100_SMS) -> TailPlan:
    """Plan the tail's launch: the level-1 sites spread evenly over at most
    one block per SM (every SM takes part in the phases over the fine
    grid); lanes per output as many as the block's threads allow, at most a
    warp; the block's vectors, x2 and the gather buffer in shared memory
    where they fit in an H100 block's (more lanes per site, so fewer
    groups, to fit the buffer), else, in that order, x2, the gather buffer
    and the vectors in global scratch; then the block's coefficients and its
    Rd columns staged in what is left.  ``table``: the entries of the fine
    window (0 without one), whose offsets the kernel tabulates."""
    n_sites, c, T = int(np.prod(grid)), int(n_comp), TAIL_THREADS
    sites = -(-n_sites // n_sm)
    blocks = -(-n_sites // sites)
    sites = -(-n_sites // blocks)
    cstride = _r16(sites * c * c * weight_bytes) + 16
    rstride = _r16(sites * c * weight_bytes) + 16

    def vb_bytes(g):
        return _r16(4 * (T // g) * n_off * c)

    # (vectors, x2, gather buffer) in shared memory: all, then without x2,
    # without the gather buffer, without the vectors
    for stage_vecs, stage_x2, stage_vb in ((1, 1, 1), (1, 0, 1), (1, 0, 0), (0, 0, 0)):
        off_x2 = stage_vecs * _r16(3 * sites * c * 4)
        off_tab = off_x2 + stage_x2 * _r16(4 * n2)
        off_vb = off_tab + _r16(4 * table)
        group = _lanes(T, sites)
        if stage_vb:
            while group < 32 and off_vb + vb_bytes(group) > H100_SMEM_PER_BLOCK:
                group *= 2
        off_coef = off_vb + stage_vb * vb_bytes(group)
        if off_coef <= H100_SMEM_PER_BLOCK:
            break
    stage_coeffs = int(off_coef + n_off * cstride <= H100_SMEM_PER_BLOCK)
    off_rd = off_coef + stage_coeffs * n_off * cstride
    stage_rd = int(dense and off_rd + n2 * rstride <= H100_SMEM_PER_BLOCK)
    return TailPlan(blocks, sites, group, _lanes(T, sites * c),
                    _lanes(T, n2), _lanes(T, sites * c), stage_coeffs, stage_rd,
                    cstride, rstride, off_coef, off_rd, off_x2, off_tab, off_vb,
                    off_rd + stage_rd * n2 * rstride, stage_vecs, stage_x2, stage_vb)


def scratch_floats(plan: TailPlan, n1: int, n2: int, n_comp: int,
                   n_off: int) -> int:
    """Floats of the kernel's global scratch: d (two), x (two) and r1 (n1
    each), the dense partials (blocks x n2), b2 and x2, then, each from a
    multiple of 4 floats, the blocks' vectors and gather buffers where the
    plan leaves them in global memory."""
    n = -(-(5 * n1 + (plan.blocks + 2) * n2) // 4) * 4
    if not plan.stage_vecs:
        n = -(-(n + plan.blocks * 3 * plan.sites * n_comp) // 4) * 4
    if not plan.stage_vb:
        n += plan.blocks * (TAIL_THREADS // plan.group) * n_off * n_comp
    return n


def plan_of(ft: FusedTail, n_sm: int = cl.H100_SMS) -> TailPlan:
    table = 0 if ft.fine_window is None else int(np.prod(ft.fine_window))
    return tail_plan(ft.grid, ft.n_comp, len(ft.offsets), ft.n2, ft.Rd is not None,
                     ft.coeffs.element_size(), table, n_sm)


# ------------------------------------------------------------------ wrappers

def fused_subcycle_apply(ft: FusedTail, b1: torch.Tensor) -> torch.Tensor:
    """x1 = subcycle(b1) (site-major flat level-1 vectors); a full-mode tail
    runs its sub-cycle alone."""
    _check_vector(ft, "b1", b1, ft.n1)
    if b1.device.type == "cpu":
        return fused_subcycle_apply_plain(ft, b1)
    out = torch.empty_like(b1)
    _launch(ft, full=False, b1=b1, out=out)
    return out


def fused_correction_apply(ft: FusedTail, x: torch.Tensor,
                           res: torch.Tensor) -> torch.Tensor:
    """x - P . subcycle(R . res) (flat fine vectors) in one launch."""
    if ft.fine_grid is None:
        raise ValueError("this tail has no fine transfer (the full-tail gate "
                         "failed at build); use fused_subcycle_apply")
    _check_vector(ft, "x", x, ft.n_fine)
    _check_vector(ft, "res", res, ft.n_fine)
    if x.device.type == "cpu":
        return fused_correction_apply_plain(ft, x, res)
    out = torch.empty_like(x)
    _launch(ft, full=True, x=x, res=res, out=out)
    return out


def _check_vector(ft: FusedTail, name, v, n):
    dev = ft.invd.device
    if v.device != dev:
        raise ValueError(f"{name} on {v.device}, the tail's operands on {dev}")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {v.device}")
    want = torch.float32 if v.device.type == "cuda" else ft.invd.dtype
    if v.dtype != want or ft.invd.dtype != want:
        raise ValueError(f"{name} must be {want} like the tail's operands "
                         f"({ft.invd.dtype}), got {v.dtype}")
    if v.shape != (n,) or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) tensor, got "
                         f"{tuple(v.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


# the C entry points (csrc/fused_tail.cu): three flags, twelve buffers, five
# int tables; the stamped instance takes the stamps buffer after them
_TAIL_ARGS = ((ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 12
              + (ctypes.POINTER(ctypes.c_int),) * 5)
_FUSED_TAIL = cl.Entry("mfmg_fused_tail", *_TAIL_ARGS)
_FUSED_TAIL_STAMPED = cl.Entry("mfmg_fused_tail_stamped", *_TAIL_ARGS,
                               ctypes.c_void_p)


def _launch(ft: FusedTail, full: bool, out, b1=None, x=None, res=None,
            stamps=None):
    """One launch of csrc/fused_tail.cu; with ``stamps`` (a zeroed int64
    (1 + marks x blocks) tensor) through the kernel instance that records
    phase stamps, an entry of the measurement scripts only."""
    for name in ("coeffs", "Rd", "W2", "W"):
        t = getattr(ft, name)
        if t is not None and (t.dtype != ft.coeffs.dtype or not t.is_contiguous()):
            raise ValueError(f"FusedTail.{name} must be contiguous "
                             f"{ft.coeffs.dtype}, got {t.dtype}")
    if not ft.coeffs.is_contiguous() or len(ft.offsets) > MAX_OFFSETS:
        raise ValueError(f"the kernel takes contiguous coefficients and at "
                         f"most {MAX_OFFSETS} offsets")
    for t in (ft.coeffs, ft.Rd):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the kernel stages coefficients and Rd with 16-byte "
                             "copies: they must start on 16 bytes")
    dense = ft.Rd is not None
    if dense:
        l2 = [ft.n2, 0] + [0] * 12
    else:
        w = ft.win
        l2 = ([ft.n2, w["n_out"]] + list(w["out_grid"]) + list(w["window_shape"])
              + list(w["stride"]) + list(w["t0"]))
    fine = [0] * 6
    if full:
        if any(w < 2 or n != a * (w - 1) + 1 for w, a, n in
               zip(ft.fine_window, ft.grid, ft.fine_grid)):
            raise ValueError(f"fine windows {ft.fine_window} at stride w - 1 "
                             f"over agglomerates {ft.grid} do not tile the "
                             f"fine grid {ft.fine_grid}")
        fine = list(ft.fine_grid) + list(ft.fine_window)
    dev = out.get_device()
    plan = plan_of(ft, cl.sm_count(dev))
    scratch = torch.empty(scratch_floats(plan, ft.n1, ft.n2, ft.n_comp,
                                         len(ft.offsets)),
                          dtype=torch.float32, device=out.device)
    args = (int(ft.coeffs.dtype == torch.bfloat16), int(full), int(dense),
            _ptr(ft.coeffs), _ptr(ft.invd), _ptr(ft.cheb_coef), _ptr(ft.Rd),
            _ptr(ft.W2), _ptr(ft.inv2), _ptr(ft.W) if full else None, _ptr(b1),
            _ptr(x), _ptr(res), out.data_ptr(), scratch.data_ptr(),
            cl.ints([*ft.grid, ft.n_comp, len(ft.offsets), ft.degree, ft.nss]),
            cl.offset_table(ft.offsets), cl.ints(l2), cl.ints(fine),
            cl.int_table(plan))
    if stamps is None:
        cl.launch(_FUSED_TAIL, "fused_tail", dev, *args)
    else:
        cl.launch(_FUSED_TAIL_STAMPED, "fused_tail", dev, *args,
                  stamps.data_ptr())
