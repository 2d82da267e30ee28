"""Fine-grid stencil kernels K1, K2 and K3: CUDA wrappers, plain versions
and plans.

Counterpart of mfmg_tpu/ops/pallas_stencil.py:

* K1 ``stencil_apply_sym`` replaces ``pallas_stencil_apply_sym`` (and covers
  ``pallas_stencil_apply_tiled_sym``): the symmetric-pair stencil apply
  y = C_0 x + sum_{o>0} [C_o x(i+o) + C_o(i-o) x(i-o)] over the gathered
  center + positive planes.
* K2 ``cheb_smooth`` replaces ``pallas_cheb_smooth`` (and covers
  ``pallas_cheb_smooth_tiled``): one whole deal.II Chebyshev step
  x <- x - p(D^-1 A) D^-1 (A x - b), with the V-cycle residual A x_s - b on
  request.  It has two forms, chosen by one rule (``k2_form``): the blocked
  form, one launch per step over tiles planned by ``cheb_blocked_plan``,
  for the Q1 stencil's 13 positive offsets at degree <= 3, for a step with
  the residual on a grid of more than ``K2_BLOCKED_MIN_POINTS``; the chain
  of one fused launch per apply for the rest (the step without the
  residual, smaller grids, the Q2 cube's 62 pairs of radius 2).
* K3 ``stencil_apply`` replaces ``pallas_stencil_apply`` (and covers
  ``pallas_stencil_apply_tiled``): the one-sided apply y = sum_o C_o
  x(i+o) over all offset planes, for operators without the symmetric-pair
  form (Q2/Q3 elements, stencils read from an assembled matrix).

K1 and K3 are one tiled kernel (``csrc/stencil_apply.cu``) over tiles of
whole grid rows planned by ``stencil_tile_plan``; K2's chain keeps its
thread-per-point apply.  All three take up to 171 positive (K1, K2) or 343
one-sided (K3) offsets of radius <= 3: every stencil up to Q3.  The
wrappers check those limits on either device, so the CPU refuses what the
card would.

The kernels are hand-written CUDA for Hopper (``csrc/stencil_apply.cu``,
``csrc/cheb_smooth.cu``) in the port's kernel library
(``ops/cuda_library.py``), which builds, loads and launches them.  Each
wrapper takes its plain PyTorch version for a tensor on the CPU, launches
its kernel for a CUDA tensor, and raises on anything else; there is no
fallback around the build or the launch.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mfmg_torch.ops import cuda_library as cl

# MFMG_MAX_POS/OFF/RADIUS in csrc/stencil_common.cuh: a Q3 stencil's 171
# positive (symmetric) or 343 (one-sided) offsets of radius 3
MAX_POS, MAX_OFF, MAX_RADIUS = 171, 343, 3
# K1/K3's tiles (csrc/stencil_apply.cu): the most points per tile
# (kMaxTile: 256 threads of 4 points), the points per tile the plan
# aims for, and the shared memory a block may take.  Tiles of 1024 points
# took less device time than tiles of 512 or 256 at every shape timed on an
# H100 (PERF.md), though they leave ~2.5 blocks per SM at 65^3.
K13_MAX_TILE = 1024
K13_TILE_POINTS = 1024
H100_SMEM_PER_BLOCK = 227 * 1024

# K2's blocked form (csrc/cheb_smooth.cu): the blocks wanted per SM, the
# shortest z chunk, the most frame rows (kFrameRows, a warp each; a row is at
# most 32 points).  The three values were the fastest of those timed on an H100
# at 65^3 and 129^3 (PERF.md).
K2_BLOCKS_PER_SM = 2
K2_MIN_CHUNK = 4
K2_FRAME_ROWS = 16
# K2's dispatch (k2_form), from both forms timed in one call on an H100 at
# 65^3 and 129^3 (PERF.md): the blocked form takes less device time only
# for the step with the residual on the 129^3 grid, where the chain streams
# the planes (60 MB in bf16, above the 50 MB L2) once per apply, three
# times.  Without the residual (two applies) or at 65^3 (planes in L2) its
# halo's redundant applies cost more than it saves.  The threshold lies
# between the two grids measured.
K2_BLOCKED_MIN_POINTS = 1 << 20

# the C entry points (csrc/stencil_apply.cu, csrc/cheb_smooth.cu)
_vp, _i, _ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_STENCIL_APPLY_SYM = cl.Entry("mfmg_stencil_apply_sym", _vp, _i, _vp, _vp, _vp,
                              _i, _i, _i, _i, _ip, _i, _i)
_STENCIL_APPLY = cl.Entry("mfmg_stencil_apply", _vp, _i, _vp, _vp, _i, _i, _i,
                          _i, _ip, _i, _i)
_CHEB_SMOOTH = cl.Entry("mfmg_cheb_smooth", _vp, _i, _vp, _vp, _vp, _vp, _i,
                        _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _ip)
_CHEB_SMOOTH_BLOCKED = cl.Entry("mfmg_cheb_smooth_blocked", _vp, _i, _vp, _vp,
                                _vp, _vp, _i, _vp, _vp, _i, _i, _i, _i, _ip,
                                _i, _i, _i)


# ------------------------------------------------------------ plain versions

def stencil_apply_sym_plain(planes: torch.Tensor, x: torch.Tensor,
                            pos_offsets, grid_shape) -> torch.Tensor:
    """Plain K1 (mfmg_tpu _stencil_apply_xla_sym): padded slice-sum over the
    center + positive planes; the backward term of each pair is the shifted
    product plane C_o * x.  Accumulates in x's dtype."""
    dim = len(grid_shape)
    xg = x.reshape(grid_shape)
    y = planes[0].to(x.dtype) * xg
    k = max((max(abs(c) for c in off) for off in pos_offsets), default=0)
    if k == 0:
        return y.reshape(x.shape)
    pad = (k,) * (2 * dim)
    xp = F.pad(xg, pad)
    for j, off in enumerate(pos_offsets):
        c = planes[j + 1].to(x.dtype)
        sl_p = tuple(slice(k + o, k + o + n) for o, n in zip(off, grid_shape))
        y = y + c * xp[sl_p]
        sl_m = tuple(slice(k - o, k - o + n) for o, n in zip(off, grid_shape))
        y = y + F.pad(c * xg, pad)[sl_m]
    return y.reshape(x.shape)


def stencil_apply_plain(planes: torch.Tensor, x: torch.Tensor, offsets,
                        grid_shape) -> torch.Tensor:
    """Plain K3 (mfmg_tpu _stencil_apply_xla): x zero-padded once by the
    stencil radius, every shifted read a static slice, summed in offset
    order in x's dtype.  Any dimension."""
    k = max(max(abs(o) for o in off) for off in offsets)
    dim = len(grid_shape)
    xp = F.pad(x.reshape(grid_shape), (k,) * (2 * dim))
    y = None
    for i, off in enumerate(offsets):
        sl = tuple(slice(k + o, k + o + n) for o, n in zip(off, grid_shape))
        t = planes[i].to(x.dtype) * xp[sl]
        y = t if y is None else y + t
    return y.reshape(x.shape)


def cheb_smooth_plain(planes, x, b, inv_diag, coef, pos_offsets, grid_shape,
                      degree: int, want_res: bool = False):
    """Plain K2: the alpha/beta recurrence of mfmg_tpu pallas_cheb_smooth
    (deal.II PreconditionChebyshev; coef = [alphas..., betas...]).  r stays
    the first residual; p and dx follow the recurrence."""
    def A(v):
        return stencil_apply_sym_plain(planes, v, pos_offsets, grid_shape)

    r = A(x) - b
    p = inv_diag * r
    dx = coef[0] * p
    for i in range(1, degree):
        p = inv_diag * (r - A(dx)) + coef[degree + i] * p
        dx = dx + coef[i] * p
    xs = x - dx
    return (xs, A(xs) - b) if want_res else (xs,)


# ------------------------------------------------------------------ wrappers

def stencil_apply_sym(planes: torch.Tensor, x: torch.Tensor, pos_offsets,
                      grid_shape) -> torch.Tensor:
    """K1: y = A x over the gathered (1 + n_pos, gz, gy, gx) planes."""
    _check_stencil(planes, x, pos_offsets, grid_shape)
    if x.device.type == "cpu":
        return stencil_apply_sym_plain(planes, x, pos_offsets, grid_shape)
    y = torch.empty_like(x)
    gz, gy, gx = grid_shape
    plan = k13_plan(tuple(pos_offsets), True, tuple(grid_shape))
    cl.launch(_STENCIL_APPLY_SYM, "stencil_apply_sym", x.get_device(),
              planes.data_ptr(), int(planes.dtype == torch.bfloat16),
              x.data_ptr(), None, y.data_ptr(), gz, gy, gx, len(pos_offsets),
              cl.offset_table(pos_offsets), plan.rows, plan.cols)
    return y


def stencil_apply(planes: torch.Tensor, x: torch.Tensor, offsets,
                  grid_shape) -> torch.Tensor:
    """K3: y = sum_o C_o x(i + o) over the (n_off, gz, gy, gx) planes of a
    one-sided stencil (offsets of radius <= 3)."""
    _check_grid(planes, x, len(offsets), grid_shape)
    if not offsets:
        raise ValueError("a one-sided stencil needs at least one offset")
    _check_takes(tuple(offsets), MAX_OFF, "K3")
    if x.device.type == "cpu":
        return stencil_apply_plain(planes, x, offsets, grid_shape)
    y = torch.empty_like(x)
    gz, gy, gx = grid_shape
    plan = k13_plan(tuple(offsets), False, tuple(grid_shape))
    cl.launch(_STENCIL_APPLY, "stencil_apply", x.get_device(),
              planes.data_ptr(), int(planes.dtype == torch.bfloat16),
              x.data_ptr(), y.data_ptr(), gz, gy, gx, len(offsets),
              cl.offset_table(offsets), plan.rows, plan.cols)
    return y


def cheb_smooth(planes: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                inv_diag: torch.Tensor, coef: torch.Tensor, pos_offsets,
                grid_shape, degree: int, want_res: bool = False):
    """K2: (x_s,) or (x_s, A x_s - b) for one Chebyshev step; coef is the
    (2 * degree,) float32 recurrence array [alphas..., betas...].  The form
    is the one ``k2_form``'s rule gives."""
    form = k2_form(tuple(pos_offsets), degree, want_res, tuple(grid_shape))
    return cheb_smooth_as(form, planes, x, b, inv_diag, coef, pos_offsets,
                          grid_shape, degree, want_res)


def cheb_smooth_as(form: str, planes, x, b, inv_diag, coef, pos_offsets,
                   grid_shape, degree: int, want_res: bool = False):
    """K2 in the given form, "blocked" or "chain": ``cheb_smooth``'s body,
    and the entry of the A/B harnesses that time one form beside the other
    (chip_smoke.py, scripts/kernel_device_times.py, the card tests).  The
    blocked form raises for offsets or a degree its kernel does not take."""
    _check_stencil(planes, x, pos_offsets, grid_shape)
    if degree < 1:
        raise ValueError(f"Chebyshev degree must be >= 1, got {degree}")
    if form not in ("blocked", "chain") or (
            form == "blocked" and not blocked_takes(tuple(pos_offsets), degree)):
        raise ValueError(f"K2 form {form!r} for these offsets at degree {degree}")
    for name, t in (("b", b), ("inv_diag", inv_diag)):
        _check_like(name, t, x)
    if (coef.dtype != torch.float32 or coef.shape != (2 * degree,)
            or coef.device != x.device or not coef.is_contiguous()):
        raise ValueError(f"coef must be a contiguous float32 ({2 * degree},) "
                         f"tensor on {x.device}, got {coef.dtype} "
                         f"{tuple(coef.shape)} on {coef.device}")
    if x.device.type == "cpu":
        return cheb_smooth_plain(planes, x, b, inv_diag, coef, pos_offsets,
                                 grid_shape, degree, want_res)
    xs = torch.empty_like(x)
    res = torch.empty_like(x) if want_res else None
    gz, gy, gx = grid_shape
    dev = x.get_device()
    head = (planes.data_ptr(), int(planes.dtype == torch.bfloat16),
            x.data_ptr(), b.data_ptr(), inv_diag.data_ptr(), coef.data_ptr(),
            degree)
    tail = (xs.data_ptr(), None if res is None else res.data_ptr(), gz, gy,
            gx, len(pos_offsets), cl.offset_table(pos_offsets))
    if form == "blocked":
        plan = cheb_blocked_plan(tuple(grid_shape), degree, want_res,
                                 cl.sm_count(dev))
        cl.launch(_CHEB_SMOOTH_BLOCKED, "cheb_smooth", dev, *head, *tail,
                  plan.ty, plan.tx, plan.cz)
    else:
        # r, p, dx0 (and dx1 above degree 2) in one scratch allocation
        n = x.numel()
        scratch = torch.empty((4 if degree > 2 else 3) * n,
                              dtype=torch.float32, device=x.device)
        r, p, dx0 = (scratch.data_ptr() + 4 * n * i for i in range(3))
        dx1 = dx0 + 4 * n if degree > 2 else dx0
        cl.launch(_CHEB_SMOOTH, "cheb_smooth", dev, *head, r, p, dx0, dx1,
                  *tail)
    cl.LAUNCHES[f"cheb_smooth_{form}"] += 1
    return (xs, res) if want_res else (xs,)


# The positive half of the Q1 27-point stencil, in the order the stencil
# extraction gives it (lexicographic): the offsets K2's blocked form takes.
Q1_POS = tuple(o for o in itertools.product((-1, 0, 1), repeat=3)
               if o > (0, 0, 0))


@functools.lru_cache(maxsize=None)
def k2_form(pos_offsets, degree: int, want_res: bool, grid_shape) -> str:
    """K2's dispatch rule: "blocked" for a step with the residual on a grid
    of more than K2_BLOCKED_MIN_POINTS points, over the Q1 positive offsets
    (Q1_POS, in that order) at degree <= 3; else "chain"."""
    big = int(np.prod(grid_shape)) > K2_BLOCKED_MIN_POINTS
    return ("blocked" if want_res and big and blocked_takes(pos_offsets, degree)
            else "chain")


def blocked_takes(pos_offsets, degree: int) -> bool:
    """The offsets and degrees the blocked kernel is compiled for."""
    return tuple(pos_offsets) == Q1_POS and 1 <= degree <= 3


class K2Plan(NamedTuple):
    """Tiles of K2's blocked form: interior (ty, tx) per (y, x) tile, cz
    z-slices per chunk, the halo (one point per recurrence level), and the
    grid (x tiles, y tiles, z chunks)."""
    ty: int
    tx: int
    cz: int
    halo: int
    grid: tuple


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def cheb_blocked_plan(grid_shape, degree: int, want_res: bool,
                      n_sm: int = cl.H100_SMS) -> K2Plan:
    """The tile schedule of K2's blocked form (csrc/cheb_smooth.cu).

    A frame (the tile and ``halo`` <= 4 points per side) is at most 32
    points wide (a warp's lanes) and ``K2_FRAME_ROWS`` rows high (a row per
    warp); the tiles split each axis evenly, so only the last tile of an
    axis is ragged, by less than the tile count.  The z chunks are as many
    as bring the blocks to ``K2_BLOCKS_PER_SM`` per SM, no shorter than
    ``K2_MIN_CHUNK`` slices."""
    gz, gy, gx = grid_shape
    halo = degree + int(want_res)
    tx = _cdiv(gx, _cdiv(gx, 32 - 2 * halo))
    ty = _cdiv(gy, _cdiv(gy, K2_FRAME_ROWS - 2 * halo))
    tiles = _cdiv(gx, tx) * _cdiv(gy, ty)
    n_chunks = max(1, min(_cdiv(gz, K2_MIN_CHUNK), K2_BLOCKS_PER_SM * n_sm // tiles))
    cz = _cdiv(gz, n_chunks)
    return K2Plan(ty, tx, cz, halo, (_cdiv(gx, tx), _cdiv(gy, ty), _cdiv(gz, cz)))


class TilePlan(NamedTuple):
    """Tiles of K1/K3 (csrc/stencil_apply.cu): ``rows`` whole grid rows of
    one z slice per block, or where a row is longer than a tile, one
    segment of ``cols`` points (rows 1); the block's shared memory (bytes)
    and the block count."""
    rows: int
    cols: int
    smem: int
    blocks: int


def tile_smem_bytes(n_vplanes, radius, rows, cols) -> int:
    """Shared memory of a K1/K3 block (``tile_layout`` in
    csrc/stencil_apply.cu): 16 bytes per virtual plane (its coefficient and
    x offsets), then the x tile with its halo in 2r + 1 slices (floats)."""
    xs = (2 * radius + 1) * (rows + 2 * radius) * (cols + 2 * radius)
    return 16 * n_vplanes + 4 * xs


@functools.lru_cache(maxsize=None)
def stencil_tile_plan(grid_shape, radius: int, n_vplanes: int) -> TilePlan:
    """The tile schedule of K1/K3: tiles of about K13_TILE_POINTS points
    (at most K13_MAX_TILE), whole rows where a row fits, split evenly so
    that only the last tile of an axis is ragged; smaller tiles where the
    block's shared memory would exceed the card's."""
    gz, gy, gx = grid_shape
    target = min(K13_TILE_POINTS, K13_MAX_TILE)
    if gx <= target:
        rows, cols = _cdiv(gy, _cdiv(gy, max(1, target // gx))), gx
    else:
        rows, cols = 1, _cdiv(gx, _cdiv(gx, target))
    while tile_smem_bytes(n_vplanes, radius, rows, cols) > H100_SMEM_PER_BLOCK:
        if rows > 1:
            rows = _cdiv(rows, 2)
        else:
            cols = _cdiv(cols, 2)
    return TilePlan(rows, cols, tile_smem_bytes(n_vplanes, radius, rows, cols),
                    _cdiv(gx, cols) * _cdiv(gy, rows) * gz)


@functools.lru_cache(maxsize=None)
def k13_plan(offsets, sym: bool, grid_shape) -> TilePlan:
    n_v = 2 * len(offsets) + 1 if sym else len(offsets)
    return stencil_tile_plan(grid_shape, _radius(offsets), n_v)


def _check_stencil(planes, x, pos_offsets, grid_shape):
    _check_grid(planes, x, 1 + len(pos_offsets), grid_shape)
    _check_takes(tuple(pos_offsets), MAX_POS, "K1/K2")


def _check_takes(offsets, max_n, name):
    if not _kernel_takes(offsets, max_n):
        raise ValueError(f"{name} takes at most {max_n} offsets of radius <= "
                         f"{MAX_RADIUS}, got {len(offsets)} of radius "
                         f"{_radius(offsets)}")


def _check_grid(planes, x, n_planes, grid_shape):
    """x a contiguous float32 grid vector, planes contiguous float32/bf16
    (n_planes,) + grid_shape on x's device (cpu or cuda)."""
    if len(grid_shape) != 3:
        raise ValueError(f"the stencil kernels take 3-D grids, got {grid_shape}")
    n = int(np.prod(grid_shape))
    if x.dtype != torch.float32 or x.shape != (n,) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 ({n},) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if planes.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"planes must be float32 or bfloat16, got {planes.dtype}")
    want = (n_planes,) + tuple(grid_shape)
    if tuple(planes.shape) != want or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous {want}, got "
                         f"{tuple(planes.shape)}")
    if planes.device != x.device:
        raise ValueError(f"planes on {planes.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} points exceed the kernels' limit (2^31)")


def _check_like(name, t, x):
    if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must match x ({x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, contiguous), got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# The offset checks are made once per offset tuple: the fine applies launch
# every few tens of microseconds.
@functools.lru_cache(maxsize=None)
def _kernel_takes(offsets, max_n) -> bool:
    return len(offsets) <= max_n and _radius(offsets) <= MAX_RADIUS


def _radius(offsets) -> int:
    return max((abs(c) for off in offsets for c in off), default=0)
