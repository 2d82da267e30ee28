"""Fine-level transfer kernels K4 and K5: CUDA wrappers and plain versions.

Counterpart of mfmg_tpu/ops/pallas_transfer.py:

* K4 ``structured_restrict`` replaces ``pallas_restrict_tiled``:
  out[(az, ay, ax), e] = sum_t W[e, t, a] x[a * s + t];
* K5 ``structured_prolong`` replaces ``pallas_prolong_tiled``: its exact
  adjoint, y = R^T xc.

W is the (c, wz, wy, wx, gz, gy, gx) weight array of a 3-D
``StructuredTransfer`` (windows w per axis at stride w - 1 over a fine grid
of g * (w - 1) + 1 nodes), float32 or bfloat16; the vectors are float32 and
the coarse one is site-major (az, ay, ax, e).  The plain versions follow
the per-axis chain of mfmg_tpu/ops/structured_transfer.py, for any
dimension: its 0/1 selection matmuls become per-axis gathers
(``index_select``) and their adjoint overlap-adds (``index_add_``), around
one ``einsum`` with W (exact float32, TF32 off); the kernels
(``csrc/structured_transfer.cu``) address the windows directly, K4 over the
blocks of ``restrict_plan``.  The TPU kernels' padded (c, gax, n_tiles*AZT*gay) layout and
their tiling geometry are not ported.

Each wrapper takes its plain version for a tensor on the CPU, launches its
kernel for a CUDA tensor, and raises on anything else; each launch counts in
``cuda_library.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from mfmg_torch.ops import cuda_library as cl

_LT, _LB = "ijk", "uvw"

# K4's blocks (csrc/structured_transfer.cu, kRestrictMaxThreads and
# kRestrictMaxSmem): at most 512 threads and an H100 block's 227 KB of
# dynamic shared memory; agglomerate rows are added to a block only while the
# card keeps this many blocks per SM.  H100_SMEM_PER_SM: the shared memory
# of an SM (228 KB), of which each resident block takes 1 KB more than it
# asks for.
RESTRICT_MAX_THREADS = 512
RESTRICT_MAX_SMEM = 232_448
RESTRICT_BLOCKS_PER_SM = 4
H100_SMEM_PER_SM = 233_472
# A block marches over several slabs only where one slab per block would
# take more than this many waves of resident blocks: on an H100 at 129^3 the
# float32 weights' blocks (2 per SM, 3.9 waves) ran fastest marching over 4
# slabs, the bf16 weights' (4 per SM, 1.9 waves) with one slab each, the
# distorted Q2 cube's (one wave) with one (PERF.md)
RESTRICT_MAX_WAVES = 2


class RestrictPlan(NamedTuple):
    """K4's launch (csrc/structured_transfer.cu struct RestrictPlan, in
    order): block (az0 / nzc, ay0 / nay, ax0 / nax) owns the agglomerates
    ay0 + [0, nay) x ax0 + [0, nax) of the slabs az0 + [0, nzc) (each ragged
    at the grid's end) and marches over the slabs; vec: 4 agglomerates per
    thread item (16- or 8-byte copies of W); ``threads`` per block; the x
    ring (wz planes, wz + wz - 1 where a block marches) ring[slot][row][q]
    [k] (q the column's phase mod sx, k the column div sx, k stride nax + 1)
    at odd row stride ``rowstride``; ``red_lanes`` lanes per output in the
    final sum over the window rows (lane l adds rows l, l + red_lanes, ..
    in order, then a butterfly); ``blocks``; the two W tiles of ``wtile``
    bytes from byte ``off_w``, the partial sums part[r][ayl, axl, e] from
    byte ``off_part``, ``smem_bytes`` in all."""
    nay: int
    nax: int
    nzc: int
    vec: int
    threads: int
    rowstride: int
    red_lanes: int
    blocks: int
    off_w: int
    wtile: int
    off_part: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=None)
def restrict_plan(window_shape, agg_shape, c: int, vec: bool, weight_bytes: int = 4,
                  n_sm: int = cl.H100_SMS, nzc=None) -> RestrictPlan:
    """Plan K4's blocks: a row of agglomerates per block where the slabs'
    rows give the card at least one block per SM (129^3: 32 x 32 rows), else
    rows cut into runs of a multiple of the item width until they do (the Q2
    cube: 8 x 8 rows of 8, cut in halves: 128 blocks); more rows per block
    while RESTRICT_BLOCKS_PER_SM blocks per SM remain; then, where one slab
    per block would take more than RESTRICT_MAX_WAVES waves of resident
    blocks, as many slabs per block as keep every block resident at once
    (129^3 with float32 W: 4 slabs, 256 blocks of 92 KB, 2 per SM; with
    bf16 W one slab, 1,024 blocks of 51 KB, 4 per SM, 1.9 waves), so that
    each block's pipeline of copies runs over several slabs.  A thread item is one window row of V
    sites (every component), so a site's window rows (wz * wy: 25 or 81)
    spread over threads; the final sums over them take as many lanes per
    output as the block's threads allow.  ``nzc``: slabs per block in place
    of the rule's (the measurement scripts' A/B of the marching)."""
    (wz, wy, wx), (gz, gy, gx) = window_shape, agg_shape
    V = 4 if vec else 1
    if vec and gx % 4:
        raise ValueError(f"K4's 16-byte form needs gx % 4 == 0, got gx = {gx}")
    R, sy, sx = wz * wy, wy - 1, wx - 1

    def layout(nay, nax, nzc):
        rowstride = sx * (nax + 1) | 1
        nring = wz + wz - 1 if nzc > 1 else wz
        off_w = _r16(4 * nring * (nay * sy + 1) * rowstride)
        wtile = _r16(weight_bytes * c * R * wx * nay * nax)
        off_part = off_w + 2 * wtile
        return rowstride, off_w, wtile, off_part, off_part + 4 * R * nay * nax * c

    def blocks(nay, nax, nzc=1):
        return _cdiv(gz, nzc) * _cdiv(gy, nay) * _cdiv(gx, nax)

    def threads(nay, nax):
        return min(RESTRICT_MAX_THREADS, _cdiv(nay * (nax // V) * R, 32) * 32)

    nax = gx
    while blocks(1, nax) < n_sm and nax > V:
        nax = max(V, _cdiv(_cdiv(nax, 2), V) * V)
    while layout(1, nax, 1)[-1] > RESTRICT_MAX_SMEM and nax > V:
        nax = max(V, _cdiv(_cdiv(nax, 2), V) * V)
    if layout(1, nax, 1)[-1] > RESTRICT_MAX_SMEM:
        raise ValueError(f"K4's block for windows {window_shape} and c = {c} "
                         f"exceeds {RESTRICT_MAX_SMEM} bytes of shared memory")
    nay = 1
    while (nay < gy and blocks(nay + 1, nax) >= RESTRICT_BLOCKS_PER_SM * n_sm
           and layout(nay + 1, nax, 1)[-1] <= RESTRICT_MAX_SMEM
           and (nay + 1) * (nax // V) * R <= RESTRICT_MAX_THREADS):
        nay += 1
    nt = threads(nay, nax)

    def per_sm(smem):
        return max(1, min(H100_SMEM_PER_SM // (smem + 1024), 2048 // nt))

    if nzc is None:
        nzc, smem2 = 1, layout(nay, nax, 2)[-1]
        if (blocks(nay, nax) > RESTRICT_MAX_WAVES * per_sm(layout(nay, nax, 1)[-1]) * n_sm
                and smem2 <= RESTRICT_MAX_SMEM):
            nzc = min(gz, _cdiv(blocks(nay, nax), per_sm(smem2) * n_sm))
    rowstride, off_w, wtile, off_part, smem = layout(nay, nax, nzc)
    # lanes per output: a power of two <= 32, as many as the threads allow
    n_out, red = nay * nax * c, 1
    while red < 32 and 2 * red * n_out <= nt:
        red *= 2
    return RestrictPlan(nay, nax, nzc, int(vec), nt, rowstride, red,
                        blocks(nay, nax, nzc), off_w, wtile, off_part, smem)


def restrict_vec(W, c: int, gx: int) -> bool:
    """K4 takes 4 agglomerates per item (16- or 8-byte copies of W) where gx
    is a multiple of 4, 1 <= c <= 4 and W starts on 16 bytes."""
    return gx % 4 == 0 and 1 <= c <= 4 and W.data_ptr() % 16 == 0


def _window_index(a: int, w: int, device) -> torch.Tensor:
    """Grid index a * (w - 1) + t of window (a, t) along one axis, in (a, t)
    order: the nonzero columns of the reference's 0/1 selection matrix."""
    return (torch.arange(a, device=device)[:, None] * (w - 1)
            + torch.arange(w, device=device)).reshape(-1)


def _specs(dim: int):
    """einsum subscripts of W (e, window, agglomerate) and of the windows in
    their interleaved (u, i, v, j, w, k) order."""
    return ("e" + _LT[:dim] + _LB[:dim],
            "".join(_LB[d] + _LT[d] for d in range(dim)))


# ------------------------------------------------------------ plain versions

def structured_restrict_plain(W, x, window_shape, agg_shape, grid_shape):
    """Plain K4: per-axis gathers cut the windows out of the grid (the
    reference's selection matmuls), one einsum contracts them with W (in
    x's dtype)."""
    dim = len(agg_shape)
    t = x.reshape(grid_shape)
    for d, (a, w) in enumerate(zip(agg_shape, window_shape)):
        t = t.index_select(d, _window_index(a, w, x.device))
    shape = []
    for d in range(dim):
        shape += [agg_shape[d], window_shape[d]]
    ws, xs = _specs(dim)
    return torch.einsum(f"{ws},{xs}->{_LB[:dim]}e", W.to(x.dtype),
                        t.reshape(shape)).reshape(-1)


def structured_prolong_plain(W, xc, window_shape, agg_shape, grid_shape):
    """Plain K5: the adjoint chain, one einsum into the windows, then
    per-axis scatter-adds overlap-add them onto the grid."""
    dim = len(agg_shape)
    xcg = xc.reshape(tuple(agg_shape) + (W.shape[0],))
    ws, xs = _specs(dim)
    t = torch.einsum(f"{ws},{_LB[:dim]}e->{xs}", W.to(xc.dtype), xcg)
    t = t.reshape(tuple(a * w for a, w in zip(agg_shape, window_shape)))
    for d, (a, w, g) in enumerate(zip(agg_shape, window_shape, grid_shape)):
        shape = list(t.shape)
        shape[d] = g
        t = t.new_zeros(shape).index_add_(d, _window_index(a, w, xc.device), t)
    return t.reshape(-1)


# ------------------------------------------------------------------ wrappers

def structured_restrict(W, x, window_shape, agg_shape, grid_shape):
    """K4: the coarse vector (site-major, gz*gy*gx*c) of the fine x."""
    n_c = _check(W, x, window_shape, agg_shape, grid_shape, coarse=False)
    if x.device.type == "cpu":
        return structured_restrict_plain(W, x, window_shape, agg_shape,
                                         grid_shape)
    out = torch.empty(n_c, dtype=torch.float32, device=x.device)
    _launch("structured_restrict", W, x, out, window_shape, agg_shape,
            grid_shape)
    return out


def structured_prolong(W, xc, window_shape, agg_shape, grid_shape):
    """K5: the fine vector R^T xc."""
    _check(W, xc, window_shape, agg_shape, grid_shape, coarse=True)
    if xc.device.type == "cpu":
        return structured_prolong_plain(W, xc, window_shape, agg_shape,
                                        grid_shape)
    y = torch.empty(_sizes(tuple(window_shape), tuple(agg_shape),
                           tuple(grid_shape), W.shape[0])[1],
                    dtype=torch.float32, device=xc.device)
    _launch("structured_prolong", W, xc, y, window_shape, agg_shape,
            grid_shape)
    return y


@functools.lru_cache(maxsize=None)
def _sizes(window_shape, agg_shape, grid_shape, c):
    """(coarse length, fine length) of a valid 3-D geometry; raises
    otherwise.  Cached: the checks cost the host more than a launch."""
    if not (len(window_shape) == len(agg_shape) == len(grid_shape) == 3):
        raise ValueError(f"the transfer kernels take 3-D grids, got "
                         f"{grid_shape}")
    if any(w < 2 or g != a * (w - 1) + 1
           for w, a, g in zip(window_shape, agg_shape, grid_shape)):
        raise ValueError(f"windows {window_shape} at stride w - 1 over "
                         f"agglomerates {agg_shape} do not tile the grid "
                         f"{grid_shape}")
    return c * int(np.prod(agg_shape)), int(np.prod(grid_shape))


def _check(W, v, window_shape, agg_shape, grid_shape, coarse: bool) -> int:
    """Shapes, dtypes, contiguity and devices; returns the coarse length."""
    geom = tuple(window_shape), tuple(agg_shape), tuple(grid_shape)
    n_c, n_f = _sizes(*geom, W.shape[0])
    want_w = (W.shape[0],) + geom[0] + geom[1]
    if (W.dtype not in (torch.float32, torch.bfloat16)
            or W.shape != want_w or not W.is_contiguous()):
        raise ValueError(f"W must be contiguous float32/bfloat16 {want_w}, "
                         f"got {W.dtype} {tuple(W.shape)}")
    n = n_c if coarse else n_f
    if v.dtype != torch.float32 or v.shape != (n,) or not v.is_contiguous():
        raise ValueError(f"the vector must be contiguous float32 ({n},), got "
                         f"{v.dtype} {tuple(v.shape)}")
    if W.device != v.device or v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"W on {W.device}, vector on {v.device}")
    if W.numel() >= 2 ** 31:
        raise ValueError(f"{W.numel()} weights exceed the kernels' limit (2^31)")
    return n_c


# the C entry points (csrc/structured_transfer.cu): bf16 flag, W, source,
# destination, the geometry table, then K4's plan or K5's SM count
_vp, _i, _ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_ENTRIES = {"structured_restrict": cl.Entry("mfmg_structured_restrict", _i, _vp,
                                            _vp, _vp, _ip, _ip),
            "structured_prolong": cl.Entry("mfmg_structured_prolong", _i, _vp,
                                           _vp, _vp, _ip, _i)}


def _launch(name, W, src, dst, window_shape, agg_shape, grid_shape, plan=None):
    """K4 (with its plan: restrict_plan's unless given) or K5 (with the
    card's SM count, which sizes its blocks)."""
    geom = (*grid_shape, *agg_shape, *window_shape, W.shape[0])
    dev = dst.get_device()
    n_sm = cl.sm_count(dev)
    if name == "structured_prolong":
        extra = n_sm
    else:
        c, gx = W.shape[0], agg_shape[-1]
        if plan is None:
            plan = restrict_plan(tuple(window_shape), tuple(agg_shape), c,
                                 restrict_vec(W, c, gx), W.element_size(), n_sm)
        extra = cl.int_table(plan)
    cl.launch(_ENTRIES[name], name, dev, int(W.dtype == torch.bfloat16),
              W.data_ptr(), src.data_ptr(), dst.data_ptr(), cl.int_table(geom),
              extra)


def _restrict_with_plan(plan: RestrictPlan, W, x, window_shape, agg_shape,
                        grid_shape):
    """K4 on a CUDA tensor through a given plan (the card tests' plans of
    other SM counts, the measurement scripts' variants); the kernel refuses
    a plan that does not hold its geometry."""
    n_c = _check(W, x, window_shape, agg_shape, grid_shape, coarse=False)
    if x.device.type != "cuda":
        raise ValueError("a K4 plan is launched on a CUDA tensor only")
    out = torch.empty(n_c, dtype=torch.float32, device=x.device)
    _launch("structured_restrict", W, x, out, window_shape, agg_shape,
            grid_shape, plan)
    return out
