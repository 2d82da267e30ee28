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
(``csrc/structured_transfer.cu``) gather the windows directly.  The TPU kernels' padded (c, gax, n_tiles*AZT*gay) layout and
their tiling geometry are not ported.

Each wrapper takes its plain version for a tensor on the CPU, launches its
kernel for a CUDA tensor, and raises on anything else; each launch counts in
``stencil_kernels.LAUNCHES``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mfmg_torch.ops import stencil_kernels

_LT, _LB = "ijk", "uvw"


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


@functools.lru_cache(maxsize=None)
def _geom_table(geom):
    return stencil_kernels._ints(geom)


def _launch(name, W, src, dst, window_shape, agg_shape, grid_shape):
    """K4 or K5; K5 also takes the card's SM count, which sizes its blocks."""
    geom = (*grid_shape, *agg_shape, *window_shape, W.shape[0])
    lib = stencil_kernels._library()
    sms = (stencil_kernels._sm_count(dst.device),) if name == "structured_prolong" else ()
    with torch.cuda.device(dst.device):
        err = getattr(lib, f"mfmg_{name}")(
            int(W.dtype == torch.bfloat16), W.data_ptr(), src.data_ptr(),
            dst.data_ptr(), _geom_table(geom), *sms, stencil_kernels._stream(dst))
    stencil_kernels._raise_on(err, name)
    stencil_kernels.LAUNCHES[name] += 1
