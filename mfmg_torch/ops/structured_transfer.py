"""Gather-free restriction/prolongation for structured block agglomerates.

Port of mfmg_tpu/ops/structured_transfer.py.  On a structured grid with
uniform block agglomerates the AMGe restriction is a strided-window
operation: coarse dof (agglomerate a, eigenvector e) reads the fine window
starting at a*s of width s+1 (windows overlap by one node plane):

  restrict:  out[e, a] = sum_t W[e, t, a] * x[a*s + t]
  prolong:   y[a*s + t] += sum_e W[e, t, a] * xc[e, a]   (the exact adjoint)

A 3-D float32 transfer goes through the kernels K4/K5
(ops/transfer_kernels.py), counterparts of the reference's Pallas pair
pallas_restrict_tiled/pallas_prolong_tiled: on a CUDA tensor they launch
``csrc/structured_transfer.cu``, on a CPU tensor they run their plain
versions, the reference's per-axis window chain plus one contraction with
the weights (per-axis gathers and overlap-adds around a ``torch.einsum`` in
exact float32, TF32 off, see mfmg_torch/__init__.py).  Other dimensions and
float64 run the plain chain, as the reference runs XLA.

Coarser levels use ``GeneralWindowTransfer``: its dense matrix ``Rd`` below
DENSE_TRANSFER_MAX_ELEMS entries, its windowed form (strided unfolds and an
overlap-add adjoint, plain PyTorch) beyond that cap (129^3 fine grids).
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from mfmg_torch.ops import transfer_kernels

# Dense-transfer size cap (entries): below it the coarse-level transfer is a
# dense matrix and both directions are one matvec (mfmg_tpu 2fcbb18).
DENSE_TRANSFER_MAX_ELEMS = 16_000_000


class StructuredTransfer(nn.Module):
    """W: (n_ev,) + window_shape + agg_shape weights (C-order, z..x axes);
    window_shape = s+1 per axis, agg_shape = blocks per axis, grid_shape =
    s*agg+1 per axis.  Coarse layout: C-order (az, ay, ax, e)."""

    def __init__(self, W: torch.Tensor, window_shape, agg_shape, grid_shape):
        super().__init__()
        self.window_shape = tuple(int(v) for v in window_shape)
        self.agg_shape = tuple(int(v) for v in agg_shape)
        self.grid_shape = tuple(int(v) for v in grid_shape)
        self.register_buffer("W", W)

    @property
    def n_ev(self):
        return self.W.shape[0]

    @property
    def shape(self):
        return (self.n_ev * int(np.prod(self.agg_shape)),
                int(np.prod(self.grid_shape)))

    def _kernel_case(self, v) -> bool:
        return (len(self.grid_shape) == 3 and v.dtype == torch.float32
                and self.W.dtype in (torch.float32, torch.bfloat16))

    def restrict(self, x):
        fn = (transfer_kernels.structured_restrict if self._kernel_case(x)
              else transfer_kernels.structured_restrict_plain)
        return fn(self.W, x, self.window_shape, self.agg_shape, self.grid_shape)

    def prolong(self, xc):
        fn = (transfer_kernels.structured_prolong if self._kernel_case(xc)
              else transfer_kernels.structured_prolong_plain)
        return fn(self.W, xc, self.window_shape, self.agg_shape, self.grid_shape)


class GeneralWindowTransfer(nn.Module):
    """Windowed transfer between two structured block grids with components
    (AMGe levels >= 1): window offsets t in [t0, t0+w) per axis with stride
    s.  W : (n_out,) + window_shape + (n_in,) + out_grid.  Below the dense
    cap the transfer is applied through its dense copy Rd (n_out_total,
    n_in_total): restrict = Rd x, prolong = Rd^T xc; without Rd, through
    the windowed form."""

    def __init__(self, W: torch.Tensor, window_shape, t0, stride, in_grid,
                 out_grid, n_in: int, n_out: int, Rd: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("W", W)
        self.register_buffer("Rd", Rd)
        self.window_shape = tuple(window_shape)
        self.t0 = tuple(t0)
        self.stride = tuple(stride)
        self.in_grid = tuple(in_grid)
        self.out_grid = tuple(out_grid)
        self.n_in = int(n_in)
        self.n_out = int(n_out)

    def restrict(self, x):
        if self.Rd is not None:
            return self.Rd @ x
        return _gwt_restrict(self, x)

    def prolong(self, xc):
        if self.Rd is not None:
            return xc @ self.Rd
        return _gwt_prolong(self, xc)


def _gwt_pads(tr: GeneralWindowTransfer):
    """Per-axis (lo, hi) padding of the input grid so that the windows at
    block positions S*stride + t0 + [0, w) tile it exactly (hi may be
    negative: a crop)."""
    return [(-tr.t0[d],
             tr.t0[d] + tr.window_shape[d] - 1
             + tr.stride[d] * (tr.out_grid[d] - 1) - (tr.in_grid[d] - 1))
            for d in range(len(tr.in_grid))]


def _gwt_restrict(tr: GeneralWindowTransfer, x):
    """Windowed restriction out[S, e] = sum_{t, f} W[e, t, f, S] x[S*s + t0
    + t, f]: every window through strided unfolds of the padded grid, then
    one contraction (the reference used one conv_general_dilated_patches)."""
    dim = len(tr.in_grid)
    pads = _gwt_pads(tr)
    flat = [0, 0]                          # the component axis is not padded
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    p = torch.nn.functional.pad(x.reshape(tr.in_grid + (tr.n_in,)), flat)
    for d in range(dim):
        p = p.unfold(d, tr.window_shape[d], tr.stride[d])
    # p: (*out_grid, n_in, *window); W: (n_out, *window, n_in, *out_grid)
    w, o = "abc"[:dim], "zyx"[:dim]
    return torch.einsum(f"e{w}f{o},{o}f{w}->{o}e", tr.W, p).reshape(-1)


def _gwt_prolong(tr: GeneralWindowTransfer, xc, between=None):
    """Exact adjoint of _gwt_restrict: per-window contributions, then an
    overlap-add over the window offsets into the padded grid, first over
    every axis but the last, then over the last.  ``between`` (identity by
    default) maps the partial sums between the two stages: the reduced
    fused tail rounds them to bf16 there, as the reference does."""
    dim, lead = len(tr.in_grid), len(tr.in_grid) - 1
    pads = _gwt_pads(tr)
    w, o = "abc"[:dim], "zyx"[:dim]
    C = torch.einsum(f"e{w}f{o},{o}e->{o}f{w}", tr.W,
                     xc.reshape(tr.out_grid + (tr.n_out,)))

    def rows(d, t):
        return slice(t, t + tr.stride[d] * (tr.out_grid[d] - 1) + 1, tr.stride[d])

    padded = tuple(n + lo + hi for n, (lo, hi) in zip(tr.in_grid, pads))
    wl = tr.window_shape[-1]
    P = xc.new_zeros(padded[:lead] + (tr.out_grid[-1], tr.n_in, wl))
    for t in itertools.product(*[range(k) for k in tr.window_shape[:lead]]):
        P[tuple(rows(d, t[d]) for d in range(lead))] += \
            C[(Ellipsis,) + t + (slice(None),)]
    P = _unpad(P, pads[:lead], tr.in_grid[:lead])
    if between is not None:
        P = between(P)
    Y = xc.new_zeros(tr.in_grid[:lead] + (padded[-1], tr.n_in))
    for t in range(wl):
        Y[(slice(None),) * lead + (rows(lead, t),)] += P[..., t]
    return _unpad(Y, [(0, 0)] * lead + [pads[-1]], tr.in_grid).reshape(-1)


def _unpad(yp, pads, sizes):
    """yp with its leading len(sizes) axes, padded by pads[d] = (lo, hi),
    cut back to sizes (zeros where a negative hi cropped the grid)."""
    src = tuple(slice(lo, min(P, lo + n))
                for (lo, _), P, n in zip(pads, yp.shape, sizes))
    y = yp.new_zeros(tuple(sizes) + tuple(yp.shape[len(sizes):]))
    y[tuple(slice(0, s.stop - s.start) for s in src)] = yp[src]
    return y


def general_window_transfer_from_csr(R_l, in_grid, n_in, out_grid, n_out,
                                     stride, dtype=torch.float32,
                                     max_halo: int = 1):
    """Build a GeneralWindowTransfer from a CSR level-l restriction: decode
    every entry into (super S, e_out) x (block B, e_in), t = B - S*stride in
    [-max_halo, stride + max_halo); None when the sparsity does not fit."""
    dim = len(in_grid)
    A = sp.coo_matrix(R_l)
    dims_in_xyz = tuple(reversed(in_grid))
    dims_out_xyz = tuple(reversed(out_grid))
    if A.shape != (int(np.prod(out_grid)) * n_out, int(np.prod(in_grid)) * n_in):
        return None

    def decode(idx, n_comp, dims_xyz):
        e = idx % n_comp
        g = idx // n_comp
        mi = []
        rem = g.copy()
        for d in range(dim):
            mi.append(rem % dims_xyz[d])
            rem //= dims_xyz[d]
        return e, np.stack(mi, axis=-1)      # x-first coords

    e_out, S = decode(A.row, n_out, dims_out_xyz)
    e_in, B = decode(A.col, n_in, dims_in_xyz)
    stride_xyz = tuple(reversed(stride))
    t = B - S * np.array(stride_xyz)
    t0_xyz = tuple(-max_halo for _ in range(dim))
    w_xyz = tuple(stride_xyz[d] + 2 * max_halo for d in range(dim))
    if np.any(t < np.array(t0_xyz)) or np.any(t >= np.array(t0_xyz) + np.array(w_xyz)):
        return None

    window_shape = tuple(reversed(w_xyz))
    t_rev = (t - np.array(t0_xyz))[:, ::-1]            # z..x window index
    out_flat = (S * np.cumprod((1,) + dims_out_xyz[:-1])).sum(axis=1)
    W = np.zeros((n_out,) + window_shape + (n_in, int(np.prod(out_grid))))
    tidx = tuple(t_rev[:, d] for d in range(dim))
    np.add.at(W, (e_out,) + tidx + (e_in, out_flat), A.data)
    W = W.reshape((n_out,) + window_shape + (n_in,) + tuple(out_grid))
    Rd = None
    if R_l.shape[0] * R_l.shape[1] <= DENSE_TRANSFER_MAX_ELEMS:
        Rd = torch.from_numpy(np.asarray(sp.csr_matrix(R_l).todense())).to(dtype)
    return GeneralWindowTransfer(
        torch.from_numpy(W).to(dtype), window_shape,
        tuple(reversed(t0_xyz)), tuple(reversed(stride_xyz)),
        in_grid, out_grid, n_in, n_out, Rd=Rd)


def structured_transfer_from_batch(mesh, batch, evecs, global_diag,
                                   dtype=torch.float32):
    """Windowed-weight transfer from the structured agglomerate batch (same
    math as amge.restriction.build_restriction: W = PoU weight x
    eigenvector); None when the blocks are not uniform windows."""
    if not mesh.is_structured:
        return None
    dim, k = mesh.dim, mesh.degree
    nc = np.asarray(mesh.structured_shape)
    n_agg, m, n_ev = evecs.shape
    if not np.all(batch.valid):
        return None
    n1 = nc * k + 1
    rem = batch.dof_map[0].copy()
    coords = []
    for d in range(dim):
        coords.append(rem % n1[d])
        rem = rem // n1[d]
    coords = np.stack(coords, axis=-1)
    wdims = coords.max(axis=0) - coords.min(axis=0) + 1   # window per axis, x first
    if int(np.prod(wdims)) != m:
        return None
    strides = wdims - 1
    if np.any(strides < 1) or np.any((n1 - 1) % strides):
        return None
    na = (n1 - 1) // strides                              # aggs per axis, x first
    if int(np.prod(na)) != n_agg:
        return None

    w = batch.diag / global_diag[batch.dof_map]
    Wfull = w[:, :, None] * evecs                         # (n_agg, m, n_ev)
    Wfull = Wfull.reshape(tuple(na[::-1]) + tuple(wdims[::-1]) + (n_ev,))
    # (az, ay, ax, tz, ty, tx, e) -> (e, tz, ty, tx, az, ay, ax)
    Wfull = np.moveaxis(Wfull, -1, 0)
    Wfull = np.moveaxis(Wfull, list(range(1 + dim, 1 + 2 * dim)),
                        list(range(1, 1 + dim)))
    return StructuredTransfer(torch.from_numpy(np.ascontiguousarray(Wfull)).to(dtype),
                              window_shape=tuple(int(v) for v in wdims[::-1]),
                              agg_shape=tuple(int(v) for v in na[::-1]),
                              grid_shape=tuple(int(v) for v in n1[::-1]))
