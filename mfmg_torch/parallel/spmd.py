"""The slab/pencil-sharded V-cycle over ``torch.distributed``.

Port of mfmg_tpu/parallel/spmd.py (the analog of the reference's MPI domain
decomposition with ghost exchange).  The structured fine node grid is split
over the ranks of a ``Mesh`` (parallel/process.py): z-slabs for a mesh of
shape (P,), (z, y) pencils for (Pz, Py).  Each rank holds one block of the
grid, and every fine stencil apply first exchanges the k boundary planes
with both neighbours, per sharded axis in sequence (the second exchange
carries the first axis's halo along, which covers the corners).

Layout, as in the reference: every sharded axis is padded to P_d *
ceil(na_d / P_d) agglomerate windows of s_d planes (one more round of P_d
windows where the last real plane would not fit), so every rank holds an
identical, window-aligned block of n_loc_d = (npad_d / P_d) * s_d planes.
Padded planes carry zero coefficients, zero smoother diagonals and zero
restriction weights, so padded dofs stay exactly zero.

The per-rank work runs the port's kernels, each on a tensor of the rank's
device (plain versions on the CPU):

* apply: K1 (``stencil_apply_sym``; K3 ``stencil_apply`` for a one-sided
  operator) on the rank's halo-extended block (n_loc_d + 2k per sharded
  axis), over planes sliced once, at build time, from the global planes
  with k extra planes on each sharded side.  K1 reads C_{-o}[i] = C_o[i-o],
  so every interior point reads only planes inside the extended block; the
  interior output planes are kept.  A one-sided operator's halo rows are
  zero.
* restriction: one plane per sharded axis from the block above, then K4
  (``structured_restrict``) on the (n_loc_d + 1)-plane block with the
  rank's contiguous slice of W, which is exactly K4's geometry g = a (w - 1)
  + 1; the coarse pieces are all-gathered, the padded agglomerates trimmed,
  and the result ordered (a_z, [a_y,] ..., e) as the reference orders it.
* prolongation: the explicit adjoint of that restriction: K5
  (``structured_prolong``) onto the rank's (n_loc_d + 1)-plane block, then
  each extra plane sent to the neighbour that owns it and added there, the
  axes undone in reverse order so that the corners arrive.
* smoother: Chebyshev (from theta, delta and degree of the unfused level-0
  smoother, ``Hierarchy._unfused_smoother0`` where the card fused it) and
  Jacobi, spelled out around the sharded apply as the reference does; K2's
  fused step is not used, since its inner applies would need a halo per
  step.
* levels >= 1: replicated on every rank's device, through the port's
  generic ``_cycle`` (the fused coarse tail is not used, as in the
  reference).

K4/K5 take 3-D grids only, so a 2-D grid's transfer takes their plain
versions on either device (the reference's 2-D runs); on the 3-D main path
every transfer launches the kernels.  ``Mesh.stats`` counts the halo
exchanges and the halo and gather bytes; ``cuda_library.LAUNCHES`` the
kernels.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from mfmg_torch.parallel.process import Mesh, all_gather, sendrecv


class SpmdVcycle:
    """The sharded V-cycle on one rank: ``fn(b_loc, x_loc) -> x_loc`` over
    this rank's blocks of the padded grid ``grid_shape`` (``block`` the
    block's slices); ``to_grid`` cuts this rank's block out of a full
    vector, ``from_grid`` gathers the blocks into the full vector on every
    rank."""

    def __init__(self, mesh, grid_shape, orig_grid, block, dtype, fn):
        self.mesh = mesh
        self.grid_shape = tuple(grid_shape)
        self.orig_grid = tuple(orig_grid)
        self.block = tuple(block)
        self.dtype = dtype
        self.fn = fn

    def to_grid(self, v_flat) -> torch.Tensor:
        v = torch.as_tensor(np.asarray(v_flat) if not isinstance(
            v_flat, torch.Tensor) else v_flat)
        g = _window(v.reshape(self.orig_grid), 0,
                    [s.start for s in self.block],
                    [s.stop - s.start for s in self.block])
        return g.to(device=self.mesh.device, dtype=self.dtype).contiguous()

    def from_grid(self, g_loc) -> torch.Tensor:
        full = _assemble(self.mesh, all_gather(self.mesh, g_loc), 0,
                         [s.stop - s.start
                          for s in self.block[:len(self.mesh.shape)]])
        return full[tuple(slice(0, o) for o in self.orig_grid)].reshape(-1)


def _window(arr, lead, starts, sizes):
    """arr's block [starts[d], starts[d] + sizes[d]) along the axes lead + d,
    zero where it leaves arr."""
    nd = len(sizes)
    out = arr.new_zeros(tuple(arr.shape[:lead]) + tuple(sizes)
                        + tuple(arr.shape[lead + nd:]))
    src, dst = [slice(None)] * lead, [slice(None)] * lead
    for d, (s, n) in enumerate(zip(starts, sizes)):
        lo, hi = max(s, 0), min(s + n, arr.shape[lead + d])
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def _assemble(mesh, parts, lead, sizes):
    """The ranks' blocks (rank order, each ``sizes`` along the axes lead + d)
    placed side by side in the mesh's C order."""
    nd = len(sizes)
    shape = list(parts[0].shape)
    for d in range(nd):
        shape[lead + d] = sizes[d] * mesh.shape[d]
    out = parts[0].new_empty(shape)
    for r, p in enumerate(parts):
        c = np.unravel_index(r, mesh.shape)
        idx = [slice(None)] * lead + [slice(int(c[d]) * sizes[d],
                                            (int(c[d]) + 1) * sizes[d])
                                      for d in range(nd)]
        out[tuple(idx)] = p
    return out


def _halo_pair(mesh, arr, width, axis):
    """arr with both neighbours' boundary planes appended along ``axis``
    (zeros at the ends of the grid)."""
    n = arr.shape[axis]
    lo_nb, hi_nb = mesh.neighbor(axis, -1), mesh.neighbor(axis, +1)
    top = arr.narrow(axis, n - width, width).contiguous()      # to the rank above
    bottom = arr.narrow(axis, 0, width).contiguous()           # to the rank below
    below, above = torch.zeros_like(top), torch.zeros_like(bottom)
    sends, recvs = [], []
    if hi_nb is not None:
        sends.append((hi_nb, top))
        recvs.append((hi_nb, above))
    if lo_nb is not None:
        sends.append((lo_nb, bottom))
        recvs.append((lo_nb, below))
    sendrecv(mesh, sends, recvs)
    return torch.cat([below, arr, above], dim=axis)


def _plane_from_above(mesh, arr, axis):
    """arr with the first plane of the block above appended along ``axis``
    (zeros on the last rank)."""
    lo_nb, hi_nb = mesh.neighbor(axis, -1), mesh.neighbor(axis, +1)
    first = arr.narrow(axis, 0, 1).contiguous()
    above = torch.zeros_like(first)
    sendrecv(mesh, [] if lo_nb is None else [(lo_nb, first)],
             [] if hi_nb is None else [(hi_nb, above)])
    return torch.cat([arr, above], dim=axis)


def _plane_to_above(mesh, arr, axis):
    """The adjoint of _plane_from_above: the last plane along ``axis`` sent
    to the rank above and added to its first plane; arr without it."""
    lo_nb, hi_nb = mesh.neighbor(axis, -1), mesh.neighbor(axis, +1)
    n = arr.shape[axis] - 1
    last = arr.narrow(axis, n, 1).contiguous()
    below = torch.zeros_like(last)
    sendrecv(mesh, [] if hi_nb is None else [(hi_nb, last)],
             [] if lo_nb is None else [(lo_nb, below)])
    out = arr.narrow(axis, 0, n).contiguous()
    if lo_nb is not None:
        out.narrow(axis, 0, 1).add_(below)
    return out


def build_spmd_vcycle(hier, mesh: Mesh, mesh_shape=None) -> SpmdVcycle:
    """The sharded V-cycle of a stencil-path hierarchy (Config(operator=
    "stencil") with a structured level-0 transfer and the direct coarse
    solver) on this rank; every rank of ``mesh`` calls it.  ``hier`` is a
    Hierarchy (or any object with ``levels`` and ``config``) on any device:
    this rank's blocks and the replicated levels >= 1 are copied to
    ``mesh.device`` once, here.  mesh_shape: (P,) slabs (the default, the
    mesh's own shape) or (Pz, Py) pencils over the same ranks."""
    from mfmg_torch.amge.hierarchy import _cycle
    from mfmg_torch.ops.stencil import StencilOperator, _gather_planes, stencil_apply
    from mfmg_torch.ops.structured_transfer import StructuredTransfer
    from mfmg_torch.solve.coarse import DirectCoarseSolver
    from mfmg_torch.solve.smoothers import (ChebyshevSmoother, JacobiSmoother,
                                            _cheb_coeffs)

    lvl0 = hier.levels[0]
    if (not isinstance(lvl0.op, StencilOperator)
            or not isinstance(lvl0.transfer, StructuredTransfer)):
        raise ValueError("SPMD V-cycle needs the stencil operator + structured transfer")
    if not isinstance(hier.levels[-1].coarse, DirectCoarseSolver):
        raise ValueError("SPMD V-cycle needs the direct coarse solver")
    if mesh_shape is None:
        mesh_shape = mesh.shape
    mesh_shape = tuple(int(p) for p in mesh_shape)
    n_shard = len(mesh_shape)
    op, tr = lvl0.op, lvl0.transfer
    # the card's finalization swaps in the K2 smoother; the sharded cycle
    # spells out the polynomial itself, so it takes the unfused one
    sm = getattr(hier, "_unfused_smoother0", None) or lvl0.smoother
    dim = len(op.grid_shape)
    if dim not in (2, 3):
        raise ValueError("SPMD V-cycle supports 2D and 3D grids")
    if not (1 <= n_shard <= 2) or n_shard >= dim:
        raise ValueError(f"mesh_shape {mesh_shape} must shard 1..min(2, dim-1) axes")
    if int(np.prod(mesh_shape)) != mesh.size:
        raise ValueError("mesh_shape does not match the device count")
    if not isinstance(sm, (ChebyshevSmoother, JacobiSmoother)):
        raise ValueError("SPMD V-cycle supports Jacobi/Chebyshev smoothers")
    mesh = mesh.reshaped(mesh_shape)
    dev = mesh.device
    Pd = mesh_shape
    rest_grid = op.grid_shape[n_shard:]
    rest_agg = tr.agg_shape[n_shard:]
    k = max(max(abs(o) for o in off) for off in op.offsets)
    strides = tuple(w - 1 for w in tr.window_shape)

    # window-aligned padded layout per sharded axis (module docstring)
    na_pad, g_pad, na_loc, n_loc = [], [], [], []
    for d in range(n_shard):
        s_d, na_d, g_d = strides[d], tr.agg_shape[d], op.grid_shape[d]
        npad = Pd[d] * (-(-na_d // Pd[d]))
        if npad * s_d < g_d:                   # the last real plane must fit
            npad += Pd[d]
        na_pad.append(npad)
        g_pad.append(npad * s_d)
        na_loc.append(npad // Pd[d])
        n_loc.append((npad // Pd[d]) * s_d)
    c = mesh.coords
    lo = [c[d] * n_loc[d] for d in range(n_shard)]
    block = tuple(slice(lo[d], lo[d] + n_loc[d]) for d in range(n_shard))

    # this rank's operands, cut once and placed on its device
    ext_grid = tuple(n + 2 * k for n in n_loc) + rest_grid
    one_sided = op.sym_pos is None
    if one_sided:
        planes = _window(op.coeffs, 1, [v - k for v in lo],
                         [n + 2 * k for n in n_loc])
        interior = (slice(None),) + tuple(slice(k, k + n) for n in n_loc)
        halo_free = torch.zeros_like(planes)
        halo_free[interior] = planes[interior]
        op_loc = StencilOperator(halo_free.to(dev).contiguous(), op.offsets,
                                 ext_grid, None)
    else:
        full = op.planes if op.planes is not None else _gather_planes(op)
        op_loc = StencilOperator(None, op.offsets, ext_grid, op.sym_pos)
        op_loc.planes = _window(full, 1, [v - k for v in lo],
                                [n + 2 * k for n in n_loc]).to(dev).contiguous()
    inside = tuple(slice(k, k + n) for n in n_loc)
    inv_diag = _window(sm.inv_diag.reshape(op.grid_shape), 0, lo,
                       n_loc).to(dev).contiguous()
    agg_lo = [c[d] * na_loc[d] for d in range(n_shard)]
    tr_loc = StructuredTransfer(
        _window(tr.W, 1 + dim, agg_lo, na_loc).to(dev).contiguous(),
        tr.window_shape, tuple(na_loc) + rest_agg,
        tuple(n + 1 for n in n_loc) + rest_grid)
    levels_rest = nn.ModuleList(copy.deepcopy(list(hier.levels[1:]))).to(dev)
    dtype = sm.inv_diag.dtype
    agg_real = tuple(tr.agg_shape)

    # ------------------------------------------------------------- apply --
    def apply(x):
        x_ext = x
        for d in range(n_shard):
            x_ext = _halo_pair(mesh, x_ext, k, d)
        y = stencil_apply(op_loc, x_ext.reshape(-1)).reshape(ext_grid)
        return y[inside].contiguous()

    # --------------------------------------------------------- transfers --
    def restrict(x):
        x_ext = x
        for d in range(n_shard):
            x_ext = _plane_from_above(mesh, x_ext, d)
        part = tr_loc.restrict(x_ext.reshape(-1)).reshape(tr_loc.agg_shape + (-1,))
        full = _assemble(mesh, all_gather(mesh, part), 0, na_loc)
        # the real agglomerates only, (a_z, [a_y,] ..., e) flat order
        return full[tuple(slice(0, a) for a in agg_real)].reshape(-1)

    def prolong(xc):
        xcg = xc.reshape(agg_real + (-1,))
        mine = _window(xcg, 0, agg_lo, na_loc).reshape(-1)
        y = tr_loc.prolong(mine).reshape(tr_loc.grid_shape)
        for d in reversed(range(n_shard)):
            y = _plane_to_above(mesh, y, d)
        return y

    # ----------------------------------------------------------- smoother --
    if isinstance(sm, ChebyshevSmoother):
        alphas, betas = _cheb_coeffs(sm.theta, sm.delta, sm.degree)
        degree = sm.degree

        def smooth(b, x):
            # ChebyshevSmoother.apply term for term, on the blocks
            src = apply(x) - b
            r, p, xx = src, None, None
            for i in range(degree):
                z = inv_diag * r
                p = z if i == 0 else z + betas[i] * p
                xx = alphas[i] * p if i == 0 else xx + alphas[i] * p
                if i < degree - 1:
                    r = src - apply(xx)
            return x - xx
    else:
        omega = sm.omega

        def smooth(b, x):
            return x - omega * inv_diag * (apply(x) - b)

    n_smooth = hier.config.smoother.n_smoothing_steps
    cycle_type = hier.config.cycle_type

    def vcycle_fn(b, x):
        for _ in range(n_smooth):
            x = smooth(b, x)
        bc = restrict(apply(x) - b)
        xc = _cycle(levels_rest, bc, torch.zeros_like(bc), 0, n_smooth,
                    cycle_type)
        x = x - prolong(xc)
        for _ in range(n_smooth):
            x = smooth(b, x)
        return x

    grid_padded = tuple(g_pad) + rest_grid
    return SpmdVcycle(mesh, grid_padded, op.grid_shape,
                      block + tuple(slice(0, g) for g in rest_grid), dtype,
                      vcycle_fn)
