"""Block-stencil operator: coarse AMGe levels on structured agglomerate grids.

Port of mfmg_tpu/ops/block_stencil.py.  The Galerkin coarse operator of a
block-agglomerated structured mesh is itself structured: coarse dofs
(agglomerate, eigenvector) live on the agglomerate grid and couple only to
the 3^dim neighbouring agglomerates, so A_c is a stencil of (n_comp x
n_comp) blocks.  The apply is a padded slice-sum of per-offset block
products (the reference used one conv_general_dilated_patches + einsum).

Coarse vector layout matches ops/structured_transfer.py: flat index =
e + n_comp * (ax + nax*(ay + nay*az)), a C-order (az, ay, ax, e) array.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn


class BlockStencilOperator(nn.Module):
    """coeffs: (n_offsets,) + agg_shape + (n_comp, n_comp), only the offsets
    with a nonzero block; offsets (z..x shifts) and agg_shape static."""

    def __init__(self, coeffs: torch.Tensor, offsets, agg_shape, n_comp: int,
                 radius: int = 1):
        super().__init__()
        self.register_buffer("coeffs", coeffs)
        self.offsets = tuple(tuple(int(c) for c in off) for off in offsets)
        self.agg_shape = tuple(int(a) for a in agg_shape)
        self.n_comp = int(n_comp)
        self.radius = int(radius)

    @property
    def shape(self):
        n = int(np.prod(self.agg_shape)) * self.n_comp
        return (n, n)

    def forward(self, x):
        return block_stencil_apply(self, x)


def block_stencil_apply(op: BlockStencilOperator, x: torch.Tensor) -> torch.Tensor:
    """y[s, e] = sum_o sum_f C_o[s, e, f] x[s + o, f], zero outside the grid."""
    return block_stencil_apply_coeffs(op.coeffs, op.offsets, op.agg_shape,
                                      op.n_comp, x, op.radius)


def block_stencil_apply_coeffs(coeffs, offsets, agg_shape, n_comp, x,
                               radius=1) -> torch.Tensor:
    """block_stencil_apply on bare (n_off,) + agg_shape + (n_comp, n_comp)
    coefficients, cast to x's dtype (the fused tail stores them in bf16)."""
    k, dim = radius, len(agg_shape)
    xg = x.reshape(tuple(agg_shape) + (n_comp,))
    xp = F.pad(xg, (0, 0) + (k, k) * dim)
    win = torch.stack([xp[tuple(slice(k + o, k + o + n)
                                for o, n in zip(off, agg_shape))]
                       for off in offsets])           # (n_off, *agg, n_comp)
    y = torch.einsum("o...ef,o...f->...e", coeffs.to(x.dtype), win)
    return y.reshape(x.shape)


def block_stencil_from_csr(A: sp.spmatrix, agg_shape: tuple, n_comp: int,
                           dtype=torch.float32, max_radius: int = 1):
    """Exact block-stencil extraction from the coarse CSR; None if entries
    fall outside the (2*max_radius+1)^dim neighbourhood."""
    dim = len(agg_shape)
    n_agg = int(np.prod(agg_shape))
    if A.shape[0] != n_agg * n_comp:
        return None
    A = sp.coo_matrix(A)
    dims_xyz = tuple(reversed(agg_shape))      # (nax, nay, naz)

    def decode(idx):
        e = idx % n_comp
        g = idx // n_comp
        mi = []
        rem = g.copy()
        for d in range(dim):                   # x first
            mi.append(rem % dims_xyz[d])
            rem //= dims_xyz[d]
        return e, np.stack(mi, axis=-1)

    er, mr = decode(A.row)
    ec, mc = decode(A.col)
    diff = mc - mr                             # x-first offsets
    if np.abs(diff).max(initial=0) > max_radius:
        return None
    offsets = list(itertools.product(*[range(-max_radius, max_radius + 1)] * dim))
    diff_rev = diff[:, ::-1]                   # z..x
    oid = np.zeros(len(A.data), dtype=np.int64)
    for d in range(dim):
        oid = oid * (2 * max_radius + 1) + (diff_rev[:, d] + max_radius)
    strides = np.cumprod((1,) + dims_xyz[:-1])
    g_flat = (mr * strides).sum(axis=1)        # x-fastest == C-order flat
    coeffs = np.zeros((len(offsets), n_agg, n_comp, n_comp))
    np.add.at(coeffs, (oid, g_flat, er, ec), A.data)
    coeffs = coeffs.reshape((len(offsets),) + tuple(agg_shape) + (n_comp, n_comp))
    nonzero = [i for i in range(len(offsets)) if np.any(coeffs[i])]
    return BlockStencilOperator(torch.from_numpy(coeffs[nonzero]).to(dtype),
                                tuple(offsets[i] for i in nonzero), agg_shape,
                                n_comp, radius=max_radius)
