"""The row-sharded hierarchy: the fine level's rows split over the ranks.

Port of mfmg_tpu/parallel/sharding.py (the reference's Epetra row maps;
its CUDA path all-gathers the whole source vector per SpMV,
sparse_matrix_device.templates.cuh:104-138).  The fine level's rows are
padded to a multiple of the rank count and rank r owns rows [r m, (r+1) m);
a fine-level vector is the rank's m rows.  PyTorch has no GSPMD to insert
the collectives, so each sharded fine-level object is an ``nn.Module``
holding its own rows and doing its collectives inside:

* ``RowShardedELL``: all-gathers x, then computes its own rows;
* ``RowShardedMatrixFree``: computes its own range of cells on the
  gathered x, scatters them into the full vector, sums the ranks'
  vectors (in rank order, the same bits on every rank) and keeps its own
  rows;
* ``RowShardedTransfer``: R replicated, applied to the gathered residual;
  R^T keeps its own rows.

Smoother diagonals are sharded too, zero on the padded rows, so padded
dofs never move; R and every coarse level are replicated on each rank's
device (the reference gathers the coarse problem for the direct solve).
The port's unchanged V-cycle (``amge/hierarchy.py`` ``vcycle``) then runs
on row-sharded vectors.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from mfmg_torch.parallel.process import Mesh, all_gather, all_sum, make_mesh

__all__ = ["make_mesh", "padded_size", "shard_vector", "gather_vector",
           "unpad_vector", "shard_hierarchy"]


def padded_size(n: int, mesh: Mesh) -> int:
    k = mesh.size
    return ((n + k - 1) // k) * k


def _own(mesh: Mesh, n_pad: int) -> slice:
    m = n_pad // mesh.size
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


def _pad_rows(t: torch.Tensor, n_pad: int) -> torch.Tensor:
    if t.shape[0] == n_pad:
        return t
    return torch.cat([t, t.new_zeros((n_pad - t.shape[0],) + tuple(t.shape[1:]))])


def shard_vector(mesh: Mesh, v, n_pad: int | None = None) -> torch.Tensor:
    """This rank's rows of a fine-level vector padded to the sharded size,
    on the rank's device."""
    v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    n_pad = n_pad or padded_size(v.shape[0], mesh)
    return _pad_rows(v, n_pad)[_own(mesh, n_pad)].to(mesh.device).contiguous()


def gather_vector(mesh: Mesh, v_loc: torch.Tensor) -> torch.Tensor:
    """The whole padded vector from every rank's rows, on every rank."""
    return torch.cat(all_gather(mesh, v_loc))


def unpad_vector(v, n: int):
    return v[:n]


class RowShardedELL(nn.Module):
    """This rank's rows of an ELL matrix; ``gather``: its input is a
    row-sharded fine vector, gathered first (the operator), else a
    replicated one (R^T's coarse vector)."""

    def __init__(self, A, mesh: Mesh, n_pad: int, gather: bool = True):
        super().__init__()
        own = _own(mesh, n_pad)
        self.mesh = mesh
        self.gather = gather
        self.register_buffer("vals", _pad_rows(A.vals, n_pad)[own].contiguous())
        self.register_buffer("cols", _pad_rows(A.cols, n_pad)[own].contiguous())
        self.n_cols = int(A.n_cols)

    def forward(self, x):
        if self.gather:
            x = gather_vector(self.mesh, x)
        return (self.vals * x[self.cols]).sum(dim=1)


class RowShardedMatrixFree(nn.Module):
    """A MatrixFreeOperator (without hanging nodes) whose cells are split
    into one contiguous range per rank; see the module docstring."""

    def __init__(self, op, mesh: Mesh, n_pad: int):
        from mfmg_torch.ops.local_apply import incidence
        super().__init__()
        if op.hc_slaves is not None:
            raise ValueError("the row-sharded matrix-free apply takes meshes "
                             "without hanging nodes")
        bounds = np.linspace(0, op.cells.shape[0], mesh.size + 1).astype(int)
        cells = slice(int(bounds[mesh.rank]), int(bounds[mesh.rank + 1]))
        own = _own(mesh, n_pad)
        self.mesh = mesh
        self.register_buffer("cells", op.cells[cells].contiguous())
        for name in ("A_loc", "G", "scale"):
            t = getattr(op, name)
            self.register_buffer(name, None if t is None else t[cells].contiguous())
        self.register_buffer("inc", incidence(self.cells.cpu().numpy(), n_pad).to(
            op.cells.device))
        con = _pad_rows(op.constrained, n_pad)
        self.register_buffer("constrained_all", con)
        self.register_buffer("constrained", con[own].contiguous())
        self.register_buffer("diag", _pad_rows(op.diag, n_pad)[own].contiguous())

    def forward(self, u_loc):
        from mfmg_torch.ops.local_apply import gather_sum
        u = gather_vector(self.mesh, u_loc)
        uz = torch.where(self.constrained_all, torch.zeros_like(u), u)
        u_c = uz[self.cells]
        if self.A_loc is not None:
            y_c = torch.bmm(self.A_loc, u_c.unsqueeze(-1)).squeeze(-1)
        else:
            t = torch.einsum("cqdj,cj->cqd", self.G, u_c) * self.scale[..., None]
            y_c = torch.einsum("cqdi,cqd->ci", self.G, t)
        y = all_sum(self.mesh, gather_sum(y_c.reshape(-1), self.inc))
        y = y[_own(self.mesh, y.shape[0])]
        return torch.where(self.constrained, self.diag * u_loc, y)


class RowShardedTransfer(nn.Module):
    """The fine level's ELL transfer: R replicated (it reads the gathered
    residual), R^T's own rows."""

    def __init__(self, transfer, mesh: Mesh, n_pad: int):
        super().__init__()
        self.mesh = mesh
        self.R = transfer.R
        self.RT = RowShardedELL(transfer.RT, mesh, n_pad, gather=False)

    def restrict(self, x_loc):
        return self.R(gather_vector(self.mesh, x_loc))

    def prolong(self, xc):
        return self.RT(xc)


def shard_hierarchy(levels, mesh: Mesh):
    """The levels with the fine level row-sharded over ``mesh`` (ELL or
    matrix-free operator, Jacobi or Chebyshev smoother, ELL transfer) and
    every coarser level replicated, all on ``mesh.device``."""
    from mfmg_torch.amge.hierarchy import LevelData
    from mfmg_torch.ops.local_apply import MatrixFreeOperator
    from mfmg_torch.ops.sparse import ELLMatrix, ELLTransfer
    from mfmg_torch.solve.smoothers import ChebyshevSmoother, JacobiSmoother

    levels = [copy.deepcopy(lv).to(mesh.device) for lv in levels]
    lvl = levels[0]
    n_pad = padded_size(lvl.op.shape[0], mesh)
    if isinstance(lvl.op, ELLMatrix):
        op = RowShardedELL(lvl.op, mesh, n_pad)
    elif isinstance(lvl.op, MatrixFreeOperator):
        op = RowShardedMatrixFree(lvl.op, mesh, n_pad)
    else:
        raise ValueError(f"the row-sharded hierarchy takes ELL and matrix-free "
                         f"fine levels, not {type(lvl.op).__name__}")
    sm = lvl.smoother
    if isinstance(sm, JacobiSmoother):
        sm = JacobiSmoother(shard_vector(mesh, sm.inv_diag, n_pad), sm.omega)
    elif isinstance(sm, ChebyshevSmoother):
        sm = ChebyshevSmoother(shard_vector(mesh, sm.inv_diag, n_pad),
                               sm.theta, sm.delta, sm.degree)
    elif sm is not None:
        raise ValueError(f"the row-sharded hierarchy takes Jacobi and "
                         f"Chebyshev smoothers, not {type(sm).__name__}")
    transfer = lvl.transfer
    if isinstance(transfer, ELLTransfer):
        transfer = RowShardedTransfer(transfer, mesh, n_pad)
    elif transfer is not None:
        raise ValueError(f"the row-sharded hierarchy takes an ELL transfer, "
                         f"not {type(transfer).__name__}")
    return [LevelData(op, smoother=sm, transfer=transfer, coarse=lvl.coarse),
            *levels[1:]]
