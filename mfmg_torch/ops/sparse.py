"""The ELL device matrix, host CSR assembly and Dirichlet elimination.

Port of mfmg_tpu/ops/sparse.py.  ``ELLMatrix`` is the assembled operator of
the library's default matrix path (``Config(operator="ell")``), the
restriction and prolongation of levels without a structured transfer, and
the coarse operator of levels outside the block-stencil window: padded rows
of (value, column), applied as one gather of x and a row sum (the
reference's ``ell_spmv``, mfmg_tpu/ops/sparse.py:48-51, an XLA gather that
is no Pallas kernel).  ``ell_spmv`` applies it: the plain PyTorch
expression for a CPU tensor, one launch of the hand-written kernel
``csrc/ell_spmv.cu`` for a CUDA tensor, over the blocks of ``ell_plan``
(counted in ``cuda_library.LAUNCHES["ell_spmv"]``).  Setup-time sparse
products (the Galerkin triple product R A R^T) stay on the host in scipy,
as in the reference.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.utils.trace import span

# The ELL kernel's blocks (csrc/ell_spmv.cu kThreads, kUnits): 256 threads,
# each loading two 16-byte vectors of values and two of columns a pass;
# the row sums aim at ELL_LANE_TERMS terms a lane; blocks take fewer rows
# where the matrix would otherwise give fewer than ELL_BLOCKS_PER_SM blocks
# per SM.  Two vectors a thread and 16 terms a lane took the least device
# time of those timed on an H100 (2, 4 or 8 vectors; 2 to 32 terms) on the
# ball's fine operator, a 65^3 operator and a 16-wide R^T (PERF.md).
ELL_THREADS, ELL_UNITS, ELL_LANE_TERMS, ELL_BLOCKS_PER_SM = 256, 2, 16, 2


class EllPlan(NamedTuple):
    """The ELL kernel's launch (csrc/ell_spmv.cu, in this order): block b
    owns rows b * rows + [0, rows) (the last ragged) and streams their
    entries in passes of ``chunk``; ``lanes`` threads sum each row's
    products; ``threads`` per block, ``blocks``, and the block's shared
    memory (``smem`` bytes: a pass's products with a word of padding after
    every 32, and the rows' totals)."""
    rows: int
    lanes: int
    chunk: int
    threads: int
    blocks: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ell_plan(n_rows: int, L: int, elem_bytes: int,
             n_sm: int = cl.H100_SMS) -> EllPlan:
    """Plan the ELL kernel from the matrix's shape: a pass holds
    ``ELL_THREADS * ELL_UNITS`` 16-byte vectors of values (V entries
    each); a block takes as many whole rows as one pass holds, in a multiple
    of V (so that every block's entries start on a vector), at least V,
    and fewer where that leaves the card under ELL_BLOCKS_PER_SM blocks per
    SM; the next power of two <= 32 of the lanes that give each lane
    ELL_LANE_TERMS terms of a row's pass sums it."""
    V = 16 // elem_bytes
    chunk = ELL_THREADS * ELL_UNITS * V
    rows = V * max(1, chunk // (V * max(L, 1)))
    rows = min(rows, V * max(1, _cdiv(_cdiv(n_rows, ELL_BLOCKS_PER_SM * n_sm), V)))
    terms = _cdiv(min(L, chunk), ELL_LANE_TERMS)
    lanes = 1
    while lanes < min(terms, 32):
        lanes *= 2
    return EllPlan(rows, lanes, chunk, ELL_THREADS, _cdiv(n_rows, rows),
                   elem_bytes * (chunk + chunk // 32 + rows))


def ell_spmv_plain(vals: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain ELL apply: gather x by the columns, multiply, sum each row."""
    return (vals * x[cols]).sum(dim=1)


# the C entry point (csrc/ell_spmv.cu): float64 flag, values, columns, x, y,
# rows, width, the plan's table
_ELL_SPMV = cl.Entry("mfmg_ell_spmv", ctypes.c_int, *(ctypes.c_void_p,) * 4,
                     ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int))


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
             n_cols: int) -> torch.Tensor:
    """y = A x of the ELL matrix (vals, cols) of ``n_cols`` columns: the
    plain version where the buffers lie on the CPU; on the card one launch
    of the kernel over the stored buffers, which takes float32 or float64
    values, int32 columns and a 1-D x of the values' type on their device
    (longer than ``n_cols`` where its tail is padding, as in the row-sharded
    hierarchy's gathered vectors), and raises on anything else.

    The solves apply small matrices back to back, so the host's work per
    call is kept short: devices compared as indices and the plan's table
    made once per shape."""
    dev = vals.get_device()
    if dev < 0:
        return ell_spmv_plain(vals, cols, x)
    n_rows, L = vals.shape
    dt = vals.dtype
    if dt is not torch.float32 and dt is not torch.float64:
        raise ValueError(f"the ELL kernel takes float32 or float64 values, got {dt}")
    if cols.dtype is not torch.int32 or cols.shape != vals.shape:
        raise ValueError(f"the ELL kernel takes int32 columns of the values' "
                         f"shape {tuple(vals.shape)}, got {cols.dtype} "
                         f"{tuple(cols.shape)}")
    if x.dtype is not dt or x.dim() != 1 or x.shape[0] < n_cols:
        raise ValueError(f"x must be a 1-D {dt} tensor of at least {n_cols} "
                         f"entries, got {x.dtype} {tuple(x.shape)}")
    if x.get_device() != dev or cols.get_device() != dev:
        raise ValueError(f"values on {vals.device}, columns on {cols.device}, "
                         f"x on {x.device}")
    if not (vals.is_contiguous() and cols.is_contiguous()):
        raise ValueError("the ELL kernel reads contiguous (n_rows, L) buffers")
    if n_rows == 0 or L == 0 or n_cols == 0:
        return torch.zeros(n_rows, dtype=dt, device=dev)
    x = x.contiguous()
    y = torch.empty(n_rows, dtype=dt, device=dev)
    cl.launch(_ELL_SPMV, "ell_spmv", dev, int(dt is torch.float64),
              vals.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
              n_rows, L, _launch_plan(n_rows, L, vals.element_size(), dev))
    return y


@functools.lru_cache(maxsize=None)
def _launch_plan(n_rows: int, L: int, elem_bytes: int, dev: int):
    """ell_plan for the card ``dev``, as the C interface's int array."""
    return cl.ints(ell_plan(n_rows, L, elem_bytes, cl.sm_count(dev)))


class ELLMatrix(nn.Module):
    """ELL (padded-row) sparse matrix.

    vals : (n_rows, L) float buffer
    cols : (n_rows, L) int32 buffer; padded entries point at column 0 with
           value 0.
    n_cols : the number of columns.
    ``forward(x)`` is y = A x; the module moves with ``.to(device)``.
    """

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, n_cols: int):
        super().__init__()
        self.register_buffer("vals", vals)
        self.register_buffer("cols", cols)
        self.n_cols = int(n_cols)

    @property
    def shape(self):
        return (self.vals.shape[0], self.n_cols)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("ell.apply"):
            return ell_spmv(self.vals, self.cols, x, self.n_cols)


class ELLTransfer(nn.Module):
    """The transfer of a level without a structured or window transfer: R
    (restriction into the next level) and R^T (prolongation) as ELL
    matrices, the reference's LevelData.R / LevelData.RT
    (mfmg_tpu/amge/hierarchy.py:54-60)."""

    def __init__(self, R: ELLMatrix, RT: ELLMatrix):
        super().__init__()
        self.R = R
        self.RT = RT

    @property
    def shape(self):
        return self.R.shape

    def restrict(self, x: torch.Tensor) -> torch.Tensor:
        return self.R(x)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        return self.RT(xc)


def ell_transfer_from_scipy(R: sp.spmatrix, dtype=torch.float64,
                            device="cpu") -> ELLTransfer:
    """ELLTransfer of the restriction R (n_coarse, n_fine)."""
    R = sp.csr_matrix(R)
    return ELLTransfer(ell_from_scipy(R, dtype=dtype, device=device),
                       ell_from_scipy(R.T.tocsr(), dtype=dtype, device=device))


def ell_pack_plain(indptr, indices, data, n_rows: int, L: int):
    """The numpy version of native.ell_pack (the reference's vectorized
    fill): (vals (n_rows, L) float64, cols (n_rows, L) int32)."""
    vals = np.zeros((n_rows, L), dtype=np.float64)
    cols = np.zeros((n_rows, L), dtype=np.int32)
    row_nnz = np.diff(indptr)
    nnz = int(indptr[-1]) if n_rows else 0
    if nnz > 0:
        rows = np.repeat(np.arange(n_rows), row_nnz)
        pos = np.arange(nnz) - np.repeat(indptr[:-1], row_nnz)
        vals[rows, pos] = data
        cols[rows, pos] = indices
    return vals, cols


def ell_from_scipy(A: sp.spmatrix, dtype=torch.float64, device="cpu",
                   pad_to: int | None = None) -> ELLMatrix:
    """A scipy sparse matrix as an ELLMatrix of ``dtype`` on ``device``,
    rows padded to the longest row (at least ``pad_to``); packed in float64
    by the host library, then cast."""
    from mfmg_torch import native
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    row_nnz = np.diff(A.indptr)
    L = int(row_nnz.max()) if n > 0 else 0
    if pad_to is not None:
        L = max(L, pad_to)
    if A.nnz > 0:
        vals, cols = native.ell_pack(A.indptr, A.indices, A.data, n, L)
    else:
        vals = np.zeros((n, L))
        cols = np.zeros((n, L), dtype=np.int32)
    return ELLMatrix(torch.from_numpy(vals).to(device=device, dtype=dtype),
                     torch.from_numpy(cols).to(device), m)


def eliminate_dirichlet(A_raw: sp.spmatrix, constrained: np.ndarray) -> sp.csr_matrix:
    """Zero constrained rows/cols, keep the raw diagonal entry at constrained
    dofs (the analog of deal.II AffineConstraints condensation, reference
    tests/laplace.hpp:197-199; the raw diagonal preserves the partition of
    unity sum_agg local_diag/global_diag = 1)."""
    A = sp.coo_matrix(A_raw)
    keep = (~constrained[A.row] & ~constrained[A.col]) | (A.row == A.col)
    return sp.csr_matrix((A.data[keep], (A.row[keep], A.col[keep])), shape=A.shape)


def assemble_csr(cells: np.ndarray, A_loc: np.ndarray, n_dofs: int) -> sp.csr_matrix:
    """Assemble batched cell matrices (n_cells, n_loc, n_loc) into a global
    CSR."""
    n_cells, n_loc = cells.shape
    rows = np.broadcast_to(cells[:, :, None], (n_cells, n_loc, n_loc)).reshape(-1)
    cols = np.broadcast_to(cells[:, None, :], (n_cells, n_loc, n_loc)).reshape(-1)
    A = sp.csr_matrix((A_loc.reshape(-1), (rows, cols)), shape=(n_dofs, n_dofs))
    A.sum_duplicates()
    return A
