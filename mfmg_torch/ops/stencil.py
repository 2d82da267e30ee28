"""Gather-free stencil operator for structured meshes.

Port of mfmg_tpu/ops/stencil.py.  On a structured Q_k grid the assembled
Laplace operator is a (2k+1)^dim stencil with variable coefficients,

    y[i] = sum_o C_o[i] * x[i + o],

extracted exactly from the per-cell matrices, so ``StencilOperator @ x ==
A @ x`` to roundoff.  For symmetric operators only the center and the
strictly-positive-offset planes are read: the negative planes satisfy
C_{-o}[i] = C_o[i-o].

Finalization (``stencil_to_device``) gathers a symmetric operator's center
and positive planes into one contiguous (1+n_pos, gz, gy, gx) buffer, or
keeps a one-sided operator's planes as one contiguous (n_off, gz, gy, gx)
buffer, and moves it to the device once; the CUDA kernels K1 and K3
(ops/stencil_kernels.py) then take one pointer and a small offset table.
The TPU's (8,128) padded plane layouts are not ported.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from mfmg_torch.fem.mesh import Mesh
from mfmg_torch.ops import stencil_kernels


class StencilOperator(nn.Module):
    """Variable-coefficient stencil y = sum_o C_o * shift(x, o).

    grid_shape is (n1_last, ..., n1_x), C-order node grid (x fastest in the
    flat dof id); offsets[o] is the per-axis shift in the same axis order.

    Buffers: ``coeffs`` (n_off,) + grid_shape, all planes, as built by the
    host setup; ``planes`` (1 + n_pos,) + grid_shape, the center then the
    positive planes of a symmetric operator, set by ``stencil_to_device``
    (which then drops ``coeffs``).  sym_pos: indices of the strictly
    positive offsets (first nonzero component > 0) when the operator is
    symmetric, else None.
    """

    def __init__(self, coeffs: torch.Tensor, offsets, grid_shape, sym_pos=None):
        super().__init__()
        self.offsets = tuple(tuple(int(c) for c in off) for off in offsets)
        self.grid_shape = tuple(int(g) for g in grid_shape)
        self.sym_pos = None if sym_pos is None else tuple(int(i) for i in sym_pos)
        self.register_buffer("coeffs", coeffs)
        self.register_buffer("planes", None)

    @property
    def shape(self):
        n = int(np.prod(self.grid_shape))
        return (n, n)

    @property
    def dtype(self):
        return (self.planes if self.planes is not None else self.coeffs).dtype

    @property
    def pos_offsets(self) -> tuple:
        return tuple(self.offsets[i] for i in self.sym_pos)

    def center_plane(self) -> torch.Tensor:
        if self.planes is not None:
            return self.planes[0]
        return self.coeffs[self.offsets.index((0,) * len(self.grid_shape))]

    def forward(self, x):
        return stencil_apply(self, x)


def detect_symmetry(coeffs: np.ndarray, offsets, grid_shape) -> tuple | None:
    """Host check that the stencil is symmetric (C_{-o}[i] = C_o[i-o]);
    returns the indices of the strictly positive offsets, or None."""
    idx = {off: i for i, off in enumerate(offsets)}
    pos = []
    dim = len(grid_shape)
    for i, off in enumerate(offsets):
        if off == (0,) * dim:
            continue
        first = next(c for c in off if c != 0)
        if first < 0:
            continue
        neg = tuple(-c for c in off)
        if neg not in idx:
            return None
        pos.append(i)
        Cp = coeffs[i].reshape(grid_shape)
        Cn = coeffs[idx[neg]].reshape(grid_shape)
        shifted = np.zeros_like(Cp)
        src = tuple(slice(max(0, -o), min(n, n - o))
                    for o, n in zip(off, grid_shape))
        dst = tuple(slice(max(0, o), min(n, n + o))
                    for o, n in zip(off, grid_shape))
        shifted[dst] = Cp[src]
        if not np.array_equal(shifted, Cn):
            return None
    if (0,) * dim not in idx:
        return None
    return tuple(pos)


def stencil_apply(op: StencilOperator, x: torch.Tensor) -> torch.Tensor:
    """y = sum_o C_o * shift(x, o) (the dispatch of mfmg_tpu
    stencil.py:115-163).

    A 3-D grid with float32 x and float32/bfloat16 planes is the reference's
    Pallas case: a symmetric operator goes through the K1 wrapper, a
    one-sided one (Q2/Q3 elements, sym_pos None) through the K3 wrapper;
    each launches its CUDA kernel on a CUDA tensor and runs its plain
    version on a CPU tensor.  Everything else (2-D grids, float64) is plain
    PyTorch, as the reference runs XLA.
    """
    kernel_case = (len(op.grid_shape) == 3 and x.dtype == torch.float32
                   and op.dtype in (torch.float32, torch.bfloat16))
    if op.sym_pos is None:
        fn = (stencil_kernels.stencil_apply if kernel_case
              else stencil_kernels.stencil_apply_plain)
        return fn(op.coeffs, x, op.offsets, op.grid_shape)
    planes = op.planes if op.planes is not None else _gather_planes(op)
    if kernel_case:
        return stencil_kernels.stencil_apply_sym(planes, x, op.pos_offsets,
                                                 op.grid_shape)
    return stencil_kernels.stencil_apply_sym_plain(planes, x, op.pos_offsets,
                                                   op.grid_shape)


def full_planes(op: StencilOperator) -> torch.Tensor:
    """Every plane of ``op.offsets``, (n_off,) + grid_shape in the storage
    dtype: ``coeffs`` as built, or, for a symmetric operator finalized to its
    center and positive planes, each negative plane rebuilt as
    C_{-o}[i] = C_o[i-o] (zero where i-o leaves the grid)."""
    if op.coeffs is not None:
        return op.coeffs
    pos = {op.offsets[i]: j + 1 for j, i in enumerate(op.sym_pos)}
    zero = (0,) * len(op.grid_shape)
    out = torch.zeros((len(op.offsets),) + op.grid_shape, dtype=op.planes.dtype,
                      device=op.planes.device)
    for i, off in enumerate(op.offsets):
        if off == zero:
            out[i] = op.planes[0]
        elif off in pos:
            out[i] = op.planes[pos[off]]
        else:
            neg = tuple(-c for c in off)
            src = tuple(slice(max(0, -o), min(n, n - o))
                        for o, n in zip(neg, op.grid_shape))
            dst = tuple(slice(max(0, o), min(n, n + o))
                        for o, n in zip(neg, op.grid_shape))
            out[i][dst] = op.planes[pos[neg]][src]
    return out


def _gather_planes(op: StencilOperator) -> torch.Tensor:
    ctr = op.offsets.index((0,) * len(op.grid_shape))
    return op.coeffs[[ctr, *op.sym_pos]].contiguous()


def stencil_to_device(op: StencilOperator, device) -> StencilOperator:
    """Finalize a host-built operator (the counterpart of mfmg_tpu
    stencil_to_device): a symmetric operator keeps only its gathered
    center + positive planes, a one-sided one all its planes, each as one
    contiguous buffer; then one host-to-device copy."""
    if op.sym_pos is not None and op.planes is None:
        op.planes = _gather_planes(op)
        op.coeffs = None
    elif op.sym_pos is None:
        op.coeffs = op.coeffs.contiguous()
    return op.to(device)


def stencil_layout(mesh: Mesh):
    """Static scatter layout of the structured-mesh stencil extraction:
    (offsets [(z..x) shifts], oid_ab [(a,b)->offset plane], grid_shape,
    n_nodes)."""
    k = mesh.degree
    nc = mesh.structured_shape
    dim = mesh.dim
    n1 = tuple(k * c + 1 for c in nc)          # nodes per dim, x first
    grid_shape = tuple(reversed(n1))           # C-order: (z, y, x)
    n_nodes = int(np.prod(n1))

    from mfmg_torch.fem.reference import reference_element
    lm = reference_element(dim, k).local_multi_index     # (n_loc, dim) x first
    doff = lm[None, :, :] - lm[:, None, :]               # (a, b, dim) x first
    offsets = list(itertools.product(*[range(-k, k + 1)] * dim))  # (z,..,x)
    oid_ab = np.zeros(doff.shape[:2], dtype=np.int64)
    for d in range(dim - 1, -1, -1):
        oid_ab = oid_ab * (2 * k + 1) + (doff[:, :, d] + k)
    return offsets, oid_ab, grid_shape, n_nodes


def stencil_scatter_plain(rows, oid_ab, A_loc, n_planes, n_nodes):
    """The numpy version of native.stencil_scatter: (n_planes, n_nodes)
    float64, coeffs[oid_ab[a, b], rows[c, a]] += A_loc[c, a, b] (one
    bincount, summed in (c, a, b) order)."""
    flat = oid_ab[None, :, :] * n_nodes + np.asarray(rows, np.int64)[:, :, None]
    coeffs = np.bincount(flat.reshape(-1), weights=A_loc.reshape(-1),
                         minlength=n_planes * n_nodes)
    return coeffs.reshape(n_planes, n_nodes)


def stencil_from_cell_matrices(mesh: Mesh, A_loc: np.ndarray,
                               constrained: np.ndarray, diag_raw: np.ndarray,
                               dtype=torch.float32,
                               raw_planes: np.ndarray | None = None) -> StencilOperator:
    """Exact stencil extraction straight from the per-cell matrices (the
    global CSR is never assembled; dealii_matrix_free_hierarchy_helpers.cc:
    55-303 analog).  The host library's ``stencil_scatter`` adds every cell
    matrix into its offset planes (``stencil_scatter_plain`` is its numpy
    version); Dirichlet elimination is then applied in stencil form:
    constrained rows keep only the raw-diagonal center, and couplings into
    constrained columns are zeroed.  The planes stay on the host (setup
    reads them there); the hierarchy moves them once, at finalization.
    raw_planes: the (n_offsets, n_nodes) planes already scattered, as the
    distributed setup sums them over the ranks' cell ranges
    (parallel/dist_setup.py); elimination then runs on them."""
    if not mesh.is_structured or mesh.dof_renumbered:
        raise ValueError("stencil operator requires a structured mesh with "
                         "lexicographic dof numbering (use operator='ell' "
                         "after renumber_dofs)")
    k = mesh.degree
    offsets, oid_ab, grid_shape, n_nodes = stencil_layout(mesh)
    if raw_planes is not None:
        coeffs = np.array(raw_planes, dtype=np.float64)
    else:
        from mfmg_torch import native
        coeffs = native.stencil_scatter(mesh.cells, oid_ab, A_loc, len(offsets),
                                        n_nodes)

    con = constrained.reshape(grid_shape)
    con_pad = np.pad(con, k, constant_values=False)
    center = len(offsets) // 2
    for i, off in enumerate(offsets):
        sl = tuple(slice(k + o, k + o + n) for o, n in zip(off, grid_shape))
        col_con = con_pad[sl].reshape(-1)
        if i == center:
            coeffs[i] = np.where(constrained, diag_raw, coeffs[i])
        else:
            coeffs[i] = np.where(constrained | col_con, 0.0, coeffs[i])

    coeffs = coeffs.reshape((len(offsets),) + grid_shape)
    nonzero = [i for i in range(len(offsets)) if np.any(coeffs[i])]
    coeffs = coeffs[nonzero]
    offsets = tuple(offsets[i] for i in nonzero)
    sym_pos = detect_symmetry(coeffs, offsets, grid_shape)
    return StencilOperator(torch.from_numpy(coeffs).to(dtype), offsets,
                           grid_shape, sym_pos)


def stencil_from_csr(A: sp.spmatrix, mesh: Mesh,
                     dtype=torch.float32) -> StencilOperator:
    """Exact stencil extraction from an assembled matrix on a structured mesh
    (mfmg_tpu/ops/stencil.py:350-393): each entry's per-axis offset comes
    from the row and column multi-indices; all-zero planes are dropped.
    The operator keeps all its planes on the host (``coeffs``)."""
    if not mesh.is_structured:
        raise ValueError("stencil operator requires a structured mesh")
    k = mesh.degree
    dim = mesh.dim
    n1 = tuple(k * c + 1 for c in mesh.structured_shape)   # x first
    grid_shape = tuple(reversed(n1))           # C order: (z, y, x)

    A = sp.coo_matrix(A)

    def multi(idx):
        out = []
        rem = idx.astype(np.int64)
        for d in range(dim):
            out.append(rem % n1[d])
            rem = rem // n1[d]
        return np.stack(out, axis=-1)          # (..., dim) x first

    diff = multi(A.col) - multi(A.row)         # per-axis offsets, x first
    if np.abs(diff).max() > k:
        raise ValueError("matrix has entries outside the (2k+1)^dim stencil")
    offsets = list(itertools.product(*[range(-k, k + 1)] * dim))  # (z..x)
    oid = np.zeros(len(A.data), dtype=np.int64)
    for d in range(dim - 1, -1, -1):
        oid = oid * (2 * k + 1) + (diff[:, d] + k)
    coeffs = np.zeros((len(offsets), int(np.prod(n1))))
    np.add.at(coeffs, (oid, A.row), A.data)
    coeffs = coeffs.reshape((len(offsets),) + grid_shape)
    nonzero = [i for i in range(len(offsets)) if np.any(coeffs[i])]
    coeffs = coeffs[nonzero]
    offsets = tuple(offsets[i] for i in nonzero)
    sym_pos = detect_symmetry(coeffs, offsets, grid_shape)
    return StencilOperator(torch.from_numpy(coeffs).to(dtype), offsets,
                           grid_shape, sym_pos)
