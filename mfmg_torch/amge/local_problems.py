"""Per-agglomerate local operators as one padded dense batch (host).

Port of mfmg_tpu/amge/local_problems.py.  All agglomerate operators are
materialized as one (n_agg, m_max, m_max) dense batch so the eigensolve
runs as one batched loop (reference dealii/amge_host.templates.hpp:586-615
solves them one at a time).  Two builders, dispatched as in the reference:
  * the uniform block partition of a structured mesh: one index structure
    shared by every agglomerate (``block_layout``), the dense assembly in
    the host library (``native.py``; ``assemble_plain`` is its numpy
    version).  Its light batch (``assemble_operator=False``) carries no
    dense operators: the device eigensolve (``eigen/device_eig.py``)
    assembles them on the card;
  * anything else (unstructured meshes, ragged parts from the walk, RCB or
    METIS): the generic builder ``_build_generic``, one agglomerate at a
    time, ragged sizes padded to m_max (dof_map -1 and ``valid`` False on
    the padding, a unit diagonal there so its eigenpairs are decoupled).

Boundary conditions per agglomerate mirror the reference
(tests/test_hierarchy_helpers.hpp:253-259): Dirichlet only where the
agglomerate touches the global Dirichlet boundary, natural (Neumann) on
interior agglomerate boundaries.  Hanging slaves are constrained dofs like
the Dirichlet ones (``Mesh.constrained_mask``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from mfmg_torch.fem.mesh import Mesh
from mfmg_torch.fem.reference import reference_element


@dataclasses.dataclass
class AgglomerateBatch:
    """Padded batch of local problems.

    dof_map : (n_agg, m_max) int64 global dof ids, -1 padding
    valid   : (n_agg, m_max) bool
    A_agg   : (n_agg, m_max, m_max) Dirichlet-eliminated local matrices
              (raw diagonal kept at constrained dofs); None in a light batch
    diag    : (n_agg, m_max) local raw diagonals (the PoU numerators)
    constrained : (n_agg, m_max) bool
    sizes   : (n_agg,) int
    """

    dof_map: np.ndarray
    valid: np.ndarray
    A_agg: np.ndarray
    diag: np.ndarray
    constrained: np.ndarray
    sizes: np.ndarray

    @property
    def n_agg(self) -> int:
        return self.dof_map.shape[0]

    @property
    def m_max(self) -> int:
        return self.dof_map.shape[1]


def build_agglomerate_batch(mesh: Mesh, A_loc: np.ndarray, agg_ids: np.ndarray,
                            batch_dtype=np.float64,
                            assemble_operator: bool = True) -> AgglomerateBatch:
    """Assemble local dense operators for every agglomerate: the vectorized
    builder for the uniform block partition of a structured mesh, the
    generic one for anything else.

    batch_dtype: dtype of the dense A_agg batch (float32 for float32
    hierarchies, as in mfmg_tpu); the PoU diagonals are always float64.
    assemble_operator=False gives the light batch (A_agg None) on the
    structured path: dof map, float64 PoU diagonals and constrained mask,
    all the restriction, the PoU check and the structured transfers read.
    The generic path always assembles, as the reference's does.
    """
    lay = _structured_layout(mesh, agg_ids)
    if lay is None:
        batch = _build_generic(mesh, A_loc, agg_ids)
        if np.dtype(batch_dtype) != np.float64:
            batch.A_agg = batch.A_agg.astype(batch_dtype)
        return batch
    cells_per_agg, local_cells, dof_map, m = lay
    n_agg = len(cells_per_agg)
    constrained = mesh.constrained_mask[dof_map]
    valid = np.ones((n_agg, m), dtype=bool)
    sizes = np.full(n_agg, m, dtype=np.int64)
    if not assemble_operator:
        return AgglomerateBatch(dof_map=dof_map, valid=valid, A_agg=None,
                                diag=_pou_diag(A_loc, cells_per_agg,
                                               local_cells, m),
                                constrained=constrained, sizes=sizes)

    from mfmg_torch import native
    A_agg = native.assemble_agglomerate_batch_uniform(
        cells_per_agg, local_cells, A_loc, n_agg, m, dtype=batch_dtype)
    if np.dtype(batch_dtype) == np.float64:
        diag = np.einsum("gii->gi", A_agg).copy()
    else:
        # PoU diagonals in float64 straight from the cell matrices
        diag = _pou_diag(A_loc, cells_per_agg, local_cells, m)

    keep = ~constrained
    A_agg *= keep[:, :, None] * keep[:, None, :]
    gi2, ii2 = np.nonzero(constrained)
    A_agg[gi2, ii2, ii2] = diag[gi2, ii2].astype(batch_dtype)

    return AgglomerateBatch(dof_map=dof_map, valid=valid, A_agg=A_agg,
                            diag=diag, constrained=constrained, sizes=sizes)


def _build_generic(mesh: Mesh, A_loc: np.ndarray, agg_ids: np.ndarray) -> AgglomerateBatch:
    """The reference's generic builder (mfmg_tpu/amge/local_problems.py:
    208-259): each agglomerate's dofs in ascending order, its operator
    assembled by a scatter-add of its cells' matrices in float64, padded
    to the largest agglomerate."""
    n_agg = int(agg_ids.max()) + 1
    n_loc = mesh.n_loc

    # group cells by agglomerate
    cells_sorted = np.argsort(agg_ids, kind="stable")
    counts = np.bincount(agg_ids, minlength=n_agg)
    offsets = np.concatenate([[0], np.cumsum(counts)])

    dof_maps = []
    sizes = np.empty(n_agg, dtype=np.int64)
    local_cells = []       # per agg: (n_agg_cells, n_loc) local dof indices
    for g in range(n_agg):
        cs = cells_sorted[offsets[g]: offsets[g + 1]]
        dofs = mesh.cells[cs]                              # (k, n_loc)
        uniq, inv = np.unique(dofs, return_inverse=True)
        dof_maps.append(uniq)
        sizes[g] = len(uniq)
        local_cells.append(inv.reshape(dofs.shape))

    m_max = int(sizes.max())
    dof_map = -np.ones((n_agg, m_max), dtype=np.int64)
    valid = np.zeros((n_agg, m_max), dtype=bool)
    A_agg = np.zeros((n_agg, m_max, m_max))
    for g in range(n_agg):
        m = sizes[g]
        dof_map[g, :m] = dof_maps[g]
        valid[g, :m] = True
        cs = cells_sorted[offsets[g]: offsets[g + 1]]
        li = local_cells[g]                                # (k, n_loc)
        rows = np.broadcast_to(li[:, :, None], (len(cs), n_loc, n_loc))
        cols = np.broadcast_to(li[:, None, :], (len(cs), n_loc, n_loc))
        np.add.at(A_agg[g], (rows.reshape(-1), cols.reshape(-1)),
                  A_loc[cs].reshape(-1))

    diag = np.einsum("gii->gi", A_agg).copy()              # raw local diagonals
    constrained = np.zeros((n_agg, m_max), dtype=bool)
    constrained[valid] = mesh.constrained_mask[dof_map[valid]]

    # elimination inside each agglomerate: zero constrained rows and
    # columns, keep the raw diagonal entry (ops/sparse.eliminate_dirichlet)
    keep = ~constrained
    A_agg *= keep[:, :, None] * keep[:, None, :]
    gi, ii = np.nonzero(constrained)
    A_agg[gi, ii, ii] = diag[gi, ii]
    # unit diagonal on padding so padded eigenpairs are decoupled
    gi, ii = np.nonzero(~valid)
    A_agg[gi, ii, ii] = 1.0

    return AgglomerateBatch(dof_map=dof_map, valid=valid, A_agg=A_agg,
                            diag=diag, constrained=constrained, sizes=sizes)


def _pou_diag(A_loc, cells_per_agg, local_cells, m) -> np.ndarray:
    """(n_agg, m) float64 local raw diagonals summed from the cell matrices."""
    n_agg = cells_per_agg.shape[0]
    diag = np.zeros((n_agg, m))
    d_loc = np.einsum("cii->ci", A_loc)[cells_per_agg]
    np.add.at(diag, (np.broadcast_to(np.arange(n_agg)[:, None, None], d_loc.shape),
                     np.broadcast_to(local_cells[None], d_loc.shape)), d_loc)
    return diag


def assemble_plain(cells_per_agg, local_cells, A_loc, n_agg, m,
                   dtype=np.float64) -> np.ndarray:
    """The numpy version of native.assemble_agglomerate_batch_uniform: the
    same scatter-add in the same order (agglomerate, cell, row, column)."""
    n_bc, n_loc = local_cells.shape
    A_agg = np.zeros((n_agg, m, m), dtype=dtype)
    gi = np.broadcast_to(np.arange(n_agg)[:, None, None, None],
                         (n_agg, n_bc, n_loc, n_loc))
    rows = np.broadcast_to(local_cells[None, :, :, None], gi.shape)
    cols = np.broadcast_to(local_cells[None, :, None, :], gi.shape)
    np.add.at(A_agg, (gi.reshape(-1), rows.reshape(-1), cols.reshape(-1)),
              A_loc[cells_per_agg].reshape(-1).astype(dtype))
    return A_agg


class BlockLayout(NamedTuple):
    """The index structure every agglomerate of a uniform block partition
    shares: cells_per_agg (n_agg, n_bc) the cells of each block in
    block-local order (x fastest), local_cells (n_bc, n_loc) the block-local
    dof of each cell's local dofs, dof_map (n_agg, m) each block's global
    dofs in lexicographic local order, m the dofs per block."""

    cells_per_agg: np.ndarray
    local_cells: np.ndarray
    dof_map: np.ndarray
    m: int


def block_layout(mesh: Mesh, agg_ids: np.ndarray) -> BlockLayout:
    """The closed-form layout of a uniform block partition of a structured
    mesh; raises ValueError for anything else."""
    lay = _structured_layout(mesh, agg_ids)
    if lay is None:
        raise ValueError("the agglomerates are not the closed-form uniform "
                         "block partition of a structured mesh")
    return lay


def _structured_layout(mesh: Mesh, agg_ids: np.ndarray) -> BlockLayout | None:
    """block_layout, or None where the generic builder applies (an
    unstructured mesh, a renumbered one, ragged or non-block
    agglomerates)."""
    if not mesh.is_structured or mesh.dof_renumbered:
        return None              # renumbered dofs: closed-form ids invalid
    n_agg = int(agg_ids.max()) + 1
    counts = np.bincount(agg_ids, minlength=n_agg)
    nc = np.asarray(mesh.structured_shape)
    dim, k = mesh.dim, mesh.degree
    mi = mesh.cell_multi_index()
    sel = agg_ids == agg_ids[0]
    bdims = (mi[sel].max(axis=0) - mi[sel].min(axis=0) + 1)
    agg_mi = mi // bdims
    n_agg_dim = nc // bdims
    stride = np.cumprod(np.concatenate([[1], n_agg_dim[:-1]]))
    if (counts.min() != counts.max() or np.prod(bdims) != counts[0]
            or np.any(nc % bdims) or not np.array_equal(agg_ids, agg_mi @ stride)):
        return None

    # local structure shared by all agglomerates
    m_dims = bdims * k + 1                # local nodes per dim
    m = int(np.prod(m_dims))
    lm = reference_element(dim, k).local_multi_index            # (n_loc, dim)
    bc = np.stack(np.meshgrid(*[np.arange(b) for b in bdims], indexing="ij"),
                  axis=-1).reshape(-1, dim, order="F")          # x fastest
    lstride = np.cumprod(np.concatenate([[1], m_dims[:-1]]))
    local_cells = ((bc[:, None, :] * k + lm[None, :, :]) @ lstride).astype(np.int64)

    gstride = np.cumprod(np.concatenate([[1], nc[:-1]]))
    agg_origin_mi = np.stack(np.meshgrid(*[np.arange(a) for a in n_agg_dim],
                                         indexing="ij"),
                             axis=-1).reshape(-1, dim, order="F") * bdims
    cells_per_agg = (agg_origin_mi[:, None, :] + bc[None, :, :]) @ gstride

    node_dims = nc * k + 1
    nstride = np.cumprod(np.concatenate([[1], node_dims[:-1]]))
    local_node_mi = np.stack(np.meshgrid(*[np.arange(md) for md in m_dims],
                                         indexing="ij"),
                             axis=-1).reshape(-1, dim, order="F")
    dof_map = ((agg_origin_mi * k)[:, None, :] + local_node_mi[None, :, :]) @ nstride

    return BlockLayout(cells_per_agg, local_cells, dof_map, m)
