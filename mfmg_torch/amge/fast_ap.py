"""fast_ap: matrix-free construction of AP = A·Rᵀ from per-agglomerate pieces.

Port of mfmg_tpu/amge/fast_ap.py (host numpy), the re-design of the
reference's fast_multiply_transpose (dealii_hierarchy_helpers.cc:56-303,
boundary agglomerates from
common/amge.templates.hpp:87-151).  The identity (verified entrywise against
the naive SpGEMM at 1e-9, mirroring tests/test_hierarchy.cc:507-642):

    column (g,k) of A·Rᵀ  =  λ_gk·e  +  A_bl·Δe  +  A_halo·(Δe + e)

where e is agglomerate g's k-th eigenvector, Δe = (w-1)·e (nonzero only on
the agglomerate's geometric boundary where the PoU weight w != 1),
A_bl is assembled from the agglomerate's boundary-layer cells (cells with a
neighbor outside), and A_halo from the one-ring of outside cells touching the
agglomerate.

Where the reference runs a WorkStream thread loop with one patch matvec at a
time, here the patch operators are never materialized at all: the patch
matvec decomposes cell-by-cell (assembly is additive), so both corrections
become ONE batched (n_pairs, n_loc, n_loc) x (n_pairs, n_loc, n_ev) einsum
over all (agglomerate, cell) pairs followed by one COO scatter — no Python
loops, no per-agglomerate dense patches.  Patch Dirichlet elimination
(zero constrained rows/cols, patch diagonal kept at constrained dofs)
telescopes through the decomposition: zero the source at constrained dofs
before the cell matvec, and replace constrained output rows by
(local diagonal)·(raw source), whose sum over patch cells is exactly
(patch diagonal)·source.

The hierarchy does not call these functions: its fast_ap Galerkin product
comes from the per-agglomerate blocks (amge/multilevel.py).  They are the
reference's fast-AP identity, held against A·Rᵀ by the tests.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from mfmg_torch.amge.local_problems import AgglomerateBatch
from mfmg_torch.fem.mesh import Mesh


def cell_adjacency(mesh: Mesh):
    """Cells sharing at least one mesh node (deal.II vertex connectivity
    analog, GridTools::get_vertex_connectivity_of_cells)."""
    n_cells = mesh.n_cells
    # node -> cells incidence as a sparse matrix, then cell-cell via product
    n_loc = mesh.n_loc
    rows = np.repeat(np.arange(n_cells), n_loc)
    cols = mesh.cells.reshape(-1)
    inc = sp.csr_matrix((np.ones(len(rows), dtype=np.int8), (rows, cols)),
                        shape=(n_cells, mesh.n_nodes))
    adj = (inc @ inc.T).tocsr()
    return adj


def boundary_halo_pairs(mesh: Mesh, agg_ids: np.ndarray):
    """All (agglomerate, cell) pairs of the fast-AP correction patches.

    bl: cells inside g with at least one vertex-neighbor outside g
        (the reference's boundary agglomerate, amge.templates.hpp:116-148);
    hl: the one-ring of outside cells vertex-touching g.
    Returned as two (P, 2) int arrays of unique (g, cell) pairs.
    """
    adj = cell_adjacency(mesh).tocoo()
    r, c = adj.row, adj.col
    cross = agg_ids[r] != agg_ids[c]
    r, c = r[cross], c[cross]
    n_cells = mesh.n_cells
    bl = np.unique(agg_ids[r].astype(np.int64) * n_cells + r)
    hl = np.unique(agg_ids[r].astype(np.int64) * n_cells + c)
    bl = np.stack([bl // n_cells, bl % n_cells], axis=1)
    hl = np.stack([hl // n_cells, hl % n_cells], axis=1)
    return bl, hl


def boundary_and_halo_patches(mesh: Mesh, agg_ids: np.ndarray):
    """Per agglomerate: (boundary-layer cells, halo cells) as lists of cell-id
    arrays (amge.templates.hpp:116-148)."""
    bl, hl = boundary_halo_pairs(mesh, agg_ids)
    n_agg = int(agg_ids.max()) + 1

    def split(pairs):
        out = [np.empty(0, dtype=np.int64)] * n_agg
        if len(pairs):
            counts = np.bincount(pairs[:, 0], minlength=n_agg)
            offs = np.concatenate([[0], np.cumsum(counts)])
            for g in range(n_agg):
                out[g] = pairs[offs[g]: offs[g + 1], 1]
        return out

    return split(bl), split(hl)


def _agg_dof_slots(batch: AgglomerateBatch, n_dofs: int):
    """Sorted (agg, dof) key array + the agg-local slot of each key, for
    vectorized (g, global dof) -> agglomerate-local index lookups."""
    gi, ii = np.nonzero(batch.valid)
    keys = gi.astype(np.int64) * n_dofs + batch.dof_map[gi, ii]
    order = np.argsort(keys)
    return keys[order], ii[order]


def fast_multiply_transpose(mesh: Mesh, A_loc: np.ndarray, agg_ids: np.ndarray,
                            batch: AgglomerateBatch, evals: np.ndarray,
                            evecs: np.ndarray, global_diag: np.ndarray) -> sp.csr_matrix:
    """Assemble AP = A·Rᵀ (shape n_dofs x n_coarse) without global SpGEMM."""
    n_agg, m_max, n_ev = evecs.shape
    n_dofs = mesh.n_nodes
    w = np.where(batch.valid,
                 batch.diag / np.where(batch.dof_map >= 0, global_diag[batch.dof_map], 1.0),
                 0.0)
    delta = (w[:, :, None] - 1.0) * evecs          # Δe on agg-local layout
    full = delta + evecs                           # Δe + e

    rows_out, cols_out, vals_out = [], [], []
    kk = np.arange(n_ev)

    # term 1: Λ·E (agg-local)
    gi, ii = np.nonzero(batch.valid)
    rows_out.append(np.broadcast_to(batch.dof_map[gi, ii][:, None],
                                    (len(gi), n_ev)).ravel())
    cols_out.append((gi[:, None] * n_ev + kk[None]).ravel())
    vals_out.append((evals[gi] * evecs[gi, ii]).ravel())

    skeys, slots = _agg_dof_slots(batch, n_dofs)
    bl, hl = boundary_halo_pairs(mesh, agg_ids)
    con = mesh.constrained_mask

    for pairs, src in ((bl, delta), (hl, full)):
        if not len(pairs):
            continue
        g, c = pairs[:, 0], pairs[:, 1]
        dofs = mesh.cells[c].astype(np.int64)      # (P, n_loc)
        qk = g[:, None] * n_dofs + dofs
        pos = np.minimum(np.searchsorted(skeys, qk), len(skeys) - 1)
        found = skeys[pos] == qk                   # dof in agg g's local space?
        v = np.where(found[:, :, None],
                     src[g[:, None], np.where(found, slots[pos], 0)], 0.0)
        cmask = con[dofs]
        Ak = A_loc[c]                              # (P, n_loc, n_loc)
        u = np.einsum("pab,pbk->pak",
                      Ak, np.where(cmask[:, :, None], 0.0, v))
        # patch Dirichlet rows: sum over patch cells of diag_loc*v = d_patch*v
        dloc = np.einsum("paa->pa", Ak)
        u = np.where(cmask[:, :, None], dloc[:, :, None] * v, u)
        rows_out.append(np.broadcast_to(dofs[:, :, None], u.shape).ravel())
        cols_out.append(np.broadcast_to((g[:, None] * n_ev + kk[None])[:, None, :],
                                        u.shape).ravel())
        vals_out.append(u.ravel())

    rows = np.concatenate(rows_out)
    cols = np.concatenate(cols_out)
    vals = np.concatenate(vals_out)
    AP = sp.csr_matrix((vals, (rows, cols)), shape=(n_dofs, n_agg * n_ev))
    AP.sum_duplicates()
    return AP
