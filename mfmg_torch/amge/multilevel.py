"""Recursive spectral AMGe: level l >= 1 built with the level-0 machinery.

Port of mfmg_tpu/amge/multilevel.py (host numpy/scipy, with the restriction
blocks and the per-super scatter in the host library, ``native.py``).  The
reference caps its own AMGe at 2 levels and delegates deeper hierarchies to
ML/AMGX (hierarchy.hpp:172, dealii_solver.cc); here level l >= 1 repeats
the level-0 construction on super-agglomerates:

  * level-l agglomerates = groups of level-(l-1) agglomerates,
  * the local operator of super-agglomerate G is the Galerkin restriction of
    G's Neumann-assembled fine patch, A_G = R_G A_G R_G^T.  At level 1 with
    the level-0 batch (or its Galerkin blocks) at hand it is summed from
    the per-agglomerate blocks K_a = Rb_a A_a Rb_a^T (one batched matmul per
    level-0 agglomerate, reused by the global Galerkin product); at every
    deeper level, and at level 1 when only a light batch without blocks
    exists, from the per-cell blocks K_c = R_c A_c R_c^T (the per-cell patch
    path, ``_super_blocks_per_cell``), in chunks of cells,
  * the local space spans every previous-level coarse dof whose support
    touches G ("overlap", the default), or, with ``local_space="interior"``
    on the per-agglomerate path, only the rows G owns (unit weights),
  * the eigenproblem is solved in the orthonormalized function space of the
    patch Gram M_G = R_G R_G^T (rank-revealing pivoted Cholesky, eigh as the
    fallback), and PoU weights w_i = diag(A_G)_i / diag(A_l)_i.

``super_range`` builds one rank's slab of supers for the distributed setup
(parallel/dist_setup.py).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp

from mfmg_torch.fem.mesh import Mesh


def group_agglomerates(mesh: Mesh, agg_ids: np.ndarray, block_dims):
    """(super_of_agg (n_agg,), super grid dims x-first): centroid-layer
    blocking of the previous-level agglomerates (exact on structured grids)."""
    n_agg = int(agg_ids.max()) + 1
    centroids = np.zeros((n_agg, mesh.dim))
    counts = np.bincount(agg_ids, minlength=n_agg).astype(float)
    cell_centers = mesh.nodes[mesh.cells].mean(axis=1)
    np.add.at(centroids, agg_ids, cell_centers)
    centroids /= counts[:, None]

    super_mi = np.zeros((n_agg, mesh.dim), dtype=np.int64)
    for d in range(mesh.dim):
        vals = np.round(centroids[:, d] / max(1e-12, np.ptp(centroids[:, d]) + 1e-30) * 1e8)
        _, layer = np.unique(vals, return_inverse=True)
        super_mi[:, d] = layer // block_dims[d]
    out = np.zeros(n_agg, dtype=np.int64)
    stride = 1
    grid = []
    for d in range(mesh.dim):
        n_d = int(super_mi[:, d].max()) + 1
        grid.append(n_d)
        out += super_mi[:, d] * stride
        stride *= n_d
    _, out = np.unique(out, return_inverse=True)
    return out, tuple(grid)


def _dof_row_structure(R: sp.csr_matrix):
    """Padded per-dof (rows, values) of R's columns: which coarse rows touch
    each fine dof.  (n_dofs, q_max) with -1 padding."""
    C = R.tocsc()
    n_dofs = C.shape[1]
    q = np.diff(C.indptr)
    q_max = int(q.max()) if n_dofs else 0
    rows = -np.ones((n_dofs, q_max), dtype=np.int64)
    vals = np.zeros((n_dofs, q_max))
    if C.nnz:
        d_idx = np.repeat(np.arange(n_dofs), q)
        pos = np.arange(C.nnz) - np.repeat(C.indptr[:-1], q)
        rows[d_idx, pos] = C.indices
        vals[d_idx, pos] = C.data
    return rows, vals


def scatter_super_blocks_plain(g_of, gpos, K, Mb, n_super, m1p):
    """The numpy version of native.scatter_super_blocks (one bincount per
    batch): (A1, M), each (n_super, m1p, m1p) float64."""
    flat = ((g_of[:, None, None] * m1p + gpos[:, :, None]) * m1p
            + gpos[:, None, :]).ravel()
    size = n_super * m1p * m1p
    return tuple(np.bincount(flat, weights=np.asarray(w, np.float64).ravel(),
                             minlength=size).reshape(n_super, m1p, m1p)
                 for w in (K, Mb))


# Gram rank cutoffs (relative); a quality knob, not only a numerical guard
# (mfmg_tpu measured V-cycle rate 0.885 / PCG 17 with the rank kept too high
# at 65^3 against 0.671 / PCG ~10 truncated).  pstrf pivots scale like
# eigenvalues of the scaled Gram, and dpstrf's stop rule is conservative, so
# its tolerance sits ~2 decades looser than the eigh cutoff.
_RANK_TOL = 1e-8      # eigh basis: keep lam > tol * lam_max
_PSTRF_TOL = 1e-6     # dpstrf pivot tolerance


def build_recursive_restriction(mesh: Mesh, A_loc: np.ndarray,
                                cell_agg_prev: np.ndarray,
                                R_prev_local: sp.csr_matrix,
                                A_coarse_prev: sp.csr_matrix,
                                boundary_dofs: np.ndarray,
                                n_ev: int, block_dims,
                                prev_batch=None, prev_blocks=None,
                                local_space: str = "overlap",
                                super_range=None) -> tuple:
    """One more AMGe level; returns (R_l csr over the previous coarse space,
    cell_super, super_grid).

    prev_batch: the previous level's AgglomerateBatch when it is the level-0
    batch (level 1): the per-agglomerate block path, with prev_blocks (the
    Galerkin blocks) or the batch's dense A_agg.  Otherwise (prev_batch None:
    levels >= 2, or a light level-0 batch without blocks) the per-cell patch
    path over the cell matrices A_loc, with the constrained fine dofs
    (boundary_dofs) eliminated from the patch operator.

    local_space="interior" (per-agglomerate path, level-0 rows
    agglomerate-major): a super's local space is the previous-level rows it
    owns, and its R rows keep unit weights (mfmg_tpu/amge/multilevel.py:
    173-191).

    super_range: (s_lo, s_hi), the distributed setup's slab: only these
    supers' rows, from prev_batch (and prev_blocks) covering exactly their
    member agglomerates; the (s_hi - s_lo) * n_ev local rows are returned
    without dropping the empty ones (the caller offsets, gathers and drops
    them)."""
    super_of_agg, super_grid = group_agglomerates(mesh, cell_agg_prev, block_dims)
    cell_super = super_of_agg[cell_agg_prev]
    n_super = int(cell_super.max()) + 1
    n_rows_prev = A_coarse_prev.shape[0]
    coarse_diag = np.asarray(A_coarse_prev.diagonal())
    dof_rows, dof_vals = _dof_row_structure(R_prev_local.tocsr())
    if super_range is not None:
        s_lo, s_hi = super_range
        agg_sel = np.nonzero((super_of_agg >= s_lo) & (super_of_agg < s_hi))[0]
        if prev_batch is None or prev_batch.n_agg != len(agg_sel):
            raise ValueError("super_range needs the matching slab batch")
        A1, M, m1s, member_pad = _super_blocks_per_agg(
            prev_batch, super_of_agg[agg_sel] - s_lo, dof_rows, dof_vals,
            n_rows_prev, s_hi - s_lo, blocks=prev_blocks)
        R_l = _solve_and_assemble(A1, M, m1s, member_pad, coarse_diag, n_ev,
                                  n_rows_prev, s_hi - s_lo, drop_empty=False)
        return R_l, cell_super, super_grid
    interior = False
    if prev_batch is not None and prev_batch.n_agg == len(super_of_agg):
        row_super = None
        if local_space == "interior" and n_rows_prev % prev_batch.n_agg == 0:
            # level-0 rows are agglomerate-major (build_restriction): row r
            # belongs to agglomerate r // n_ev, hence to that agg's super
            n_ev_prev = n_rows_prev // prev_batch.n_agg
            row_super = super_of_agg[np.arange(n_rows_prev) // n_ev_prev]
            interior = True
        A1, M, m1s, member_pad = _super_blocks_per_agg(
            prev_batch, super_of_agg, dof_rows, dof_vals, n_rows_prev, n_super,
            row_super=row_super, blocks=prev_blocks)
    else:
        A1, M, m1s, member_pad = _super_blocks_per_cell(
            mesh, A_loc, cell_super, dof_rows, dof_vals, boundary_dofs,
            n_rows_prev, n_super)
    R_l = _solve_and_assemble(A1, M, m1s, member_pad, coarse_diag, n_ev,
                              n_rows_prev, n_super, unit_weights=interior)
    return R_l, cell_super, super_grid


# bytes of the per-cell path's largest per-chunk arrays: the chunk of cells
# is sized so that each of them stays near this (the K blocks, their scatter
# indices, the row tables), which holds the stage's own arrays near 2 GB in
# all whatever the cell count
CELL_CHUNK_BYTES = 256 << 20


def _sorted_cell_rows(cells, dof_rows, n_rows_prev):
    """The coarse rows of every (dof, row) slot of a chunk of cells, sorted
    per cell: (cr (nc, n_loc, q) with -1 padding, order, the sorting
    permutation of each cell's slots, srt, the sorted rows with the padding
    as n_rows_prev, and new, True at each row's first slot)."""
    cr = dof_rows[cells]                                   # (nc, n_loc, q)
    nc = cr.shape[0]
    flat = np.where(cr >= 0, cr, n_rows_prev).reshape(nc, -1)
    order = np.argsort(flat, axis=1, kind="stable")
    srt = np.take_along_axis(flat, order, axis=1)
    new = np.concatenate([np.ones((nc, 1), bool), srt[:, 1:] != srt[:, :-1]],
                         axis=1) & (srt < n_rows_prev)
    return cr, order, srt, new


def _cell_row_tables(cells, dof_rows, n_rows_prev):
    """Per-cell coarse row bases for a chunk of cells: (crows (nc, r_max)
    int64, the sorted coarse rows touching each cell, padded with
    n_rows_prev; pos (nc, n_loc, q), each slot's place in crows; cr, the
    slots' rows, -1 where there is none)."""
    cr, order, srt, new = _sorted_cell_rows(cells, dof_rows, n_rows_prev)
    nc = cr.shape[0]
    r_max = max(int(new.sum(axis=1).max()), 1) if nc else 1
    crows = np.full((nc, r_max), n_rows_prev, dtype=np.int64)
    rank = np.cumsum(new, axis=1) - 1           # each sorted slot's row's place
    ci = np.broadcast_to(np.arange(nc)[:, None], new.shape)
    crows[ci[new], rank[new]] = srt[new]
    pos = np.empty_like(rank)
    np.put_along_axis(pos, order, rank, axis=1)
    return crows, pos.reshape(cr.shape), cr


def _super_blocks_per_cell(mesh: Mesh, A_loc: np.ndarray,
                           cell_super: np.ndarray,
                           dof_rows: np.ndarray, dof_vals: np.ndarray,
                           boundary_dofs: np.ndarray,
                           n_rows_prev: int, n_super: int,
                           chunk_bytes: int = CELL_CHUNK_BYTES):
    """Per-super (A1, Gram) padded batches assembled from per-CELL blocks
    (the reference's _super_blocks_per_cell, mfmg_tpu/amge/multilevel.py:
    195-275).  A1_G = sum over the cells c of G of K_c = Rl_c A_c Rl_c^T,
    Rl_c the R values of the coarse rows touching c at c's dofs with the
    constrained dofs zeroed; M_G = sum over the dofs d of G of r_d r_d^T
    (R's column at d, not eliminated), here as the per-cell blocks
    Rown_c Rown_c^T of each (super, dof) pair's first cell, so that both
    scatter through one native.scatter_super_blocks per chunk of cells.
    Assembly is additive over cells: the chunks change the summation order
    only."""
    cells = mesh.cells.astype(np.int64)
    nc_all, n_loc = cells.shape
    con_all = boundary_dofs[cells]
    cell_super = cell_super.astype(np.int64)
    q = dof_rows.shape[1]

    # ---- ownership: the first cell of each (super, dof) pair -------------
    dkeys = (cell_super[:, None] * np.int64(mesh.n_nodes) + cells).ravel()
    order = np.argsort(dkeys, kind="stable")
    sd = dkeys[order]
    first = np.concatenate([[True], sd[1:] != sd[:-1]])
    own = np.zeros(nc_all * n_loc, dtype=bool)
    own[order[first]] = True
    own = own.reshape(nc_all, n_loc)

    def chunks(per_cell_bytes):
        step = max(1, int(chunk_bytes // max(per_cell_bytes, 1)))
        return range(0, nc_all, step), step

    # ---- pass 1: the member-row table per super, the most rows per cell --
    # (the slot tables hold about 6 int64 per (dof, row) slot)
    rng, step = chunks(6 * 8 * n_loc * q)
    member_keys, r_all = [], 1
    for lo in rng:
        hi = min(lo + step, nc_all)
        _, _, srt, new = _sorted_cell_rows(cells[lo:hi], dof_rows, n_rows_prev)
        r_all = max(r_all, int(new.sum(axis=1).max()))
        member_keys.append(np.unique(
            np.broadcast_to(cell_super[lo:hi, None] * n_rows_prev, srt.shape)[new]
            + srt[new]))
    member_keys = np.unique(np.concatenate(member_keys))
    key_super = member_keys // n_rows_prev
    m1s = np.bincount(key_super, minlength=n_super)
    offs = np.concatenate([[0], np.cumsum(m1s)])
    m1_max = int(m1s.max()) if n_super else 0
    member_pad = np.zeros((n_super, m1_max), dtype=np.int64)
    within = np.arange(len(member_keys)) - offs[key_super]
    member_pad[key_super, within] = member_keys % n_rows_prev

    # ---- pass 2: per-cell K and Gram blocks, scattered chunk by chunk -----
    from mfmg_torch import native
    m1p = m1_max + 1
    A1 = np.zeros((n_super, m1p, m1p))
    M = np.zeros((n_super, m1p, m1p))
    rng, step = chunks(8 * 8 * n_loc * q + 3 * 8 * r_all * (r_all + n_loc))
    for lo in rng:
        hi = min(lo + step, nc_all)
        crows, pos, cr = _cell_row_tables(cells[lo:hi], dof_rows, n_rows_prev)
        nc, r_max = crows.shape
        valid = cr >= 0
        cv = dof_vals[cells[lo:hi]][valid]
        ci = np.broadcast_to(np.arange(nc)[:, None, None], pos.shape)[valid]
        li = np.broadcast_to(np.arange(n_loc)[None, :, None], pos.shape)[valid]
        pv = pos[valid]
        # K from the values with the constrained dofs eliminated, the Gram
        # from the values as they are at the dofs each cell owns
        Rl = np.zeros((nc, r_max, n_loc))
        Rl[ci, pv, li] = np.where(con_all[lo:hi][ci, li], 0.0, cv)
        Ro = np.zeros((nc, r_max, n_loc))
        Ro[ci, pv, li] = np.where(own[lo:hi][ci, li], cv, 0.0)
        K = np.empty((nc, r_max, r_max))
        Mc = np.empty((nc, r_max, r_max))
        A_c = A_loc[lo:hi]

        def _blk(a, b):
            np.matmul(np.matmul(Rl[a:b], A_c[a:b]), np.swapaxes(Rl[a:b], 1, 2),
                      out=K[a:b])
            np.matmul(Ro[a:b], np.swapaxes(Ro[a:b], 1, 2), out=Mc[a:b])

        _run_threaded(_blk, nc)
        row_ok = crows < n_rows_prev
        g = cell_super[lo:hi]
        keys = np.where(row_ok, g[:, None] * n_rows_prev + crows, 0)
        gpos = np.where(row_ok, np.searchsorted(member_keys, keys)
                        - offs[g][:, None], m1_max)
        native.scatter_super_blocks(g, gpos, K, Mc, n_super, m1p, out=(A1, M))
    A1 = A1[:, :m1_max, :m1_max]
    M = M[:, :m1_max, :m1_max]
    A1 = 0.5 * (A1 + np.swapaxes(A1, 1, 2))
    M = 0.5 * (M + np.swapaxes(M, 1, 2))
    return A1, M, m1s, member_pad


class AggBlocks:
    """Per-agglomerate dense R / Galerkin blocks (shared by the global
    Galerkin product and the recursive level's patch assembly).

    arows : (n_agg, t_max) coarse rows touching each agglomerate (padded)
    t_s   : (n_agg,) valid row counts
    Rb    : (n_agg, t_max, m) dense blocks of R restricted to rows x agg dofs
    K     : (n_agg, t_max, t_max) Galerkin blocks  Rb A_agg Rb^T
    """

    __slots__ = ("arows", "t_s", "Rb", "K")

    def __init__(self, arows, t_s, Rb, K):
        self.arows, self.t_s, self.Rb, self.K = arows, t_s, Rb, K


def agg_galerkin_blocks(batch, dof_rows: np.ndarray, dof_vals: np.ndarray,
                        n_rows: int, eliminate: bool = True) -> AggBlocks:
    """Batched per-agglomerate Galerkin blocks K_a = Rb_a A_a Rb_a^T.

    Assembly is additive over cells and every cell belongs to exactly one
    agglomerate, so scattering the K_a reproduces R A R^T exactly.
    eliminate: additionally zero R values at constrained dofs inside the
    blocks (the recursive level's local-eigenproblem convention).  n_rows
    (R's rows) is what the plain version ``agg_row_blocks_plain`` keys on.
    """
    from mfmg_torch import native
    dm = np.where(batch.valid, batch.dof_map, 0)
    keep = batch.valid & ~batch.constrained if eliminate else batch.valid
    arows, t_s, Rb = native.agg_row_blocks(dm, batch.valid, keep, dof_rows,
                                           dof_vals)
    n_agg, t_max = arows.shape

    # K in the batch's dtype (float32 batches halve the BLAS-3 time)
    kdt = batch.A_agg.dtype
    K = np.empty((n_agg, t_max, t_max), dtype=kdt)

    def _blk(lo, hi):
        Rb_c = Rb[lo:hi].astype(kdt, copy=False)
        tmp = np.matmul(Rb_c, batch.A_agg[lo:hi])
        np.matmul(tmp, np.swapaxes(Rb_c, 1, 2), out=K[lo:hi])

    _run_threaded(_blk, n_agg)
    return AggBlocks(arows, t_s, Rb, K)


def agg_row_blocks_plain(dm, valid, keep, dof_rows, dof_vals, n_rows):
    """The numpy version of native.agg_row_blocks (global-key unique and
    searchsorted positions): (arows, t_s, Rb)."""
    n_agg, m = dm.shape
    ar = np.where(valid[:, :, None], dof_rows[dm], -1)     # (n_agg, m, q)
    av = np.where(keep[:, :, None], dof_vals[dm], 0.0)
    ok = ar >= 0
    keys = np.where(ok, np.arange(n_agg, dtype=np.int64)[:, None, None]
                    * n_rows + ar, -1)
    agg_keys = np.unique(keys[ok])                     # agg-major sorted
    key_agg = agg_keys // n_rows
    t_s = np.bincount(key_agg, minlength=n_agg)
    offs_a = np.concatenate([[0], np.cumsum(t_s)])
    t_max = int(t_s.max()) if n_agg else 0
    arows = np.zeros((n_agg, t_max), dtype=np.int64)
    within = np.arange(len(agg_keys)) - offs_a[key_agg]
    arows[key_agg, within] = agg_keys % n_rows
    # dense per-agg R blocks ((row, dof) pairs are unique -> assignment)
    pos = np.searchsorted(agg_keys, np.where(ok, keys, 0)) - offs_a[
        np.arange(n_agg)[:, None, None]]
    ai = np.broadcast_to(np.arange(n_agg)[:, None, None], ar.shape)
    si = np.broadcast_to(np.arange(m)[None, :, None], ar.shape)
    Rb = np.zeros((n_agg, t_max, m))
    Rb[ai[ok], pos[ok], si[ok]] = av[ok]
    return arows, t_s, Rb


def galerkin_product_from_blocks(blocks: AggBlocks, n_rows: int) -> sp.csr_matrix:
    """A_coarse = R A R^T assembled from the per-agglomerate Galerkin blocks
    (the global fine matrix never exists)."""
    t_max = blocks.arows.shape[1]
    valid = np.arange(t_max)[None] < blocks.t_s[:, None]
    vij = valid[:, :, None] & valid[:, None, :]
    ri = np.broadcast_to(blocks.arows[:, :, None], blocks.K.shape)[vij]
    cj = np.broadcast_to(blocks.arows[:, None, :], blocks.K.shape)[vij]
    A = sp.csr_matrix((blocks.K[vij], (ri, cj)), shape=(n_rows, n_rows))
    A.sum_duplicates()
    # padded patch-row pairs that share no cell are exact structural zeros;
    # dropping them keeps the coarse graph inside the block-stencil window
    A.eliminate_zeros()
    return A


def _super_blocks_per_agg(batch, super_of_agg: np.ndarray,
                          dof_rows: np.ndarray, dof_vals: np.ndarray,
                          n_rows_prev: int, n_super: int,
                          row_super=None, blocks: AggBlocks | None = None):
    """Per-super (A1, Gram) padded batches from per-agglomerate blocks:
    K_a = Rb_a A_a Rb_a^T and M_a = Rown_a Rown_a^T (Rown = Rb masked to the
    dofs owned by a within its super, so each dof of a super counts once).
    row_super (the owning super of each previous-level row): a super's
    member rows are only the rows it owns (interior-only local spaces)."""
    if blocks is None:
        blocks = agg_galerkin_blocks(batch, dof_rows, dof_vals, n_rows_prev)
    arows, t_s, Rb, K = blocks.arows, blocks.t_s, blocks.Rb, blocks.K
    n_agg, m = batch.dof_map.shape
    t_max = arows.shape[1]
    dm = np.where(batch.valid, batch.dof_map, 0)

    # ownership: one owner agglomerate per (super, dof)
    G_of = super_of_agg.astype(np.int64)
    dkeys = np.where(batch.valid, G_of[:, None] * np.int64(dm.max() + 1) + dm, -1)
    flatd = dkeys.ravel()
    order = np.argsort(flatd, kind="stable")
    sortd = flatd[order]
    first = np.concatenate([[True], sortd[1:] != sortd[:-1]]) & (sortd >= 0)
    own = np.zeros(n_agg * m, dtype=bool)
    own[order[first]] = True
    own2 = own.reshape(n_agg, m)

    wdt = K.dtype
    Mb = np.empty((n_agg, t_max, t_max), dtype=wdt)

    def _blk(lo, hi):
        Rm = Rb[lo:hi].astype(wdt, copy=False) * own2[lo:hi][:, None, :]
        np.matmul(Rm, np.swapaxes(Rm, 1, 2), out=Mb[lo:hi])

    _run_threaded(_blk, n_agg)

    # member-row table per super + scatter
    skeys = np.where(np.arange(t_max)[None] < t_s[:, None],
                     G_of[:, None] * n_rows_prev + arows, -1)
    if row_super is not None:
        # rows owned by neighbouring supers drop out of the patch blocks
        skeys = np.where((skeys >= 0) & (row_super[arows] == G_of[:, None]),
                         skeys, -1)
    member_keys = np.unique(skeys[skeys >= 0])
    key_super = member_keys // n_rows_prev
    m1s = np.bincount(key_super, minlength=n_super)
    offs = np.concatenate([[0], np.cumsum(m1s)])
    m1_max = int(m1s.max()) if n_super else 0
    member_pad = np.zeros((n_super, m1_max), dtype=np.int64)
    within = np.arange(len(member_keys)) - offs[key_super]
    member_pad[key_super, within] = member_keys % n_rows_prev

    m1p = m1_max + 1
    s_ok = skeys >= 0
    gpos = np.where(s_ok, np.searchsorted(member_keys, np.where(s_ok, skeys, 0))
                    - offs[G_of][:, None], m1_max)         # (n_agg, t_max)
    from mfmg_torch import native
    A1, M = native.scatter_super_blocks(G_of, gpos, K, Mb, n_super, m1p)
    A1 = A1[:, :m1_max, :m1_max]
    M = M[:, :m1_max, :m1_max]
    A1 = 0.5 * (A1 + np.swapaxes(A1, 1, 2))
    M = 0.5 * (M + np.swapaxes(M, 1, 2))
    return A1, M, m1s, member_pad


def _run_threaded(fn, n, min_per_worker=16):
    """Run fn(lo, hi) over [0, n) split across a thread pool, with
    BLAS-internal threading pinned to 1 inside the pool (nested OpenBLAS
    threads oversubscribe small hosts)."""
    n_workers = min(os.cpu_count() or 1, 8, max(1, n // min_per_worker))
    if n_workers <= 1:
        fn(0, n)
        return
    from mfmg_torch.utils.threads import blas_single_thread
    bounds = np.linspace(0, n, n_workers + 1).astype(int)
    with blas_single_thread():
        with ThreadPoolExecutor(n_workers) as pool:
            for f in [pool.submit(fn, bounds[t], bounds[t + 1])
                      for t in range(n_workers)]:
                f.result()


def _solve_and_assemble(A1, M, m1s, member_pad, coarse_diag, n_ev,
                        n_rows_prev, n_super, unit_weights=False,
                        drop_empty=True):
    """Per-super rank-revealing eigensolves (threaded LAPACK) and assembly
    of R_l with PoU weights (unit weights for interior-only local spaces).
    The degenerate pencil (A1, M) is reduced with an M-orthonormal basis W
    of range(M): pivoted Cholesky (Jacobi-scaled), with the
    eigendecomposition of M as the fallback.  drop_empty=False keeps the
    empty rows (a distributed slab's row offsets stay put)."""
    import scipy.linalg as sla
    from scipy.linalg.lapack import dpstrf

    m1_max = member_pad.shape[1]
    diag1 = np.einsum("gii->gi", A1)
    cols_pad = np.zeros((n_super, n_ev, m1_max))
    kks = np.zeros(n_super, dtype=np.int64)

    def _reduce_pstrf(Ag, Mg, m1):
        d = np.sqrt(np.maximum(Mg.diagonal(), 1e-300))
        Dg = 1.0 / d
        Ms = Mg * Dg[:, None] * Dg[None, :]
        c, piv, r, info = dpstrf(Ms, lower=1, tol=_PSTRF_TOL)
        if info < 0 or r == 0:
            return None
        piv = piv - 1                                  # LAPACK is 1-based
        L11 = np.tril(c[:r, :r])
        Ap = (Ag * Dg[:, None] * Dg[None, :])[np.ix_(piv, piv)]
        X = sla.solve_triangular(L11, Ap[:, :r].T, lower=True,
                                 check_finite=False).T
        A_red = sla.solve_triangular(L11, X[:r], lower=True,
                                     check_finite=False)
        A_red = 0.5 * (A_red + A_red.T)
        kk = min(n_ev, r)
        w_, y_ = sla.eigh(A_red, subset_by_index=[0, kk - 1],
                          driver="evr", check_finite=False)
        cr = sla.solve_triangular(L11, y_, lower=True, trans="T",
                                  check_finite=False)   # L11^{-T} y
        c_full = np.zeros((m1, kk))
        c_full[piv[:r]] = cr
        return kk, c_full * Dg[:, None]

    def _reduce_eigh(Ag, Mg, m1):
        lam, Q = np.linalg.eigh(Mg)
        r = int(np.sum(lam > _RANK_TOL * max(lam[-1], 1e-300)))
        if r == 0:
            return None
        W = Q[:, m1 - r:] / np.sqrt(lam[m1 - r:])
        A_red = W.T @ Ag @ W
        A_red = 0.5 * (A_red + A_red.T)
        kk = min(n_ev, r)
        w_, y_ = sla.eigh(A_red, subset_by_index=[0, kk - 1],
                          driver="evr", check_finite=False)
        return kk, W @ y_

    def _solve_range(lo, hi):
        for G in range(lo, hi):
            m1 = int(m1s[G])
            if m1 == 0:
                continue
            Ag, Mg = A1[G, :m1, :m1], M[G, :m1, :m1]
            try:
                out = _reduce_pstrf(Ag, Mg, m1)
            except (np.linalg.LinAlgError, ValueError):
                out = None
            if out is None:
                out = _reduce_eigh(Ag, Mg, m1)
            if out is None:
                continue
            kk, c = out
            kks[G] = kk
            if unit_weights:
                cols_pad[G, :kk, :m1] = c.T
            else:
                w_pou = diag1[G, :m1] / coarse_diag[member_pad[G, :m1]]
                cols_pad[G, :kk, :m1] = (w_pou[:, None] * c).T

    _run_threaded(_solve_range, n_super, min_per_worker=2)

    gsel, jsel = np.nonzero(np.arange(n_ev)[None] < kks[:, None])
    rows_out = np.repeat(gsel * n_ev + jsel, m1s[gsel])
    mask = np.arange(m1_max)[None] < m1s[gsel][:, None]
    cols_out = member_pad[gsel][mask]
    vals_out = cols_pad[gsel, jsel][mask]
    R_l = sp.csr_matrix((vals_out, (rows_out, cols_out)),
                        shape=(n_super * n_ev, n_rows_prev))
    if not drop_empty:
        return R_l
    nonzero = np.diff(R_l.indptr) > 0
    return R_l[nonzero]
