"""Distributed (multi-process) hierarchy setup: levels 0 and 1.

Port of mfmg_tpu/parallel/dist_setup.py.  The reference's whole setup runs
under MPI domain decomposition: each rank builds only its own agglomerates,
and the restriction is assembled by all-gathering the per-rank rows
(amge.templates.hpp:596-643).  Over the ranks of a ``torch.distributed``
group (``Config.distributed_setup``, active only where the group has more
than one rank):

* SUPER-agglomerates (the level-1 groups) are split into contiguous slabs,
  and each rank's level-0 slab is its supers' member agglomerates
  (``super_partition``): one partition drives the level-0 eigensolve, the
  level-0 Galerkin blocks and the level-1 recursive restrictor
  (``distributed_recursive_restriction``);
* each rank assembles and eigensolves only its slab's dense batch; the
  eigenpairs are all-gathered (``distributed_eigensolve``,
  ``gather_to_rows``) and every rank assembles the full R;
* the Galerkin product A_c = R A R^T is additive over agglomerates: each
  rank forms its slab's blocks, and the COO triplets are all-gathered and
  summed (``distributed_galerkin``, ``allgather_coo``);
* the fine stencil extraction is additive over cells: each rank scatters
  its own cell range and the planes are summed over the ranks
  (``distributed_stencil_planes``);
* levels >= 2 stay replicated.

These collectives move host arrays, as the reference's process_allgather
does: they run on a gloo group over CPU tensors (the default group where it
is gloo, else one ``dist.new_group(backend="gloo")`` made once).  Sums over
the ranks add the ranks' arrays in rank order on every rank, so every rank
builds the same bits.  The process count and index come from the group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

_HOST_GROUP = {}


def _host_group():
    """The gloo group of the host-side setup collectives (None: the
    default group, where it is gloo)."""
    if str(dist.get_backend()).lower() == "gloo":
        return None
    if "group" not in _HOST_GROUP:
        _HOST_GROUP["group"] = dist.new_group(backend="gloo")
    return _HOST_GROUP["group"]


def _nproc_pid(nproc=None, pid=None):
    if nproc is None:
        nproc = dist.get_world_size(_host_group())
    if pid is None:
        pid = dist.get_rank(_host_group())
    return nproc, pid


def _allgather(arr: np.ndarray) -> np.ndarray:
    """(nproc,) + arr.shape: every rank's same-shape host array."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(_host_group()))]
    dist.all_gather(out, t, group=_host_group())
    return torch.stack(out).numpy()


def slab_range(n: int):
    """Contiguous [lo, hi) slab of n items for this rank."""
    nproc, pid = _nproc_pid()
    bounds = np.linspace(0, n, nproc + 1).astype(int)
    return int(bounds[pid]), int(bounds[pid + 1])


def _pad_to(arr: np.ndarray, m: int) -> np.ndarray:
    pad = np.zeros((m,) + arr.shape[1:], dtype=arr.dtype)
    pad[: arr.shape[0]] = arr
    return pad


def _allreduce_sum(arr: np.ndarray) -> np.ndarray:
    """The sum of a same-shape host array over the ranks, in rank order."""
    return _allgather(arr).sum(axis=0)


def to_host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def super_partition(super_of_agg: np.ndarray, nproc: int | None = None,
                    pid: int | None = None):
    """Partition SUPER-agglomerates into contiguous slabs and derive each
    rank's level-0 agglomerate index set (its supers' member agglomerates).

    Aligning the level-0 slab to super boundaries lets the same slab batch
    drive the level-0 eigensolve, the level-0 Galerkin blocks and the
    level-1 recursive restrictor (every member agglomerate of an owned
    super is local).  Returns (agg_sel (this rank), (s_lo, s_hi),
    sel_counts (per rank), agg_sels (list per rank: deterministic, no
    communication needed))."""
    nproc, pid = _nproc_pid(nproc, pid)
    n_super = int(super_of_agg.max()) + 1
    if nproc > n_super:
        # an empty super slab would flow an n_agg == 0 batch into the slab
        # eigensolve and Galerkin-block paths, which are not written for it
        raise ValueError(
            f"distributed setup needs process_count <= n_super "
            f"({nproc} processes > {n_super} super-agglomerates); use fewer "
            f"processes or a finer mesh, or disable Config.distributed_setup")
    bounds = np.linspace(0, n_super, nproc + 1).astype(int)
    agg_sels = [np.nonzero((super_of_agg >= bounds[p])
                           & (super_of_agg < bounds[p + 1]))[0]
                for p in range(nproc)]
    counts = np.array([len(s) for s in agg_sels])
    return (agg_sels[pid], (int(bounds[pid]), int(bounds[pid + 1])),
            counts, agg_sels)


def gather_to_rows(arr_slab: np.ndarray, agg_sels, n_total: int) -> np.ndarray:
    """All-gather per-rank row slabs (selected by arbitrary index sets) into
    the full (n_total, ...) array."""
    counts = np.array([len(s) for s in agg_sels])
    g = _allgather(_pad_to(np.asarray(arr_slab), int(counts.max())))
    out = np.zeros((n_total,) + g.shape[2:], dtype=g.dtype)
    for p, sel in enumerate(agg_sels):
        out[sel] = g[p, : counts[p]]
    return out


def distributed_eigensolve(batch_slab, agg_sels, n_total: int, eigensolve):
    """Eigensolve only this rank's slab (``batch_slab``, the agglomerates
    ``agg_sels[rank]``); the (evals, evecs) of all n_total agglomerates,
    gathered to every rank in float64."""
    return tuple(gather_to_rows(to_host(a).astype(np.float64), agg_sels, n_total)
                 for a in eigensolve(batch_slab))


def allgather_coo(A_part, shape):
    """Sum per-rank sparse contributions: COO triplets padded to the largest
    nnz, one all-gather each, rebuilt and sum_duplicates (the analog of
    Trilinos compress after per-rank assembly)."""
    import scipy.sparse as sp

    A_part = A_part.tocoo()
    counts = _allgather(np.array([A_part.nnz], dtype=np.int64))[:, 0]
    m = int(counts.max())
    parts = [_allgather(_pad_to(np.asarray(a, dtype=dt), m))
             for a, dt in ((A_part.row, np.int64), (A_part.col, np.int64),
                           (A_part.data, np.float64))]
    r, c, v = (np.concatenate([g[p, : counts[p]] for p in range(len(counts))])
               for g in parts)
    A = sp.csr_matrix((v, (r, c)), shape=shape)
    A.sum_duplicates()
    return A


def distributed_recursive_restriction(mesh, A_loc, cell_agg_prev, R_prev,
                                      A_coarse_prev, boundary_dofs, n_ev,
                                      block_dims, batch_slab, blocks_slab,
                                      super_range):
    """Level-1 restrictor with each rank building only its super slab: the
    local rows are offset to their global position, all-gathered as COO,
    and empty rows (supers whose pencil lost rank) dropped globally."""
    import scipy.sparse as sp

    from mfmg_torch.amge.multilevel import build_recursive_restriction

    R_local, cell_super, super_grid = build_recursive_restriction(
        mesh, A_loc, cell_agg_prev, R_prev, A_coarse_prev, boundary_dofs,
        n_ev, block_dims, prev_batch=batch_slab, prev_blocks=blocks_slab,
        super_range=super_range)
    n_super = int(cell_super.max()) + 1
    s_lo, _ = super_range
    part = R_local.tocoo()
    shifted = sp.coo_matrix(
        (part.data, (part.row + s_lo * n_ev, part.col)),
        shape=(n_super * n_ev, R_local.shape[1]))
    R_full = allgather_coo(shifted, shifted.shape)
    nonzero = np.diff(R_full.indptr) > 0
    return R_full[nonzero], cell_super, super_grid


def distributed_galerkin(batch_slab, dof_rows, dof_vals, n_rows,
                         return_blocks: bool = False):
    """This slab's contribution to A_c = R A R^T, summed over the ranks
    (COO triplets all-gathered).  return_blocks=True also returns the
    slab's AggBlocks for the distributed level-1 restrictor."""
    from mfmg_torch.amge.multilevel import (agg_galerkin_blocks,
                                            galerkin_product_from_blocks)

    blocks = agg_galerkin_blocks(batch_slab, dof_rows, dof_vals, n_rows,
                                 eliminate=False)
    A_part = galerkin_product_from_blocks(blocks, n_rows)
    A = allgather_coo(A_part, (n_rows, n_rows))
    A.eliminate_zeros()
    return (A, blocks) if return_blocks else A


def distributed_stencil_planes(mesh, A_loc, n_offsets: int, n_nodes: int,
                               oid_ab: np.ndarray) -> np.ndarray:
    """Raw (un-eliminated) stencil planes from this rank's cell range,
    summed over the ranks (the extraction is additive over cells)."""
    from mfmg_torch import native

    lo, hi = slab_range(mesh.n_cells)
    coeffs = native.stencil_scatter(mesh.cells[lo:hi], oid_ab, A_loc[lo:hi],
                                    n_offsets, n_nodes)
    return _allreduce_sum(coeffs)
