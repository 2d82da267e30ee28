"""Multilevel graph partitioner (METIS-style) for unstructured agglomeration.

Port of mfmg_tpu/amge/graph_partition.py (plain numpy, the same
``np.random.default_rng(seed)`` draws in the same order, so the partition
is identical).  It is the analog of the reference's METIS/Zoltan
partitioner option (reference common/amge.templates.hpp:501-594, which
hands the cell connectivity graph to deal.II's SparsityTools::partition),
without an external graph library: the standard multilevel scheme those
libraries use:

  1. coarsen by heavy-edge matching until the graph is small,
  2. initial k-way split by recursive bisection (BFS region growth seeded at
     a peripheral vertex),
  3. uncoarsen, refining each bisection with Fiedler-free FM/KL boundary
     passes (move the highest-gain boundary vertex subject to balance).

Everything is plain numpy on the setup host; the result feeds the same
batched AMGe machinery as the block partitioner.
"""

from __future__ import annotations

import numpy as np


def adjacency_from_cells(mesh) -> tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, indices) of the face-neighbor cell graph."""
    from mfmg_torch.amge.agglomeration import face_neighbors

    nbrs = face_neighbors(mesh)
    n = nbrs.shape[0]
    rows, cols = np.nonzero(nbrs >= 0)
    cols = nbrs[rows, cols]
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, cols.astype(np.int64)


def _heavy_edge_matching(indptr, indices, ew, vw, rng):
    """One coarsening pass: match each vertex to its heaviest unmatched
    neighbor; returns (coarse_of, n_coarse)."""
    n = len(indptr) - 1
    match = -np.ones(n, dtype=np.int64)
    visit = rng.permutation(n)
    for u in visit:
        if match[u] >= 0:
            continue
        best, best_w = -1, -1.0
        for e in range(indptr[u], indptr[u + 1]):
            v = indices[e]
            if match[v] < 0 and v != u and ew[e] > best_w:
                best, best_w = v, ew[e]
        match[u] = best if best >= 0 else u
        if best >= 0:
            match[best] = u
    coarse_of = -np.ones(n, dtype=np.int64)
    nc = 0
    for u in range(n):
        if coarse_of[u] >= 0:
            continue
        coarse_of[u] = nc
        if match[u] != u:
            coarse_of[match[u]] = nc
        nc += 1
    return coarse_of, nc


def _coarsen(indptr, indices, ew, vw, coarse_of, nc):
    """Contract the graph along the matching (sums edge/vertex weights)."""
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    cr, cc = coarse_of[rows], coarse_of[indices]
    keep = cr != cc
    cr, cc, cw = cr[keep], cc[keep], ew[keep]
    key = cr * nc + cc
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.zeros(len(uniq))
    np.add.at(w, inv, cw)
    cr, cc = uniq // nc, uniq % nc
    order = np.argsort(cr, kind="stable")
    cr, cc, w = cr[order], cc[order], w[order]
    iptr = np.zeros(nc + 1, dtype=np.int64)
    np.add.at(iptr, cr + 1, 1)
    iptr = np.cumsum(iptr)
    vw2 = np.zeros(nc)
    np.add.at(vw2, coarse_of, vw)
    return iptr, cc, w, vw2


def _grow_bisection(indptr, indices, vw, target, rng):
    """BFS region growth from a (pseudo-)peripheral vertex until the grown
    side reaches `target` vertex weight; returns side mask."""
    n = len(indptr) - 1
    # peripheral seed: BFS twice from a random vertex
    def bfs_far(s):
        dist = -np.ones(n, dtype=np.int64)
        dist[s] = 0
        q = [s]
        last = s
        while q:
            nq = []
            for u in q:
                for e in range(indptr[u], indptr[u + 1]):
                    v = indices[e]
                    if dist[v] < 0:
                        dist[v] = dist[u] + 1
                        nq.append(v)
                        last = v
            q = nq
        return last
    from collections import deque
    s = bfs_far(bfs_far(int(rng.integers(n))))
    side = np.zeros(n, dtype=bool)
    grown = 0.0
    q = deque([s])
    seen = np.zeros(n, dtype=bool)
    seen[s] = True
    while q and grown < target:
        u = q.popleft()
        if grown + vw[u] > target * 1.1:
            continue
        side[u] = True
        grown += vw[u]
        for e in range(indptr[u], indptr[u + 1]):
            v = indices[e]
            if not seen[v]:
                seen[v] = True
                q.append(v)
    # disconnected leftovers: dump smallest-weight unseen vertices to balance
    if grown < target:
        for u in np.nonzero(~side)[0]:
            if grown >= target:
                break
            if not seen[u]:
                side[u] = True
                grown += vw[u]
    return side


def _fm_refine(indptr, indices, ew, vw, side, target, n_passes=4):
    """FM boundary refinement: repeatedly move the best-gain boundary vertex
    (gain = external minus internal edge weight), keeping both sides within
    10% of their targets.  Gains are recomputed vectorized after each move —
    O(m) numpy work per move, with moves bounded by the boundary size."""
    n = len(vw)
    total = vw.sum()
    rows = np.repeat(np.arange(n), np.diff(indptr))
    w_side = vw[side].sum()
    for _ in range(n_passes):
        moved_any = False
        max_moves = max(16, int(np.count_nonzero(
            side[rows] != side[indices]) // 2))
        for _move in range(max_moves):
            cross = side[rows] != side[indices]
            ext = np.bincount(rows, ew * cross, minlength=n)
            intr = np.bincount(rows, ew * ~cross, minlength=n)
            gain = ext - intr
            new_w = np.where(side, w_side - vw, w_side + vw)
            movable = (ext > 0) & (np.abs(new_w - target) <= 0.1 * total)
            gain = np.where(movable, gain, -np.inf)
            u = int(np.argmax(gain))
            if not np.isfinite(gain[u]) or gain[u] <= 0:
                break
            w_side += -vw[u] if side[u] else vw[u]
            side[u] = ~side[u]
            moved_any = True
        if not moved_any:
            break
    return side


def _bisect_multilevel(indptr, indices, ew, vw, target, rng, min_size=64):
    n = len(indptr) - 1
    if n > min_size:
        coarse_of, nc = _heavy_edge_matching(indptr, indices, ew, vw, rng)
        if nc < n:
            ci, cj, cw, cvw = _coarsen(indptr, indices, ew, vw, coarse_of, nc)
            cside = _bisect_multilevel(ci, cj, cw, cvw, target, rng, min_size)
            side = cside[coarse_of]
            return _fm_refine(indptr, indices, ew, vw, side, target, n_passes=2)
    side = _grow_bisection(indptr, indices, vw, target, rng)
    return _fm_refine(indptr, indices, ew, vw, side, target)


def partition_graph(indptr, indices, n_parts: int, seed: int = 0) -> np.ndarray:
    """k-way partition by recursive multilevel bisection; returns part ids."""
    n = len(indptr) - 1
    ew = np.ones(len(indices))
    vw = np.ones(n)
    out = np.zeros(n, dtype=np.int64)
    rng = np.random.default_rng(seed)

    def rec(ids, k, base):
        if k <= 1 or len(ids) <= 1:
            out[ids] = base
            return
        # subgraph
        gmap = -np.ones(n, dtype=np.int64)
        gmap[ids] = np.arange(len(ids))
        si, sj, sw = [], [], []
        iptr = [0]
        for u in ids:
            for e in range(indptr[u], indptr[u + 1]):
                v = gmap[indices[e]]
                if v >= 0:
                    sj.append(v)
                    sw.append(ew[e])
            iptr.append(len(sj))
        iptr = np.asarray(iptr)
        sj = np.asarray(sj, dtype=np.int64)
        sw = np.asarray(sw)
        svw = vw[ids]
        k1 = k // 2
        target = svw.sum() * k1 / k
        side = _bisect_multilevel(iptr, sj, sw, svw, target, rng)
        rec(ids[side], k1, base)
        rec(ids[~side], k - k1, base + k1)

    rec(np.arange(n), n_parts, 0)
    return out


def build_agglomerates_multilevel(mesh, n_agglomerates: int,
                                  seed: int = 0) -> np.ndarray:
    indptr, indices = adjacency_from_cells(mesh)
    return partition_graph(indptr, indices, n_agglomerates, seed)
