"""The reference's own mesh of upstream's hyper_ball (tests/laplace.hpp:
GridGenerator::hyper_ball, refine_global), from deal.II's definition.

The coarse mesh: an inner cube of half-width b / (1 + sqrt 3), b = 1 / sqrt 3,
and six cells from its faces out to the cube of half-width b, whose corners
lie on the unit sphere.  Each refinement places every new point by deal.II's
transfinite (Coons) blend of the points around it (TriaAccessor::center):
an edge's midpoint is the mean of its ends; a face's is 1/2 the sum of its
edges' midpoints less 1/4 the sum of its corners; a cell's centre is 1/2
the sum of its faces' midpoints less 1/4 the sum of its edges' plus 1/8 the
sum of its corners.  On the sphere (the faces that one cell only has, and
their edges) the same weights act on unit directions and the point is
projected onto the sphere.  Every node on the sphere is a Dirichlet dof.
Plain NumPy on the host, numbered in its own order; ``locate`` matches the
program's points to it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.fem import FACES

# the 12 edges of a hexahedron, node i = ix + 2 iy + 4 iz: (i, i + 2^d)
_EDGES = tuple((i, i + (1 << d)) for d in range(3) for i in range(8)
               if not (i >> d) & 1)


def _coarse():
    b = 1.0 / np.sqrt(3.0)
    a = b / (1.0 + np.sqrt(3.0))
    s = np.array([[x, y, z] for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)],
                 dtype=float)
    verts = np.vstack([a * s, b * s])              # 0-7 inner, 8-15 outer
    # a cell per face of the inner cube: the face, then its image outside,
    # ordered so that the local axes follow x, y, z
    cells = [list(range(8))]
    for d in range(3):
        for side in (0, 1):
            f = [i for i in range(8) if (i >> d) & 1 == side]
            inner, outer = f, [8 + i for i in f]
            lo, hi = (outer, inner) if side == 0 else (inner, outer)
            cell = [0] * 8
            for j, i in enumerate(f):
                cell[i & ~(1 << d)] = lo[j]
                cell[i | (1 << d)] = hi[j]
            cells.append(cell)
    return verts, np.array(cells, dtype=np.int64)


def _unit(p):
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def _entities(cells, groups):
    """Each cell's entities of the local node groups (e.g. its edges), as
    ids into the unique entities, and the unique ones' node lists."""
    local = cells[:, np.asarray(groups)]                    # (nc, g, k)
    key = np.sort(local, axis=2).reshape(-1, local.shape[2])
    uniq, first, inv = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True)
    return inv.reshape(cells.shape[0], len(groups)), local.reshape(
        -1, local.shape[2])[first]


def refine(verts, cells):
    """One uniform refinement: (verts, cells) with 8 children a cell."""
    nc, n0 = cells.shape[0], verts.shape[0]
    f_id, f_nodes = _entities(cells, FACES)            # faces (00,10,01,11)
    on_sphere = np.bincount(f_id.reshape(-1), minlength=len(f_nodes)) == 1
    e_id, e_nodes = _entities(cells, _EDGES)
    # edges of the faces on the sphere
    bf = f_nodes[on_sphere]
    be = np.sort(np.concatenate([bf[:, [0, 1]], bf[:, [2, 3]], bf[:, [0, 2]],
                                 bf[:, [1, 3]]]), axis=1)
    e_key = np.sort(e_nodes, axis=1)
    e_sphere = np.isin(e_key[:, 0] * n0 + e_key[:, 1], be[:, 0] * n0 + be[:, 1])

    E = 0.5 * (verts[e_nodes[:, 0]] + verts[e_nodes[:, 1]])
    E[e_sphere] = _unit(E[e_sphere])

    # a face's edges in its layout: (0,1), (2,3), (0,2), (1,3)
    keys = e_key[:, 0] * n0 + e_key[:, 1]                  # ascending
    pairs = np.sort(f_nodes[:, [[0, 1], [2, 3], [0, 2], [1, 3]]], axis=2)
    fe = np.searchsorted(keys, pairs[..., 0] * n0 + pairs[..., 1])
    F = 0.5 * E[fe].sum(1) - 0.25 * verts[f_nodes].sum(1)
    Fs = 0.5 * _unit(E[fe[on_sphere]]).sum(1) \
        - 0.25 * _unit(verts[f_nodes[on_sphere]]).sum(1)
    F[on_sphere] = _unit(Fs)

    H = 0.5 * F[f_id].sum(1) - 0.25 * E[e_id].sum(1) \
        + 0.125 * verts[cells].sum(1)

    V = np.vstack([verts, E, F, H])
    # each cell's 3x3x3 grid of points, index a + 3 b + 9 c
    g = np.empty((nc, 27), dtype=np.int64)
    off_e, off_f, off_h = n0, n0 + len(E), n0 + len(E) + len(F)
    for c3 in range(27):
        t = (c3 % 3, (c3 // 3) % 3, c3 // 9)
        odd = [d for d in range(3) if t[d] == 1]
        even = [t[d] // 2 for d in range(3)]
        corner = even[0] + 2 * even[1] + 4 * even[2]
        if not odd:
            g[:, c3] = cells[:, corner]
        elif len(odd) == 1:
            g[:, c3] = off_e + e_id[:, _EDGES.index((corner, corner + (1 << odd[0])))]
        elif len(odd) == 2:
            d = ({0, 1, 2} - set(odd)).pop()
            g[:, c3] = off_f + f_id[:, 2 * d + even[d]]
        else:
            g[:, c3] = off_h + np.arange(nc)
    children = [[(sx + lx) + 3 * (sy + ly) + 9 * (sz + lz)
                 for lz in (0, 1) for ly in (0, 1) for lx in (0, 1)]
                for sz in (0, 1) for sy in (0, 1) for sx in (0, 1)]
    return V, g[:, np.asarray(children)].reshape(-1, 8)


def mesh(cfg: dict, n_refinements: int, device):
    """(nodes (n, 3) float64, cells (n_cells, 8) int64, constrained (n,)
    bool) on ``device``."""
    verts, cells = _coarse()
    for _ in range(n_refinements):
        verts, cells = refine(verts, cells)
    nodes = torch.as_tensor(verts, dtype=torch.float64, device=device)
    cells = torch.as_tensor(cells, dtype=torch.int64, device=device)
    on_sphere = (torch.linalg.norm(nodes, dim=1) - 1.0).abs() < 1e-9
    return nodes, cells, on_sphere


def locate(nodes: torch.Tensor, points: torch.Tensor):
    """(idx, gap): the node each point lies nearest to, and its distance."""
    from scipy.spatial import cKDTree
    gap, idx = cKDTree(nodes.cpu().numpy()).query(points.cpu().numpy(),
                                                  workers=-1)
    dev = nodes.device
    return (torch.as_tensor(idx, dtype=torch.int64, device=dev),
            torch.as_tensor(gap, dtype=torch.float64, device=dev))
