"""hyper_ball meshes: deal.II-compatible ball triangulations.

Port of mfmg_tpu/fem/ball.py (plain numpy, the same vertex numbering and
cell table).  It reproduces dealii::GridGenerator::hyper_ball +
refine_global as used by the reference tests (tests/laplace.hpp:91-97): a
coarse cell complex (5 cells in 2D, 7 in 3D) whose outer vertices lie on
the sphere, refined uniformly with new boundary points projected onto the
sphere (SphericalManifold behaviour) and interior points placed by the
transfinite (Coons) blend of deal.II's TriaAccessor::center.

The inner square / cube sits at a = 1/(1+sqrt(2)) (2D) and
a = 1/(1+sqrt(3)) (3D) of the outer half-width, deal.II's choice to
balance the cell sizes at the transition to the radial cells.
"""

from __future__ import annotations

import numpy as np


def hyper_ball_base(dim: int, radius: float = 1.0):
    """Vertices and cells of the unrefined ball mesh."""
    if dim == 2:
        b = radius / np.sqrt(2.0)
        # deal.II 2D hyper_ball: outer square corners on the circle at b,
        # inner square at b * 1/(1+sqrt(2)) (GridGenerator::hyper_ball)
        a = 1.0 / (1.0 + np.sqrt(2.0))
        inner = b * a * np.array([[-1, -1], [1, -1], [-1, 1], [1, 1]], dtype=float)
        outer = b * np.array([[-1, -1], [1, -1], [-1, 1], [1, 1]], dtype=float)
        verts = np.vstack([outer[0], outer[1], inner[0], inner[1],
                           inner[2], inner[3], outer[2], outer[3]])
        # quads with consistent (counterclockwise) orientation, lexicographic
        # local ordering (x fastest): (v00, v10, v01, v11)
        cells = np.array([
            [0, 1, 2, 3],     # bottom
            [2, 3, 4, 5],     # center
            [0, 2, 6, 4],     # left
            [3, 1, 5, 7],     # right
            [4, 5, 6, 7],     # top
        ])
        return verts, cells
    if dim == 3:
        b = radius / np.sqrt(3.0)
        # deal.II: inner cube at a = 1/(1+sqrt(3)) of the outer half-width
        # ("equilibrate cell sizes at transition from inner part to radial
        # cells", GridGenerator::hyper_ball<3>)
        ai = b / (1.0 + np.sqrt(3.0))
        corners = np.array([[x, y, z] for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)], dtype=float)
        verts = np.vstack([corners * ai, corners * b])   # 0-7 inner, 8-15 outer
        I, O = np.arange(8), np.arange(8, 16)
        # local lexicographic hex ordering: (x fastest, then y, then z)
        def hx(v000, v100, v010, v110, v001, v101, v011, v111):
            return [v000, v100, v010, v110, v001, v101, v011, v111]
        cells = np.array([
            hx(*I),                                                    # center
            hx(O[0], O[1], O[2], O[3], I[0], I[1], I[2], I[3]),        # bottom (z-)
            hx(I[4], I[5], I[6], I[7], O[4], O[5], O[6], O[7]),        # top (z+)
            hx(O[0], O[1], I[0], I[1], O[4], O[5], I[4], I[5]),        # front (y-)
            hx(I[2], I[3], O[2], O[3], I[6], I[7], O[6], O[7]),        # back (y+)
            hx(O[0], I[0], O[2], I[2], O[4], I[4], O[6], I[6]),        # left (x-)
            hx(I[1], O[1], I[3], O[3], I[5], O[5], I[7], O[7]),        # right (x+)
        ])
        return verts, cells
    raise ValueError("hyper_ball supports dim 2 and 3")


def _cell_faces(dim):
    """Local vertex index lists of the 2*dim faces of a cell (lexicographic
    vertex numbering, x fastest)."""
    n = 2 ** dim
    idx = np.arange(n)
    coords = [(idx >> d) & 1 for d in range(dim)]
    faces = []
    for d in range(dim):
        for side in (0, 1):
            faces.append(tuple(int(i) for i in idx[coords[d] == side]))
    return faces


def _request_pattern(dim):
    """The new-vertex requests of the reference's refinement walk
    (mfmg_tpu/fem/ball.py:100-236) over one cell, in its order, as
    (kind, arg): "E" an edge midpoint (arg: its two local corners), "F" a
    face or 2-D cell midpoint (its local corners in the
    (00, 10, 01, 11) layout of the call; its four edges are requested just
    before it), "H" the 3-D cell centre (arg: the slots of its six face and
    twelve edge requests, which precede it).  Also the request slot of each
    of the 3^dim grid points, or ("V", corner) at a corner."""
    reqs, grid = [], {}

    def quad(q):
        a, b, c, d = q
        reqs.extend([("E", (a, b)), ("E", (c, d)), ("E", (a, c)), ("E", (b, d))])
        reqs.append(("F", tuple(q)))
        return len(reqs) - 1

    for mi in np.ndindex(*(3,) * dim):
        odd = [d for d in range(dim) if mi[d] == 1]
        if not odd:
            grid[mi] = ("V", sum((mi[d] // 2) << d for d in range(dim)))
        elif len(odd) == 1:
            d0 = odd[0]
            lo = sum((0 if d == d0 else mi[d] // 2) << d for d in range(dim))
            reqs.append(("E", (lo, lo + (1 << d0))))
            grid[mi] = ("R", len(reqs) - 1)
        elif len(odd) == 2:
            q = []
            for t1 in (0, 1):
                for t0 in (0, 1):
                    corner = [mi[d] // 2 for d in range(dim)]
                    corner[odd[0]], corner[odd[1]] = t0, t1
                    q.append(sum(corner[d] << d for d in range(dim)))
            grid[mi] = ("R", quad(q))
        else:
            face_slots = [quad(list(f)) for f in _cell_faces(3)]
            edge_slots = []
            for d in range(3):
                for i in range(8):
                    if not (i >> d) & 1:
                        reqs.append(("E", (i, i + (1 << d))))
                        edge_slots.append(len(reqs) - 1)
            reqs.append(("H", (face_slots, edge_slots)))
            grid[mi] = ("R", len(reqs) - 1)
    return reqs, grid


def _seq_sum(xs):
    """sum(xs) in Python's order (left to right), over arrays."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def refine_ball(verts, cells, radius: float):
    """One uniform refinement with deal.II-compatible new-vertex placement:
    the reference's loop over cells (mfmg_tpu/fem/ball.py:100-236) as
    whole-array operations, with the same vertices in the same order, the
    same cells and the same coordinates bit for bit.

    deal.II's Triangulation::execute_refinement places every new vertex via
    TriaAccessor::center(true, true), interpolating from the surrounding
    points with transfinite (Coons) weights:
      line midpoint:  mean of the 2 vertices; boundary lines project to the
                      sphere (geodesic midpoint)
      quad midpoint:  1/2 sum of line-mids - 1/4 sum of vertices (flat
                      quads); boundary quads: the same weights over unit
                      directions, projected to the sphere
      hex center:     1/2 sum of face-mids - 1/4 sum of line-mids
                      + 1/8 sum of vertices
    Boundary lines and faces (faces in one cell only) carry the spherical
    manifold; interior points feel the curvature through the Coons blend.

    A new vertex's id is the place of its entity's first request in the
    loop (cells in order, each cell's requests in ``_request_pattern``
    order; an edge or face that an earlier cell requested keeps that
    cell's vertex), and its coordinates are the loop's expressions in the
    same order, a face's in the corner layout of its first request, each
    boundary point's radius through the same ``np.linalg.norm`` of one
    vector (a vectorized norm differs in the last bit)."""
    verts = np.asarray(verts, dtype=float)
    cells = np.asarray(cells, dtype=np.int64)
    dim = verts.shape[1]
    n0, nc = len(verts), len(cells)

    # every request of the walk, cell-major, as an entity code: edges by
    # their sorted corners, faces by their sorted corners, centres by cell
    reqs, grid = _request_pattern(dim)
    n_req = len(reqs)
    slots = {k: np.array([i for i, (kk, _) in enumerate(reqs) if kk == k],
                         dtype=np.int64) for k in "EFH"}
    code = np.empty((nc, n_req), dtype=np.int64)
    e_loc = np.array([reqs[i][1] for i in slots["E"]])
    ev = np.sort(cells[:, e_loc], axis=2)
    e_uniq, e_id = np.unique(ev[..., 0] * n0 + ev[..., 1], return_inverse=True)
    e_id = e_id.reshape(nc, -1)
    code[:, slots["E"]] = e_id
    n_e = len(e_uniq)
    f_loc = np.array([reqs[i][1] for i in slots["F"]])
    fq = cells[:, f_loc]                                   # (nc, nF, 4) layouts
    f_uniq, f_id = np.unique(np.sort(fq, axis=2).reshape(-1, 4), axis=0,
                             return_inverse=True)
    f_id = f_id.reshape(nc, -1)
    code[:, slots["F"]] = n_e + f_id
    n_f = len(f_uniq)
    code[:, slots["H"]] = n_e + n_f + np.arange(nc)[:, None]

    def in_one_cell(ids, n):
        """Entities of ids (nc, k) that only one cell requests."""
        pairs = np.unique(ids * np.int64(nc) + np.arange(nc)[:, None])
        return np.bincount(pairs // nc, minlength=n) == 1

    # vertex ids: the entities in the order of their first requests
    flat = code.reshape(-1)
    first = np.full(n_e + n_f + nc * len(slots["H"]), flat.size, dtype=np.int64)
    np.minimum.at(first, flat, np.arange(flat.size, dtype=np.int64))
    vid = np.empty(len(first), dtype=np.int64)
    vid[np.argsort(first, kind="stable")] = n0 + np.arange(len(first))
    V = np.empty((n0 + len(first), dim))
    V[:n0] = verts

    # the first request of each face, its corner layout there, and the
    # faces on the sphere (3-D: in one cell only; every cell requests all
    # its faces) with their edges; in 2-D the boundary lines are the edges
    # in one cell only
    fr = first[n_e:n_e + n_f]
    q = fq[fr // n_req, np.searchsorted(slots["F"], fr % n_req)]
    if dim == 3:
        bface = in_one_cell(f_id, n_f)
        a, b, c, d = q[bface].T
        bl = np.sort(np.concatenate([np.stack(e, axis=1) for e in
                                     ((a, b), (c, d), (a, c), (b, d))]), axis=1)
        bline = np.isin(e_uniq, bl[:, 0] * n0 + bl[:, 1])
    else:
        bline = in_one_cell(e_id, n_e)

    # edge midpoints, those on the sphere projected
    ea, eb = np.divmod(e_uniq, n0)
    P = 0.5 * (V[ea] + V[eb])
    for i in np.nonzero(bline)[0]:
        P[i] = P[i] / np.linalg.norm(P[i]) * radius
    V[vid[:n_e]] = P

    def edge_v(x, y):
        k = np.minimum(x, y) * n0 + np.maximum(x, y)
        return V[vid[np.searchsorted(e_uniq, k)]]

    # face (2-D: cell) midpoints in the layout of their first requests
    a, b, c, d = q.T
    lm = [edge_v(a, b), edge_v(c, d), edge_v(a, c), edge_v(b, d)]
    vs = [V[a], V[b], V[c], V[d]]
    P = 0.5 * _seq_sum(lm) - 0.25 * _seq_sum(vs)
    if dim == 3:
        w = [0.5] * 4 + [-0.25] * 4
        for i in np.nonzero(bface)[0]:
            cand = 0
            for wi, pt in zip(w, [x[i] for x in lm + vs]):
                cand = cand + wi * (pt / np.linalg.norm(pt))
            P[i] = cand / np.linalg.norm(cand) * radius
    V[vid[n_e:n_e + n_f]] = P

    # 3-D cell centres from their six faces, twelve edges and eight corners
    for h in slots["H"]:
        face_slots, edge_slots = reqs[h][1]
        fm = [V[vid[code[:, j]]] for j in face_slots]
        lmids = [V[vid[code[:, j]]] for j in edge_slots]
        vs = [V[cells[:, i]] for i in range(8)]
        V[vid[code[:, h]]] = (0.5 * _seq_sum(fm) - 0.25 * _seq_sum(lmids)
                              + 0.125 * _seq_sum(vs))

    # children: 2^dim per cell, from each cell's 3^dim grid
    pos = {mi: j for j, mi in enumerate(np.ndindex(*(3,) * dim))}
    gids = np.empty((nc, len(pos)), dtype=np.int64)
    for mi, j in pos.items():
        kind, k = grid[mi]
        gids[:, j] = cells[:, k] if kind == "V" else vid[code[:, k]]
    pattern = [[pos[tuple(((si >> d) & 1) + ((ci >> d) & 1) for d in range(dim))]
                for ci in range(2 ** dim)] for si in range(2 ** dim)]
    return V, gids[:, np.asarray(pattern)].reshape(-1, 2 ** dim)

