"""Plain reference of the problem every cell solves: the variable-coefficient
Laplace operator -div(c grad u), Q1 hexahedra, Dirichlet dofs eliminated.

Written from the problem's definition (the bilinear form and material
properties of mfmg's tests/laplace.hpp and test_hierarchy_helpers.hpp): a
trilinear map per cell, 2x2x2 Gauss points, the cell matrices
sum_q JxW c(x_q) grad(phi_i).grad(phi_j), summed into the global operator,
whose constrained rows and columns are zero but for the diagonal, which
keeps its assembled value.  Plain PyTorch, float64 unless a lower precision
is asked for.  The mesh is the reference's own (a module of this package
named by the configuration's ``reference`` key builds it); of the program
it takes only the coordinates of the program's dofs, to find which of its
own dofs each one is, and the program's Dirichlet flags, to compare them
with its own.
"""

from __future__ import annotations

import importlib
import itertools
import math

import numpy as np
import torch

# 2-point Gauss-Legendre on [0, 1]
_GAUSS = (0.5 - 0.5 / math.sqrt(3.0), 0.5 + 0.5 / math.sqrt(3.0))
_WEIGHT = 0.125                    # 0.5^3 at every point of the 2x2x2 rule

# the local faces of a hexahedron whose node i = ix + 2 iy + 4 iz, each in
# the layout (00, 10, 01, 11) of its two other axes
FACES = tuple(tuple(i for i in range(8) if (i >> d) & 1 == side)
              for d in range(3) for side in (0, 1))


def q1_tables():
    """(N, D): shape values N[q, i] and reference gradients D[q, d, i] of the
    trilinear element at the Gauss points q = qx + 2 qy + 4 qz, float64."""
    N = np.zeros((8, 8))
    D = np.zeros((8, 3, 8))
    for q, i in itertools.product(range(8), range(8)):
        t = [_GAUSS[(q >> d) & 1] for d in range(3)]
        bits = [(i >> d) & 1 for d in range(3)]
        v = [t[d] if bits[d] else 1.0 - t[d] for d in range(3)]
        N[q, i] = v[0] * v[1] * v[2]
        for d in range(3):
            dv = 1.0 if bits[d] else -1.0
            D[q, d, i] = dv * math.prod(v[e] for e in range(3) if e != d)
    return N, D


def coefficient(name: str, p: torch.Tensor) -> torch.Tensor:
    """The material properties of mfmg's tests (constant, linear, linear_x,
    discontinuous) at points p (..., 3)."""
    if name == "constant":
        return torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    if name == "linear":
        return 1.0 + sum((1.0 + d) * p[..., d].abs() for d in range(p.shape[-1]))
    if name == "linear_x":
        return 1.0 + p[..., 0].abs()
    if name == "discontinuous":
        odd = (torch.floor(p * 100.0).to(torch.int64) % 2).sum(-1)
        return torch.where(odd == p.shape[-1], 100.0, 10.0).to(p.dtype)
    raise ValueError(f"unknown material property {name!r}")


def _inverse_3x3(J: torch.Tensor):
    """(det, inverse) of (..., 3, 3) matrices by cofactors."""
    a = J
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    inv = torch.stack([
        torch.stack([c00, a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                     a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]], -1),
        torch.stack([c01, a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                     a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]], -1),
        torch.stack([c02, a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                     a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]], -1),
    ], -2) / det[..., None, None]
    return det, inv


class Operator:
    """The eliminated global operator, applied cell by cell.

    nodes (n, 3), cells (n_cells, 8) in the lexicographic local order,
    constrained (n,) bool, on ``device``.  The cell matrices are worked out
    in float64 in chunks of ``chunk`` cells: once and kept (``store``), or
    anew in every apply, which needs no more memory than a chunk.
    ``det_min`` is the smallest Jacobian determinant met at a Gauss point.
    """

    def __init__(self, nodes, cells, constrained, material: str, device,
                 chunk: int = 1 << 17, store: bool = True):
        self.device = torch.device(device)
        self.chunk = int(chunk)
        self.material = material
        f64 = dict(dtype=torch.float64, device=self.device)
        self.nodes = torch.as_tensor(nodes, **f64)
        self.cells = torch.as_tensor(cells, dtype=torch.int64,
                                     device=self.device)
        self.constrained = torch.as_tensor(constrained, dtype=torch.bool,
                                           device=self.device)
        self.n = self.nodes.shape[0]
        self._tables = tuple(torch.as_tensor(t, **f64) for t in q1_tables())
        self.diag = torch.zeros(self.n, **f64)
        blocks, det_min = [], math.inf
        for lo, c in self._chunks():
            A, det = self._cell_matrices(c)
            det_min = min(det_min, float(det.min()))
            self.diag.index_add_(0, c.reshape(-1),
                                 torch.diagonal(A, dim1=1, dim2=2).reshape(-1))
            if store:
                blocks.append(A)
        self.A_loc = torch.cat(blocks) if store else None
        self.det_min = det_min

    def _chunks(self):
        for lo in range(0, self.cells.shape[0], self.chunk):
            yield lo, self.cells[lo:lo + self.chunk]

    def _cell_matrices(self, c):
        """(A_loc, det) of the cells c (k, 8): (k, 8, 8) and (k, 8)."""
        N, D = self._tables
        xe = self.nodes[c]                                     # (k, 8, 3)
        J = torch.einsum("cia,qbi->cqab", xe, D)
        det, Jinv = _inverse_3x3(J)
        G = torch.einsum("cqba,qbi->cqai", Jinv, D)            # J^-T grad
        xq = torch.einsum("cia,qi->cqa", xe, N)
        s = _WEIGHT * det.abs() * coefficient(self.material, xq)
        return torch.einsum("cq,cqai,cqaj->cij", s, G, G), det

    def apply(self, X: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
        """A X for X (n,) or (n, k), computed in ``dtype`` throughout."""
        one = X.dim() == 1
        X = (X[:, None] if one else X).to(device=self.device, dtype=dtype)
        free = (~self.constrained)[:, None].to(dtype)
        Xm = X * free
        Y = torch.zeros_like(X)
        k = X.shape[1]
        for lo, c in self._chunks():
            A = (self.A_loc[lo:lo + c.shape[0]] if self.A_loc is not None
                 else self._cell_matrices(c)[0])
            y = torch.bmm(A.to(dtype), Xm[c])
            Y.index_add_(0, c.reshape(-1), y.reshape(-1, k))
        Y = Y * free + self.diag.to(dtype)[:, None] * X * (1 - free)
        return Y[:, 0] if one else Y

    def energy(self, X: torch.Tensor) -> torch.Tensor:
        """sqrt(x^T A x) of each column of X (n, k), float64."""
        X = X.to(device=self.device, dtype=torch.float64)
        return (X * self.apply(X)).sum(0).clamp_min(0).sqrt()

    def assembled(self):
        """The operator as a scipy CSR matrix (small meshes: the tests)."""
        import scipy.sparse as sp
        c = self.cells.cpu().numpy()
        A = self.A_loc.cpu().numpy()
        fixed = self.constrained.cpu().numpy()
        rows = np.broadcast_to(c[:, :, None], A.shape)
        cols = np.broadcast_to(c[:, None, :], A.shape)
        keep = ~fixed[rows] & ~fixed[cols]
        d = np.flatnonzero(fixed)
        M = sp.coo_matrix((np.concatenate([A[keep], self.diag.cpu().numpy()[d]]),
                           (np.concatenate([rows[keep], d]),
                            np.concatenate([cols[keep], d]))),
                          shape=(self.n, self.n)).tocsr()
        M.sum_duplicates()
        return M


class Problem:
    """The reference's problem for a configuration and refinement: its own
    mesh (``reference/<cfg["reference"]>.py``: ``mesh`` and ``locate``), its
    operator (the module's ``Operator`` where it has one, as an element
    other than Q1 needs; this module's otherwise), the map between the
    program's dof numbering and its own, and
    the readings of the program's mesh against it, each 0 for a sound one:

      dofs_gap              |program's dofs - reference's dofs|
      mesh_numbering_defect reference dofs that no program dof, or more than
                            one, lies on
      mesh_node_gap         the largest distance of a program dof from the
                            reference dof it lies on
      mesh_boundary_mismatch dofs whose Dirichlet flags differ
      mesh_inverted         1 where a reference cell has a Jacobian <= 0

    ``to_ref`` takes the program's vectors (n, ...) into the reference's
    numbering, ``to_program`` back; both None where the numbering is
    defective.
    """

    def __init__(self, cfg: dict, n_refinements: int, program_nodes,
                 program_flags, device, store: bool = True):
        module = importlib.import_module(f"portbench.reference.{cfg['reference']}")
        device = torch.device(device)
        nodes, cells, flags = module.mesh(cfg, n_refinements, device)
        operator = getattr(module, "Operator", Operator)
        self.op = operator(nodes, cells, flags, cfg["material_property"]["type"],
                           device, store=store)
        n = self.op.n
        pn = torch.as_tensor(program_nodes, dtype=torch.float64, device=device)
        idx, gap = module.locate(self.op.nodes, pn)
        hits = torch.bincount(idx, minlength=n)
        defect = int((hits != 1).sum())
        pf = torch.as_tensor(program_flags, dtype=torch.bool, device=device)
        self.readings = {
            "dofs_gap": float(abs(pn.shape[0] - n)),
            "mesh_numbering_defect": float(defect),
            "mesh_node_gap": float(gap.max()) if len(gap) else math.inf,
            "mesh_boundary_mismatch": float((flags[idx] != pf).sum()),
            "mesh_inverted": float(self.op.det_min <= 0.0)}
        if defect == 0 and pn.shape[0] == n:
            self._to_ref = torch.argsort(idx)      # program dof of each own dof
            self._to_program = idx
        else:
            self._to_ref = self._to_program = None

    def to_ref(self, X):
        if self._to_ref is None:
            return None
        return X.to(self.op.device)[self._to_ref]

    def to_program(self, X):
        if self._to_program is None:
            return None
        return X.to(self.op.device)[self._to_program]
