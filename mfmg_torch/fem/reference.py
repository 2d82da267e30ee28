"""Tensor-product Lagrange (Q_k) reference element on [0,1]^dim.

This replaces the deal.II FE_Q + QGauss + FEValues subset that mfmg's tests
rely on (reference tests/laplace.hpp:159-195 assembles with FE_Q(k) and
QGauss(k+1)).  Shape functions are tensor products of 1D Lagrange polynomials
on Gauss-Lobatto support points; quadrature is tensor-product Gauss-Legendre
with (k+1)^dim points — identical to the reference discretization, so the
assembled matrices agree to roundoff.

Local dof ordering is lexicographic (x fastest), which differs from deal.II's
vertex/edge/face ordering, but all global objects (CSR matrix, restriction
rows) are independent of the local convention.
"""

from __future__ import annotations

import numpy as np
from functools import lru_cache


def gauss_legendre_1d(n: int):
    """n-point Gauss-Legendre rule on [0,1]."""
    pts, wts = np.polynomial.legendre.leggauss(n)
    return 0.5 * (pts + 1.0), 0.5 * wts


def gauss_lobatto_points_1d(k: int) -> np.ndarray:
    """k+1 Gauss-Lobatto-Legendre support points on [0,1] (deal.II FE_Q uses
    GLL support points)."""
    if k == 1:
        return np.array([0.0, 1.0])
    if k == 2:
        return np.array([0.0, 0.5, 1.0])
    # Interior GLL points are roots of P'_k (derivative of Legendre poly).
    leg = np.polynomial.legendre.Legendre.basis(k)
    interior = np.sort(leg.deriv().roots())
    return np.concatenate([[0.0], 0.5 * (interior + 1.0), [1.0]])


def lagrange_basis_1d(support: np.ndarray, x: np.ndarray):
    """Values and derivatives of the Lagrange basis through `support` at `x`.

    Returns (vals[nx, nsup], grads[nx, nsup])."""
    nsup = len(support)
    nx = len(x)
    vals = np.ones((nx, nsup))
    grads = np.zeros((nx, nsup))
    for i in range(nsup):
        for j in range(nsup):
            if j == i:
                continue
            vals[:, i] *= (x - support[j]) / (support[i] - support[j])
        # derivative via sum over product rule
        for m in range(nsup):
            if m == i:
                continue
            term = np.ones(nx) / (support[i] - support[m])
            for j in range(nsup):
                if j == i or j == m:
                    continue
                term *= (x - support[j]) / (support[i] - support[j])
            grads[:, i] += term
    return vals, grads


class ReferenceElement:
    """Q_k element data on [0,1]^dim.

    Attributes
    ----------
    N : (n_q, n_loc) shape values at quadrature points.
    D : (n_q, dim, n_loc) reference-space shape gradients at quadrature points.
    qpoints : (n_q, dim) quadrature points in [0,1]^dim.
    qweights : (n_q,) quadrature weights.
    nodes : (n_loc, dim) support points (for geometry interpolation Q_k maps).
    """

    def __init__(self, dim: int, degree: int, n_q_1d: int | None = None):
        self.dim = dim
        self.degree = degree
        k = degree
        nq1 = n_q_1d if n_q_1d is not None else k + 1
        q1, w1 = gauss_legendre_1d(nq1)
        sup = gauss_lobatto_points_1d(k)
        v1, g1 = lagrange_basis_1d(sup, q1)  # (nq1, k+1)

        self.n_loc_1d = k + 1
        self.n_q_1d = nq1
        # 1D value/derivative tables (nq1, k+1) — the sum-factorization factors
        self.v1d = v1
        self.g1d = g1

        # Tensor products, x fastest for both q and local indices.
        axes_q = [q1] * dim
        axes_i = [np.arange(k + 1)] * dim

        qgrids = np.meshgrid(*axes_q, indexing="ij")
        # index order: we want x-fastest flattening => build with last axis = x.
        # Use lexicographic flatten where dimension 0 (x) varies fastest:
        # construct arrays of shape (n1,)*dim with axis d indexing dim d, then
        # flatten in Fortran order.
        self.qpoints = np.stack([g.flatten(order="F") for g in qgrids], axis=-1)
        wgrids = np.meshgrid(*([w1] * dim), indexing="ij")
        self.qweights = np.ones(nq1**dim)
        for g in wgrids:
            self.qweights = self.qweights * g.flatten(order="F")

        igrids = np.meshgrid(*axes_i, indexing="ij")
        local_multi = np.stack([g.flatten(order="F") for g in igrids], axis=-1)  # (n_loc, dim)
        self.local_multi_index = local_multi
        self.nodes = sup[local_multi]  # (n_loc, dim)

        n_q = nq1**dim
        n_loc = (k + 1) ** dim
        N = np.ones((n_q, n_loc))
        D = np.zeros((n_q, dim, n_loc))
        qmulti = np.stack(
            [np.arange(nq1)[g] for g in np.meshgrid(*([np.arange(nq1)] * dim), indexing="ij")],
            axis=-1,
        ).reshape(-1, dim, order="C")
        # rebuild q multi-index consistent with Fortran flatten above
        qm = np.stack([g.flatten(order="F") for g in np.meshgrid(*([np.arange(nq1)] * dim), indexing="ij")], axis=-1)
        del qmulti
        for q in range(n_q):
            for i in range(n_loc):
                for d in range(dim):
                    N[q, i] *= v1[qm[q, d], local_multi[i, d]]
                for dgrad in range(dim):
                    term = 1.0
                    for d in range(dim):
                        f = g1 if d == dgrad else v1
                        term *= f[qm[q, d], local_multi[i, d]]
                    D[q, dgrad, i] = term
        self.N = N
        self.D = D
        self.n_q = n_q
        self.n_loc = n_loc


@lru_cache(maxsize=None)
def reference_element(dim: int, degree: int, n_q_1d: int | None = None) -> ReferenceElement:
    return ReferenceElement(dim, degree, n_q_1d)
