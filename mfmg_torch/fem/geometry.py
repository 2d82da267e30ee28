"""Per-cell geometry factors at quadrature points (host numpy, float64).

Port of mfmg_tpu/fem/geometry.py: what deal.II's FEValues mapping data
provides (Jacobians, JxW, physical quadrature points; reference
tests/laplace.hpp:160-195), batched over all cells as dense arrays, and the
batched variable-coefficient Laplace cell matrices built from them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mfmg_torch.fem.mesh import Mesh
from mfmg_torch.fem.reference import reference_element


@dataclasses.dataclass
class GeometryFactors:
    """Batched mapping data.

    G : (n_cells, n_q, dim, n_loc) physical-space shape gradients.
    JxW : (n_cells, n_q) quadrature weight times |det J|.
    qpoints_phys : (n_cells, n_q, dim) physical quadrature points.

    When all cells are congruent by translation (undistorted structured
    grids), G and JxW are zero-copy broadcast views of the single-cell
    factors, also exposed as G_shared (n_q, dim, n_loc) / JxW_shared (n_q,).
    """

    G: np.ndarray
    JxW: np.ndarray
    qpoints_phys: np.ndarray
    G_shared: np.ndarray = None
    JxW_shared: np.ndarray = None


def _det_inv_small(J: np.ndarray):
    """Closed-form det + inverse for batched 1x1/2x2/3x3 Jacobians (the
    adjugate formulas are vectorized arithmetic; per-matrix LAPACK LU is
    ~50x slower at 2M Jacobians)."""
    d = J.shape[-1]
    if d == 1:
        return J[..., 0, 0], 1.0 / J
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = np.empty_like(J)
        inv[..., 0, 0] = e
        inv[..., 0, 1] = -b
        inv[..., 1, 0] = -c
        inv[..., 1, 1] = a
        inv /= det[..., None, None]
        return det, inv
    if d == 3:
        f = np.ascontiguousarray(J.reshape(-1, 9)).T
        m00, m01, m02, m10, m11, m12, m20, m21, m22 = f
        c00 = m11 * m22 - m12 * m21
        c01 = m12 * m20 - m10 * m22
        c02 = m10 * m21 - m11 * m20
        det = m00 * c00 + m01 * c01 + m02 * c02
        inv = np.empty((J.size // 9, 9), dtype=J.dtype)
        inv[:, 0] = c00
        inv[:, 3] = c01
        inv[:, 6] = c02
        inv[:, 1] = m02 * m21 - m01 * m22
        inv[:, 4] = m00 * m22 - m02 * m20
        inv[:, 7] = m01 * m20 - m00 * m21
        inv[:, 2] = m01 * m12 - m02 * m11
        inv[:, 5] = m02 * m10 - m00 * m12
        inv[:, 8] = m00 * m11 - m01 * m10
        inv /= det[:, None]
        return det.reshape(J.shape[:-2]), inv.reshape(J.shape)
    return np.linalg.det(J), np.linalg.inv(J)


def _translation_invariant(xe: np.ndarray) -> bool:
    """All cells congruent by translation (shared Jacobian)?"""
    if len(xe) < 2:
        return True
    rel = xe - xe[:, :1, :]
    scale = max(np.abs(rel[0]).max(), 1e-300)
    return bool(np.abs(rel - rel[0]).max() <= 1e-12 * scale)


def compute_geometry(mesh: Mesh) -> GeometryFactors:
    ref = reference_element(mesh.dim, mesh.degree)
    dim = mesh.dim
    n_q = ref.D.shape[0]
    xe = mesh.nodes[mesh.cells]                  # (n_cells, n_loc, dim)
    if _translation_invariant(xe):
        J1 = np.einsum("ia,qbi->qab", xe[0], ref.D)
        det1, Jinv1 = _det_inv_small(J1)
        if np.any(det1 <= 0):
            raise ValueError("mesh contains inverted/degenerate cells (det J <= 0)")
        G1 = np.swapaxes(Jinv1, 1, 2) @ ref.D            # (q, dim, n_loc)
        JxW1 = ref.qweights * det1
        qoff = np.einsum("ia,qi->qa", xe[0] - xe[0, :1], ref.N)
        qpoints_phys = xe[:, 0, None, :] + qoff[None]
        n_cells = len(xe)
        return GeometryFactors(
            G=np.broadcast_to(G1, (n_cells,) + G1.shape),
            JxW=np.broadcast_to(JxW1, (n_cells, n_q)),
            qpoints_phys=qpoints_phys, G_shared=G1, JxW_shared=JxW1)
    D2 = ref.D.reshape(-1, ref.D.shape[-1])      # (q*b, i)
    J = (xe.transpose(0, 2, 1) @ D2.T).reshape(
        len(xe), dim, n_q, dim).transpose(0, 2, 1, 3)
    detJ, Jinv = _det_inv_small(J)
    if np.any(detJ <= 0):
        raise ValueError("mesh contains inverted/degenerate cells (det J <= 0)")
    G = np.swapaxes(Jinv, 2, 3) @ ref.D[None]
    JxW = ref.qweights[None, :] * detJ
    qpoints_phys = np.einsum("cia,qi->cqa", xe, ref.N)
    return GeometryFactors(G=G, JxW=JxW, qpoints_phys=qpoints_phys)


def local_stiffness_matrices(mesh: Mesh, geom: GeometryFactors,
                             coeff_at_q: np.ndarray) -> np.ndarray:
    """A_loc[c,i,j] = sum_q JxW[c,q] * coeff[c,q] * grad(phi_i).grad(phi_j)
    (the bilinear form of reference tests/laplace.hpp:186-191), float64."""
    s = geom.JxW * coeff_at_q                    # (c, q)
    if geom.G_shared is not None:
        G1 = geom.G_shared
        n_q, _, n_loc = G1.shape
        B = np.einsum("qdi,qdj->qij", G1, G1).reshape(n_q, n_loc * n_loc)
        return (s @ B).reshape(len(s), n_loc, n_loc)
    return np.einsum("cqdi,cq,cqdj->cij", geom.G, s, geom.G, optimize=True)


def local_mass_rhs(mesh: Mesh, geom: GeometryFactors, f_at_q: np.ndarray) -> np.ndarray:
    """Cell load vectors rhs_loc[c,i] = sum_q JxW * f * phi_i
    (laplace.hpp:192-193), float64."""
    ref = reference_element(mesh.dim, mesh.degree)
    return np.einsum("cq,qi->ci", geom.JxW * f_at_q, ref.N)
