"""Variable-coefficient Laplace problem: -div(c(x) grad u) = f, u=0 on boundary.

Port of mfmg_tpu/fem/laplace.py (reference tests/laplace.hpp:43-292).  The
problem holds the host data the hierarchy setup consumes: per-cell matrices
``A_loc``, the raw (Neumann-assembled) global diagonal ``diag_raw`` used for
the partition-of-unity weights, and the constrained mask ``constrained``
(Dirichlet dofs and hanging slaves).  The assembled matrix ``A_raw`` and the
condensed (hanging-node), Dirichlet-eliminated ``A`` are built lazily: the
stencil and matrix-free setup paths never need them; the assembled path
(``ell_operator``, ``Config(operator="ell")``) applies ``A`` as an
``ELLMatrix``, the matrix-free paths (``matrix_free_operator``,
``Config(operator="matrix_free" | "sumfac")``) the cell matrices.  On an
adaptive mesh the solve happens in range(C): ``assemble_rhs`` gives the
condensed load and ``distribute`` recovers the hanging values after it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from mfmg_torch.fem import coefficients as coeff_mod
from mfmg_torch.fem.geometry import (GeometryFactors, compute_geometry,
                                     local_mass_rhs, local_stiffness_matrices)
from mfmg_torch.fem.mesh import Mesh, hyper_cube
from mfmg_torch.ops.sparse import (ELLMatrix, assemble_csr,
                                   eliminate_dirichlet, ell_from_scipy)
from mfmg_torch.utils.device import checked_device


@dataclasses.dataclass
class LaplaceProblem:
    mesh: Mesh
    coefficient: Callable
    geom: GeometryFactors = None
    A_loc: np.ndarray = None          # (n_cells, n_loc, n_loc) cell matrices
    diag_raw: np.ndarray = None       # raw (Neumann-assembled) global diagonal
    coeff_at_q: np.ndarray = None
    # A_loc is the Laplace form of coefficient (no local_matrix_fn): the
    # device eigensolve rebuilds the batch from geom and coeff_at_q only then
    laplace_form: bool = True
    _A_raw: sp.csr_matrix = dataclasses.field(default=None, repr=False)
    _A: sp.csr_matrix = dataclasses.field(default=None, repr=False)

    @property
    def A_raw(self) -> sp.csr_matrix:
        """Assembled matrix, no constraints (lazy)."""
        if self._A_raw is None:
            self._A_raw = assemble_csr(self.mesh.cells, self.A_loc,
                                       self.mesh.n_nodes)
        return self._A_raw

    @property
    def A(self) -> sp.csr_matrix:
        """Assembled, condensed (hanging-node) and Dirichlet-eliminated
        matrix (lazy).  On adaptive meshes this is C^T A C in the
        AffineConstraints sense (reference tests/laplace.hpp:126-141,197-199)."""
        if self._A is None:
            A = self.A_raw
            if self.mesh.hanging is not None:
                A = self.mesh.hanging.condense(A)
            self._A = eliminate_dirichlet(A, self.mesh.constrained_mask)
        return self._A

    def ell_operator(self, dtype=torch.float64, device="cuda") -> ELLMatrix:
        """The assembled-path operator: ``A`` as an ELLMatrix on ``device``
        (the analog of the reference's DealIITrilinosMatrixOperator /
        SparseMatrixDevice).  device is "cuda" unless the caller asks for the
        CPU; "cuda" needs a CUDA device and never falls back to the CPU."""
        return ell_from_scipy(self.A, dtype=dtype, device=checked_device(device))

    def matrix_free_operator(self, dtype=torch.float64,
                             mode: str = "local_matrix", device="cuda"):
        """The matrix-free operator on ``device`` (the analog of the
        reference's DealIIMatrixFreeOperator; mfmg_tpu/fem/laplace.py:
        118-167): mode "local_matrix" or "quadrature" gives a
        MatrixFreeOperator (ops/local_apply.py), "sumfac" a
        SumFactoredOperator (ops/sumfac.py).  Hanging-node meshes apply the
        condensed C^T A C cell-wise; the condensed diagonal is read once
        from the assembled A.  device is "cuda" unless the caller asks for
        the CPU."""
        from mfmg_torch.ops.local_apply import MatrixFreeOperator
        device = checked_device(device)

        def dev(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        if mode == "sumfac":
            from mfmg_torch.ops.sumfac import build_sumfac_operator
            return build_sumfac_operator(self.mesh, self.coeff_at_q,
                                         self.diag_raw, self.A_loc,
                                         dtype=dtype, device=device)
        hc_kw = {}
        if self.mesh.hanging is not None:
            h = self.mesh.hanging
            valid = np.arange(h.masters.shape[1])[None] < h.n_masters[:, None]
            hc_kw = dict(
                hc_slaves=dev(h.slaves, torch.int64),
                hc_masters=dev(np.where(valid, h.masters, 0), torch.int64),
                hc_weights=dev(np.where(valid, h.weights, 0.0)),
                hc_n_masters=np.asarray(h.n_masters),
                diag_all=dev(self.A.diagonal()))
        common = dict(cells=dev(self.mesh.cells, torch.int64),
                      constrained=dev(self.mesh.boundary_dofs, torch.bool),
                      diag=dev(self.diag_raw), **hc_kw)
        if mode == "local_matrix":
            return MatrixFreeOperator(A_loc=dev(self.A_loc), **common)
        if mode == "quadrature":
            # the shared single-cell gradients of an undistorted grid are
            # broadcast on the device; the (n_cells, n_q, dim, n_loc) table
            # is held only in this mode
            G = (dev(self.geom.G_shared).expand(self.mesh.n_cells,
                                                *self.geom.G_shared.shape)
                 if self.geom.G_shared is not None else dev(self.geom.G))
            return MatrixFreeOperator(
                G=G.contiguous(), scale=dev(self.geom.JxW * self.coeff_at_q),
                **common)
        raise ValueError(f"unknown matrix-free mode {mode!r}")

    @staticmethod
    def hyper_cube(dim: int, n_refinements: int, degree: int = 1,
                   material_property: str | Callable = "constant",
                   distort_random: bool = False, seed: int = 0) -> "LaplaceProblem":
        """Problem on the unit hyper_cube (reference tests/laplace.hpp:88-111)."""
        mesh = hyper_cube(dim, n_refinements, degree=degree,
                          distort_random=distort_random, seed=seed)
        return LaplaceProblem.from_mesh(mesh, material_property)

    @staticmethod
    def from_mesh(mesh: Mesh, material_property: str | Callable = "constant",
                  local_matrix_fn: Callable | None = None) -> "LaplaceProblem":
        """Build a problem on any mesh; local_matrix_fn(mesh, geom,
        coeff_at_q) overrides the Laplace bilinear form."""
        coefficient = (coeff_mod.get(material_property)
                       if isinstance(material_property, str) else material_property)
        prob = LaplaceProblem(mesh=mesh, coefficient=coefficient)
        prob._setup(local_matrix_fn)
        return prob

    def _setup(self, local_matrix_fn=None):
        self.geom = compute_geometry(self.mesh)
        self.coeff_at_q = self.coefficient(self.geom.qpoints_phys)
        fn = local_matrix_fn or local_stiffness_matrices
        self.laplace_form = local_matrix_fn is None
        self.A_loc = fn(self.mesh, self.geom, self.coeff_at_q)
        # raw global diagonal straight from the cell matrices (no assembly)
        d_loc = np.einsum("cii->ci", self.A_loc)
        self.diag_raw = np.bincount(self.mesh.cells.reshape(-1),
                                    weights=d_loc.reshape(-1),
                                    minlength=self.mesh.n_nodes)

    @property
    def n_dofs(self) -> int:
        return self.mesh.n_nodes

    @property
    def constrained(self) -> np.ndarray:
        return self.mesh.constrained_mask

    def distribute(self, u: np.ndarray) -> np.ndarray:
        """Recover hanging-slave values from their masters after a solve
        (AffineConstraints::distribute; no-op on conforming meshes)."""
        if self.mesh.hanging is None:
            return u
        return self.mesh.hanging.distribute(u)

    def assemble_rhs(self, source: Callable) -> np.ndarray:
        """Load vector for a source term; zero at constrained dofs.  On an
        adaptive mesh the condensed load C^T b (slave load redistributed to
        the masters)."""
        f_at_q = source(self.geom.qpoints_phys)
        rhs_loc = local_mass_rhs(self.mesh, self.geom, f_at_q)
        rhs = np.zeros(self.n_dofs)
        np.add.at(rhs, self.mesh.cells.reshape(-1), rhs_loc.reshape(-1))
        if self.mesh.hanging is not None:
            rhs = self.mesh.hanging.matrix(self.n_dofs).T @ rhs
        rhs[self.mesh.constrained_mask] = 0.0
        return rhs

    def l2_error(self, u: np.ndarray, exact: Callable) -> float:
        """L2 norm of (u_h - exact) by the quadrature rule (analog of
        dealii::VectorTools::integrate_difference, laplace.hpp:227-243)."""
        from mfmg_torch.fem.reference import reference_element
        ref = reference_element(self.mesh.dim, self.mesh.degree)
        u_at_q = np.einsum("qi,ci->cq", ref.N, u[self.mesh.cells])
        diff = u_at_q - exact(self.geom.qpoints_phys)
        return float(np.sqrt(np.sum(self.geom.JxW * diff**2)))
