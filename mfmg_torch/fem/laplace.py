"""Variable-coefficient Laplace problem: -div(c(x) grad u) = f, u=0 on boundary.

Port of mfmg_tpu/fem/laplace.py (reference tests/laplace.hpp:43-292).  The
problem holds the host data the hierarchy setup consumes: per-cell matrices
``A_loc``, the raw (Neumann-assembled) global diagonal ``diag_raw`` used for
the partition-of-unity weights, and the Dirichlet mask ``constrained``.  The
assembled, Dirichlet-eliminated CSR ``A`` is built lazily: the stencil setup
path never needs it; the assembled path (``ell_operator``,
``Config(operator="ell")``) applies it as an ``ELLMatrix``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from mfmg_torch.fem import coefficients as coeff_mod
from mfmg_torch.fem.geometry import (GeometryFactors, compute_geometry,
                                     local_stiffness_matrices)
from mfmg_torch.fem.mesh import Mesh, hyper_cube
from mfmg_torch.ops.sparse import (ELLMatrix, assemble_csr,
                                   eliminate_dirichlet, ell_from_scipy)


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
    _A: sp.csr_matrix = dataclasses.field(default=None, repr=False)

    @property
    def A(self) -> sp.csr_matrix:
        """Assembled, Dirichlet-eliminated matrix (lazy)."""
        if self._A is None:
            A_raw = assemble_csr(self.mesh.cells, self.A_loc, self.mesh.n_nodes)
            self._A = eliminate_dirichlet(A_raw, self.mesh.constrained_mask)
        return self._A

    def ell_operator(self, dtype=torch.float64, device="cpu") -> ELLMatrix:
        """The assembled-path operator: ``A`` as an ELLMatrix (the analog of
        the reference's DealIITrilinosMatrixOperator / SparseMatrixDevice)."""
        return ell_from_scipy(self.A, dtype=dtype, device=device)

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
