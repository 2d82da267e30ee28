"""The system under test: mfmg_torch's ``Hierarchy`` on a ``LaplaceProblem``,
built from a configuration file of ``configs/``.  The one module of the
benchmark that imports the program; it hands the rest plain tensors and
arrays."""

from __future__ import annotations

import time

import torch


def program_config(cfg: dict):
    """mfmg_torch's Config from a configuration file: the upstream groups as
    they stand, the port's own choices from ``assumed``."""
    from mfmg_torch import config as C
    a = cfg["assumed"]
    return C.Config(
        max_levels=cfg["max_levels"],
        is_preconditioner=cfg["is_preconditioner"],
        fast_ap=a["fast_ap"],
        operator=a["operator"],
        dtype=a["dtype"],
        coeff_dtype=a["coeff_dtype"],
        eigensolver=C.EigensolverConfig(
            **cfg["eigensolver"], n_eigenvectors_deep=a["n_eigenvectors_deep"]),
        smoother=C.SmootherConfig(**cfg["smoother"],
                                  eig_estimate=a["eig_estimate"]),
        coarse=C.CoarseConfig(**cfg["coarse"]),
        agglomeration=C.AgglomerationConfig(**cfg["agglomeration"]))


def build_problem(cfg: dict, n_refinements: int):
    """The mesh generator that ``laplace.mesh`` names, refined
    ``n_refinements`` times, and the Laplace problem of its material."""
    from mfmg_torch.fem import mesh as mesh_mod
    from mfmg_torch.fem.laplace import LaplaceProblem
    lap = cfg["laplace"]
    if lap["reordering"] != "None":
        raise ValueError(f"reordering {lap['reordering']!r} is not run here")
    mesh = getattr(mesh_mod, lap["mesh"])(
        cfg["assumed"]["dim"], n_refinements, degree=lap["fe_degree"],
        distort_random=lap["distort_random"])
    return LaplaceProblem.from_mesh(mesh, cfg["material_property"]["type"])


class System:
    """The problem and its hierarchy on ``device``, with the host-clock
    seconds of each (``problem_s``; ``hierarchy_s`` up to a synchronised
    device)."""

    def __init__(self, cfg: dict, device: torch.device, n_refinements: int):
        from mfmg_torch.amge.hierarchy import Hierarchy
        self.device = device
        t0 = time.perf_counter()
        self.problem = build_problem(cfg, n_refinements)
        t1 = time.perf_counter()
        self.hier = Hierarchy(self.problem, program_config(cfg), device=device)
        self.synchronize()
        t2 = time.perf_counter()
        self.problem_s, self.hierarchy_s = t1 - t0, t2 - t1
        self.n = int(self.problem.n_dofs)
        self.levels = [int(lv.op.shape[0]) for lv in self.hier.levels]
        self.dtype = self.hier.dtype

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mesh(self):
        """(nodes, cells, constrained) of the program's mesh, numpy arrays:
        its dofs' coordinates, its cells and its Dirichlet flags."""
        m = self.problem.mesh
        return m.nodes, m.cells, self.problem.constrained
