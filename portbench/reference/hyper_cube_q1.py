"""The reference's own mesh of upstream's hyper_cube (tests/laplace.hpp:
GridGenerator::hyper_cube, refine_global): the unit cube cut into 2^r Q1
cells a side, nodes numbered x fastest, every node on the cube's surface a
Dirichlet dof."""

from __future__ import annotations

import torch


def mesh(cfg: dict, n_refinements: int, device):
    """(nodes (n, 3) float64, cells (n_cells, 8) int64, constrained (n,)
    bool) on ``device``; node ix + m iy + m^2 iz at (ix, iy, iz) / 2^r."""
    k = 2 ** n_refinements
    m = k + 1
    i = torch.arange(m, device=device)
    iz, iy, ix = torch.meshgrid(i, i, i, indexing="ij")
    grid = torch.stack([ix, iy, iz], -1).reshape(-1, 3)
    nodes = grid.to(torch.float64) / k
    constrained = ((grid == 0) | (grid == k)).any(1)
    c = torch.arange(k, device=device)
    cz, cy, cx = (t.reshape(-1) for t in torch.meshgrid(c, c, c, indexing="ij"))
    corner = cx + m * cy + m * m * cz
    local = torch.tensor([(l & 1) + m * ((l >> 1) & 1) + m * m * (l >> 2)
                          for l in range(8)], device=device)
    return nodes, corner[:, None] + local[None, :], constrained


def locate(nodes: torch.Tensor, points: torch.Tensor):
    """(idx, gap): the grid node each point lies nearest to, and its
    distance from it."""
    m = round(float(nodes.shape[0]) ** (1.0 / 3.0))
    k = m - 1
    g = torch.round(points * k).clamp(0, k)
    gap = torch.linalg.norm(points - g / k, dim=1)
    g = g.to(torch.int64)
    return g[:, 0] + m * g[:, 1] + m * m * g[:, 2], gap
