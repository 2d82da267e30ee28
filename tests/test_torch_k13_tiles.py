"""K1/K3's tiles modelled block by block on the CPU
(``_torch_kernel_models.k13_tile_model``) against the plain versions, and
their plan at the main shapes."""

import numpy as np
import pytest
import torch

from _torch_kernel_models import K13_MODEL_CASES, K2_TOL, cdiv, k13_tile_model
from _torch_stencils import cube_offsets
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import stencil_kernels as tk


@pytest.mark.parametrize("case", list(K13_MODEL_CASES))
@pytest.mark.parametrize("tile", [1024, 256], ids=["1024-point-tiles", "256-point-tiles"])
def test_k13_tile_model_matches_plain(case, tile, monkeypatch):
    """K1/K3's tiles, the points dealt to threads, x halos with zero fill,
    and the backward term's shifted reads, against the plain versions in
    float64 on ragged grids, radius 1-3, dense and sparse offsets, the
    plan's whole-row tiles and row segments, one z slice (K1's reads
    clamped at the planes' start); no NaN reaches the output (every point
    written, no value read that was not loaded)."""
    grid, radius, sym, sparse, override = K13_MODEL_CASES[case]
    offsets = cube_offsets(radius, sym, sparse)
    n = int(np.prod(grid))
    n_v = 2 * len(offsets) + 1 if sym else len(offsets)
    monkeypatch.setattr(tk, "K13_TILE_POINTS", tile)
    plan = tk.stencil_tile_plan.__wrapped__(grid, radius, n_v)
    if override is not None:
        rows, cols = override
        plan = plan._replace(rows=rows, cols=cols, blocks=cdiv(grid[2], cols)
                             * cdiv(grid[1], rows) * grid[0])
    rng = np.random.default_rng(len(offsets))
    n_planes = 1 + len(offsets) if sym else len(offsets)
    planes = torch.from_numpy(rng.uniform(-1, 1, (n_planes,) + grid))
    x = torch.from_numpy(rng.uniform(-1, 1, n))
    got = k13_tile_model(planes, x, offsets, grid, sym, plan)
    ref = (tk.stencil_apply_sym_plain if sym else tk.stencil_apply_plain)(
        planes, x, offsets, grid)
    assert not torch.isnan(got).any(), "a point no block wrote, or a NaN read"
    assert float((got - ref).abs().max()) <= K2_TOL * float(ref.abs().max())


def test_k13_plan_at_the_main_shapes():
    """K1/K3's plan: whole-row tiles of at most K13_TILE_POINTS points, split
    evenly over y (only the last one ragged), more blocks than SMs at the
    main shapes, shared memory that lets 3 blocks share an SM (228 KB); a
    row longer than a tile is cut into even segments, and Q3's 343 terms
    fit."""
    cases = [((65,) * 3, 2, 125), ((65,) * 3, 1, 27), ((129,) * 3, 1, 27),
             ((65,) * 3, 3, 343), ((49,) * 3, 3, 343), ((13,) * 3, 3, 343)]
    for grid, r, n_v in cases:
        p = tk.stencil_tile_plan(grid, r, n_v)
        gz, gy, gx = grid
        assert p.cols == gx and p.rows * gx <= tk.K13_TILE_POINTS
        n_yt = cdiv(gy, p.rows)
        last = gy - (n_yt - 1) * p.rows
        assert 1 <= last and p.rows - last < n_yt
        assert p.blocks == n_yt * gz
        assert p.blocks >= 2 * cl.H100_SMS or gx < 65
        assert 3 * p.smem <= 228 * 1024
        assert p.smem == tk.tile_smem_bytes(n_v, r, p.rows, p.cols)
    p = tk.stencil_tile_plan((3, 4, 1500), 3, 343)
    assert p.rows == 1 and p.cols == 750 and p.smem <= tk.H100_SMEM_PER_BLOCK
