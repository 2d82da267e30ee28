"""K2's blocked form on the CPU: its model on the 19x23x37 grid (the
13x41x67 cases are in tests/test_torch_k2_model_res.py and
test_torch_k2_model_nores.py), the plan's tiles, the dispatch rule
``k2_form`` and the wrapper's plain path on CPU tensors."""

import itertools

import numpy as np
import pytest
import torch

from _torch_kernel_models import check_k2_blocked_model, random_sym_case
from mfmg_torch import LaplaceProblem
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import stencil as tst
from mfmg_torch.ops import stencil_kernels as tk


@pytest.mark.parametrize("grid", [(19, 23, 37)], ids=["19x23x37"])
@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("want_res", [False, True], ids=["no-res", "res"])
def test_k2_blocked_model_matches_plain(grid, degree, want_res):
    check_k2_blocked_model(grid, degree, want_res)


def test_k2_plan_tiles_split_evenly():
    """The plan's tiles cover each axis with only the last one ragged, a
    frame is at most 32 points wide and K2_FRAME_ROWS high, and the blocks
    fill the SMs about K2_BLOCKS_PER_SM times at 129^3.  There, for the
    degree-2 step with the residual (3 levels), the block reads each plane
    slice over level 1's region (the tile and 2 points per side, cz + 4
    slices): 1.81x the interior, above the 1.5x aimed at because a frame
    is at most 16 rows (a warp per row, 512 threads); its applies over the
    shrinking regions are 1.39x the chain's."""
    for grid in ((129, 129, 129), (65, 65, 65), (19, 23, 37)):
        for degree, res in itertools.product((1, 2, 3), (False, True)):
            p = tk.cheb_blocked_plan(grid, degree, res)
            for n, t, nb in zip(grid, (p.cz, p.ty, p.tx), p.grid[::-1]):
                assert nb == -(-n // t) and n - (nb - 1) * t >= 1
                assert t - (n - (nb - 1) * t) < nb
            assert p.tx + 2 * p.halo <= 32
            assert p.ty + 2 * p.halo <= tk.K2_FRAME_ROWS
    p = tk.cheb_blocked_plan((129,) * 3, 2, True)
    interior = p.ty * p.tx * p.cz

    def region(m):                       # level L - m: margin m, in points
        return (p.ty + 2 * m) * (p.tx + 2 * m) * (p.cz + 2 * m)

    assert region(p.halo - 1) <= 1.85 * interior
    assert sum(region(m) for m in range(p.halo)) <= 1.4 * p.halo * interior
    n_blocks = int(np.prod(p.grid))
    assert cl.H100_SMS <= n_blocks <= (tk.K2_BLOCKS_PER_SM + 1) * cl.H100_SMS


def test_k2_form_rule():
    """A step with the residual on Q1 planes (the 13 positive offsets of
    radius 1, in their order) at degrees 1-3 goes to the blocked form on a
    grid of more than K2_BLOCKED_MIN_POINTS points (129^3, not 65^3); the
    step without the residual, smaller grids, the Q2 cube's 62 pairs of
    radius 2 and degree 4 go to the chain."""
    prob = LaplaceProblem.hyper_cube(3, 2, material_property="linear")
    op = tst.stencil_from_cell_matrices(prob.mesh, prob.A_loc, prob.constrained,
                                        prob.diag_raw, dtype=torch.float32)
    assert op.sym_pos is not None and len(op.pos_offsets) == 13
    assert tuple(op.pos_offsets) == tk.Q1_POS
    small, g65, g129 = op.grid_shape, (65,) * 3, (129,) * 3
    for degree, res, grid in itertools.product((1, 2, 3), (False, True),
                                               (small, g65, g129)):
        want = "blocked" if grid == g129 and res else "chain"
        assert tk.k2_form(op.pos_offsets, degree, res, grid) == want
    assert 65 ** 3 <= tk.K2_BLOCKED_MIN_POINTS < 129 ** 3
    q2 = tuple(o for o in itertools.product(range(-2, 3), repeat=3)
               if o > (0, 0, 0))
    for res in (False, True):
        assert tk.k2_form(op.pos_offsets, 4, res, g129) == "chain"
        assert len(q2) == 62 and tk.k2_form(q2, 2, res, g129) == "chain"
        # the kernel's offsets are compile-time: another order or subset of
        # the radius-1 offsets goes to the chain
        assert tk.k2_form(op.pos_offsets[::-1], 2, res, g129) == "chain"
        assert tk.k2_form(op.pos_offsets[:7], 2, res, g129) == "chain"
    with pytest.raises(ValueError, match="form 'blocked'"):
        x = torch.zeros(int(np.prod(small)))
        tk.cheb_smooth_as("blocked", torch.zeros((14,) + small), x, x, x,
                        torch.zeros(4), tk.Q1_POS[::-1], small, 2)


def test_k2_wrapper_counts_nothing_on_the_cpu():
    """On CPU tensors K2 runs its plain version whatever the form."""
    grid = (5, 6, 7)
    planes, x, b, invd, pos = random_sym_case(grid, 0)
    planes, x, b, invd = (t.to(torch.float32) for t in (planes, x, b, invd))
    coef = torch.tensor([0.9, 0.7, 0.0, 0.2], dtype=torch.float32)
    cl.reset_launch_counts()
    got = tk.cheb_smooth(planes, x, b, invd, coef, pos, grid, 2, True)
    ref = tk.cheb_smooth_plain(planes, x, b, invd, coef, pos, grid, 2, True)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert all(v == 0 for v in cl.LAUNCHES.values())
