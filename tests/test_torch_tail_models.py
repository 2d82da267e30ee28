"""The fused coarse tail modelled phase by phase and block by block on the
CPU (``_torch_kernel_models.tail_model``) against the plain versions, and
``fused_cycle.tail_plan`` at the main shapes, where weights do not fit and
where the block's vectors go to global scratch."""

import numpy as np
import pytest
import torch

from _torch_kernel_models import TAIL_CASES, TAIL_TOL, rel, tail_model
from _torch_tails import UNSTAGED_TAILS, random_tail
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import fused_cycle as fc


@pytest.mark.parametrize("case", list(TAIL_CASES))
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "windowed"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("degree,nss", [(1, 1), (2, 1), (3, 1), (2, 2)],
                         ids=["d1", "d2", "d3", "d2-nss2"])
def test_tail_model_matches_plain(case, dense, bf16, degree, nss):
    grid, fw, n_sm = TAIL_CASES[case]
    ft = random_tail(grid, 2, dense=dense, fine_window=fw, degree=degree,
                     nss=nss, bf16=bf16, window=(4, 4, 4), stride=(2, 2, 2),
                     t0=(-1, -1, -1), dtype=torch.float64, seed=degree)
    plan = fc.plan_of(ft, n_sm)
    if case == "5x7x9-3^3":
        assert (plan.blocks, plan.sites, plan.group) == (8, 40, 8)
    rng = np.random.default_rng(7)
    b1 = torch.from_numpy(rng.standard_normal(ft.n1))
    x = torch.from_numpy(rng.uniform(size=ft.n_fine))
    res = torch.from_numpy(rng.standard_normal(ft.n_fine))
    for full in (False, True):
        got = (tail_model(ft, plan, True, x=x, res=res) if full
               else tail_model(ft, plan, False, b1=b1))
        ref = (fc.fused_correction_apply_plain(ft, x, res) if full
               else fc.fused_subcycle_apply_plain(ft, b1))
        assert not torch.isnan(got).any(), "a value no block computed"
        assert rel(got, ref) <= TAIL_TOL


def test_tail_plan_at_the_main_shapes():
    """At the 65^3, 129^3 and Q2-cube shapes (c = 2, 27 offsets), bf16 and
    f32 weights: at most one block per SM, every site owned once (the last
    block ragged at 129^3), the groups of lanes filling the block, and the
    dynamic shared memory within the H100's 227 KB per block with the
    coefficients (and the dense Rd columns) staged there."""
    # (level-1 grid, n2, dense, the fine window's entries: 5^3, none in the
    # sub-cycle mode at 129^3, 9^3)
    shapes = {"65^3": ((16,) * 3, 256, True, 125),
              "129^3": ((32,) * 3, 2048, False, 0), "Q2": ((8,) * 3, 32, True, 729)}
    for name, (grid, n2, dense, table) in shapes.items():
        n_sites = int(np.prod(grid))
        for wb in (2, 4):
            p = fc.tail_plan(grid, 2, 27, n2, dense, wb, table)
            assert 1 <= p.blocks <= cl.H100_SMS
            assert (p.blocks - 1) * p.sites < n_sites <= p.blocks * p.sites
            assert p.smem_bytes <= fc.H100_SMEM_PER_BLOCK
            assert p.stage_coeffs and p.stage_rd == int(dense)
            for g, items in ((p.group, p.sites), (p.fine_group, 2 * p.sites),
                             (p.row_parts, n2), (p.col_parts, 2 * p.sites)):
                assert g in (1, 2, 4, 8, 16, 32)
                assert g == 32 or 2 * g * items > fc.TAIL_THREADS
                assert g == 1 or g * items <= fc.TAIL_THREADS
            assert p.off_x2 >= 3 * p.sites * 2 * 4
            assert p.off_tab >= p.off_x2 + 4 * n2
            assert p.off_vb >= p.off_tab + 4 * table
            assert p.off_coef >= p.off_vb + 4 * (fc.TAIL_THREADS // p.group) * 27 * 2
            assert p.cstride >= 2 * 2 * p.sites * wb + 15
            assert p.off_rd >= p.off_coef + 27 * p.cstride
    # 65^3: 128 blocks of 32 sites, 16 lanes per site, 8 per (e, a) of the
    # fine restriction (125 window entries: 16 per lane); the Q2 cube: 128
    # blocks of 4 sites, a warp per site and per (e, a) (729 entries: 23 per
    # lane); 129^3: 132 blocks, the last of 149 sites
    p65 = fc.tail_plan((16,) * 3, 2, 27, 256, True, 2)
    assert (p65.blocks, p65.sites, p65.group, p65.fine_group) == (128, 32, 16, 8)
    pq = fc.tail_plan((8,) * 3, 2, 27, 32, True, 2)
    assert (pq.blocks, pq.sites, pq.group, pq.fine_group) == (128, 4, 32, 32)
    p129 = fc.tail_plan((32,) * 3, 2, 27, 2048, False, 2)
    assert (p129.blocks, p129.sites) == (132, 249)
    assert 32 ** 3 - 131 * 249 == 149
    # the main shapes keep the all-shared plan of the kernel's design, field
    # for field (the plans before global placement existed, recorded)
    before = {
        ((16,) * 3, 256, True, 2, 125): (128, 32, 16, 8, 2, 8, 1, 1, 272, 144, 9216,
                                         16560, 768, 1792, 2304, 53424),
        ((16,) * 3, 256, True, 4, 125): (128, 32, 16, 8, 2, 8, 1, 1, 528, 272, 9216,
                                         23472, 768, 1792, 2304, 93104),
        ((32,) * 3, 2048, False, 2, 0): (132, 249, 2, 1, 1, 1, 1, 0, 2016, 1024,
                                         69472, 123904, 5984, 14176, 14176, 123904),
        ((32,) * 3, 2048, False, 4, 0): (132, 249, 2, 1, 1, 1, 1, 0, 4000, 2016,
                                         69472, 177472, 5984, 14176, 14176, 177472),
        ((8,) * 3, 32, True, 2, 729): (128, 4, 32, 32, 16, 32, 1, 1, 48, 32, 6608,
                                       7904, 96, 224, 3152, 8928),
        ((8,) * 3, 32, True, 4, 729): (128, 4, 32, 32, 16, 32, 1, 1, 80, 48, 6608,
                                       8768, 96, 224, 3152, 10304),
    }
    for (grid, n2, dense, wb, table), fields in before.items():
        assert tuple(fc.tail_plan(grid, 2, 27, n2, dense, wb, table)) == fields + (1, 1, 1)
    # beyond the card's shared memory the weights stay in global memory;
    # where not even the block's own vectors, x2 and gather buffer fit, the
    # plan places them in global scratch (test_tail_plan_places_in_global_memory)
    big = fc.tail_plan((64,) * 3, 2, 27, 16384, False, 4)
    assert not big.stage_coeffs and big.smem_bytes <= fc.H100_SMEM_PER_BLOCK
    over = fc.tail_plan((64,) * 3, 8, 27, 16384, False, 4)
    assert (over.stage_vecs, over.stage_x2, over.stage_vb) == (1, 0, 1)
    assert over.smem_bytes <= fc.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("case", list(UNSTAGED_TAILS))
def test_tail_plan_leaves_what_does_not_fit(case):
    """Tails whose weights do not all fit an H100 block's shared memory
    (the card test test_fused_tail_unstaged_matches_plain runs them): the
    plan stages what fits, in order coefficients then Rd, owns every site
    once and stays within 227 KB."""
    kw, staged = UNSTAGED_TAILS[case]
    ft = random_tail(fine_window=(3, 3, 3), **kw)
    p = fc.plan_of(ft)
    assert (p.stage_coeffs, p.stage_rd) == staged
    assert p.smem_bytes <= fc.H100_SMEM_PER_BLOCK
    n_sites = int(np.prod(ft.grid))
    assert p.blocks <= cl.H100_SMS
    assert (p.blocks - 1) * p.sites < n_sites <= p.blocks * p.sites
    coef_bytes = len(ft.offsets) * p.cstride
    rd_bytes = ft.n2 * p.rstride
    # what is not staged would not have fit beside what is
    if not p.stage_coeffs:
        assert p.off_coef + coef_bytes > fc.H100_SMEM_PER_BLOCK
    if ft.Rd is not None and not p.stage_rd:
        assert p.off_rd + rd_bytes > fc.H100_SMEM_PER_BLOCK
    assert p.smem_bytes == (p.off_rd + p.stage_rd * rd_bytes
                            if ft.Rd is not None else p.off_rd)


# (level-1 grid, c, n2): what the plan leaves in global memory, in order:
# x2 (64^3 level-1 sites at c = 8, a 257^3 fine grid: the vectors 190,656
# bytes and x2 65,536 do not fit beside each other), then the gather buffer
# (66 x 66 x 70 sites: vectors 221,760 bytes), then the vectors (80^3)
PLACEMENTS = {
    "64^3-c8": ((64, 64, 64), 8, 16384, (1, 0, 1)),
    "66x66x70-c8": ((66, 66, 70), 8, 16384, (1, 0, 0)),
    "80^3-c8": ((80, 80, 80), 8, 16384, (0, 0, 0)),
}


@pytest.mark.parametrize("case", list(PLACEMENTS))
@pytest.mark.parametrize("wb", [2, 4], ids=["bf16", "f32"])
def test_tail_plan_places_in_global_memory(case, wb):
    """Tails whose block vectors, x2 or gather buffer overflow an H100
    block's shared memory get a plan (build_fused_tail no longer gives them
    to the generic recursion): what does not fit lies in global scratch,
    what stays in shared memory is laid out as before within 227 KB, every
    site owned once, and the scratch holds the blocks' vectors and gather
    buffers from 16-byte boundaries."""
    grid, c, n2, placed = PLACEMENTS[case]
    p = fc.tail_plan(grid, c, 27, n2, False, wb)
    assert (p.stage_vecs, p.stage_x2, p.stage_vb) == placed
    assert p.smem_bytes <= fc.H100_SMEM_PER_BLOCK and not p.stage_coeffs
    n_sites = int(np.prod(grid))
    assert (p.blocks - 1) * p.sites < n_sites <= p.blocks * p.sites
    vec = -(-3 * p.sites * c * 4 // 16) * 16
    vb = -(-4 * (fc.TAIL_THREADS // p.group) * 27 * c // 16) * 16
    assert p.off_x2 == p.stage_vecs * vec
    assert p.off_tab == p.off_x2 + p.stage_x2 * 4 * n2
    assert p.off_coef == p.off_vb + p.stage_vb * vb
    # the placement before this one would not have fit
    if p.stage_vecs and not p.stage_x2 and p.stage_vb:
        assert vec + 4 * n2 + vb > fc.H100_SMEM_PER_BLOCK
    if not p.stage_vb:
        assert vec + -(-4 * 16 * 27 * c // 16) * 16 > fc.H100_SMEM_PER_BLOCK
    n1 = n_sites * c
    base = -(-(5 * n1 + (p.blocks + 2) * n2) // 4) * 4
    want = base
    if not p.stage_vecs:
        want = -(-(want + p.blocks * 3 * p.sites * c) // 4) * 4
    if not p.stage_vb:
        want += p.blocks * (fc.TAIL_THREADS // p.group) * 27 * c
    assert fc.scratch_floats(p, n1, n2, c, 27) == want
