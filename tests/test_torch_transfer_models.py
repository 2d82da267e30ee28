"""K4 and K5 modelled block by block on the CPU
(``_torch_kernel_models.restrict_block_model`` and
``prolong_owner_model``) against the plain versions, and K4's plan at the
main shapes."""

import numpy as np
import pytest
import torch

from _torch_kernel_models import (K4_MODEL_CASES, K4_TOL, K5_TOL,
                                  prolong_owner_model, rel,
                                  restrict_block_model)
from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import transfer_kernels as ttk


@pytest.mark.parametrize("window,agg", [(5, (3, 4, 5)), (9, (2, 3, 2))],
                         ids=["5^3-windows", "Q2-9^3-windows"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k5_owner_model_matches_plain(window, agg, bf16):
    ws = (window,) * 3
    grid = tuple(a * (window - 1) + 1 for a in agg)
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.standard_normal((2,) + ws + agg).astype(np.float32))
    if bf16:
        W = W.to(torch.bfloat16)
    xc = torch.from_numpy(rng.standard_normal(2 * int(np.prod(agg)))
                          .astype(np.float32))
    got = prolong_owner_model(W, xc, ws, agg, grid)
    assert not torch.isnan(got).any(), "a fine point has no owner"
    assert rel(got, ttk.structured_prolong_plain(W, xc, ws, agg, grid)) <= K5_TOL


@pytest.mark.parametrize("case", list(K4_MODEL_CASES))
def test_k4_block_model_matches_plain(case):
    ws, agg, c, vec, n_sm, wb = K4_MODEL_CASES[case]
    grid = tuple(a * (w - 1) + 1 for a, w in zip(agg, ws))
    plan = ttk.restrict_plan(ws, agg, c, vec, wb, n_sm)
    if case == "uneven-gy":
        assert plan.nay == 6
    assert plan.nzc == (4 if case == "129^3-5^3-32^3" else 3 if case == "march-ragged"
                        else 1)
    if case == "march-ragged":
        assert agg[0] % plan.nzc
    if case == "march-ragged":
        assert agg[1] % plan.nay
    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.standard_normal((c,) + ws + agg)).to(
        torch.bfloat16 if wb == 2 else torch.float32)
    x = torch.from_numpy(rng.standard_normal(int(np.prod(grid))))
    got = restrict_block_model(W, x, ws, agg, grid, plan)
    assert not torch.isnan(got).any(), "an output read a value no one wrote"
    ref = ttk.structured_restrict_plain(W.double(), x, ws, agg, grid)
    assert rel(got, ref) <= K4_TOL


def test_k4_plan_at_the_main_shapes():
    """Both main shapes fill the card: at 129^3 (32^3 agglomerates of 5^3
    windows) a row of 32 per block, 224 threads (200 items: 8 groups of 4
    sites x 25 window rows), 2 lanes per output's final sum, marching over 4
    slabs with float32 W (256 blocks of 92 KB, two per SM, all resident; one
    slab each would take 3.9 waves) and one slab with bf16 (1,024 blocks of
    51 KB, four per SM, 1.9 waves); on the distorted Q2
    cube (8^3 of 9^3) half rows of 4, one slab, 128 blocks of 96 threads (81
    items), as many as its runs of 4 give, 8 lanes per output; the ring's
    row stride odd; everything within an H100 block's shared memory."""
    f32 = ttk.restrict_plan((5,) * 3, (32,) * 3, 2, True, 4)
    bf = ttk.restrict_plan((5,) * 3, (32,) * 3, 2, True, 2)
    q = ttk.restrict_plan((9,) * 3, (8,) * 3, 2, True, 4)
    fields = ("nay", "nax", "nzc", "vec", "threads", "red_lanes", "blocks")
    assert tuple(getattr(f32, k) for k in fields) == (1, 32, 4, 1, 224, 2, 256)
    assert tuple(getattr(bf, k) for k in fields) == (1, 32, 1, 1, 224, 2, 1024)
    assert tuple(getattr(q, k) for k in fields) == (1, 4, 1, 1, 96, 8, 128)
    assert f32.blocks <= 2 * cl.H100_SMS
    assert 2 * (f32.smem_bytes + 1024) <= ttk.H100_SMEM_PER_SM
    assert 4 * (bf.smem_bytes + 1024) <= ttk.H100_SMEM_PER_SM
    assert bf.blocks <= ttk.RESTRICT_MAX_WAVES * 4 * cl.H100_SMS
    for plan in (f32, bf, q):
        assert plan.rowstride % 2 == 1 and plan.smem_bytes <= ttk.RESTRICT_MAX_SMEM
    with pytest.raises(ValueError, match="gx % 4"):
        ttk.restrict_plan((5,) * 3, (3, 4, 5), 2, True)
