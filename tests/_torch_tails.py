"""Test and script helper: fused coarse tails with random operands, for the
CPU model and card tests of csrc/fused_tail.cu and the measurement scripts,
at shapes no hierarchy at hand gives.  Imports torch and mfmg_torch only
(the card's machine runs it without jax).

Scripts under scripts/ import it after putting tests/ on sys.path.
"""

import numpy as np
import torch

from mfmg_torch.ops import fused_cycle as fc
from mfmg_torch.solve.smoothers import _cheb_coeffs

RADIUS1_OFFSETS = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1))
# inv2's scale over n2.  The coarse correction's share of a random tail's
# sub-cycle output (correction_share) is then 2-66% in the dense form, as
# in the hierarchies (4-69%, scripts/tail_share.py), but ~0.13% in the
# windowed form, where a bf16 rounding that flips under another summation
# order stays at roundoff; with a unit-scale inv2 such a flip moved the
# windowed 32^3 random tail's output by 6.3e-5 (PERF.md, the coarse tail)
INV2_SCALE = 0.02


def random_tail(grid, n_comp=2, *, dense=True, fine_window=None, degree=2,
                nss=1, bf16=True, n2e=4, window=(6, 6, 6), stride=(4, 4, 4),
                t0=(-1, -1, -1), dtype=torch.float32, seed=0,
                device="cpu") -> fc.FusedTail:
    """A tail with random operands made from ``seed`` with numpy.

    The level-1 block stencil over the 27 offsets of radius 1 (its centre
    block diagonally dominant), invd its inverse diagonal, the Chebyshev
    coefficients of the interval (1.15, 1.08), a small symmetric inv2 of
    n2 = n2e * prod(ceil(grid / stride)) rows (INV2_SCALE / n2 times a
    standard normal matrix), a dense Rd (n2, n1) or the windowed W2
    (``window`` at ``stride`` from ``t0`` over the level-1 grid), and with
    ``fine_window`` the fine W over those windows at stride w - 1 (full
    mode).  Weights in bf16 or ``dtype``, the rest in ``dtype``."""
    rng = np.random.default_rng(seed)
    grid, c = tuple(grid), int(n_comp)
    n_sites = int(np.prod(grid))
    out_grid = tuple(-(-g // s) for g, s in zip(grid, stride))
    n2 = n2e * int(np.prod(out_grid))
    wdt = torch.bfloat16 if bf16 else dtype

    def t(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    C = rng.uniform(-0.5, 0.0, (27,) + grid + (c, c)) / c
    C[13] = rng.uniform(-0.2, 0.2, grid + (c, c))
    C[13] += (28.0 + rng.uniform(0, 1, grid + (c,)))[..., None] * np.eye(c)
    coeffs = t(C, wdt)
    invd = 1.0 / torch.diagonal(coeffs[13].to(dtype), dim1=-2, dim2=-1).reshape(-1)
    alphas, betas = _cheb_coeffs(1.15, 1.08, degree)
    G = INV2_SCALE * rng.standard_normal((n2, n2)) / n2
    Rd = W2 = win = W = fine_grid = None
    if dense:
        Rd = t(rng.standard_normal((n2, n_sites * c)) / 8, wdt)
    else:
        W2 = t(rng.standard_normal((n2,) + tuple(window) + (c,)) / 8, wdt)
        win = dict(window_shape=tuple(window), t0=tuple(t0),
                   stride=tuple(stride), out_grid=out_grid, n_out=n2e)
    if fine_window is not None:
        W = t(rng.uniform(0, 1, (c,) + tuple(fine_window) + grid), wdt)
        fine_grid = tuple(a * (w - 1) + 1 for a, w in zip(grid, fine_window))
    return fc.FusedTail(coeffs, RADIUS1_OFFSETS, grid, c, invd.contiguous(),
                        t(alphas + betas), degree, nss, t(G + G.T), Rd=Rd, W2=W2,
                        win=win, W=W, fine_window=fine_window, fine_grid=fine_grid)


def correction_share(ft: fc.FusedTail, b1: torch.Tensor) -> float:
    """The coarse correction's share of the sub-cycle's output (plain
    version): ||subcycle(b1) - subcycle(b1) without the correction|| /
    ||subcycle(b1)||, the second with inv2 = 0."""
    bare = fc.FusedTail(ft.coeffs, ft.offsets, ft.grid, ft.n_comp, ft.invd,
                        ft.cheb_coef, ft.degree, ft.nss, torch.zeros_like(ft.inv2),
                        Rd=ft.Rd, W2=ft.W2, win=ft.win, W=ft.W,
                        fine_window=ft.fine_window, fine_grid=ft.fine_grid)
    out = fc.fused_subcycle_apply_plain(ft, b1)
    diff = out - fc.fused_subcycle_apply_plain(bare, b1)
    return float(torch.linalg.norm(diff) / torch.linalg.norm(out))


# Tails whose plan leaves weights in global memory (bf16 weights, c = 4,
# fine windows of 3^3), each with its (stage_coeffs, stage_rd): the
# coefficients and the windowed W2 unstaged; the coefficients staged and
# the dense Rd not; the coefficients unstaged and the dense Rd staged.
UNSTAGED_TAILS = {
    "40^3-c4-windowed": (dict(grid=(40,) * 3, n_comp=4, dense=False), (0, 0)),
    "24^3-c4-dense": (dict(grid=(24,) * 3, n_comp=4, stride=(8, 8, 8)), (1, 0)),
    "40^3-c4-dense-n2-8": (dict(grid=(40,) * 3, n_comp=4, n2e=1, stride=(20,) * 3),
                           (0, 1)),
}
