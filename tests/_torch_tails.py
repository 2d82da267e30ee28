"""Test and script helper: fused coarse tails with random operands, for the
CPU model and card tests of csrc/fused_tail.cu and the measurement scripts,
at shapes no hierarchy at hand gives.  Imports torch and mfmg_torch only
(the card's machine runs it without jax).

Scripts under scripts/ import it after putting tests/ on sys.path.
"""

import numpy as np
import torch

from mfmg_torch.amge.hierarchy import LevelData
from mfmg_torch.ops import fused_cycle as fc
from mfmg_torch.ops import transfer_kernels as ttk
from mfmg_torch.ops.block_stencil import BlockStencilOperator
from mfmg_torch.solve.coarse import DirectCoarseSolver
from mfmg_torch.solve.smoothers import ChebyshevSmoother, _cheb_coeffs

# the Chebyshev interval's centre and half-width of every random tail
CHEB_THETA, CHEB_DELTA = 1.15, 1.08

RADIUS1_OFFSETS = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1))
# inv2's scale over n2.  The coarse correction's share of a random tail's
# sub-cycle output (correction_share) is then 2-66% in the dense form, as
# in the hierarchies (4-69%, scripts/tail_share.py), but ~0.13% in the
# windowed form, where a bf16 rounding that flips under another summation
# order stays at roundoff; with a unit-scale inv2 such a flip moved the
# windowed 32^3 random tail's output by 6.3e-5 (PERF.md, the coarse tail)
INV2_SCALE = 0.02
# inv2's scale for tails whose coarse correction is a hierarchy-like share of
# the sub-cycle's output (54-69% in the 129^3 hierarchy's windowed bf16
# tail, scripts/tail_share.py): 0.6-0.9 in the windowed random tails of
# 12^3-32^3 level-1 sites (correction_share), so that the bf16 roundings of
# that form move the output as they move a hierarchy's
HIERARCHY_INV2_SCALE = 10.0


def random_tail(grid, n_comp=2, *, dense=True, fine_window=None, degree=2,
                nss=1, bf16=True, n2e=4, window=(6, 6, 6), stride=(4, 4, 4),
                t0=(-1, -1, -1), dtype=torch.float32, seed=0,
                device="cpu", inv2_scale=INV2_SCALE) -> fc.FusedTail:
    """A tail with random operands made from ``seed`` with numpy.

    The level-1 block stencil over the 27 offsets of radius 1 (its centre
    block diagonally dominant), invd its inverse diagonal, the Chebyshev
    coefficients of the interval (1.15, 1.08), a small symmetric inv2 of
    n2 = n2e * prod(ceil(grid / stride)) rows (inv2_scale / n2 times a
    standard normal matrix, symmetrized), a dense Rd (n2, n1) or the windowed W2
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
    alphas, betas = _cheb_coeffs(CHEB_THETA, CHEB_DELTA, degree)
    G = inv2_scale * rng.standard_normal((n2, n2)) / n2
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


def levels_of_tail(ft: fc.FusedTail):
    """Three levels whose tail is ft's sub-cycle (windowed form, no fine
    transfer): level 1's block stencil (ft's coefficients in float32),
    Chebyshev smoother and window transfer, level 2's direct solve with
    ft's inv2; level 0 holds nothing the builder reads.
    ``fc.build_fused_tail(levels, ft.nss, reduced_storage=True)`` gives back
    ft's operands."""
    l1 = LevelData(BlockStencilOperator(ft.coeffs.float(), ft.offsets, ft.grid,
                                        ft.n_comp),
                   smoother=ChebyshevSmoother(ft.invd, CHEB_THETA, CHEB_DELTA,
                                              ft.degree),
                   transfer=ft.coarse_transfer(torch.float32))
    return [LevelData(None), l1, LevelData(None, coarse=DirectCoarseSolver(ft.inv2))]


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


# The bf16 tail's check against the float64 plain version with the same
# rounding points (fused_cycle.fused_subcycle_apply_plain64).  A float32
# kernel lands off it by its float32 error plus the roundings that error
# flips, and each flip at b2 or x2 moves the 129^3 output by up to ~1e-4
# (scripts/tail_rounding.py), far above TAIL_TOL.  The limit measures, on
# the same input, how far such flips move the output: ROUNDING_DRAWS runs
# of the float64 version with every value perturbed before its rounding by
# a float32 sum's error, u * sqrt(n) * 2^-24 * mag (u uniform in [-1, 1], n
# the sum's terms, mag the sum of their magnitudes), and the float32 plain
# version itself; the largest of these gaps, times ROUNDING_MARGIN (the
# kernel may draw more or larger flips than any one of them), plus
# TAIL_TOL.  An indexing error moves an output by the size of the output
# itself, far above that in the max norm (tests/test_torch_fused_cycle.py
# holds a wrong site and a wrong window offset to fail it).
TAIL_TOL = 1e-5
ROUNDING_DRAWS = 8
ROUNDING_MARGIN = 4.0


def rel_inf(a, b):
    """||a - b||_inf / ||b||_inf, in float64."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def rounding_limit(ft: fc.FusedTail, b1: torch.Tensor, seed: int = 0):
    """(float64 plain output, limit, readings) for the sub-cycle of ft on b1
    (see above); readings: the float32 plain version's gap and each draw's.
    Every gap and the limit are relative in the max norm (``rel_inf``): a
    flip spreads over the outputs through inv2 and the post-smooth, a wrong
    index sits at its own outputs."""
    return _rounding_limit(
        ft, lambda perturb=None: fc.fused_subcycle_apply_plain64(ft, b1, perturb),
        fc.fused_subcycle_apply_plain(ft, b1.float()), seed)


def correction_plain64(ft: fc.FusedTail, res: torch.Tensor,
                       perturb=None) -> torch.Tensor:
    """The full mode's correction P . subcycle(R . res) in float64 (the
    full output is x minus it), the sub-cycle rounding to bf16 where the
    float32 one does (``fused_subcycle_apply_plain64``), the fine transfer
    in float64 over the stored (bf16) fine weights."""
    g = (ft.fine_window, ft.grid, ft.fine_grid)
    W = ft.W.to(torch.float64)
    b1 = ttk.structured_restrict_plain(W, res.to(torch.float64), *g)
    x1 = fc.fused_subcycle_apply_plain64(ft, b1, perturb)
    return ttk.structured_prolong_plain(W, x1, *g)


def correction_of(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The correction a full-mode output applied to x: x - out, in float64."""
    return x.double() - out.double()


def rounding_limit_full(ft: fc.FusedTail, x: torch.Tensor, res: torch.Tensor,
                        seed: int = 0):
    """``rounding_limit`` for the full mode, read on its correction
    (``correction_of(x, out)``) so that x does not dilute a wrong one: the
    float64 correction (``correction_plain64``), the float32 plain version's
    gap to it (its final float32 subtraction from x included) and the
    perturbed draws of its sub-cycle, in the max norm of the correction."""
    return _rounding_limit(
        ft, lambda perturb=None: correction_plain64(ft, res, perturb),
        correction_of(x, fc.fused_correction_apply_plain(ft, x.float(),
                                                         res.float())), seed)


def _rounding_limit(ft, run64, plain32, seed):
    ref = run64()
    w = ft.win
    terms = {"r1": len(ft.offsets) * ft.n_comp + 1,
             "b2": int(np.prod(w["window_shape"])) * ft.n_comp if w else 1,
             "x2": ft.n2, "zy": 4 * (w["n_out"] if w else 1)}
    f32 = rel_inf(plain32, ref)
    draws = []
    for d in range(ROUNDING_DRAWS):
        rng = np.random.default_rng([seed, d])

        def perturb(point, v, mag):
            u = torch.from_numpy(rng.uniform(-1, 1, tuple(v.shape))).to(v)
            return v + u * (np.sqrt(terms[point]) * 2.0 ** -24) * mag

        draws.append(rel_inf(run64(perturb), ref))
    limit = TAIL_TOL + ROUNDING_MARGIN * max([f32] + draws)
    return ref, limit, dict(plain_f32=f32, draws=draws)


# A tail whose block vectors and x2 overflow an H100 block's shared memory:
# 64^3 level-1 sites (a 257^3 fine grid) with 8 eigenvectors and 16,384
# coarse rows (tail_plan places x2 in global scratch); ~1 GB of bf16
# coefficients and a 1 GiB inv2, so a card's test only
OVERFLOW_TAIL = dict(grid=(64, 64, 64), n_comp=8, dense=False)
