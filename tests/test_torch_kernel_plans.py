"""The decompositions of K2's blocked form and of K5, modelled on the CPU.

The CUDA kernels (mfmg_torch/csrc/cheb_smooth.cu, structured_transfer.cu)
run only on the card; these plain models follow their index arithmetic
block by block, so that the tiling and ownership logic is checked where
there is no GPU:

* K5 (y = R^T xc) owner computes: a block owns one fine z plane and one
  agglomerate row ay; every fine point takes its own window's term and, on
  each axis where its local offset t is 0, the t = s term of the lower
  neighbour's window.  Held against ``structured_prolong_plain`` (which
  tests/test_torch_transfer_kernels.py holds against the reference's
  ``pallas_prolong_tiled``) at 5^3 and 9^3 windows, float32 and bf16 W.
* K2's blocked form: ``cheb_blocked_plan``'s tiles and z chunks, each level
  of the recurrence computed over the tile plus a margin that shrinks one
  point per level, from the values the previous level left in the block's
  frame.  Values a block never computed or loaded are NaN in the model, so
  a halo one point short shows as NaN in the output.  Held against
  ``cheb_smooth_plain`` with random planes on 19x23x37 and 13x41x67 grids
  (2-3 tiles per axis, ragged last tiles and z chunks).
* K2's dispatch rule ``k2_form``.

Tolerances: the models sum the same float64 (K2) or float32 (K5) products
as the plain versions in another order: 1e-12 relative for K2 in float64,
1e-6 relative (2-norm) for K5 in float32 (observed ~1e-7).
"""

import itertools

import numpy as np
import pytest
import torch

from mfmg_torch import LaplaceProblem
from mfmg_torch.ops import stencil as tst
from mfmg_torch.ops import stencil_kernels as tk
from mfmg_torch.ops import transfer_kernels as ttk

K2_TOL, K5_TOL = 1e-12, 1e-6


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


# ------------------------------------------------------------------ K5

def prolong_owner_model(W, xc, window_shape, agg_shape, grid_shape):
    """K5's blocks: (iz, ay) each write the fine rows ay * sy + [0, ry) of
    plane iz; the window pairs (tx, ax) sum their z/y windows over e, then
    the x overlap adds the lower neighbour's tx = sx term."""
    (wz, wy, wx), (gz, gy, gx), (nz, ny, nx) = window_shape, agg_shape, grid_shape
    sz, sy, sx = wz - 1, wy - 1, wx - 1
    c = W.shape[0]
    Wf = W.to(torch.float32)
    xcg = xc.reshape(gz, gy, gx, c)
    y = torch.full((nz, ny, nx), float("nan"))
    ix = torch.arange(nx)
    ax_own = torch.clamp(ix // sx, max=gx - 1)
    tx_own = ix - ax_own * sx
    x_nb = (tx_own == 0) & (ax_own > 0)
    for iz in range(nz):
        az = min(iz // sz, gz - 1)
        tz = iz - az * sz
        zwin = [(az, tz)] + ([(az - 1, sz)] if tz == 0 and az > 0 else [])
        for ay in range(gy):
            ry = sy + 1 if ay == gy - 1 else sy
            for r in range(ry):
                ywin = [(ay, r)] + ([(ay - 1, sy)] if r == 0 and ay > 0 else [])
                win = torch.zeros(gx, wx)                    # [ax][tx]
                for azw, tzw in zwin:
                    for ayw, tyw in ywin:
                        # W[e, tz, ty, :, az, ay, :] is (c, wx, gx); sum over e
                        w = Wf[:, tzw, tyw, :, azw, ayw, :]
                        win += torch.einsum("etx,xe->xt", w, xcg[azw, ayw])
                row = win[ax_own, tx_own]
                row[x_nb] += win[ax_own[x_nb] - 1, sx]
                iy = ay * sy + r
                assert torch.isnan(y[iz, iy]).all(), "a fine row has two owners"
                y[iz, iy] = row
    return y.reshape(-1)


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
    assert _rel(got, ttk.structured_prolong_plain(W, xc, ws, agg, grid)) <= K5_TOL


# ------------------------------------------------------------------ K2

def _frame_apply(C, V, pos, z, y, x):
    """A v over the global box z, y, x (slices) from frame-padded arrays C
    (planes) and V: out-of-domain entries are 0, entries never loaded or
    computed NaN.  pos: positive offsets."""
    acc = C[0][z, y, x] * V[z, y, x]
    for j, (dz, dy, dx) in enumerate(pos):
        fwd = (slice(z.start + dz, z.stop + dz), slice(y.start + dy, y.stop + dy),
               slice(x.start + dx, x.stop + dx))
        bwd = (slice(z.start - dz, z.stop - dz), slice(y.start - dy, y.stop - dy),
               slice(x.start - dx, x.stop - dx))
        acc = acc + C[j + 1][z, y, x] * V[fwd] + C[j + 1][bwd] * V[bwd]
    return acc


def cheb_blocked_model(planes, x, b, invd, coef, pos, grid_shape, degree,
                       want_res, plan):
    """K2's blocked form block by block: each block sees x on its frame (the
    tile and plan.halo points per side, slices [z0 - L, z1 + L)), the planes
    on slices [z0 - L - 1, z1 + L - 1), and computes level k over the tile
    plus a margin of L - k, clipped to the domain; it writes x_s (and the
    residual) on its tile only."""
    gz, gy, gx = grid_shape
    L = plan.halo
    assert L == degree + int(want_res)
    P = L + 2                                   # frame padding of the model
    nan = float("nan")

    def padded(src, z_lo, z_hi, y_lo, y_hi, x_lo, x_hi):
        """src (gz, gy, gx) on the loaded box, 0 out of domain, NaN in the
        domain outside the box; indices shifted by P."""
        out = torch.zeros((gz + 2 * P, gy + 2 * P, gx + 2 * P), dtype=src.dtype)
        out[P:P + gz, P:P + gy, P:P + gx] = nan
        zs = slice(max(z_lo, 0), min(z_hi, gz))
        ys = slice(max(y_lo, 0), min(y_hi, gy))
        xs_ = slice(max(x_lo, 0), min(x_hi, gx))
        out[zs.start + P:zs.stop + P, ys.start + P:ys.stop + P,
            xs_.start + P:xs_.stop + P] = src[zs, ys, xs_]
        return out

    def blank():
        out = torch.zeros((gz + 2 * P, gy + 2 * P, gx + 2 * P), dtype=x.dtype)
        out[P:P + gz, P:P + gy, P:P + gx] = nan
        return out

    xg, bg, ig = (t.reshape(grid_shape) for t in (x, b, invd))
    xs_out = torch.full(grid_shape, nan, dtype=x.dtype)
    res_out = torch.full(grid_shape, nan, dtype=x.dtype)
    nbx, nby, nbz = plan.grid
    alphas, betas = coef[:degree], coef[degree:]
    for bz, by, bx in itertools.product(range(nbz), range(nby), range(nbx)):
        z0, y0, x0 = bz * plan.cz, by * plan.ty, bx * plan.tx
        z1, y1, x1 = (min(z0 + plan.cz, gz), min(y0 + plan.ty, gy),
                      min(x0 + plan.tx, gx))
        assert z0 < gz and y0 < gy and x0 < gx, "an empty block"
        box = (y0 - L, y1 + L, x0 - L, x1 + L)
        X = padded(xg, z0 - L, z1 + L, *box)
        C = [padded(p.reshape(grid_shape), z0 - L - 1, z1 + L - 1, *box)
             for p in planes.to(x.dtype)]

        def region(m):
            return tuple(slice(max(lo - m, 0) + P, min(hi + m, n) + P)
                         for lo, hi, n in ((z0, z1, gz), (y0, y1, gy), (x0, x1, gx)))

        def at(t, reg):          # a global (gz, gy, gx) array on a region
            return t[tuple(slice(s.start - P, s.stop - P) for s in reg)]

        V = X
        for k in range(1, L + 1):
            reg = region(L - k)
            av = _frame_apply(C, V, pos, *reg)
            if want_res and k == L:
                res = av - at(bg, reg)
                break
            if k == 1:
                r = blank()
                r[reg] = av - at(bg, reg)
                p = blank()
                p[reg] = at(ig, reg) * r[reg]
                dx = blank()
                dx[reg] = alphas[0] * p[reg]
            else:
                p_new = at(ig, reg) * (r[reg] - av) + betas[k - 1] * p[reg]
                p = blank()
                p[reg] = p_new
                dx_new = V[reg] + alphas[k - 1] * p_new
                dx = blank()
                dx[reg] = dx_new
            if k == degree:
                xs = blank()
                xs[reg] = at(xg, reg) - dx[reg]
                V = xs
            else:
                V = dx
        tile = (slice(z0, z1), slice(y0, y1), slice(x0, x1))
        ptile = tuple(slice(s.start + P, s.stop + P) for s in tile)
        assert torch.isnan(xs_out[tile]).all(), "a point has two owners"
        xs_out[tile] = xs[ptile]
        if want_res:
            reg0 = region(0)
            res_out[tile] = res.reshape(tuple(s.stop - s.start for s in reg0))
    xs_out = xs_out.reshape(-1)
    return (xs_out, res_out.reshape(-1)) if want_res else (xs_out,)


def _random_sym_case(grid_shape, seed):
    """Random positive planes of a Q1 27-point stencil, diagonally dominant
    center, and x, b, 1/diag, in float64."""
    rng = np.random.default_rng(seed)
    pos = tk.Q1_POS
    n = int(np.prod(grid_shape))
    planes = rng.uniform(-1.0, 0.0, (1 + len(pos),) + grid_shape)
    planes[0] = 30.0 + rng.uniform(0.0, 1.0, grid_shape)
    t = [torch.from_numpy(v) for v in (planes, rng.uniform(-1, 1, n),
                                       rng.uniform(-1, 1, n))]
    invd = 1.0 / t[0][0].reshape(-1)
    return t[0], t[1], t[2], invd, pos


@pytest.mark.parametrize("grid", [(19, 23, 37), (13, 41, 67)],
                         ids=["19x23x37", "13x41x67"])
@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("want_res", [False, True], ids=["no-res", "res"])
def test_k2_blocked_model_matches_plain(grid, degree, want_res):
    planes, x, b, invd, pos = _random_sym_case(grid, degree)
    coef = torch.tensor([0.9, 0.7, 0.5][:degree] + [0.0, 0.2, 0.1][:degree],
                        dtype=torch.float64)
    plan = tk.cheb_blocked_plan(grid, degree, want_res)
    assert plan.halo == degree + int(want_res)
    assert all(n > 1 for n in plan.grid), "one tile on an axis"
    assert plan.ty + 2 * plan.halo <= tk.K2_FRAME_ROWS
    assert plan.tx + 2 * plan.halo <= 32
    got = cheb_blocked_model(planes, x, b, invd, coef, pos, grid, degree,
                             want_res, plan)
    ref = tk.cheb_smooth_plain(planes, x, b, invd, coef, pos, grid, degree,
                               want_res)
    for g, r in zip(got, ref):
        assert not torch.isnan(g).any(), "a point no block computed"
        assert _rel(g, r) <= K2_TOL


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
    assert tk.H100_SMS <= n_blocks <= (tk.K2_BLOCKS_PER_SM + 1) * tk.H100_SMS


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
        tk._cheb_smooth("blocked", torch.zeros((14,) + small), x, x, x,
                        torch.zeros(4), tk.Q1_POS[::-1], small, 2)


def test_k2_wrapper_counts_nothing_on_the_cpu():
    """On CPU tensors K2 runs its plain version whatever the form."""
    grid = (5, 6, 7)
    planes, x, b, invd, pos = _random_sym_case(grid, 0)
    planes, x, b, invd = (t.to(torch.float32) for t in (planes, x, b, invd))
    coef = torch.tensor([0.9, 0.7, 0.0, 0.2], dtype=torch.float32)
    tk.reset_launch_counts()
    got = tk.cheb_smooth(planes, x, b, invd, coef, pos, grid, 2, True)
    ref = tk.cheb_smooth_plain(planes, x, b, invd, coef, pos, grid, 2, True)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert all(v == 0 for v in tk.LAUNCHES.values())
