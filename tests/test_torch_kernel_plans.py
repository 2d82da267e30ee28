"""The decompositions of K2's blocked form, of K4, of K5, of K1/K3's tiles
and of the fused coarse tail, modelled on the CPU.

The CUDA kernels (mfmg_torch/csrc/cheb_smooth.cu, structured_transfer.cu,
stencil_apply.cu, fused_tail.cu) run only on the card; these plain models
follow their index arithmetic block by block, so that the tiling and
ownership logic is checked where there is no GPU:

* K4 (R x) after ``restrict_plan``: blocks own runs of agglomerates and
  march over z-slabs; slab k+1's x planes (into a ring of planes) and W
  tile (into the other of two tiles) are copied before slab k is summed,
  both NaN until copied, so a slot overwritten while still read shows;
  every W entry is copied and read once, every output written once, the
  window rows summed over red_lanes lanes and a butterfly.  Held against
  ``structured_restrict_plain`` in float64 at the 129^3 shape (f32 and
  bf16 W), the distorted-Q2 shape, a ragged gx, uneven gy, ragged
  marching and c = 1-5.
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
* K1/K3 (``stencil_tile_plan``): a block owns whole grid rows of one z
  slice (or a row segment), 256 threads take 4 of its points each, x is
  staged over the tile and a halo of the radius (NaN until loaded, 0 outside
  the grid), and every term reads its virtual plane's coefficient at the
  point's index plus the plane's offset (K1's backward term at the flat
  shift -d(o)); y starts as NaN.  Held against the plain versions in
  float64 on ragged grids, radius 1-3, dense and sparse offsets, 1024-
  and 256-point tiles (the latter with clamped duplicate points), row segments and a
  one-slice grid (the clamped backward reads).
* The fused tail (``fused_cycle.tail_plan``): block b owns the level-1
  sites [b * sites, (b + 1) * sites) for the whole launch and keeps their
  b1, residual and Chebyshev p to itself; d, x and r1 go through global
  vectors that start as NaN, so a site no block owns, or a value read
  before a phase wrote it, shows as NaN in the output.  An apply sums in
  offset order (its G lanes per site only gather).  Every split sum follows
  the kernel: each lane adds its share in increasing index (the fine
  window's entries in the fine restriction; the block's columns of the
  dense partial restriction; the blocks, window entries or columns of a
  warp's coarse row; the coarse rows of a dense prolongation), then the lanes meet in the xor butterfly of
  __shfl_xor_sync; with bf16 weights the windowed form rounds r1, b2, x2 and
  each x window's z/y sum.  Held against ``fused_subcycle_apply_plain`` and
  ``fused_correction_apply_plain`` on random tails (``_torch_tails.random_tail``) over
  ragged level-1 grids, dense and windowed, f32 and bf16 weights, degree
  1-3, one and two smoothing steps.

Tolerances: the models sum the same float64 (K2, K4) or float32 (K5)
products as the plain versions in another order: 1e-12 relative for K2
and K4 in float64,
1e-6 relative (2-norm) for K5 in float32 (observed ~1e-7).  The tail model
runs in float64 against the plain versions in float64 and is held to
chip_smoke.py's TAIL_TOL, 1e-5 relative (2-norm) (observed ~1e-15: the
same products in another order, and the bf16 rounding points agree).
"""

import itertools

import numpy as np
import pytest
import torch

from _torch_stencils import cube_offsets
from _torch_tails import UNSTAGED_TAILS, random_tail
from mfmg_torch import LaplaceProblem
from mfmg_torch.ops import fused_cycle as fc
from mfmg_torch.ops import stencil as tst
from mfmg_torch.ops import stencil_kernels as tk
from mfmg_torch.ops import transfer_kernels as ttk

K2_TOL, K4_TOL, K5_TOL, TAIL_TOL = 1e-12, 1e-12, 1e-6, 1e-5


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


# ------------------------------------------------------------------ K4

def restrict_block_model(W, x, window_shape, agg_shape, grid_shape, plan):
    """K4 as restrict_plan's blocks run it, in float64.  Block (az0, ay0,
    ax0) marches over its slabs: before it sums slab k it starts the copies
    of slab k + 1 -- the x planes it does not share with slab k into a ring
    of planes (NaN-initialised, the kernel's split-by-phase layout) and its W
    tile rows into the other of two tiles (NaN-initialised) -- so a slot or
    tile that is overwritten while still read gives a wrong or NaN output.
    Its items (one window row of V sites, every component) write partial
    sums into part[r][ayl, axl, e] (NaN until written), and red_lanes lanes
    per output add them (each lane its rows in increasing r, then the
    butterfly).  Checks that the copies stay inside the grid and inside
    their part of shared memory, that every W entry is copied once and read
    once, and every output written once."""
    (wz, wy, wx), (gz, gy, gx), (nz, ny, nx) = window_shape, agg_shape, grid_shape
    sz, sy, sx = wz - 1, wy - 1, wx - 1
    c, V = W.shape[0], 4 if plan.vec else 1
    Wf, xg = W.to(torch.float64), x.to(torch.float64).reshape(nz, ny, nx)
    Wt = Wf.reshape(c * wz * wy * wx, gz, gy, gx)     # W[t, az, ay, ax]
    nzb, nyc, nxc = -(-gz // plan.nzc), -(-gy // plan.nay), -(-gx // plan.nax)
    assert plan.blocks == nzb * nyc * nxc
    ks, rs = plan.nax + 1, plan.rowstride
    ps, R = (plan.nay * sy + 1) * rs, wz * wy
    P = plan.nay * plan.nax * c
    nring = wz + sz if plan.nzc > 1 else wz
    wb = W.element_size()
    assert rs % 2 == 1 and rs >= sx * ks and plan.off_w >= 4 * nring * ps
    assert plan.wtile >= wb * c * R * wx * plan.nay * plan.nax
    assert plan.off_part >= plan.off_w + 2 * plan.wtile
    assert plan.smem_bytes >= plan.off_part + 4 * R * P
    assert plan.smem_bytes <= ttk.RESTRICT_MAX_SMEM
    assert plan.threads % 32 == 0 and plan.threads <= ttk.RESTRICT_MAX_THREADS
    copied = torch.zeros(Wt.shape, dtype=torch.int64)
    writes = torch.zeros(gz * gy * gx * c, dtype=torch.int64)
    out = torch.full((gz * gy * gx * c,), float("nan"), dtype=torch.float64)
    for blk in range(plan.blocks):
        bx, u = blk % nxc, blk // nxc
        by, bz = u % nyc, u // nyc
        az0, ay0, ax0 = bz * plan.nzc, by * plan.nay, bx * plan.nax
        nzk = min(plan.nzc, gz - az0)
        nay, nax = min(plan.nay, gy - ay0), min(plan.nax, gx - ax0)
        ring = torch.full((nring * ps,), float("nan"), dtype=torch.float64)
        tiles = [torch.full((c * R * wx * plan.nay * plan.nax,), float("nan"),
                            dtype=torch.float64) for _ in range(2)]
        tile_reads = [torch.zeros(t.shape, dtype=torch.int64) for t in tiles]

        def copy_slab(k, first):
            az = az0 + k
            # x: items (plane, row, k), each its sx columns
            pl, row, kk = torch.meshgrid(torch.arange(first, wz),
                                         torch.arange(nay * sy + 1),
                                         torch.arange(nax + 1), indexing="ij")
            for q in range(sx):
                ok = kk * sx + q < nax * sx + 1
                iz, iy, ix = az * sz + pl[ok], ay0 * sy + row[ok], ax0 * sx + kk[ok] * sx + q
                assert int(iz.max()) < nz and int(iy.max()) < ny and int(ix.max()) < nx
                dst = ((k * sz + pl[ok]) % nring) * ps + row[ok] * rs + q * ks + kk[ok]
                assert int(dst.max()) < nring * ps
                ring[dst] = xg[iz, iy, ix]
            # W: tile rows (t, ayl) of nax agglomerates
            t, ayl, a = torch.meshgrid(torch.arange(Wt.shape[0]), torch.arange(nay),
                                       torch.arange(nax), indexing="ij")
            tiles[k % 2][((t * plan.nay + ayl) * plan.nax + a).reshape(-1)] = \
                Wt[t, az, ay0 + ayl, ax0 + a].reshape(-1)
            tile_reads[k % 2].zero_()
            copied[t, az, ay0 + ayl, ax0 + a] += 1

        copy_slab(0, 0)
        for k in range(nzk):
            if k + 1 < nzk:
                copy_slab(k + 1, 1)
            az = az0 + k
            part = torch.full((R * P,), float("nan"), dtype=torch.float64)
            nv = nax // V
            it = torch.arange(nay * nv * R)
            v, r, ayl = it % nv, (it // nv) % R, it // (nv * R)
            tz, ty = r // wy, r % wy
            for i in range(V):
                axl = v * V + i
                for e in range(c):
                    acc = torch.zeros(it.numel(), dtype=torch.float64)
                    for tx in range(wx):
                        q, kk = (tx, axl) if tx < sx else (0, axl + 1)
                        xv = ring[((k * sz + tz) % nring) * ps + (ayl * sy + ty) * rs
                                  + q * ks + kk]
                        wi = (((e * R + r) * wx + tx) * plan.nay + ayl) * plan.nax + axl
                        acc = acc + tiles[k % 2][wi] * xv
                        tile_reads[k % 2][wi] += 1
                    part[r * P + (ayl * plan.nax + axl) * c + e] = acc
            used = tile_reads[k % 2]
            assert bool((used[used > 0] == 1).all()), "a tile entry read twice"
            j = torch.arange(nay * nax * c)
            jay, m = j // (nax * c), j % (nax * c)
            rows = torch.stack([part[rr * P + jay * plan.nax * c + m] for rr in range(R)])
            acc = _split_sum(rows, plan.red_lanes)
            dst = ((az * gy + ay0 + jay) * gx + ax0) * c + m
            out[dst] = acc
            writes[dst] += 1
    assert bool((copied == 1).all()), "a weight copied other than once"
    assert bool((writes == 1).all()), "an output written other than once"
    return out


# (window, agglomerates, c, vec, SMs, weight bytes): the 129^3 shape
# (marching over 4 slabs per block with float32 W, one slab with bf16) and
# the distorted-Q2 shape on 132 SMs; a ragged gx
# (scalar path); uneven gy (runs of 6 rows over 7, on a card of 1 SM so
# that rows are added); marching with ragged runs in y and z; rows of 12
# agglomerates (3 copies of W per row); c = 1..5 (5: scalar)
K4_MODEL_CASES = {
    "129^3-5^3-32^3": ((5, 5, 5), (32, 32, 32), 2, True, tk.H100_SMS, 4),
    "129^3-5^3-32^3-bf16": ((5, 5, 5), (32, 32, 32), 2, True, tk.H100_SMS, 2),
    "Q2-9^3-8^3": ((9, 9, 9), (8, 8, 8), 2, True, tk.H100_SMS, 4),
    "ragged-gx-5": ((5, 5, 5), (3, 4, 5), 2, False, tk.H100_SMS, 4),
    "uneven-gy": ((3, 3, 3), (3, 7, 8), 2, True, 1, 4),
    "march-ragged": ((5, 5, 5), (7, 4, 8), 2, True, 2, 4),
    "three-chunks": ((3, 3, 3), (2, 3, 12), 2, True, 1, 4),
    "c1": ((5, 5, 5), (2, 3, 8), 1, True, 8, 4),
    "c3": ((3, 4, 5), (2, 5, 4), 3, True, 8, 4),
    "c4": ((9, 9, 9), (2, 2, 4), 4, True, tk.H100_SMS, 4),
    "c5-scalar": ((3, 3, 3), (4, 3, 6), 5, False, 8, 4),
    "c4-scalar-ragged": ((5, 3, 4), (3, 5, 7), 4, False, 8, 4),
}


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
    assert _rel(got, ref) <= K4_TOL


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
    assert f32.blocks <= 2 * tk.H100_SMS
    assert 2 * (f32.smem_bytes + 1024) <= ttk.H100_SMEM_PER_SM
    assert 4 * (bf.smem_bytes + 1024) <= ttk.H100_SMEM_PER_SM
    assert bf.blocks <= ttk.RESTRICT_MAX_WAVES * 4 * tk.H100_SMS
    for plan in (f32, bf, q):
        assert plan.rowstride % 2 == 1 and plan.smem_bytes <= ttk.RESTRICT_MAX_SMEM
    with pytest.raises(ValueError, match="gx % 4"):
        ttk.restrict_plan((5,) * 3, (3, 4, 5), 2, True)


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


# ------------------------------------------------------------------ K1/K3

def _cdiv(a, b):
    return -(-a // b)


def _virtual_planes(offsets, sym, grid):
    """K1/K3's terms in summation order: (stored plane, flat shift of the
    coefficient read, offset of the x read)."""
    gz, gy, gx = grid
    if not sym:
        return [(v, 0, off) for v, off in enumerate(offsets)]
    out = [(0, 0, (0, 0, 0))]
    for j, (dz, dy, dx) in enumerate(offsets):
        out.append((j + 1, 0, (dz, dy, dx)))
        out.append((j + 1, -((dz * gy + dy) * gx + dx), (-dz, -dy, -dx)))
    return out


def k13_tile_model(planes, x, offsets, grid, sym, plan):
    """K1 (sym) or K3 block by block, as csrc/stencil_apply.cu runs them.

    A block owns one tile of ``plan`` (whole rows of one z slice, or one row
    segment): a contiguous run [i0, i0 + P), its points dealt to 256
    threads, 4 each (thread t takes t + 256 k).  Its x tile (the tile and a halo of the radius r, in 2r + 1
    slices) starts as NaN and takes x inside the grid and 0 outside, as the
    kernel's 4-byte copies do.  Each virtual plane's coefficient is read at
    the point's index plus the plane's offset (the backward term's flat
    shift included; clamped at the planes' first element where an offset's
    flat shift can exceed a plane);
    a read outside the planes fails the model.  Sums in float64, in
    virtual-plane order; y starts as NaN."""
    gz, gy, gx = grid
    n = gz * gy * gx
    flat = planes.reshape(-1).numpy()
    xv = x.numpy()
    r = max((abs(c) for off in offsets for c in off), default=0)
    rows_max, cols_max = plan.rows, plan.cols
    n_xt, n_yt = _cdiv(gx, cols_max), _cdiv(gy, rows_max)
    assert plan.blocks == n_xt * n_yt * gz
    assert rows_max == 1 or cols_max >= gx, "a tile is not one run"
    assert rows_max * cols_max <= tk.K13_MAX_TILE
    clamp = sym and r * (gy * gx + gx + 1) > gz * gy * gx
    sy = cols_max + 2 * r
    sz = (rows_max + 2 * r) * sy
    y = np.full(n, np.nan)
    for blk in range(plan.blocks):
        xt, yt, z = blk % n_xt, (blk // n_xt) % n_yt, blk // (n_xt * n_yt)
        x0, y0 = xt * cols_max, yt * rows_max
        cols, rows = min(cols_max, gx - x0), min(rows_max, gy - y0)
        P = rows * cols
        i0 = (z * gy + y0) * gx + x0
        xs = np.full((2 * r + 1) * sz, np.nan)
        kz, ky, kx = np.meshgrid(np.arange(2 * r + 1), np.arange(rows_max + 2 * r),
                                 np.arange(sy), indexing="ij")
        zz, yy, xx = z - r + kz, y0 - r + ky, x0 - r + kx
        ok = (zz >= 0) & (zz < gz) & (yy >= 0) & (yy < gy) & (xx >= 0) & (xx < gx)
        xs[kz * sz + ky * sy + kx] = np.where(
            ok, xv[np.where(ok, (zz * gy + yy) * gx + xx, 0)], 0.0)
        t, k = np.meshgrid(np.arange(256), np.arange(4), indexing="ij")
        p = (t + k * 256).reshape(-1)
        p = p[p < P]
        assert np.array_equal(np.sort(p), np.arange(P)), "a point no thread takes"
        xb = r * sz + (p // cols + r) * sy + p % cols + r
        acc = np.zeros(p.size)
        for pl, shift, (dz, dy, dx) in _virtual_planes(offsets, sym, grid):
            e = pl * n + shift + i0 + p
            if clamp:
                e = np.maximum(e, 0)
            assert e.min() >= 0 and e.max() < flat.size, "a read outside the planes"
            acc += flat[e] * xs[xb + dz * sz + dy * sy + dx]
        y[i0 + p] = acc
    return torch.from_numpy(y)


K13_MODEL_CASES = {
    # name: (grid, radius, sym, sparse, plan override: None or (rows, cols))
    "K3-r1-19x23x37": ((19, 23, 37), 1, False, False, None),
    "K3-r2-sparse-7x9x11": ((7, 9, 11), 2, False, True, None),
    "K3-r3-5x6x13": ((5, 6, 13), 3, False, False, None),
    "K3-r2-row-segments": ((4, 5, 29), 2, False, False, (1, 10)),
    "K1-r1-19x23x37": ((19, 23, 37), 1, True, False, None),
    "K1-r2-sparse-9x7x11": ((9, 7, 11), 2, True, True, None),
    "K1-r3-5x6x13": ((5, 6, 13), 3, True, False, None),
    "K1-r1-row-segments": ((3, 4, 23), 1, True, False, (1, 7)),
    "K1-r1-one-slice": ((1, 5, 6), 1, True, False, None),
}


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
        plan = plan._replace(rows=rows, cols=cols, blocks=_cdiv(grid[2], cols)
                             * _cdiv(grid[1], rows) * grid[0])
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
        n_yt = _cdiv(gy, p.rows)
        last = gy - (n_yt - 1) * p.rows
        assert 1 <= last and p.rows - last < n_yt
        assert p.blocks == n_yt * gz
        assert p.blocks >= 2 * tk.H100_SMS or gx < 65
        assert 3 * p.smem <= 228 * 1024
        assert p.smem == tk.tile_smem_bytes(n_v, r, p.rows, p.cols)
    p = tk.stencil_tile_plan((3, 4, 1500), 3, 343)
    assert p.rows == 1 and p.cols == 750 and p.smem <= tk.H100_SMEM_PER_BLOCK


# ------------------------------------------------------------ the fused tail

def _lane_sums(terms, G):
    """(G, ...) sums of terms (n, ...) over a group of G lanes: lane l adds
    terms l, l + G, ... in that order, as a kernel's strided loop does."""
    lanes = []
    for lane in range(G):
        acc = torch.zeros_like(terms[0])
        for t in terms[lane::G]:
            acc = acc + t
        lanes.append(acc)
    return torch.stack(lanes)


def _butterfly(lanes):
    """Lane 0's value after the __shfl_xor_sync butterfly over dim 0."""
    v, m = lanes, lanes.shape[0] // 2
    while m:
        v = v + v[torch.arange(v.shape[0]) ^ m]
        m //= 2
    return v[0]


def _split_sum(terms, G):
    return _butterfly(_lane_sums(terms, G))


def tail_model(ft, plan, full, b1=None, x=None, res=None):
    """csrc/fused_tail.cu phase by phase, block by block, in ft's dtype."""
    dt = ft.invd.dtype
    gz, gy, gx = ft.grid
    c, n_sites, n1, n2 = ft.n_comp, int(np.prod(ft.grid)), ft.n1, ft.n2
    d, nss, warp = ft.degree, ft.nss, 32
    C = ft.coeffs.to(dt).reshape(len(ft.offsets), n_sites, c, c)
    coef, invd = ft.cheb_coef.to(dt), ft.invd
    alphas, betas = coef[:d], coef[d:]
    rnd_on = ft.W2 is not None and ft.W2.dtype == torch.bfloat16

    def rnd(v):
        return v.to(torch.bfloat16).to(dt) if rnd_on else v

    owned = torch.zeros(n_sites, dtype=torch.int64)
    blocks = []
    for b in range(plan.blocks):
        s0 = b * plan.sites
        ns = min(plan.sites, n_sites - s0)
        assert ns >= 1, "a block without sites"
        owned[s0:s0 + ns] += 1
        blocks.append((s0, ns))
    assert (owned == 1).all(), "a site not owned exactly once"

    def nan(n):
        return torch.full((n,), float("nan"), dtype=dt)

    D, X, R = [nan(n1), nan(n1)], [nan(n1), nan(n1)], nan(n1)
    part = torch.full((plan.blocks, n2), float("nan"), dtype=dt)
    sm = [dict(B=None, R=None, P=None) for _ in blocks]

    def own(b):
        s0, ns = blocks[b]
        return slice(s0 * c, (s0 + ns) * c)

    def apply(b, v):
        """(A v) at block b's sites: the plan's lanes only gather the
        neighbour values; one lane per output sums them in offset order."""
        s0, ns = blocks[b]
        s = torch.arange(s0, s0 + ns)
        az, ay, ax = s // (gy * gx), (s // gx) % gy, s % gx
        vg = v.reshape(n_sites, c)
        terms = []
        for o, (dz, dy, dx) in enumerate(ft.offsets):
            bz, by, bx = az + dz, ay + dy, ax + dx
            ok = ((bz >= 0) & (bz < gz) & (by >= 0) & (by < gy)
                  & (bx >= 0) & (bx < gx))
            nb = torch.where(ok, (bz * gy + by) * gx + bx, 0)
            t = torch.einsum("sef,sf->se", C[o, s0:s0 + ns], vg[nb])
            terms.append(torch.where(ok[:, None], t, torch.zeros_like(t)))
        return _split_sum(torch.stack(terms), 1).reshape(-1)

    def cheb_first(b, r, x_sub, x_out):
        o = own(b)
        z = invd[o] * r
        sm[b]["P"] = z
        dd = alphas[0] * z
        if d == 1:
            x_out[o] = dd if x_sub is None else x_sub[o] - dd
        else:
            D[0][o] = dd

    def cheb_step(i, src_key, x_sub, x_out):
        d_in, d_out = D[(i - 1) % 2].clone(), D[i % 2]
        for b in range(len(blocks)):
            o = own(b)
            z = invd[o] * (sm[b][src_key] - apply(b, d_in))
            pn = z + betas[i] * sm[b]["P"]
            sm[b]["P"] = pn
            dn = d_in[o] + alphas[i] * pn
            if i == d - 1:
                x_out[o] = dn if x_sub is None else x_sub[o] - dn
            else:
                d_out[o] = dn

    def residual(v, round_it, x_out):
        v = v.clone()
        for b in range(len(blocks)):
            r = apply(b, v) - sm[b]["B"]
            if round_it:
                r = rnd(r)
            sm[b]["R"] = r
            R[own(b)] = r
            if x_out is not None:
                cheb_first(b, r, v, x_out)

    def smooth(x_in, x_out):
        residual(x_in, False, x_out)
        for i in range(1, d):
            cheb_step(i, "R", x_in, x_out)

    # phase 0: b1 at own sites, the first pointwise step
    if full:
        (wz, wy, wx), (nz, ny, nx) = ft.fine_window, ft.fine_grid
        W = ft.W.to(dt)
        rg = res.reshape(nz, ny, nx)
    for b, (s0, ns) in enumerate(blocks):
        if not full:
            sm[b]["B"] = b1[own(b)].clone()
        else:
            a = torch.arange(s0, s0 + ns)
            az, ay, ax = a // (gy * gx), (a // gx) % gy, a % gx
            terms = []                  # the window's entries t = (tz, ty, tx)
            for tz, ty, tx in itertools.product(range(wz), range(wy), range(wx)):
                xv = rg[az * (wz - 1) + tz, ay * (wy - 1) + ty, ax * (wx - 1) + tx]
                terms.append(W[:, tz, ty, tx, az, ay, ax].T * xv[:, None])
            sm[b]["B"] = _split_sum(torch.stack(terms), plan.fine_group).reshape(-1)
        cheb_first(b, sm[b]["B"], None, X[0])
    xc, xn = X
    for i in range(1, d):
        cheb_step(i, "B", None, xc)
    for _ in range(nss - 1):
        smooth(xc, xn)
        xc, xn = xn, xc

    # coarse correction
    residual(xc, True, None)
    b2, x2 = nan(n2), nan(n2)
    if ft.Rd is not None:
        Rd = ft.Rd.to(dt)
        for b in range(len(blocks)):
            terms = Rd[:, own(b)].T * sm[b]["R"][:, None]       # (cols, n2)
            part[b] = _split_sum(terms, plan.row_parts)
        b2 = _split_sum(part, warp)
    else:
        tr = ft.coarse_transfer(dt)
        w = ft.win
        (wz2, wy2, wx2), (sz2, sy2, sx2), (tz0, ty0, tx0) = (
            w["window_shape"], w["stride"], w["t0"])
        W2 = ft.W2.to(dt).reshape(n2, -1)
        Rg = R.reshape(gz, gy, gx, c)
        k = torch.arange(n2)
        S = k // w["n_out"]
        oz, oy, ox = w["out_grid"]
        sz, sy, sx = S // (oy * ox), (S // ox) % oy, S % ox
        terms = []
        for q in range(W2.shape[1]):
            f, t = q % c, q // c
            tx, ty, tz = t % wx2, (t // wx2) % wy2, t // (wx2 * wy2)
            bz, by, bx = sz * sz2 + tz0 + tz, sy * sy2 + ty0 + ty, sx * sx2 + tx0 + tx
            ok = ((bz >= 0) & (bz < gz) & (by >= 0) & (by < gy)
                  & (bx >= 0) & (bx < gx))
            v = Rg[bz.clamp(0, gz - 1), by.clamp(0, gy - 1), bx.clamp(0, gx - 1), f]
            terms.append(torch.where(ok, W2[:, q] * v, torch.zeros_like(v)))
        b2 = rnd(_split_sum(torch.stack(terms), warp))
        assert tr.n_out == w["n_out"]
    x2 = rnd(_split_sum((ft.inv2.to(dt) * b2[None, :]).T, warp))
    for b, (s0, ns) in enumerate(blocks):
        o = own(b)
        if ft.Rd is not None:
            xc[o] = xc[o] - _split_sum(Rd[:, o] * x2[:, None], plan.col_parts)
            continue
        # windowed: each (site, f) sums each x window over its z and y
        # windows, rounds, then adds the x windows
        x2g = x2.reshape(-1, w["n_out"])
        W2g = ft.W2.to(dt).reshape((-1, w["n_out"]) + w["window_shape"] + (c,))
        for j in range(s0 * c, (s0 + ns) * c):
            f, bs = j % c, j // c
            bz, by, bx = bs // (gy * gx), (bs // gx) % gy, bs % gx
            acc = 0.0
            for sxx in range(ox):
                tx = bx - sxx * sx2 - tx0
                if not 0 <= tx < wx2:
                    continue
                zy = torch.zeros((), dtype=dt)
                for szz, syy in itertools.product(range(oz), range(oy)):
                    tz, ty = bz - szz * sz2 - tz0, by - syy * sy2 - ty0
                    if 0 <= tz < wz2 and 0 <= ty < wy2:
                        Sx = (szz * oy + syy) * ox + sxx
                        for e2 in range(w["n_out"]):
                            zy = zy + W2g[Sx, e2, tz, ty, tx, f] * x2g[Sx, e2]
                acc = acc + rnd(zy)
            xc[j] = xc[j] - acc
    for k in range(nss):
        target = nan(n1)
        smooth(xc, target)
        xc = target
    if not full:
        return xc
    return x - ft.fine_transfer(dt).prolong(xc)


_TAIL_CASES = {
    # level-1 grid, fine windows, SMs of the plan: a warp per site and per
    # (e, a) (3 sites per block; 1 over 9^3 fine windows, as on the Q2
    # cube), and 8 lanes per site with the last block ragged
    "3x4x5-5^3": ((3, 4, 5), (5, 5, 5), 20),
    "5x7x9-3^3": ((5, 7, 9), (3, 3, 3), 8),
    "2x3x2-9^3": ((2, 3, 2), (9, 9, 9), tk.H100_SMS),
}


@pytest.mark.parametrize("case", list(_TAIL_CASES))
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "windowed"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("degree,nss", [(1, 1), (2, 1), (3, 1), (2, 2)],
                         ids=["d1", "d2", "d3", "d2-nss2"])
def test_tail_model_matches_plain(case, dense, bf16, degree, nss):
    grid, fw, n_sm = _TAIL_CASES[case]
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
        assert _rel(got, ref) <= TAIL_TOL


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
            assert 1 <= p.blocks <= tk.H100_SMS
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
    assert p.blocks <= tk.H100_SMS
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
