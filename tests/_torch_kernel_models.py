"""Models of the decompositions of K2's blocked form, of K4, of K5, of K1/K3's
tiles and of the fused coarse tail, on the CPU, with their case tables.

The CUDA kernels (mfmg_torch/csrc/cheb_smooth.cu, structured_transfer.cu,
stencil_apply.cu, fused_tail.cu) run only on the card; these plain models
follow their index arithmetic block by block, so that the tiling and
ownership logic is checked where there is no GPU.  The tests that hold
them against the plain versions are spread over several files, so that a
run that gives each file to one worker spreads them too:
tests/test_torch_k2_plans.py, test_torch_k2_model_res.py,
test_torch_k2_model_nores.py (K2), test_torch_transfer_models.py (K4, K5),
test_torch_k13_tiles.py (K1/K3) and test_torch_tail_models.py (the tail).


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
import torch

from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops import stencil_kernels as tk
from mfmg_torch.ops import transfer_kernels as ttk

K2_TOL, K4_TOL, K5_TOL, TAIL_TOL = 1e-12, 1e-12, 1e-6, 1e-5


def rel(a, b):
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
    "129^3-5^3-32^3": ((5, 5, 5), (32, 32, 32), 2, True, cl.H100_SMS, 4),
    "129^3-5^3-32^3-bf16": ((5, 5, 5), (32, 32, 32), 2, True, cl.H100_SMS, 2),
    "Q2-9^3-8^3": ((9, 9, 9), (8, 8, 8), 2, True, cl.H100_SMS, 4),
    "ragged-gx-5": ((5, 5, 5), (3, 4, 5), 2, False, cl.H100_SMS, 4),
    "uneven-gy": ((3, 3, 3), (3, 7, 8), 2, True, 1, 4),
    "march-ragged": ((5, 5, 5), (7, 4, 8), 2, True, 2, 4),
    "three-chunks": ((3, 3, 3), (2, 3, 12), 2, True, 1, 4),
    "c1": ((5, 5, 5), (2, 3, 8), 1, True, 8, 4),
    "c3": ((3, 4, 5), (2, 5, 4), 3, True, 8, 4),
    "c4": ((9, 9, 9), (2, 2, 4), 4, True, cl.H100_SMS, 4),
    "c5-scalar": ((3, 3, 3), (4, 3, 6), 5, False, 8, 4),
    "c4-scalar-ragged": ((5, 3, 4), (3, 5, 7), 4, False, 8, 4),
}


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


def random_sym_case(grid_shape, seed):
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


def check_k2_blocked_model(grid, degree, want_res):
    """K2's blocked model against cheb_smooth_plain on random Q1 planes: the
    plan's halo and frame within the kernel's, more than one tile on every
    axis, no NaN reaching the output."""
    planes, x, b, invd, pos = random_sym_case(grid, degree)
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
        assert rel(g, r) <= K2_TOL


# ------------------------------------------------------------------ K1/K3

def cdiv(a, b):
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
    n_xt, n_yt = cdiv(gx, cols_max), cdiv(gy, rows_max)
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


TAIL_CASES = {
    # level-1 grid, fine windows, SMs of the plan: a warp per site and per
    # (e, a) (3 sites per block; 1 over 9^3 fine windows, as on the Q2
    # cube), and 8 lanes per site with the last block ragged
    "3x4x5-5^3": ((3, 4, 5), (5, 5, 5), 20),
    "5x7x9-3^3": ((5, 7, 9), (3, 3, 3), 8),
    "2x3x2-9^3": ((2, 3, 2), (9, 9, 9), cl.H100_SMS),
}
