"""Device times of the port's kernels against their library yardsticks on
an NVIDIA GPU, at the main paths' shapes.

    python3 scripts/kernel_device_times.py [--parent-csrc DIR] [--k4-only]
        [--k13-parent-csrc DIR] [--k13-only] [--tile-points N]

CUDA-event times of back-to-back calls (chip_smoke.py's "ms") include the
wrappers' host work, which on the H100 machine exceeds a small kernel's
device time; this script reads the device rows of torch.profiler instead
and prints both, each A/B in turns (A, B, B, A):
* K1 (the symmetric apply) and K3 (the one-sided apply) at every shape of
  PERF.md rows 1, 4, 8 and 9 (below), against one cuSPARSE CSR SpMV of the
  assembled float32 matrix (zeros dropped) where there is one;
* K4 (row 6), R x on random weights at the 129^3 shape (5^3 windows over
  32^3 agglomerates) and the distorted Q2 cube's (9^3 over 8^3), f32 and
  bf16 W, against cuSPARSE R (f32), with the bytes of x its blocks stage;
  with --parent-csrc the parent's K4 beside it (its plan-less C entry
  point) and the plan without its marching over slabs at 129^3, and the
  V-cycle's device time on the 129^3 and distorted Q2 paths with this
  tree's K4 and the parent's, in turns (--k4-only: this section alone);
* K2, one degree-2 Chebyshev step on random Q1 planes (bf16, the V-cycle's
  storage) at 65^3 and 129^3, with and without the residual: the blocked
  form against the chain (the data of the rule ``k2_form``);
* K5, y = R^T xc on random 5^3-window weights over 32^3 agglomerates (the
  129^3 level-0 transfer) and 9^3 windows over 8^3 (the Q2 cube's), f32
  and bf16 W, against one cuSPARSE CSR SpMV of R^T (f32);
* the fused coarse tail (rows 3 and 5) at the 65^3 full, 129^3 sub-cycle
  and Q2-cube full shapes (random operands, scripts/tail_phases.py), which
  has no library counterpart.
--parent-csrc DIR (an older csrc/, e.g. ``git archive <commit>
mfmg_torch/csrc | tar -x -C .chip_scratch/parent``) builds that library and
times its K4 (whose C entry point takes no plan) as above.  With
--k13-parent-csrc DIR (a csrc/ from before K1/K3's tiled kernel, whose
thread-per-point K1 and K3 C entry points take no tile plan) it times those
beside the current ones, in turns, at every K1/K3 shape: K3 on the Q2
cube's 125 planes kept one-sided, the distorted Q2 cube and the 129^3
operator as 27 one-sided planes; K1 at 13 pairs (Q1
65^3 and 129^3), 62 (the Q2 cube, symmetrized) and 171 (the Q3 stencil on
49^3 nodes, symmetrized), f32 and bf16 planes, with each shape's byte bound.
--tile-points N also times K1/K3 with tiles of N points in place of the
plan's rule (stencil_tile_plan); --k13-only skips the rest.
The operators are the problems' own (LaplaceProblem.hyper_cube); weights
and vectors are random from fixed seeds on the card.  The library calls are
yardsticks, never used by the port.  Prints the card's name and power limit
first; needs one GPU.
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))


def device_ms(fn, n=50):
    """Device time per call (ms): the profiler's CUDA rows over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / 1e3 / n


def in_turns(fns):
    """{name: ([device ms], [event ms])} over the order A, B, B, A."""
    import chip_smoke as cs
    names = list(fns)
    out = {k: ([], []) for k in names}
    for k in names + names[::-1]:
        out[k][0].append(round(device_ms(fns[k]), 5))
        out[k][1].append(round(cs.median_ms(fns[k]), 5))
    return out


def load_parent_k13(csrc):
    """K1/K3 of an older library (tail_phases.load_parent builds it): their
    C entry points without the tile plan."""
    import ctypes
    import tail_phases as tp
    lib = tp.load_parent(Path(csrc).resolve())
    vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.mfmg_stencil_apply_sym.argtypes = [vp, i, vp, vp, vp, i, i, i, i, ip, vp]
    lib.mfmg_stencil_apply.argtypes = [vp, i, vp, vp, i, i, i, i, ip, vp]
    lib.mfmg_stencil_apply_sym.restype = lib.mfmg_stencil_apply.restype = i
    return lib


def parent_call(lib, sym, planes, x, offsets, grid):
    """One launch of the parent's K1 (sym) or K3 into a new y."""
    from mfmg_torch.ops import cuda_library as cl
    y = torch.empty_like(x)
    bf16 = int(planes.dtype == torch.bfloat16)
    head = (planes.data_ptr(), bf16, x.data_ptr())
    table = cl.offset_table(tuple(offsets))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if sym:
        err = lib.mfmg_stencil_apply_sym(*head, None, y.data_ptr(), *grid, len(offsets),
                                         table, stream)
    else:
        err = lib.mfmg_stencil_apply(*head, y.data_ptr(), *grid, len(offsets),
                                     table, stream)
    if err:
        raise RuntimeError(f"the parent's stencil kernel failed ({err})")
    return y


def k13_section(dev, parent, tile_points=None):
    """K1 and K3 at their shapes: the current kernels, the parent's, and
    cuSPARSE on the float32 matrix, in turns."""
    import chip_smoke as cs
    from _torch_stencils import symmetrize
    from mfmg_torch import LaplaceProblem
    from mfmg_torch.ops import stencil as st
    from mfmg_torch.ops import stencil_kernels as tk

    base = tk.K13_TILE_POINTS

    def fixed_tiles(fn, points):
        def run():
            tk.K13_TILE_POINTS = points
            tk.stencil_tile_plan.cache_clear()
            tk.k13_plan.cache_clear()
            try:
                return fn()
            finally:
                tk.K13_TILE_POINTS = base
                tk.stencil_tile_plan.cache_clear()
                tk.k13_plan.cache_clear()
        return run

    def case(label, sym, planes, offsets, grid, A=None):
        x = torch.rand(int(np.prod(grid)), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(4))
        kern = tk.stencil_apply_sym if sym else tk.stencil_apply
        plain = tk.stencil_apply_sym_plain if sym else tk.stencil_apply_plain
        fns = {"new": lambda: kern(planes, x, offsets, grid)}
        y = fns["new"]()
        ref = plain(planes, x, offsets, grid)
        err = float((y - ref).abs().max() / ref.abs().max())
        if tile_points:
            fns[f"tiles of {tile_points}"] = fixed_tiles(fns["new"], tile_points)
        if parent is not None and (not sym or len(offsets) <= 62):   # its cap
            fns["parent"] = lambda: parent_call(parent, sym, planes, x, offsets, grid)
            perr = float((fns["parent"]() - ref).abs().max() / ref.abs().max())
            err = f"{err:.3e} (parent {perr:.3e})"
        if A is not None:
            fns["cuSPARSE"] = lambda: torch.mv(A, x)
        work = (cs.k1_work if sym else cs.k3_work)(planes, x.numel())
        b_ms, b_by = cs.bound(*work)
        plan = tk.k13_plan(tuple(offsets), sym, tuple(grid))
        print(f"{'K1' if sym else 'K3'} {label} {planes.dtype} ({len(offsets)} "
              f"{'pairs' if sym else 'offsets'}): bound {b_ms:.5f} ms ({b_by}), "
              f"plan {tuple(plan)}, rel err vs plain {err}; (device ms, event ms) "
              f"{in_turns(fns)}", flush=True)

    def operator(prob, dt):
        return st.stencil_from_cell_matrices(prob.mesh, prob.A_loc, prob.constrained,
                                             prob.diag_raw, dtype=dt)

    # K3: the Q2 cube kept one-sided, the distorted Q2 cube, 129^3 as 27 planes
    for label, kw in (("Q2 cube", {}), ("distorted Q2", dict(distort_random=True,
                                                             seed=0))):
        prob = LaplaceProblem.hyper_cube(3, 5, degree=2, material_property="linear", **kw)
        host = operator(prob, torch.float32)
        A = cs.csr_from_stencil(host, dev)
        for dt in (torch.bfloat16, torch.float32):
            c = host.coeffs.to(dt).to(dev)
            case(label, False, c, host.offsets, host.grid_shape,
                 A if dt == torch.float32 else None)
            del c
        if label == "Q2 cube":
            # K1 on the same cube's 62 pairs (symmetrized: bit-symmetric on
            # any host)
            cs_ = symmetrize(host.coeffs.double().numpy(), host.offsets, host.grid_shape)
            pos = st.detect_symmetry(cs_, host.offsets, host.grid_shape)
            op = st.stencil_to_device(st.StencilOperator(
                torch.from_numpy(cs_).float(), host.offsets, host.grid_shape, pos), dev)
            for dt in (torch.bfloat16, torch.float32):
                case(label, True, op.planes.to(dt), op.pos_offsets, op.grid_shape,
                     A if dt == torch.float32 else None)
            del op, cs_
        del prob, host, A
    for n_ref in (6, 7):
        prob = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear")
        host = operator(prob, torch.float32)
        A = cs.csr_from_stencil(host, dev)
        sym = st.stencil_to_device(st.StencilOperator(
            host.coeffs, host.offsets, host.grid_shape, host.sym_pos), dev)
        label = f"Q1 {2 ** n_ref + 1}^3"
        for dt in (torch.float32, torch.bfloat16):
            case(label, True, sym.planes.to(dt), sym.pos_offsets, sym.grid_shape,
                 A if dt == torch.float32 else None)
            if n_ref == 7:
                c = host.coeffs.to(dt).to(dev)
                case(label + " as 27 one-sided planes", False, c, host.offsets,
                     host.grid_shape, A if dt == torch.float32 else None)
                del c
        del prob, host, A, sym
    # K1 at 171 pairs: the Q3 stencil on 49^3 nodes, symmetrized
    prob = LaplaceProblem.hyper_cube(3, 4, degree=3, material_property="linear")
    host = operator(prob, torch.float64)
    c3 = symmetrize(host.coeffs.numpy(), host.offsets, host.grid_shape)
    full = st.StencilOperator(torch.from_numpy(c3).float(), host.offsets, host.grid_shape)
    op = st.stencil_to_device(st.StencilOperator(
        torch.from_numpy(c3).float(), host.offsets, host.grid_shape,
        st.detect_symmetry(c3, host.offsets, host.grid_shape)), dev)
    A = cs.csr_from_stencil(full, dev)
    for dt in (torch.float32, torch.bfloat16):
        case("Q3 49^3 symmetrized", True, op.planes.to(dt), op.pos_offsets,
             op.grid_shape, A if dt == torch.float32 else None)


def load_parent_k4(csrc):
    """K4 of an older library (tail_phases.load_parent builds it): its C
    entry point without the plan."""
    import ctypes
    import tail_phases as tp
    lib = tp.load_parent(Path(csrc).resolve())
    vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.mfmg_structured_restrict.argtypes = [i, vp, vp, vp, ip, vp]
    lib.mfmg_structured_restrict.restype = i
    return lib


def parent_restrict(lib, W, x, ws, agg, grid):
    """One launch of the parent's K4 into a new coarse vector."""
    from mfmg_torch.ops import cuda_library as cl
    out = torch.empty(W.shape[0] * int(np.prod(agg)), device=x.device)
    geom = cl.ints((*grid, *agg, *ws, W.shape[0]))
    err = lib.mfmg_structured_restrict(int(W.dtype == torch.bfloat16), W.data_ptr(),
                                       x.data_ptr(), out.data_ptr(), geom,
                                       torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"the parent's K4 failed ({err})")
    return out


class ParentK4Transfer(torch.nn.Module):
    """A level-0 StructuredTransfer whose restriction runs the parent's K4
    (its prolongation this tree's K5): the V-cycle's A/B of K4."""

    def __init__(self, tr, lib):
        super().__init__()
        self.tr, self.lib = tr, lib

    def restrict(self, x):
        t = self.tr
        return parent_restrict(self.lib, t.W, x, t.window_shape, t.agg_shape, t.grid_shape)

    def prolong(self, xc):
        return self.tr.prolong(xc)


def x_box_bytes(plan, ws, agg):
    """Bytes of x K4's blocks copy: each block's planes once (a marching
    block shares the boundary plane of consecutive slabs); neighbouring
    blocks re-read their boundary planes, rows and columns."""
    (wz, wy, wx), (gz, gy, gx) = ws, agg
    planes = sum(min(plan.nzc, gz - z0) * (wz - 1) + 1 for z0 in range(0, gz, plan.nzc))
    n = 0
    for ay0 in range(0, gy, plan.nay):
        for ax0 in range(0, gx, plan.nax):
            n += (min(plan.nay, gy - ay0) * (wy - 1) + 1) * (min(plan.nax, gx - ax0)
                                                          * (wx - 1) + 1)
    return 4 * planes * n


def k4_section(dev, parent):
    """K4 at the 129^3 and distorted-Q2 shapes, f32 and bf16 W: this tree's
    kernel, the parent's (with --parent-csrc), the same blocks with one slab
    each where the plan marches (129^3), and cuSPARSE R (f32), in turns; then the
    V-cycle's device time on the 129^3 and distorted-Q2 paths with this
    tree's K4 and the parent's, in turns."""
    import chip_smoke as cs
    import mfmg_torch.config as cfg
    from mfmg_torch import Hierarchy, LaplaceProblem
    from mfmg_torch.ops import cuda_library as cl
    from mfmg_torch.ops import transfer_kernels as ttk
    from mfmg_torch.ops.structured_transfer import StructuredTransfer

    n_sm = cl.sm_count(dev)
    for name, w, agg in (("129^3", 5, (32, 32, 32)), ("distorted Q2", 9, (8, 8, 8))):
        ws = (w,) * 3
        grid = tuple(a * (w - 1) + 1 for a in agg)
        g = torch.Generator(device=dev).manual_seed(1)
        W32 = torch.randn((2,) + ws + agg, device=dev, generator=g)
        xf = torch.randn(int(np.prod(grid)), device=dev, generator=g)
        R, _ = cs.csr_from_transfer(StructuredTransfer(W32, ws, agg, grid), dev)
        for W in (W32, W32.to(torch.bfloat16)):
            vec = ttk.restrict_vec(W, 2, agg[2])
            plan = ttk.restrict_plan(ws, agg, 2, vec, W.element_size(), n_sm)
            fns = {"K4": lambda W=W: ttk.structured_restrict(W, xf, ws, agg, grid)}
            ref = ttk.structured_restrict_plain(W, xf, ws, agg, grid)
            errs = {"K4": cs_rel(fns["K4"](), ref)}
            if parent is not None:
                fns["parent K4"] = lambda W=W: parent_restrict(parent, W, xf, ws, agg, grid)
                errs["parent K4"] = cs_rel(fns["parent K4"](), ref)
            if plan.nzc > 1:
                # the same blocks without the marching: one slab each
                one = ttk.restrict_plan(ws, agg, 2, vec, W.element_size(), n_sm, nzc=1)
                fns["K4 one slab"] = lambda W=W, one=one: ttk._restrict_with_plan(
                    one, W, xf, ws, agg, grid)
                errs["K4 one slab"] = cs_rel(fns["K4 one slab"](), ref)
            if W.dtype == torch.float32:
                fns["cuSPARSE R"] = lambda: torch.mv(R, xf)
            work = cs.xfer_work(W, xf.numel(), ref.numel())
            b_ms, b_by = cs.bound(*work)
            print(f"K4 {name} W {W.dtype}: bound {b_ms:.5f} ms ({b_by}), plan "
                  f"{tuple(plan)}, x box bytes {x_box_bytes(plan, ws, agg)} (x "
                  f"{4 * xf.numel()}), rel err vs plain {errs}; (device ms, event ms) "
                  f"{in_turns(fns)}", flush=True)
    if parent is None:
        return
    paths = {"129^3": (dict(n_ref=7), 3), "distorted Q2": (
        dict(n_ref=5, degree=2, distort_random=True, seed=0), 2)}
    for label, (kw, levels) in paths.items():
        n_ref = kw.pop("n_ref")
        prob = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear", **kw)
        hier = Hierarchy(prob, cs.main_config(cfg, levels), device="cuda")
        tr = hier.levels[0].transfer
        bd = torch.from_numpy(np.random.default_rng(0).uniform(size=prob.n_dofs)
                              .astype(np.float32)).to(dev)
        ref = hier.vmult(bd)
        hier.levels[0].transfer = ParentK4Transfer(tr, parent)
        other = hier.vmult(bd)
        hier.levels[0].transfer = tr
        out = {"K4": [], "parent K4": []}
        for key in ("K4", "parent K4", "parent K4", "K4"):
            hier.levels[0].transfer = tr if key == "K4" else ParentK4Transfer(tr, parent)
            out[key].append(round(device_ms(lambda: hier.vmult(bd), 20), 5))
        hier.levels[0].transfer = tr
        print(f"V-cycle {label}: device ms per cycle (in turns) {out}; V-cycle rel "
              f"diff K4 vs parent K4 {cs_rel(ref, other):.3e}", flush=True)
        del hier, tr, bd


def cs_rel(a, b):
    return float(torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b.double()))


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", type=Path)
    ap.add_argument("--k13-parent-csrc", type=Path)
    ap.add_argument("--k13-only", action="store_true")
    ap.add_argument("--k4-only", action="store_true")
    ap.add_argument("--tile-points", type=int)
    args = ap.parse_args()
    import chip_smoke as cs
    from mfmg_torch.ops import cuda_library as cl
    from mfmg_torch.ops import stencil_kernels as tk
    from mfmg_torch.ops import transfer_kernels as ttk
    from mfmg_torch.ops.structured_transfer import StructuredTransfer

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    cl.library()
    if args.k4_only:
        k4_section(dev, load_parent_k4(args.parent_csrc) if args.parent_csrc else None)
        return
    parent = load_parent_k13(args.k13_parent_csrc) if args.k13_parent_csrc else None
    k13_section(dev, parent, args.tile_points)
    if args.k13_only:
        return
    k4_section(dev, load_parent_k4(args.parent_csrc) if args.parent_csrc else None)

    for grid in ((65, 65, 65), (129, 129, 129)):
        g = torch.Generator(device=dev).manual_seed(0)
        planes = -torch.rand((14,) + grid, device=dev, generator=g)
        planes[0] = 26.0 + torch.rand(grid, device=dev, generator=g)
        planes = planes.to(torch.bfloat16)
        invd = (1.0 / planes[0].float()).reshape(-1).contiguous()
        n = int(np.prod(grid))
        x, b = (torch.rand(n, device=dev, generator=g) for _ in range(2))
        coef = torch.tensor([0.9, 0.7, 0.0, 0.2], device=dev)
        for want_res in (True, False):
            args = (planes, x, b, invd, coef, tk.Q1_POS, grid, 2, want_res)
            t = in_turns({f: (lambda f=f: tk.cheb_smooth_as(f, *args))
                          for f in ("blocked", "chain")})
            print(f"K2 {grid[0]}^3 residual={want_res}: (device ms, event ms) {t}",
                  flush=True)
    for name, w, agg in (("129^3", 5, (32, 32, 32)), ("Q2", 9, (8, 8, 8))):
        ws = (w,) * 3
        grid = tuple(a * (w - 1) + 1 for a in agg)
        g = torch.Generator(device=dev).manual_seed(1)
        W = torch.randn((2,) + ws + agg, device=dev, generator=g)
        xc = torch.randn(2 * int(np.prod(agg)), device=dev, generator=g)
        R, RT = cs.csr_from_transfer(StructuredTransfer(W, ws, agg, grid), dev)
        for Wt in (W, W.to(torch.bfloat16)):
            t = in_turns({
                "K5": lambda Wt=Wt: ttk.structured_prolong(Wt, xc, ws, agg, grid),
                "cuSPARSE R^T": lambda: torch.mv(RT, xc)})
            print(f"K5 {name} W {Wt.dtype}: (device ms, event ms) {t}", flush=True)
    # the fused tail at its main shapes (random operands)
    import tail_phases as tp
    from _torch_tails import random_tail
    for label, (kw, full) in tp.SHAPES.items():
        ft = random_tail(**kw, device="cuda")
        run = tp.runner(ft, full, tp.tail_inputs(ft, full))
        print(f"fused tail {label}: (device ms, event ms) {in_turns({'tail': run})}",
              flush=True)

if __name__ == "__main__":
    main()
