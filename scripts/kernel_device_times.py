"""Device times of the port's kernels against their library yardsticks on
an NVIDIA GPU, at the main paths' shapes.

    python3 scripts/kernel_device_times.py

CUDA-event times of back-to-back calls (chip_smoke.py's "ms") include the
wrappers' host work, which on the H100 machine exceeds a small kernel's
device time; this script reads the device rows of torch.profiler instead
and prints both, each A/B in turns (A, B, B, A):
* K1 (the symmetric apply, float32 planes of the outer CG) on the Q1 65^3
  and 129^3 operators (PERF.md rows 1 and 4) against one cuSPARSE CSR SpMV
  of the assembled float32 matrix (zeros dropped);
* K3 (the one-sided apply) on the distorted Q2 cube's 125 planes and on the
  129^3 operator as 27 one-sided planes (rows 8 and 9), f32 and bf16 planes,
  against cuSPARSE on the same float32 matrix;
* K4, R x on random 5^3-window weights over 32^3 agglomerates (row 6), f32
  W, against cuSPARSE R;
* K2, one degree-2 Chebyshev step on random Q1 planes (bf16, the V-cycle's
  storage) at 65^3 and 129^3, with and without the residual: the blocked
  form against the chain (the data of the rule ``k2_form``);
* K5, y = R^T xc on random 5^3-window weights over 32^3 agglomerates (the
  129^3 level-0 transfer) and 9^3 windows over 8^3 (the Q2 cube's), f32
  and bf16 W, against one cuSPARSE CSR SpMV of R^T (f32);
* the fused coarse tail (rows 3 and 5) at the 65^3 full, 129^3 sub-cycle
  and Q2-cube full shapes (random operands, scripts/tail_phases.py), which
  has no library counterpart.
The operators are the problems' own (LaplaceProblem.hyper_cube); weights
and vectors are random from fixed seeds on the card.  The library calls are
yardsticks, never used by the port.  Prints the card's name and power limit
first; needs one GPU.
"""

import os
import sys

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


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from mfmg_torch.ops import stencil_kernels as tk
    from mfmg_torch.ops import transfer_kernels as ttk
    from mfmg_torch.ops.structured_transfer import StructuredTransfer

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    tk._library()
    from mfmg_torch import LaplaceProblem
    from mfmg_torch.ops import stencil as st

    def operator(prob, dt):
        return st.stencil_from_cell_matrices(prob.mesh, prob.A_loc, prob.constrained,
                                             prob.diag_raw, dtype=dt)

    # K1 and K3 on the problems' own operators, against cuSPARSE
    for n_ref in (6, 7):
        prob = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear")
        host = operator(prob, torch.float32)
        A = cs.csr_from_stencil(host, dev)
        x = torch.rand(prob.n_dofs, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2))
        sym = st.stencil_to_device(st.StencilOperator(
            host.coeffs, host.offsets, host.grid_shape, host.sym_pos), dev)
        n = 2 ** n_ref + 1
        t = in_turns({"K1": lambda: tk.stencil_apply_sym(sym.planes, x, sym.pos_offsets,
                                                         sym.grid_shape),
                      "cuSPARSE": lambda: torch.mv(A, x)})
        print(f"K1 {n}^3 f32 (nnz {A.values().numel()}): (device ms, event ms) {t}",
              flush=True)
        if n_ref == 7:
            for dt in (torch.float32, torch.bfloat16):
                one = st.stencil_to_device(st.StencilOperator(
                    host.coeffs.to(dt), host.offsets, host.grid_shape, None), dev)
                t = in_turns({"K3": lambda: tk.stencil_apply(one.coeffs, x, one.offsets,
                                                             one.grid_shape),
                              "cuSPARSE": lambda: torch.mv(A, x)})
                print(f"K3 129^3 as 27 one-sided planes {dt}: (device ms, event ms) {t}",
                      flush=True)
                del one
        del prob, host, A, sym
    probd = LaplaceProblem.hyper_cube(3, 5, degree=2, material_property="linear",
                                      distort_random=True, seed=0)
    A = cs.csr_from_stencil(operator(probd, torch.float32), dev)
    x = torch.rand(probd.n_dofs, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(3))
    for dt in (torch.float32, torch.bfloat16):
        op = st.stencil_to_device(operator(probd, dt), dev)
        t = in_turns({"K3": lambda: tk.stencil_apply(op.coeffs, x, op.offsets,
                                                     op.grid_shape),
                      "cuSPARSE": lambda: torch.mv(A, x)})
        print(f"K3 distorted Q2 ({len(op.offsets)} planes) {dt} (nnz "
              f"{A.values().numel()}): (device ms, event ms) {t}", flush=True)
    del probd, A, op

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
            t = in_turns({f: (lambda f=f: tk._cheb_smooth(f, *args))
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
        if name == "129^3":
            xf = torch.randn(int(np.prod(grid)), device=dev, generator=g)
            t = in_turns({
                "K4": lambda: ttk.structured_restrict(W, xf, ws, agg, grid),
                "cuSPARSE R": lambda: torch.mv(R, xf)})
            print(f"K4 {name} W {W.dtype}: (device ms, event ms) {t}", flush=True)
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
