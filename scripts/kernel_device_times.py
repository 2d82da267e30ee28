"""Device time of K2's two forms and of K5 against its library yardstick on
an NVIDIA GPU, at the main path's shapes.

    python3 scripts/kernel_device_times.py

CUDA-event times of back-to-back calls (chip_smoke.py's "ms") include the
wrappers' host work, which on the H100 machine exceeds a small kernel's
device time; this script reads the device rows of torch.profiler instead
and prints both, each A/B in turns (A, B, B, A), on random inputs made from
fixed seeds on the card:
* K2, one degree-2 Chebyshev step on random Q1 planes (bf16, the V-cycle's
  storage) at 65^3 and 129^3, with and without the residual: the blocked
  form against the chain (the data of the rule ``k2_form``);
* K5, y = R^T xc on random 5^3-window weights over 32^3 agglomerates (the
  129^3 level-0 transfer) and 9^3 windows over 8^3 (the Q2 cube's), f32
  and bf16 W, against one cuSPARSE CSR SpMV of R^T (f32; never used by the
  port).
Prints the card's name and power limit first; needs one GPU.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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
        _, RT = cs.csr_from_transfer(StructuredTransfer(W, ws, agg, grid), dev)
        for Wt in (W, W.to(torch.bfloat16)):
            t = in_turns({
                "K5": lambda Wt=Wt: ttk.structured_prolong(Wt, xc, ws, agg, grid),
                "cuSPARSE R^T": lambda: torch.mv(RT, xc)})
            print(f"K5 {name} W {Wt.dtype}: (device ms, event ms) {t}", flush=True)


if __name__ == "__main__":
    main()
