"""How far the 129^3 main path's fused tail lands from its plain version, and
why: the windowed level-1 -> 2 form with bf16 weights rounds r1, b2, x2 and
the prolonged z/y sums to bf16, so a value whose float32 sum falls on the
other side of a rounding boundary under another summation order moves the
output by far more than float32 roundoff.

    python3 scripts/tail_rounding.py --parent-csrc DIR

Builds the 129^3 main-path hierarchy on the card (chip_smoke.py's
configuration; about 75 s of host setup) and, for the sub-cycle tail on
the inputs of seeds 7-11 (chip_smoke.py holds them to the float64 plain
version with the same rounding points, tests/_torch_tails.py
rounding_limit), prints
the plain version's own float32-against-float64 gap (its sensitivity to
such flips), this tree's kernel and the parent's kernel (built from DIR,
as scripts/tail_phases.py --parent-csrc does) against the plain version,
the kernel with one lane per site in its applies against the plan's, and
whether the kernel and the parent agree bit for bit.  Prints the card's
name and power limit first; needs one GPU.
"""

import argparse
import copy
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def rel(a, b):
    return float(torch.linalg.norm(a.double() - b.double())
                 / torch.linalg.norm(b.double()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    import mfmg_torch.config as cfg
    import tail_phases as tp
    from mfmg_torch import Hierarchy, LaplaceProblem
    from mfmg_torch.ops import cuda_library as cl
    from mfmg_torch.ops import fused_cycle as fc

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    cl.library()
    parent = tp.load_parent(args.parent_csrc.resolve())
    t0 = time.time()
    prob = LaplaceProblem.hyper_cube(3, 7, material_property="linear")
    h = Hierarchy(prob, cs.main_config(cfg), device="cuda")
    print(f"setup {time.time() - t0:.1f} s", flush=True)
    ft = h.levels[0].fused
    ft64 = copy.deepcopy(ft)
    for name in ("invd", "cheb_coef", "inv2"):
        setattr(ft64, name, getattr(ft, name).double())
    plan = fc.tail_plan

    def one_lane(*a, **k):
        return plan(*a, **k)._replace(group=1)

    for seed in (7, 8, 9, 10, 11):
        rng = np.random.default_rng(seed)
        b1 = torch.from_numpy(rng.standard_normal(ft.n1).astype(np.float32)).to(dev)
        inp = dict(b1=b1)
        ref = fc.fused_subcycle_apply_plain(ft, b1)
        ref64 = fc.fused_subcycle_apply_plain(ft64, b1.double())
        new = tp.runner(ft, False, inp)()
        par = tp.parent_runner(parent, ft, False, inp)()
        fc.tail_plan = one_lane
        try:
            g1 = tp.runner(ft, False, inp)()
        finally:
            fc.tail_plan = plan
        torch.cuda.synchronize()
        print(f"seed {seed}: plain32 vs plain64 {rel(ref, ref64):.3e}; new vs plain "
              f"{rel(new, ref):.3e} (vs plain64 {rel(new, ref64):.3e}); parent vs "
              f"plain {rel(par, ref):.3e} (vs plain64 {rel(par, ref64):.3e}); new with "
              f"G=1 vs plain {rel(g1, ref):.3e}; new vs parent {rel(new, par):.3e}; "
              f"new vs G=1 bitwise {torch.equal(new, g1)}", flush=True)


if __name__ == "__main__":
    main()
