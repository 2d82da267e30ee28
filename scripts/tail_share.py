"""The coarse correction's share of the fused tail's sub-cycle output, in
the main path's hierarchies and in the random tails the kernel's tests and
scripts use.

    python3 scripts/tail_share.py [--n-ref 4 5 6] [--device cpu] [--random]

The share is ||subcycle(b1) - subcycle(b1) with inv2 = 0|| / ||subcycle(b1)||
(``correction_share`` in tests/_torch_tails.py, the plain version), over b1
standard normal from seeds 7-9, as chip_smoke.py's checks draw it.  It says
how much a bf16 rounding of the windowed level-1 -> 2 correction, which
flips under another summation order, moves the output: the check of the
kernel against its plain version is as sensitive to such rounding in a
random tail as in a hierarchy only where the shares are alike.

--n-ref: hyper_cube refinements of chip_smoke.py's main configuration (4:
17^3, 5: 33^3, 6: 65^3, 7: 129^3 -- run that one on the card: its setup
takes minutes and GiBs on a host CPU).  --random: the random tails at the
main paths' shapes (scripts/tail_phases.py) and the card tests' ragged and
unstaged ones.  A plain computation: the device gives the hierarchy's setup
and the sums' speed, not the values' meaning.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "tests"))

SEEDS = (7, 8, 9)


def shares(ft, dev):
    from _torch_tails import correction_share
    out = []
    for seed in SEEDS:
        rng = np.random.default_rng(seed)
        b1 = torch.from_numpy(rng.standard_normal(ft.n1)).to(dev, ft.invd.dtype)
        out.append(correction_share(ft, b1))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-ref", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--random", action="store_true")
    args = ap.parse_args()
    import chip_smoke as cs
    import mfmg_torch.config as cfg
    from mfmg_torch import Hierarchy, LaplaceProblem
    from mfmg_torch.ops import fused_cycle as fc

    dev = torch.device(args.device)
    for n_ref in args.n_ref:
        t0 = time.time()
        prob = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear")
        h = Hierarchy(prob, cs.main_config(cfg), device=dev)
        # on the card the hierarchy carries its tail; elsewhere build it as
        # the card's does (bf16 weights, one smoothing step)
        ft = h.levels[0].fused or fc.build_fused_tail(list(h.levels), 1,
                                                      reduced_storage=True)
        n = 2 ** n_ref + 1
        form = "dense" if ft.Rd is not None else "windowed"
        print(f"{n}^3 hierarchy ({form} L1->L2, level-1 grid {ft.grid}, c {ft.n_comp}, "
              f"n2 {ft.n2}; setup {time.time() - t0:.1f} s): share "
              f"{' '.join(f'{s:.3e}' for s in shares(ft, dev))}", flush=True)
        del h, ft
    if args.random:
        import tail_phases as tp
        from _torch_tails import UNSTAGED_TAILS, random_tail
        tails = {label: kw for label, (kw, _) in tp.SHAPES.items()}
        tails["ragged 13x17x11 windowed (card tests)"] = dict(
            grid=(13, 17, 11), dense=False, window=(4, 4, 4), stride=(2, 2, 2))
        tails.update({f"{k} (card tests)": kw for k, (kw, _) in UNSTAGED_TAILS.items()})
        for label, kw in tails.items():
            ft = random_tail(**kw, device=dev)
            print(f"random tail {label}: share "
                  f"{' '.join(f'{s:.3e}' for s in shares(ft, dev))}", flush=True)


if __name__ == "__main__":
    main()
