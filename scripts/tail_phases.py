"""Phase times and device times of the fused coarse tail on an NVIDIA GPU.

    python3 scripts/tail_phases.py [--parent-csrc DIR] [--out FILE]

The tail (mfmg_torch/csrc/fused_tail.cu) is one cooperative launch whose
phases are separated by grid barriers.  Its stamped instance (launched here
only, through ``fused_cycle._launch(..., stamps=...)``) records
%globaltimer at every block's arrival at and release from each barrier; this
script reads those stamps over 20 launches and prints, per phase, the median
time from the last block's release of the previous barrier to the last
block's arrival (the phase on the critical path), block 0's own time, and
each barrier's time from the last arrival to the last release.  Beside them
it prints the unstamped kernel's device time per call (torch.profiler's
device rows) and CUDA-event time, and holds the kernel against its plain
version and against itself (two launches, the same bits).

The tails have random operands (``random_tail`` of tests/_torch_tails.py, fixed seeds) at
the shapes of the main paths, whose kernel time does not depend on the
values: the 65^3 full tail (16^3 level-1 sites, c = 2, dense Rd 256 x 8192,
5^3 fine windows), the 129^3 sub-cycle (32^3 sites, windowed W2 6^3 at
stride 4, 2048 coarse rows) and the Q2 cube's full tail (8^3 sites, dense Rd
32 x 1024, 9^3 fine windows), all with bf16 weights, degree 2, one
smoothing step.  Then, in device time and in turns (A, B, B, A), the open
questions of the reference's two gates: at 65^3 the full tail with the
windowed level-1 -> 2 form against the dense one; at 129^3 the full tail
(the full-tail gate lifted here only) against the sub-cycle tail between
K4 and K5 as the V-cycle runs it (float32 fine W, as the hierarchy's
level-0 transfer).

--parent-csrc DIR builds a second kernel library from an older csrc/ whose
mfmg_fused_tail takes no plan (the parent commit's: ``git archive <commit>
mfmg_torch/csrc``), launches it with that signature, and times it in turns
with this tree's kernel at every shape: the A/B of the two designs in one
process.  It also builds a copy of that fused_tail.cu with the same stamps
added (``stamped_source``) and prints the older kernel's phases beside this
tree's.  Prints the card's name and power limit first; needs one GPU.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "tests"))

SHAPES = {
    "65^3 full": (dict(grid=(16,) * 3, dense=True, fine_window=(5,) * 3), True),
    "129^3 sub-cycle": (dict(grid=(32,) * 3, dense=False), False),
    "Q2 cube full": (dict(grid=(8,) * 3, dense=True, fine_window=(9,) * 3), True),
}
TAIL_TOL = 1e-5            # chip_smoke.py's bound on the kernel against plain
N_STAMPED = 20


def phase_names(full, degree, nss):
    """The phases of the kernel in order, one per grid sync and the last."""
    names = ["fine restriction, first step" if full else "b1, first step"]
    names += [f"pre-smooth step {i}" for i in range(1, degree)]
    for k in range(1, nss):
        names += [f"smooth {k}: residual, first step"]
        names += [f"smooth {k}: step {i}" for i in range(1, degree)]
    names += ["r1 = A x1 - b1 (dense: partial R2 r1)", "b2", "x2 = inv2 b2",
              "x1 -= R2^T x2"]
    for k in range(1, nss + 1):
        names += [f"post-smooth {k}: residual, first step"]
        names += [f"post-smooth {k}: step {i}" for i in range(1, degree)]
    return names + (["fine prolongation"] if full else [])


def tail_inputs(ft, full, seed=0, dev="cuda"):
    rng = np.random.default_rng(seed)
    if full:
        x = rng.uniform(size=ft.n_fine).astype(np.float32)
        res = rng.standard_normal(ft.n_fine).astype(np.float32)
        return dict(x=torch.from_numpy(x).to(dev), res=torch.from_numpy(res).to(dev))
    b1 = rng.standard_normal(ft.n1).astype(np.float32)
    return dict(b1=torch.from_numpy(b1).to(dev))


def plain_of(ft, full, inp):
    from mfmg_torch.ops import fused_cycle as fc
    if full:
        return fc.fused_correction_apply_plain(ft, inp["x"], inp["res"])
    return fc.fused_subcycle_apply_plain(ft, inp["b1"])


def runner(ft, full, inp):
    """run(stamps=None): one launch of this tree's kernel."""
    from mfmg_torch.ops import fused_cycle as fc
    like = inp["x"] if full else inp["b1"]

    def run(stamps=None):
        out = torch.empty_like(like)
        fc._launch(ft, full=full, out=out, stamps=stamps, **inp)
        return out
    return run


def parent_args(ft, full, out, scratch, b1=None, x=None, res=None):
    """The C arguments of the parent's mfmg_fused_tail, which takes no plan
    (its scratch: 7 n1 + 2 n2 floats)."""
    from mfmg_torch.ops import cuda_library as cl

    def ptr(t):
        return None if t is None else t.data_ptr()
    if ft.Rd is not None:
        l2 = [ft.n2] + [0] * 13
    else:
        w = ft.win
        l2 = [ft.n2, w["n_out"], *w["out_grid"], *w["window_shape"], *w["stride"],
              *w["t0"]]
    fine = [*ft.fine_grid, *ft.fine_window] if full else [0] * 6
    return [int(ft.coeffs.dtype == torch.bfloat16), int(full), int(ft.Rd is not None),
            ptr(ft.coeffs), ptr(ft.invd), ptr(ft.cheb_coef), ptr(ft.Rd), ptr(ft.W2),
            ptr(ft.inv2), ptr(ft.W) if full else None, ptr(b1), ptr(x), ptr(res),
            out.data_ptr(), scratch.data_ptr(),
            cl.ints([*ft.grid, ft.n_comp, len(ft.offsets), ft.degree, ft.nss]),
            cl.offset_table(ft.offsets), cl.ints(l2), cl.ints(fine),
            torch.cuda.current_stream(out.device).cuda_stream]


def parent_runner(lib, ft, full, inp):
    """run(stamps=None): one launch of the parent's kernel; with stamps
    (``lib`` the stamped build) its marks go there."""
    like = inp["x"] if full else inp["b1"]

    def run(stamps=None):
        out = torch.empty_like(like)
        scratch = torch.empty(7 * ft.n1 + 2 * ft.n2, dtype=torch.float32,
                              device=out.device)
        if stamps is not None:
            lib.mfmg_set_tail_stamps(stamps.data_ptr())
            torch.cuda.synchronize()
        err = lib.mfmg_fused_tail(*parent_args(ft, full, out, scratch, **inp))
        if err:
            raise RuntimeError(f"the parent's tail failed ({err})")
        return out
    return run


# The stamps of the parent's kernel, added to a copy of its source: every
# block marks its entry, its arrival at and release from each grid sync,
# and its exit, as this tree's stamped instance does (Marks in
# csrc/fused_tail.cu), through a device pointer that mfmg_set_tail_stamps
# sets.  The kernel and its launcher are renamed so that no symbol of the
# parent's own build in the same process stands in for them.
STAMPS = r"""
__device__ long long* tail_stamps;
__device__ void tail_mark(bool first) {
    __shared__ int k;
    __syncthreads();
    if (threadIdx.x == 0) {
        if (first) k = 0;
        long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        tail_stamps[1 + (size_t)k * gridDim.x + blockIdx.x] = t;
        if (first && blockIdx.x == 0) tail_stamps[0] = gridDim.x;
        ++k;
    }
}
"""
SET_STAMPS = r"""
extern "C" int mfmg_set_tail_stamps(long long* p) {
    return (int)cudaMemcpyToSymbol(tail_stamps, &p, sizeof(p));
}
"""


def stamped_source(src: str) -> str:
    """The parent's fused_tail.cu with stamps (see STAMPS)."""
    anchors = ("namespace cg = cooperative_groups;\n",
               "    cg::grid_group grid = cg::this_grid();\n",
               "        prolong_fine<T>(p, xc);\n    }\n}\n")
    for a in anchors:
        if src.count(a) != 1:
            raise ValueError(f"the parent's fused_tail.cu has not one {a!r}")
    src = src.replace(anchors[0], anchors[0] + STAMPS)
    src = src.replace(anchors[1], anchors[1] + "    tail_mark(true);\n")
    src = src.replace(anchors[2], "        prolong_fine<T>(p, xc);\n    }\n"
                                  "    tail_mark(false);\n}\n")
    src = src.replace("grid.sync();",
                      "{ tail_mark(false); grid.sync(); tail_mark(false); }")
    src = src.replace("fused_tail_kernel", "fused_tail_kernel_stamped")
    src = src.replace("launch_fused_tail", "launch_fused_tail_stamped")
    return src + SET_STAMPS


def load_parent(csrc: Path, stamped=False):
    """The parent's kernel library, built from csrc (into csrc/../_build);
    stamped: its fused_tail.cu alone with stamps (stamped_source), built
    from csrc/../csrc_stamped."""
    from mfmg_torch.ops import cuda_library as cl
    if stamped:
        dst = csrc.parent / "csrc_stamped"
        dst.mkdir(exist_ok=True)
        for h in csrc.glob("*.cuh"):
            (dst / h.name).write_text(h.read_text())
        (dst / "fused_tail.cu").write_text(
            stamped_source((csrc / "fused_tail.cu").read_text()))
        csrc = dst
    saved = cl.CSRC, cl.BUILD_DIR
    cl.CSRC, cl.BUILD_DIR = csrc, csrc.parent / ("_build_stamped" if stamped else "_build")
    try:
        path, _ = cl.build_library()
    finally:
        cl.CSRC, cl.BUILD_DIR = saved
    lib = ctypes.CDLL(str(path))
    vp, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.mfmg_fused_tail.argtypes = [i, i, i] + [vp] * 12 + [ip] * 4 + [vp]
    lib.mfmg_fused_tail.restype = i
    if stamped:
        lib.mfmg_set_tail_stamps.argtypes = [vp]
        lib.mfmg_set_tail_stamps.restype = i
    print(f"built the parent's kernels{' with stamps' if stamped else ''} from "
          f"{csrc} -> {path}", flush=True)
    return lib


def phase_times(run, n=N_STAMPED):
    """Median over n stamped launches, in us: per phase (last release ->
    last arrival, block 0's own), per barrier (last arrival -> last
    release), and the span from the first block's entry to the last exit."""
    buf = torch.zeros(1 + 64 * 4096, dtype=torch.int64, device="cuda")
    per = []
    for _ in range(n + 1):
        buf.zero_()
        run(buf)
        torch.cuda.synchronize()
        h = buf.cpu().numpy()
        g = int(h[0])
        k = int(np.count_nonzero(h[1:]) // g)
        per.append(h[1:1 + k * g].reshape(k, g).astype(np.float64) / 1e3)
    per = per[1:]                      # the first launch warms up
    n_sync = (per[0].shape[0] - 2) // 2

    def med(f):
        return float(np.median([f(T) for T in per]))

    def last(T, m):
        return T[m].max()
    phases = [dict(critical_us=med(lambda T, i=i: last(T, 2 * i + 1) - last(T, 2 * i)),
                   block0_us=med(lambda T, i=i: T[2 * i + 1, 0] - T[2 * i, 0]))
              for i in range(n_sync + 1)]
    barriers = [med(lambda T, j=j: last(T, 2 * j + 2) - last(T, 2 * j + 1))
                for j in range(n_sync)]
    span = med(lambda T: T[-1].max() - T[0].min())
    return dict(blocks=per[0].shape[1], phases=phases, barriers_us=barriers,
                span_us=span)


def in_turns(fns):
    """{name: {"device_ms": [..], "event_ms": [..]}} over the order A, B, B, A."""
    import chip_smoke as cs
    from kernel_device_times import device_ms
    names = list(fns)
    out = {k: dict(device_ms=[], event_ms=[]) for k in names}
    for k in names + names[::-1]:
        out[k]["device_ms"].append(device_ms(fns[k]))
        out[k]["event_ms"].append(cs.median_ms(fns[k]))
    return out


def rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", type=Path)
    ap.add_argument("--out", type=Path, help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from _torch_tails import random_tail
    from mfmg_torch.ops import cuda_library as cl
    from mfmg_torch.ops import fused_cycle as fc
    from mfmg_torch.ops import transfer_kernels as ttk

    card = cs.card_line()
    print(card, flush=True)
    _, log = cl.build_library()
    cl.library()
    lines = log.splitlines()
    for i, line in enumerate(lines):
        # ptxas -v: "Compiling entry function '<mangled>'" then its usage
        if "Compiling entry" in line and "tail" in line:
            for ln in lines[i + 1:i + 4]:
                print(f"  ptxas {line.split()[-3]}: {ln.strip()}", flush=True)
    parent = parent_stamped = None
    if args.parent_csrc:
        parent = load_parent(args.parent_csrc.resolve())
        parent_stamped = load_parent(args.parent_csrc.resolve(), stamped=True)
    result = dict(card=card, shapes={}, questions={})
    ok = True
    for label, (kw, full) in SHAPES.items():
        ft = random_tail(**kw, device="cuda")
        inp = tail_inputs(ft, full)
        ref = plain_of(ft, full, inp)
        fns = {"kernel": runner(ft, full, inp)}
        if parent is not None:
            fns["parent"] = parent_runner(parent, ft, full, inp)
        entry = dict(plan=fc.plan_of(ft, cl.sm_count(ref.device))._asdict())
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            e = rel(got, ref)
            good = bool(torch.isfinite(got).all()) and e <= TAIL_TOL
            ok &= good
            entry[f"{name}_rel_err"] = e
            print(f"{label} [{name}]: rel err {e:.3e} ({'ok' if good else 'FAIL'})",
                  flush=True)
        twice = fns["kernel"](), fns["kernel"]()
        entry["repeats_bit_for_bit"] = bool(torch.equal(*twice))
        ok &= entry["repeats_bit_for_bit"]
        entry["times"] = in_turns(fns)
        print(f"{label}: {json.dumps(entry['times'])}; plan {entry['plan']}", flush=True)
        names = phase_names(full, ft.degree, ft.nss)
        stamped = {"kernel": fns["kernel"]}
        if parent is not None:
            stamped["parent"] = parent_runner(parent_stamped, ft, full, inp)
        for name, run in stamped.items():
            st = entry[f"{name}_stamped"] = phase_times(run)
            print(f"{label} [{name}]: stamped span {st['span_us']:.2f} us over "
                  f"{st['blocks']} blocks", flush=True)
            for i, ph in enumerate(st["phases"]):
                bar = (f", barrier {st['barriers_us'][i]:.2f}"
                       if i < len(st["barriers_us"]) else "")
                nm = names[i] if len(names) == len(st["phases"]) else f"phase {i}"
                print(f"  {i} {nm}: {ph['critical_us']:.2f} us (block 0 "
                      f"{ph['block0_us']:.2f}){bar}", flush=True)
        print(f"{label}: same bits twice: {entry['repeats_bit_for_bit']}", flush=True)
        result["shapes"][label] = entry

    # the reference's two gates, in device time
    q = result["questions"]
    kw = dict(grid=(16,) * 3, fine_window=(5,) * 3)
    dense, win = (random_tail(**kw, dense=d, device="cuda") for d in (True, False))
    inp = tail_inputs(dense, True)
    q["65^3 full: dense against windowed L1->L2"] = in_turns(
        {"dense": runner(dense, True, inp), "windowed": runner(win, True, inp)})
    full129 = random_tail((32,) * 3, dense=False, fine_window=(5,) * 3,
                          device="cuda")
    inp = tail_inputs(full129, True)
    W = full129.W.float()
    geo = (full129.fine_window, full129.grid, full129.fine_grid)

    def sub_cycle():
        xc = ttk.structured_restrict(W, inp["res"], *geo)
        return inp["x"] - ttk.structured_prolong(W, fc.fused_subcycle_apply(full129, xc),
                                                 *geo)
    e = rel(runner(full129, True, inp)(), sub_cycle())
    q["129^3: full tail (gate lifted) against K4 + sub-cycle tail + K5"] = dict(
        in_turns({"full": runner(full129, True, inp), "sub-cycle + K4/K5": sub_cycle}),
        rel_between=e)
    for k, v in q.items():
        print(f"{k}: {json.dumps(v)}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    if not ok:
        sys.exit("a tail disagrees with its plain version or repeats other bits")


if __name__ == "__main__":
    main()
