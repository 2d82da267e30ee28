"""hierarchy_driver: the command line of mfmg_torch.

The port of mfmg_tpu/driver.py (the reference's tests/hierarchy_driver.cc):
reads an mfmg-style .info (or .json) configuration, builds the Laplace
problem and the hierarchy on the card, and either runs 20 standalone
V-cycles and prints the asymptotic convergence rate
(hierarchy_driver.cc:75-102) or runs the hierarchy-preconditioned CG and
prints its iteration count (hierarchy_driver.cc:104-116), then the timer
summary.

    python3 -m mfmg_torch.driver -f input.info -d 3 [--solve] [-t 1e-6]

A .info input gets the reference driver's forced settings
(hierarchy_driver.cc:255-272): fast AP, the "anasazi" (LOBPCG) eigensolver
at tolerance 1e-3, and with --raw-ml (or use_raw_ml) the "hidden" subtree
uncovered.  --device picks the device (default "cuda", which needs a CUDA
device and never falls back to the CPU).

--spmd N starts N local ranks (mfmg_torch.parallel.launch), each building
(or, with --load-hierarchy, loading) the hierarchy on its device, and runs
the reference's 20 sharded V-cycles (parallel/spmd.py) from a random x with
b = 0; rank 0 prints the rate and the timer section "Apply: 20 V-cycles
(spmd n=N)".  --backend gloo (the default: the CPU, or every rank sharing
the one card with host-staged halos) or nccl (one card per rank) is chosen
before the ranks start and printed; a failed rank, or ranks still running
after --spmd-timeout seconds, end the run with an error.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import warnings

import numpy as np


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-f", "--file", help="mfmg-style .info (or .json) config file")
    p.add_argument("-d", "--dim", type=int, default=2)
    p.add_argument("-m", "--matrix-free", action="store_true",
                   help="use the matrix-free operator path")
    p.add_argument("--operator", default=None,
                   help="operator representation: ell | stencil | matrix_free | sumfac")
    p.add_argument("-t", "--tolerance", type=float, default=None,
                   help="CG solver tolerance (default: .info "
                        "solver.tolerance, else 1e-6)")
    p.add_argument("--solve", action="store_true",
                   help="CG-preconditioner mode (default: 20 V-cycles + rate)")
    p.add_argument("--n-refinements", type=int, default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--max-levels", type=int, default=None)
    p.add_argument("--fe-degree", type=int, default=None,
                   help="Q_k element degree (laplace.fe_degree in .info)")
    p.add_argument("--device", default="cuda",
                   help="device of the hierarchy (default cuda; cpu on request)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the apply phase, "
                        "with the program's spans, to DIR/trace.json")
    p.add_argument("--spmd", type=int, metavar="N", default=None,
                   help="the apply phase slab-sharded over N local ranks")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                   help="torch.distributed backend of --spmd (default gloo: "
                        "the CPU, or the ranks sharing one card; nccl: one "
                        "card per rank)")
    p.add_argument("--spmd-timeout", type=float, default=1800.0,
                   help="seconds the --spmd ranks may take (default 1800)")
    p.add_argument("--save-hierarchy", metavar="PATH", default=None,
                   help="write the built hierarchy (mfmg_torch's own format) "
                        "for later reuse")
    p.add_argument("--load-hierarchy", metavar="PATH", default=None,
                   help="skip setup; reload a hierarchy saved earlier")
    p.add_argument("--raw-ml", action="store_true",
                   help="uncover the .info 'hidden' ML subtree (the "
                        "reference driver's use_raw_ml switch): a single "
                        "mfmg level with the smoothed-aggregation ML coarse "
                        "solver")
    p.add_argument("--true-residual", action="store_true",
                   help="after the CG solve, also print ||b - A x|| / ||b|| "
                        "in float64 on the host (assembles A)")
    return p


def load_config(args):
    """(Config, the input as nested dicts) with the reference driver's
    forced settings applied to a .info input and the command line's
    overrides."""
    from mfmg_torch.config import Config
    cfg_dict = {}
    if args.file:
        if args.file.endswith(".json"):
            import json
            with open(args.file) as f:
                cfg_dict = json.load(f)
        else:
            from mfmg_torch.utils.info_parser import load_info
            cfg_dict = load_info(args.file)
    is_info = bool(args.file) and not args.file.endswith(".json")
    if cfg_dict and is_info:
        # the reference driver's forced settings apply to .info runs only:
        # fast AP, LOBPCG at 1e-3, and the use_raw_ml uncover of the hidden
        # ML subtree; JSON configs keep their eigensolver
        use_raw_ml = (args.raw_ml or str(cfg_dict.get("use_raw_ml", "false"))
                      .strip().lower() in ("true", "1", "yes"))
        if (not args.matrix_free and use_raw_ml
                and isinstance(cfg_dict.get("hidden"), dict)):
            for k, v in cfg_dict["hidden"].items():
                cfg_dict[k] = v
        cfg_dict["fast_ap"] = True
        cfg_dict.setdefault("eigensolver", {})
        cfg_dict["eigensolver"]["type"] = "anasazi"
        cfg_dict["eigensolver"]["tolerance"] = 1e-3
    cfg = Config.from_dict(cfg_dict, info_style=is_info)
    if args.matrix_free:
        cfg.operator = "matrix_free"
        if cfg.smoother.type == "jacobi":
            cfg.smoother.type = "chebyshev"
    if args.operator:
        cfg.operator = args.operator
    if args.dtype:
        cfg.dtype = args.dtype
    if args.max_levels:
        cfg.max_levels = args.max_levels
    return cfg, cfg_dict


def build_problem(args, cfg, cfg_dict):
    """The Laplace problem of the .info "laplace" subtree and the command
    line (mesh, refinements, distortion, degree, dof renumbering)."""
    from mfmg_torch import LaplaceProblem
    from mfmg_torch.fem.mesh import hyper_ball, hyper_cube, renumber_dofs
    laplace = cfg_dict.get("laplace", {})
    n_ref = args.n_refinements or int(laplace.get("n_refinements", 3))
    material = cfg_dict.get("material_property", {}).get("type", "constant")
    distort = str(laplace.get("distort_random", "false")).lower() == "true"
    fe_degree = args.fe_degree or int(laplace.get("fe_degree", 1))
    make = hyper_ball if laplace.get("mesh", "hyper_cube") == "hyper_ball" else hyper_cube
    mesh = make(args.dim, n_ref, degree=fe_degree, distort_random=distort)
    # dof renumbering (laplace.hpp:115-122): RCM and King; the reference's
    # goldens are reordering-invariant (test_hierarchy.cc:282-307)
    reordering = str(laplace.get("reordering", "None"))
    if reordering.strip().lower().replace("-", "_").replace(" ", "_") not in ("none", ""):
        try:
            mesh = renumber_dofs(mesh, reordering)
            if cfg.operator in ("stencil", "matrix_free", "sumfac"):
                warnings.warn(f"laplace.reordering={reordering!r}: renumbered "
                              "dofs are not lexicographic; switching operator "
                              "to 'ell'")
                cfg.operator = "ell"
        except ValueError:
            warnings.warn(f"laplace.reordering={reordering!r} is not supported "
                          "(only Reverse Cuthill_McKee and King); proceeding "
                          "with the natural numbering")
    return LaplaceProblem.from_mesh(mesh, material)


def _setup(args, device, save=True):
    """(problem, hierarchy, timer, cfg_dict) of the command line on device,
    with the "n_dofs ... levels ..." line printed."""
    from mfmg_torch import Hierarchy
    from mfmg_torch.utils.timer import TimerOutput

    cfg, cfg_dict = load_config(args)
    timer = TimerOutput()
    with timer.section("Setup: problem"):
        prob = build_problem(args, cfg, cfg_dict)
    with timer.section("Setup: hierarchy"):
        if args.load_hierarchy:
            hier = Hierarchy.load(args.load_hierarchy, prob, device=device)
        else:
            hier = Hierarchy(prob, cfg, device=device)
    if args.save_hierarchy and save:
        hier.save(args.save_hierarchy)

    print(f"n_dofs: {prob.n_dofs}  levels: {len(hier.levels)}  "
          f"grid complexity: {hier.grid_complexity():.3f}  "
          f"operator complexity: {hier.operator_complexity():.3f}")
    return prob, hier, timer, cfg_dict


@contextlib.contextmanager
def _profile_ctx(args, device):
    """With --profile, a torch.profiler profile with the program's spans
    (utils/trace.py) on, so that its trace shows them beside the kernels."""
    if not args.profile:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    from mfmg_torch.utils import trace
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace.enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        trace.disable()


def _spmd_rank(mesh, argv):
    """One rank of --spmd: its hierarchy on mesh.device, the reference's 20
    sharded V-cycles (mfmg_tpu/driver.py:160-179); rank 0's printed lines
    are returned to the launching process."""
    import io

    import torch

    from mfmg_torch.parallel.spmd import build_spmd_vcycle
    from mfmg_torch.solve.operator import apply_op

    args = _parser().parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out if mesh.rank == 0 else io.StringIO()):
        prob, hier, timer, _ = _setup(args, mesh.device, save=mesh.rank == 0)
        sv = build_spmd_vcycle(hier, mesh)
        x = np.random.default_rng(0).uniform(size=prob.n_dofs)
        x[prob.constrained] = 0.0
        xg = sv.to_grid(x)
        bg = sv.to_grid(np.zeros(prob.n_dofs))
        rate = res_prev = None
        with _profile_ctx(args, mesh.device) as prof, timer.section(
                f"Apply: 20 V-cycles (spmd n={args.spmd})"):
            for _ in range(20):
                xg = sv.fn(bg, xg)
                xf = sv.from_grid(xg)
                res = float(torch.linalg.norm(apply_op(hier.levels[0].op, xf)))
                if res_prev:
                    rate = res / res_prev
                nrm = float(torch.linalg.norm(xf))
                xg, res_prev = xg / nrm, res / nrm
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
        print(f"Convergence rate: {rate:.10f}")
        if args.profile and mesh.rank == 0:
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(timer.summary())
    return out.getvalue()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.spmd:
        from mfmg_torch.parallel import launch
        print(f"spmd: {args.spmd} ranks, backend {args.backend}, device "
              f"{args.device}, timeout {args.spmd_timeout:.0f} s", flush=True)
        texts = launch(_spmd_rank, args.spmd, args=(argv,), backend=args.backend,
                       device=args.device, timeout=args.spmd_timeout)
        print(texts[0], end="")
        return 0

    import torch

    from mfmg_torch.amge.hierarchy import measure_vcycle_rate

    prob, hier, timer, cfg_dict = _setup(args, args.device)
    profile_ctx = _profile_ctx(args, hier.device)

    def synchronize():
        if hier.device.type == "cuda":
            torch.cuda.synchronize(hier.device)

    # CLI -t wins; else the .info solver.tolerance; else 1e-6, the
    # reference driver's precedence (hierarchy_driver.cc:273-279)
    solver_tol = args.tolerance
    if solver_tol is None:
        solver_tol = float(cfg_dict.get("solver", {}).get("tolerance", 1e-6))
    rng = np.random.default_rng(0)
    with profile_ctx as prof:
        if args.solve:
            b = rng.uniform(size=prob.n_dofs)
            b[prob.constrained] = 0.0
            with timer.section("Apply: CG solve"):
                x, info = hier.solve_cg(b, tol=solver_tol)
                synchronize()
            print(f"Solved in {int(info['iterations'])} iterations, "
                  f"relative residual {float(info['relres']):.3e}")
        else:
            with timer.section("Apply: 20 V-cycles"):
                rate = measure_vcycle_rate(hier, n_cycles=20, seed=0)
                synchronize()
            print(f"Convergence rate: {rate:.10f}")
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    if hier.device.type == "cuda":
        print(f"Peak device memory: "
              f"{torch.cuda.max_memory_allocated(hier.device) / 2**30:.3f} GiB")
    if args.solve and args.true_residual:
        bt = hier._vector(b).cpu().double().numpy()
        xt = x.cpu().double().numpy()
        true = np.linalg.norm(bt - prob.A @ xt) / np.linalg.norm(bt)
        print(f"True relative residual (float64, host): {true:.3e}")

    print(timer.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
