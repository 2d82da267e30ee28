"""Smoke run of the mfmg_torch main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check or exception exits non-zero before the last line):
 1. the card (nvidia-smi name and power limit), torch and CUDA versions;
 2. build the CUDA kernels from mfmg_torch/csrc (nvcc, sm_90a), timed;
 3. kernels against their plain PyTorch versions at the 65^3 main-path
    shapes: K1 (bf16 and f32 planes) and K2 (with and without the residual),
    with the median time of each over 50 runs (CUDA events);
 4. a small-input reference: the 17^3 main-path hierarchy on the GPU against
    the same hierarchy on the CPU (plain versions);
 5. the main path at 65^3 (274,625 dofs): Hierarchy(..., device="cuda"),
    solve_cg(tol=1e-5, maxiter=50), the true residual in float64 on the
    host, the median ms per V-cycle, and the kernels' launch counts.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the mfmg_torch
package beside this file, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_REF = 6                 # 65^3 fine grid, 274,625 dofs
PCG_TOL, PCG_MAX, PCG_ITERS_MAX = 1e-5, 50, 10
# True residual ||b - A x|| / ||b|| in float64 of the float32 iterate.  The
# float32 CG (the reference's own algorithm) stops on its recursive residual
# (<= PCG_TOL); its true residual levels off near 2e-5 at 65^3: mfmg_tpu
# reaches 2.0e-5 on the same configuration, and the float32 rounding of an
# exact solution alone leaves 5.9e-6.  The bound is twice the reference's.
TRUE_RES_MAX = 4e-5
K1_TOL = 1e-5             # ||dy||_inf / ||y||_inf
K2_X_TOL, K2_RES_TOL = 1e-5, 1e-4
N_TIMED = 50


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def median_ms(fn, n=N_TIMED, batch=10, warm=5):
    """Median over n batches of the CUDA-event time per call of `batch`
    back-to-back calls (so n * batch >= 50 runs)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / batch)
    return float(np.median(times))


def main_config(cfg):
    return cfg.Config(max_levels=3, operator="stencil", dtype="float32",
                      coeff_dtype="bfloat16",
                      eigensolver=cfg.EigensolverConfig(
                          type="lapack", n_eigenvectors=2, n_eigenvectors_deep=4),
                      smoother=cfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=cfg.AgglomerationConfig(nx=4, ny=4, nz=4),
                      coarse=cfg.CoarseConfig(type="direct"))


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run needs "
              "an NVIDIA GPU", flush=True)
        sys.exit(2)
    import mfmg_torch.config as cfg
    from mfmg_torch import Hierarchy, LaplaceProblem
    from mfmg_torch.ops import stencil as st
    from mfmg_torch.ops import stencil_kernels as tk
    from mfmg_torch.solve.smoothers import build_smoother, fuse_chebyshev

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    path, log = tk.build_library()
    tk._library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # ---- 3. kernels against plain at 65^3 -----------------------------
    t0 = time.perf_counter()
    prob = LaplaceProblem.hyper_cube(3, N_REF, material_property="linear")
    print(f"problem: {prob.n_dofs} dofs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, prob.n_dofs).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(size=prob.n_dofs).astype(np.float32)).to(dev)
    ops = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        host = st.stencil_from_cell_matrices(prob.mesh, prob.A_loc,
                                             prob.constrained, prob.diag_raw,
                                             dtype=dt)
        if dt == torch.bfloat16:
            sm = build_smoother(host, cfg.SmootherConfig(type="chebyshev",
                                                         degree=2),
                                dtype=torch.float32)
        ops[name] = st.stencil_to_device(host, dev)
    fused = fuse_chebyshev(sm.to(dev), ops["bf16"])
    check(fused is not None, "no fused smoother for the 65^3 bf16 stencil")

    variants = {}
    k1_err = 0.0
    for name, op in ops.items():
        args = (op.planes, x, op.pos_offsets, op.grid_shape)
        y = tk.stencil_apply_sym(*args)
        ref = tk.stencil_apply_sym_plain(*args)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(bool(torch.isfinite(y).all()), f"K1 {name}: non-finite output")
        check(rel <= K1_TOL, f"K1 {name}: |dy|/|y| = {rel:.3e} > {K1_TOL}")
        ms = median_ms(lambda: tk.stencil_apply_sym(*args))
        pms = median_ms(lambda: tk.stencil_apply_sym_plain(*args))
        variants[f"stencil_apply_sym/{name}"] = dict(max_abs_err=err, rel_err=rel,
                                                     ms=ms, plain_ms=pms)
        k1_err = max(k1_err, err)
        print(f"K1 {name} planes: max|dy| {err:.3e} (rel {rel:.3e}), "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)

    op = ops["bf16"]
    k2_err = 0.0
    for want_res in (True, False):
        args = (op.planes, x, b, fused.inv_diag, fused.coef, op.pos_offsets,
                op.grid_shape, fused.degree, want_res)
        got = tk.cheb_smooth(*args)
        ref = tk.cheb_smooth_plain(*args)
        torch.cuda.synchronize()
        ex = float(torch.linalg.norm(got[0] - ref[0]) / torch.linalg.norm(ref[0]))
        err = float((got[0] - ref[0]).abs().max())
        check(ex <= K2_X_TOL, f"K2 res={want_res}: x rel err {ex:.3e} > {K2_X_TOL}")
        msg = f"K2 res={want_res}: max|dx| {err:.3e} (rel {ex:.3e})"
        if want_res:
            er = float(torch.linalg.norm(got[1] - ref[1]) / torch.linalg.norm(ref[1]))
            check(er <= K2_RES_TOL, f"K2: residual rel err {er:.3e} > {K2_RES_TOL}")
            err = max(err, float((got[1] - ref[1]).abs().max()))
            msg += f", residual rel {er:.3e}"
        ms = median_ms(lambda: tk.cheb_smooth(*args))
        pms = median_ms(lambda: tk.cheb_smooth_plain(*args))
        key = "cheb_smooth/" + ("with_residual" if want_res else "no_residual")
        variants[key] = dict(max_abs_err=err, rel_err=ex, ms=ms, plain_ms=pms)
        k2_err = max(k2_err, err)
        print(f"{msg}, kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
    del ops, fused, x, b

    # ---- 4. small-input reference: GPU hierarchy against CPU ----------
    small = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    hc = Hierarchy(small, main_config(cfg))
    hg = Hierarchy(small, main_config(cfg), device="cuda")
    bs = np.random.default_rng(1).uniform(size=small.n_dofs).astype(np.float32)
    yc, yg = hc.vmult(bs), hg.vmult(bs).cpu()
    rel = float(torch.linalg.norm(yg - yc) / torch.linalg.norm(yc))
    _, ic = hc.solve_cg(bs, tol=PCG_TOL, maxiter=PCG_MAX)
    _, ig = hg.solve_cg(bs, tol=PCG_TOL, maxiter=PCG_MAX)
    print(f"17^3 reference: V-cycle GPU vs CPU rel {rel:.3e}; PCG "
          f"{ig['iterations']} (GPU) vs {ic['iterations']} (CPU)", flush=True)
    check(rel <= 1e-5, f"17^3 V-cycle GPU vs CPU rel {rel:.3e} > 1e-5")
    check(ig["iterations"] == ic["iterations"], "17^3 PCG counts differ")
    del hc, hg

    # ---- 5. the main path at 65^3 --------------------------------------
    tk.reset_launch_counts()
    t0 = time.perf_counter()
    hier = Hierarchy(prob, main_config(cfg), device="cuda")
    setup_s = time.perf_counter() - t0
    sizes = [lv.op.shape[0] for lv in hier.levels]
    print(f"setup {setup_s:.2f} s, levels {sizes}, smoother L0 "
          f"{type(hier.levels[0].smoother).__name__}", flush=True)
    print("  setup stages: " + ", ".join(f"{k} {v:.2f}s"
                                         for k, v in hier.setup_seconds.items()),
          flush=True)
    on_cuda = all(t.is_cuda for lv in hier.levels for t in lv.buffers())
    check(on_cuda, "a level buffer is not on cuda")
    print(f"every level buffer on cuda: {on_cuda}", flush=True)
    bh = np.random.default_rng(0).uniform(size=prob.n_dofs).astype(np.float32)
    t0 = time.perf_counter()
    xs, info = hier.solve_cg(bh, tol=PCG_TOL, maxiter=PCG_MAX)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    check(xs.shape == (prob.n_dofs,) and bool(torch.isfinite(xs).all()),
          "solution not finite or of the wrong shape")
    A64 = st.stencil_to_device(st.stencil_from_cell_matrices(
        prob.mesh, prob.A_loc, prob.constrained, prob.diag_raw,
        dtype=torch.float64), "cpu")
    b64 = torch.from_numpy(bh.astype(np.float64))
    true_rel = float(torch.linalg.norm(b64 - A64(xs.cpu().double()))
                     / torch.linalg.norm(b64))
    print(f"solve_cg: {info['iterations']} iterations, relres "
          f"{info['relres']:.3e}, true relres (f64 host) {true_rel:.3e}, "
          f"{solve_s:.3f} s", flush=True)
    check(info["iterations"] <= PCG_ITERS_MAX,
          f"PCG took {info['iterations']} > {PCG_ITERS_MAX} iterations")
    check(info["relres"] <= PCG_TOL, f"relres {info['relres']:.3e} > {PCG_TOL}")
    check(true_rel <= TRUE_RES_MAX, f"true relres {true_rel:.3e} > {TRUE_RES_MAX}")
    bd = torch.from_numpy(bh).to(dev)
    ms_cycle = median_ms(lambda: hier.vmult(bd))
    launches = dict(tk.LAUNCHES)
    print(f"V-cycle: {ms_cycle:.4f} ms median over {N_TIMED} (CUDA events), "
          f"{prob.n_dofs / (ms_cycle * 1e-3):.3e} dof/s", flush=True)
    print(f"launches in the main path: {launches}", flush=True)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was never launched by the main path")

    kernels = [
        dict(name="stencil_apply_sym", route="cuda",
             source="mfmg_torch/csrc/stencil_apply_sym.cu",
             replaces="mfmg_tpu/ops/pallas_stencil.py:611",
             launches=launches["stencil_apply_sym"], max_abs_err=k1_err,
             ms=variants["stencil_apply_sym/f32"]["ms"],
             plain_ms=variants["stencil_apply_sym/f32"]["plain_ms"]),
        dict(name="cheb_smooth", route="cuda",
             source="mfmg_torch/csrc/cheb_smooth.cu",
             replaces="mfmg_tpu/ops/pallas_stencil.py:691",
             launches=launches["cheb_smooth"], max_abs_err=k2_err,
             ms=variants["cheb_smooth/with_residual"]["ms"],
             plain_ms=variants["cheb_smooth/with_residual"]["plain_ms"]),
    ]
    summary = dict(n_dofs=prob.n_dofs, setup_s=setup_s,
                   pcg_iterations=info["iterations"], relres=info["relres"],
                   true_relres=true_rel, ms_per_vcycle=ms_cycle, card=card)
    print(f"summary: {json.dumps(summary)}", flush=True)
    print(f"kernel variants: {json.dumps(variants)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
