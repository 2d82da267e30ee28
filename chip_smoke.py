"""Smoke run of the mfmg_torch main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check or exception exits non-zero before the last line;
each phase prints its wall time):
 1. the card (nvidia-smi name and power limit), torch and CUDA versions;
 2. build the CUDA kernels from mfmg_torch/csrc (nvcc, sm_90a), timed;
 3. kernels against their plain PyTorch versions at the 65^3 main-path
    shapes: K1 (bf16 and f32 planes) and K2 (with and without the residual),
    with the median time of each over 50 runs (CUDA events), K1's library
    yardstick (one cuSPARSE CSR SpMV of the assembled float32 matrix), and
    the fused coarse tail in both modes (full tail, sub-cycle), both
    level-1 -> 2 forms (dense, windowed) and both storages (f32, bf16) on
    the 17^3 and 33^3 hierarchies;
 4. a small-input reference: the 17^3 main-path hierarchy on the GPU against
    the same hierarchy on the CPU (plain versions, the same bf16 tail), and
    against the CPU's generic recursion within the bf16 storage's gap;
 5. the main path at 65^3 (274,625 dofs): Hierarchy(..., device="cuda") with
    the full-mode tail, solve_cg(tol=1e-5, maxiter=50), the true residual in
    float64 on the host, the launch counts (the tail once per V-cycle), the
    tail against its plain version at these shapes (and the windowed
    level-1 -> 2 form, timed beside the dense one), the median ms per
    V-cycle with the tail and with the generic recursion in turns, and the
    PCG count with K2's plain version as the smoother;
 6. the main path at 129^3 (2,146,689 dofs): the same with the sub-cycle-mode
    tail (windowed level-1 -> 2 inside the kernel), setup seconds per stage,
    peak device memory, and K1 (which stands for the reference's z-tiled
    pallas_stencil_apply_tiled_sym there), K2 and the tail against their
    plain versions at these shapes.
The line before the last is the kernel table as JSON (launches from the main
paths' runs; bound_ms from the bytes and operations of this run's inputs at
3.35 TB/s and 67 TFLOP/s float32, the H100 SXM data sheet); the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the mfmg_torch
package beside this file, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_REF, N_REF_LARGE = 6, 7         # 65^3 (274,625 dofs), 129^3 (2,146,689)
PCG_TOL, PCG_MAX, PCG_ITERS_MAX = 1e-5, 50, 10
# True residual ||b - A x|| / ||b|| in float64 of the float32 iterate.  The
# float32 CG (the reference's own algorithm) stops on its recursive residual
# (<= PCG_TOL); its true residual levels off near 2e-5 at 65^3: mfmg_tpu
# reaches 2.0e-5 on the same configuration, and the float32 rounding of an
# exact solution alone leaves 5.9e-6.  The bound is twice the reference's.
# At 129^3 the reference's value is not measured; the bound there is the 65^3
# bound times 4, the growth of the Laplacian's condition number (h^-2) per
# refinement, which the float32 CG's attainable true residual follows.
TRUE_RES_MAX = 4e-5
TRUE_RES_MAX_LARGE = 4 * TRUE_RES_MAX
K1_TOL = 1e-5             # ||dy||_inf / ||y||_inf
K2_X_TOL, K2_RES_TOL = 1e-5, 1e-4
# fused tail: ||d||_2 / ||ref||_2, float sums over the same operands in
# another order (the bound tests/test_fused_cycle.py holds the reference's
# kernel to against its recursion)
TAIL_TOL = 1e-5
# a V-cycle with the bf16-weight tail against the generic recursion (float32
# coarse levels): the bf16 storage alone, 1.1e-3 to 1.6e-3 at 17^3 and 33^3
# (tests/test_torch_fused_cycle.py::test_bf16_tail_gap_to_generic_recursion)
BF16_STORAGE_GAP = 2e-3
N_TIMED = 50
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12    # H100 SXM data sheet


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
    back-to-back calls (n * batch >= 50 runs)."""
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


def bound(bytes_moved, flops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the float32 peak."""
    tb, to = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def k1_work(planes, n):
    """K1: the planes once, x in, y out; 2 flops per plane term, each
    positive plane used twice."""
    return nbytes(planes) + 8 * n, 2 * (2 * planes.shape[0] - 1) * n


def k2_work(planes, n, degree, want_res):
    """K2: planes once, x, b, invd in, x_s (and res) out; degree applies
    plus the residual's."""
    applies = degree + int(want_res)
    return (nbytes(planes) + 4 * n * (3 + 1 + int(want_res)),
            applies * 2 * (2 * planes.shape[0] - 1) * n + 8 * degree * n)


def tail_work(ft, full):
    """Fused tail: every operand once plus the vectors in and out;
    operations of its applies, transfers and coarse solve."""
    vec = (3 * ft.n_fine if full else 2 * ft.n1) * 4
    ops = nbytes(ft.coeffs, ft.invd, ft.cheb_coef, ft.inv2, ft.Rd, ft.W2,
                 ft.W if full else None) + vec
    d, nss = ft.degree, ft.nss
    applies = (d - 1) + (nss - 1) * d + 1 + nss * d
    flops = (applies * 2 * ft.coeffs.numel()
             + 4 * (ft.Rd if ft.Rd is not None else ft.W2).numel()
             + 2 * ft.n2 ** 2 + (4 * ft.W.numel() if full else 0))
    return ops, flops


def csr_from_stencil(op, device):
    """The assembled float32 matrix of a host stencil (all offset planes,
    zeros dropped) as a torch sparse CSR tensor on the card: the operand of
    K1's library yardstick, never used by the port."""
    gz, gy, gx = op.grid_shape
    n = gz * gy * gx
    idx = torch.arange(n, device=device)
    iz, iy, ix = idx // (gy * gx), (idx // gx) % gy, idx % gx
    C = op.coeffs.to(device=device, dtype=torch.float32).reshape(len(op.offsets), n)
    rows, cols, vals = [], [], []
    for o, (dz, dy, dx) in enumerate(op.offsets):
        ok = ((iz + dz >= 0) & (iz + dz < gz) & (iy + dy >= 0) & (iy + dy < gy)
              & (ix + dx >= 0) & (ix + dx < gx) & (C[o] != 0))
        rows.append(idx[ok])
        cols.append(idx[ok] + (dz * gy + dy) * gx + dx)
        vals.append(C[o][ok])
    A = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                torch.cat(vals), (n, n),
                                check_invariants=False).coalesce()
    return A.to_sparse_csr()


def main_config(cfg):
    return cfg.Config(max_levels=3, operator="stencil", dtype="float32",
                      coeff_dtype="bfloat16",
                      eigensolver=cfg.EigensolverConfig(
                          type="lapack", n_eigenvectors=2, n_eigenvectors_deep=4),
                      smoother=cfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=cfg.AgglomerationConfig(nx=4, ny=4, nz=4),
                      coarse=cfg.CoarseConfig(type="direct"))


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== phase {self.name}", flush=True)

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
                  flush=True)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke run needs "
              "an NVIDIA GPU", flush=True)
        sys.exit(2)
    import mfmg_torch.config as cfg
    from mfmg_torch import Hierarchy, LaplaceProblem
    from mfmg_torch.amge.hierarchy import LevelData
    from mfmg_torch.ops import fused_cycle as fc
    from mfmg_torch.ops import stencil as st
    from mfmg_torch.ops import stencil_kernels as tk
    from mfmg_torch.ops.structured_transfer import GeneralWindowTransfer
    from mfmg_torch.solve.smoothers import build_smoother, fuse_chebyshev

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    variants = {}

    def rel2(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    def check_k1(name, planes, x, pos, grid):
        args = (planes, x, pos, grid)
        y = tk.stencil_apply_sym(*args)
        ref = tk.stencil_apply_sym_plain(*args)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(bool(torch.isfinite(y).all()), f"K1 {name}: non-finite output")
        check(rel <= K1_TOL, f"K1 {name}: |dy|/|y| = {rel:.3e} > {K1_TOL}")
        ms = median_ms(lambda: tk.stencil_apply_sym(*args))
        pms = median_ms(lambda: tk.stencil_apply_sym_plain(*args), batch=1)
        variants[name] = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=pms)
        print(f"{name}: max|dy| {err:.3e} (rel {rel:.3e}), kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms", flush=True)
        return y

    def library_k1(name, host_op, x, y_kernel):
        """One cuSPARSE CSR SpMV of the same matrix, timed beside K1."""
        A = csr_from_stencil(host_op, dev)
        y = torch.mv(A, x)
        torch.cuda.synchronize()
        err = float((y - y_kernel).abs().max() / y_kernel.abs().max())
        lms = median_ms(lambda: torch.mv(A, x))
        variants[name]["library_ms"] = lms
        variants[name]["library_nnz"] = int(A.values().numel())
        print(f"{name}: cuSPARSE CSR SpMV (nnz {A.values().numel()}) "
              f"{lms:.4f} ms, |dy|/|y| vs K1 {err:.3e}", flush=True)
        return lms

    def check_tail(name, ft, full, rng, time_it=False):
        """One mode of a tail against its plain version on card tensors."""
        if full:
            x, res = (torch.from_numpy(v.astype(np.float32)).to(dev) for v in
                      (rng.uniform(size=ft.n_fine), rng.standard_normal(ft.n_fine)))
            run = lambda: fc.fused_correction_apply(ft, x, res)          # noqa: E731
            plain = lambda: fc.fused_correction_apply_plain(ft, x, res)  # noqa: E731
        else:
            b1 = torch.from_numpy(rng.standard_normal(ft.n1).astype(np.float32)).to(dev)
            run = lambda: fc.fused_subcycle_apply(ft, b1)                # noqa: E731
            plain = lambda: fc.fused_subcycle_apply_plain(ft, b1)        # noqa: E731
        got, ref = run(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        rel = rel2(got, ref)
        err = float((got - ref).abs().max())
        check(rel <= TAIL_TOL, f"{name}: rel err {rel:.3e} > {TAIL_TOL}")
        v = dict(max_abs_err=err, rel_err=rel)
        if time_it:
            v["ms"] = median_ms(run)
            v["plain_ms"] = median_ms(plain, batch=1)
        variants[name] = v
        print(f"{name}: max|d| {err:.3e} (rel {rel:.3e})"
              + (f", kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms"
                 if time_it else ""), flush=True)
        return v

    def check_k2(tag, op, x, b, fsm):
        """K2 with and without the residual against its plain version;
        returns the largest absolute error."""
        k2_err = 0.0
        for want_res in (True, False):
            args = (op.planes, x, b, fsm.inv_diag, fsm.coef, op.pos_offsets,
                    op.grid_shape, fsm.degree, want_res)
            got = tk.cheb_smooth(*args)
            ref = tk.cheb_smooth_plain(*args)
            torch.cuda.synchronize()
            ex = rel2(got[0], ref[0])
            err = float((got[0] - ref[0]).abs().max())
            check(bool(torch.isfinite(got[0]).all()), f"K2 {tag}: non-finite output")
            check(ex <= K2_X_TOL, f"K2 {tag} res={want_res}: x rel err {ex:.3e} "
                  f"> {K2_X_TOL}")
            msg = f"K2 {tag} res={want_res}: max|dx| {err:.3e} (rel {ex:.3e})"
            if want_res:
                er = rel2(got[1], ref[1])
                check(er <= K2_RES_TOL, f"K2 {tag}: residual rel err {er:.3e} "
                      f"> {K2_RES_TOL}")
                err = max(err, float((got[1] - ref[1]).abs().max()))
                msg += f", residual rel {er:.3e}"
            ms = median_ms(lambda: tk.cheb_smooth(*args))
            pms = median_ms(lambda: tk.cheb_smooth_plain(*args), batch=1)
            key = f"cheb_smooth/{tag}/" + ("with_residual" if want_res
                                           else "no_residual")
            variants[key] = dict(max_abs_err=err, rel_err=ex, ms=ms, plain_ms=pms)
            k2_err = max(k2_err, err)
            print(f"{msg}, kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
        return k2_err

    class PlainChebyshev(torch.nn.Module):
        """K2's plain PyTorch version on a fused smoother's buffers: the
        same smoother without the kernel, for the PCG count."""

        def __init__(self, fsm):
            super().__init__()
            self.fsm = fsm

        def _run(self, op, b, x, want_res):
            f = self.fsm
            return tk.cheb_smooth_plain(op.planes, x, b, f.inv_diag, f.coef,
                                        op.pos_offsets, op.grid_shape,
                                        f.degree, want_res)

        def apply(self, op, b, x):
            return self._run(op, b, x, False)[0]

        def apply_with_residual(self, op, b, x):
            return self._run(op, b, x, True)

    def tail_variants(levels, windowed, reduced):
        if windowed:
            tr = levels[1].transfer
            win = GeneralWindowTransfer(tr.W, tr.window_shape, tr.t0, tr.stride,
                                        tr.in_grid, tr.out_grid, tr.n_in, tr.n_out)
            levels = [levels[0], LevelData(levels[1].op, smoother=levels[1].smoother,
                                           transfer=win), levels[2]]
        return fc.build_fused_tail(levels, 1, reduced_storage=reduced)

    def true_relres(prob, xs, bh):
        A64 = st.stencil_to_device(st.stencil_from_cell_matrices(
            prob.mesh, prob.A_loc, prob.constrained, prob.diag_raw,
            dtype=torch.float64), "cpu")
        b64 = torch.from_numpy(bh.astype(np.float64))
        return float(torch.linalg.norm(b64 - A64(xs.cpu().double()))
                     / torch.linalg.norm(b64))

    def device_ms_per_cycle(hier, bd, n=20):
        """Device time per V-cycle from torch.profiler: the events that ran
        on the card (kernels, copies, fills) over n cycles, in ms per cycle,
        with the largest five by name."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        hier.vmult(bd)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                hier.vmult(bd)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        return sum(by_name.values()), [(k[:60], v) for k, v in top]

    def run_main_path(label, prob, mode_full):
        """Hierarchy + solve_cg with the counts set to 0 just before and read
        just after; the rest of the phase is measurement."""
        tk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hier = Hierarchy(prob, main_config(cfg), device="cuda")
        setup_s = time.perf_counter() - t0
        bh = np.random.default_rng(0).uniform(size=prob.n_dofs).astype(np.float32)
        t0 = time.perf_counter()
        xs, info = hier.solve_cg(bh, tol=PCG_TOL, maxiter=PCG_MAX)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = dict(tk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        sizes = [lv.op.shape[0] for lv in hier.levels]
        ft = hier.levels[0].fused
        print(f"{label}: setup {setup_s:.2f} s, levels {sizes}, smoother L0 "
              f"{type(hier.levels[0].smoother).__name__}", flush=True)
        print("  setup stages: " + ", ".join(f"{k} {v:.2f}s"
                                             for k, v in hier.setup_seconds.items()),
              flush=True)
        check(ft is not None, f"{label}: no fused tail on level 0")
        check((ft.fine_grid is not None) == mode_full,
              f"{label}: tail mode is not {'full' if mode_full else 'sub-cycle'}")
        print(f"  tail: {'full' if mode_full else 'sub-cycle'} mode, "
              f"{'dense' if ft.Rd is not None else 'windowed'} L1->L2, weights "
              f"{ft.coeffs.dtype}", flush=True)
        check(all(t.is_cuda for lv in hier.levels for t in lv.buffers()),
              "a level buffer is not on cuda")
        check(xs.shape == (prob.n_dofs,) and bool(torch.isfinite(xs).all()),
              "solution not finite or of the wrong shape")
        tr = true_relres(prob, xs, bh)
        print(f"  solve_cg: {info['iterations']} iterations, relres "
              f"{info['relres']:.3e}, true relres (f64 host) {tr:.3e}, "
              f"{solve_s:.3f} s; peak device memory {peak / 2**30:.3f} GiB",
              flush=True)
        print(f"  launches in the main path: {launches}", flush=True)
        check(info["iterations"] <= PCG_ITERS_MAX,
              f"PCG took {info['iterations']} > {PCG_ITERS_MAX} iterations")
        check(info["relres"] <= PCG_TOL, f"relres {info['relres']:.3e} > {PCG_TOL}")
        check(np.isfinite(tr), "true relres not finite")
        for k, v in launches.items():
            check(v > 0, f"kernel {k} was never launched by the {label} main path")
        # solve_cg applies the preconditioner once per iteration plus once
        check(launches["fused_tail"] == info["iterations"] + 1,
              f"tail launched {launches['fused_tail']} times in "
              f"{info['iterations'] + 1} V-cycles")
        # same-call A/B: the tail and the generic recursion, in turns
        bd = torch.from_numpy(bh).to(dev)
        ab = {"tail": [], "generic": []}
        for key in ("tail", "generic", "generic", "tail"):
            hier.levels[0].fused = ft if key == "tail" else None
            ab[key].append(median_ms(lambda: hier.vmult(bd), batch=2))
        dev_ms, dev_top, pcg = {}, {}, {}
        for key in ("tail", "generic"):
            hier.levels[0].fused = ft if key == "tail" else None
            dev_ms[key], dev_top[key] = device_ms_per_cycle(hier, bd)
            if key == "generic":
                pcg[key] = hier.solve_cg(bh, tol=PCG_TOL, maxiter=PCG_MAX)[1]
        # the tail with float32 weight storage, for the iteration count
        hier.levels[0].fused = fc.build_fused_tail(hier.levels, ft.nss)
        pcg["tail_f32_weights"] = hier.solve_cg(bh, tol=PCG_TOL, maxiter=PCG_MAX)[1]
        hier.levels[0].fused = ft
        # K2's plain version as the smoother, for the iteration count
        fsm = hier.levels[0].smoother
        hier.levels[0].smoother = PlainChebyshev(fsm)
        pcg["tail_plain_smoother"] = hier.solve_cg(bh, tol=PCG_TOL,
                                                   maxiter=PCG_MAX)[1]
        hier.levels[0].smoother = fsm
        print(f"  V-cycle ms (CUDA events, medians in turns tail/generic/"
              f"generic/tail): tail {ab['tail']}, generic {ab['generic']}; "
              f"device ms/cycle (profiler): tail {dev_ms['tail']:.4f}, "
              f"generic {dev_ms['generic']:.4f}", flush=True)
        for key in ("tail", "generic"):
            print(f"  device ms/cycle by kernel ({key}): "
                  + "; ".join(f"{k} {v:.4f}" for k, v in dev_top[key]), flush=True)
        print("  PCG in the same process: " + ", ".join(
            f"{k} {v['iterations']} iterations (relres {v['relres']:.3e})"
            for k, v in pcg.items()), flush=True)
        summary = dict(n_dofs=prob.n_dofs, setup_s=setup_s,
                       setup_stages=hier.setup_seconds,
                       pcg_iterations=info["iterations"], relres=info["relres"],
                       true_relres=tr, solve_s=solve_s,
                       ms_per_vcycle_tail=ab["tail"],
                       ms_per_vcycle_generic=ab["generic"],
                       device_ms_per_vcycle=dev_ms, device_top=dev_top,
                       pcg_iterations_other={k: v["iterations"]
                                             for k, v in pcg.items()},
                       peak_device_gib=peak / 2**30, launches=launches)
        return hier, summary, tr

    # ---- 2. build -----------------------------------------------------
    with Phase("2 build"):
        t0 = time.perf_counter()
        path, log = tk.build_library()
        tk._library()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s: {path}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}", flush=True)

    # ---- 3. kernels against plain --------------------------------------
    with Phase("3 kernels at 65^3 and the tail at 17^3 / 33^3"):
        prob = LaplaceProblem.hyper_cube(3, N_REF, material_property="linear")
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.uniform(-1, 1, prob.n_dofs).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.uniform(size=prob.n_dofs).astype(np.float32)).to(dev)
        ops, hosts = {}, {}
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            host = st.stencil_from_cell_matrices(prob.mesh, prob.A_loc,
                                                 prob.constrained, prob.diag_raw,
                                                 dtype=dt)
            if dt == torch.bfloat16:
                sm = build_smoother(host, cfg.SmootherConfig(type="chebyshev",
                                                             degree=2),
                                    dtype=torch.float32)
            else:
                hosts[name] = st.StencilOperator(host.coeffs, host.offsets,
                                                 host.grid_shape, host.sym_pos)
            ops[name] = st.stencil_to_device(host, dev)
        fused = fuse_chebyshev(sm.to(dev), ops["bf16"])
        check(fused is not None, "no fused smoother for the 65^3 bf16 stencil")
        for name, op in ops.items():
            y = check_k1(f"stencil_apply_sym/{name}", op.planes, x,
                         op.pos_offsets, op.grid_shape)
        library_k1("stencil_apply_sym/f32", hosts["f32"], x, y)

        op = ops["bf16"]
        k2_err = check_k2("65^3", op, x, b, fused)
        k1_work65 = k1_work(ops["f32"].planes, prob.n_dofs)
        k2_work65 = k2_work(op.planes, prob.n_dofs, fused.degree, True)
        del ops, hosts, fused, x, b

        # the tail in both modes, forms and storages at small sizes
        for n_ref in (4, 5):
            h = Hierarchy(LaplaceProblem.hyper_cube(3, n_ref,
                                                    material_property="linear"),
                          main_config(cfg), device="cuda")
            for windowed in (False, True):
                for reduced in (False, True):
                    ft = tail_variants(list(h.levels), windowed, reduced)
                    check(ft is not None and (ft.Rd is None) == windowed,
                          "tail variant not built")
                    for full in (True, False):
                        check_tail(f"fused_tail/{2 ** n_ref + 1}^3/"
                                   f"{'full' if full else 'subcycle'}/"
                                   f"{'windowed' if windowed else 'dense'}/"
                                   f"{'bf16' if reduced else 'f32'}",
                                   ft, full, np.random.default_rng(n_ref))
            del h

    # ---- 4. small-input reference: GPU hierarchy against CPU ----------
    with Phase("4 17^3 GPU against CPU"):
        small = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
        hc = Hierarchy(small, main_config(cfg), device="cpu")
        hg = Hierarchy(small, main_config(cfg), device="cuda")
        bs = np.random.default_rng(1).uniform(size=small.n_dofs).astype(np.float32)
        y_generic = hc.vmult(bs)          # the CPU generic recursion
        # the card's tail (bf16 weights) on the CPU levels too, plain version
        hc.levels[0].fused = fc.build_fused_tail(hc.levels, 1, reduced_storage=True)
        yc, yg = hc.vmult(bs), hg.vmult(bs).cpu()
        rel, rel_generic = rel2(yg, yc), rel2(yg, y_generic)
        _, ic = hc.solve_cg(bs, tol=PCG_TOL, maxiter=PCG_MAX)
        _, ig = hg.solve_cg(bs, tol=PCG_TOL, maxiter=PCG_MAX)
        print(f"17^3 reference: V-cycle GPU vs CPU rel {rel:.3e} (vs the CPU "
              f"generic recursion {rel_generic:.3e}); PCG "
              f"{ig['iterations']} (GPU) vs {ic['iterations']} (CPU)", flush=True)
        check(rel <= 1e-5, f"17^3 V-cycle GPU vs CPU rel {rel:.3e} > 1e-5")
        check(rel_generic <= BF16_STORAGE_GAP,
              f"17^3 V-cycle GPU vs CPU generic rel {rel_generic:.3e} > "
              f"{BF16_STORAGE_GAP}")
        check(ig["iterations"] == ic["iterations"], "17^3 PCG counts differ")
        del hc, hg

    # ---- 5. the main path at 65^3 --------------------------------------
    with Phase("5 main path 65^3"):
        hier, summary65, tr65 = run_main_path("65^3", prob, mode_full=True)
        check(tr65 <= TRUE_RES_MAX, f"true relres {tr65:.3e} > {TRUE_RES_MAX}")
        ft65 = hier.levels[0].fused
        v65 = check_tail("fused_correction_apply/65^3", ft65, True,
                         np.random.default_rng(5), time_it=True)
        # the same tail's sub-cycle alone: the fine transfer's share
        check_tail("fused_subcycle_apply/65^3", ft65, False,
                   np.random.default_rng(6), time_it=True)
        # the windowed level-1 -> 2 form at the same shapes, timed beside the
        # dense form the builder picks here
        check_tail("fused_correction_apply/65^3/windowed",
                   tail_variants(list(hier.levels), True, True), True,
                   np.random.default_rng(5), time_it=True)
        del hier

    # ---- 6. the main path at 129^3 -------------------------------------
    with Phase("6 main path 129^3"):
        t0 = time.perf_counter()
        prob7 = LaplaceProblem.hyper_cube(3, N_REF_LARGE, material_property="linear")
        print(f"problem: {prob7.n_dofs} dofs in {time.perf_counter() - t0:.1f} s",
              flush=True)
        hier7, summary129, tr129 = run_main_path("129^3", prob7, mode_full=False)
        check(tr129 <= TRUE_RES_MAX_LARGE,
              f"129^3 true relres {tr129:.3e} > {TRUE_RES_MAX_LARGE}")
        ft129 = hier7.levels[0].fused
        check(ft129.W2 is not None, "129^3 tail is not in the windowed form")
        v129 = check_tail("fused_subcycle_apply/129^3", ft129, False,
                          np.random.default_rng(7), time_it=True)
        ex7 = hier7._exact_fine_op()
        rng7 = np.random.default_rng(8)
        x7 = torch.from_numpy(rng7.uniform(-1, 1, prob7.n_dofs)
                              .astype(np.float32)).to(dev)
        b7 = torch.from_numpy(rng7.uniform(size=prob7.n_dofs)
                              .astype(np.float32)).to(dev)
        op7 = hier7.levels[0].op
        k2_err = max(k2_err, check_k2("129^3", op7, x7, b7,
                                      hier7.levels[0].smoother))
        del b7
        y7 = check_k1("stencil_apply_tiled_sym/f32", ex7.planes, x7,
                      ex7.pos_offsets, ex7.grid_shape)
        check_k1("stencil_apply_tiled_sym/bf16", op7.planes, x7,
                 op7.pos_offsets, op7.grid_shape)
        host7 = st.stencil_from_cell_matrices(prob7.mesh, prob7.A_loc,
                                              prob7.constrained, prob7.diag_raw,
                                              dtype=torch.float32)
        library_k1("stencil_apply_tiled_sym/f32", host7, x7, y7)
        k1_work129 = k1_work(ex7.planes, prob7.n_dofs)
        tail_work129 = tail_work(ft129, False)
        del host7, hier7

    tail_work65 = tail_work(ft65, True)
    l65, l129 = summary65["launches"], summary129["launches"]

    def row(name, source, replaces, launches, var, work, library_ms, err=None):
        b_ms, b_by = bound(*work)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches,
                    max_abs_err=var["max_abs_err"] if err is None else err,
                    ms=var["ms"], plain_ms=var["plain_ms"], bound_ms=b_ms,
                    bound_by=b_by, library_ms=library_ms)

    k1v, k1tv = variants["stencil_apply_sym/f32"], variants["stencil_apply_tiled_sym/f32"]
    kernels = [
        row("stencil_apply_sym", "mfmg_torch/csrc/stencil_apply_sym.cu",
            "mfmg_tpu/ops/pallas_stencil.py:611", l65["stencil_apply_sym"],
            k1v, k1_work65, k1v["library_ms"],
            err=max(k1v["max_abs_err"],
                    variants["stencil_apply_sym/bf16"]["max_abs_err"])),
        row("cheb_smooth", "mfmg_torch/csrc/cheb_smooth.cu",
            "mfmg_tpu/ops/pallas_stencil.py:691", l65["cheb_smooth"],
            variants["cheb_smooth/65^3/with_residual"], k2_work65, None,
            err=k2_err),
        row("fused_correction_apply", "mfmg_torch/csrc/fused_tail.cu",
            "mfmg_tpu/ops/fused_cycle.py:402", l65["fused_tail"], v65,
            tail_work65, None),
        row("fused_subcycle_apply", "mfmg_torch/csrc/fused_tail.cu",
            "mfmg_tpu/ops/fused_cycle.py:376", l129["fused_tail"], v129,
            tail_work129, None),
        row("stencil_apply_tiled_sym", "mfmg_torch/csrc/stencil_apply_sym.cu",
            "mfmg_tpu/ops/pallas_stencil.py:139", l129["stencil_apply_sym"],
            k1tv, k1_work129, k1tv["library_ms"],
            err=max(k1tv["max_abs_err"],
                    variants["stencil_apply_tiled_sym/bf16"]["max_abs_err"])),
    ]
    for s in (summary65, summary129):
        s["card"] = card
    print(f"summary 65^3: {json.dumps(summary65)}", flush=True)
    print(f"summary 129^3: {json.dumps(summary129)}", flush=True)
    print(f"kernel variants: {json.dumps(variants)}", flush=True)
    print(f"total wall time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
