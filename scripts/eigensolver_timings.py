"""Timings behind the design of mfmg_torch's level-0 eigensolvers.

    python3 scripts/eigensolver_timings.py [--device cuda|cpu] [--no-arpack]

- LOBPCG's Rayleigh-Ritz at the 65^3 main configuration's shapes (4,096
  agglomerates of 125 dofs, a trial basis of 3 x 2 columns): the batched
  QR by ``torch.linalg.qr`` and by ``eigen/lobpcg.py`` ``householder_qr``
  (ms per call, and how far apart their factors are), the batched 6 x 6
  eigh and the triangular solve, on ``--device`` (the card by default).
- ARPACK (``eigen/arpack.py``, host eigsh in shift-invert mode) per
  agglomerate of the 65^3 main configuration, in agglomerate order with
  one BLAS thread, at tolerances 1e-14 (the config's default), 1e-10 and
  1e-6: 16 agglomerates touching the boundary and 16 interior ones (no
  constrained dof, the slow case).
Prints the card's name and power limit first where there is one.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def per_call_ms(fn, device, n=5):
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-arpack", action="store_true")
    args = ap.parse_args()
    from mfmg_torch.eigen.lobpcg import householder_qr
    from mfmg_torch.utils.device import checked_device
    device = checked_device(args.device)
    if device.type == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(out.stdout.strip(), flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    S = torch.randn(4096, 125, 6, dtype=torch.float64, device=device, generator=g)
    T = S.mT @ S
    R = torch.triu(T) + torch.eye(6, dtype=torch.float64, device=device)
    Q1, R1 = torch.linalg.qr(S)
    Q2, R2 = householder_qr(S)
    print(f"QR of (4096, 125, 6) float64 on {device}: torch.linalg.qr "
          f"{per_call_ms(lambda: torch.linalg.qr(S), device):.2f} ms, "
          f"householder_qr {per_call_ms(lambda: householder_qr(S), device):.2f} ms; "
          f"max |dQ| {float((Q1 - Q2).abs().max()):.1e}, max |dR| "
          f"{float((R1 - R2).abs().max()):.1e}", flush=True)
    print(f"eigh of (4096, 6, 6): {per_call_ms(lambda: torch.linalg.eigh(T), device):.2f} ms; "
          f"solve_triangular: "
          f"{per_call_ms(lambda: torch.linalg.solve_triangular(R, T[:, :, :2], upper=True), device):.2f} ms",
          flush=True)
    if args.no_arpack:
        return
    import mfmg_torch.config as cfg
    from mfmg_torch import LaplaceProblem
    from mfmg_torch.amge.agglomeration import build_agglomerates
    from mfmg_torch.amge.local_problems import (AgglomerateBatch,
                                                build_agglomerate_batch)
    from mfmg_torch.eigen import arpack
    p = LaplaceProblem.hyper_cube(3, 6, material_property="linear")
    batch = build_agglomerate_batch(p.mesh, p.A_loc, build_agglomerates(
        p.mesh, cfg.AgglomerationConfig(nx=4, ny=4, nz=4)), batch_dtype=np.float32)
    touching = batch.constrained.any(axis=1)
    for name, ids in (("boundary", np.nonzero(touching)[0]),
                      ("interior", np.nonzero(~touching)[0])):
        sel = ids[:: max(1, len(ids) // 16)][:16]
        sub = AgglomerateBatch(**{k: getattr(batch, k)[sel] for k in (
            "dof_map", "valid", "A_agg", "diag", "constrained", "sizes")})
        for tol in (1e-14, 1e-10, 1e-6):
            t0 = time.perf_counter()
            arpack.batched_arpack_smallest(
                sub, cfg.EigensolverConfig(type="arpack", tolerance=tol), "pin")
            ms = (time.perf_counter() - t0) / len(sel) * 1e3
            print(f"ARPACK, {name} agglomerates ({len(ids)} of {batch.n_agg}), "
                  f"tolerance {tol:g}: {ms:.1f} ms per agglomerate", flush=True)


if __name__ == "__main__":
    main()
