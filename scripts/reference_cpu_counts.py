"""The reference's PCG count and true residual on the CPU, for the bounds of
chip_smoke.py.

    JAX_PLATFORMS=cpu python scripts/reference_cpu_counts.py N_REF DEGREE \
        [--distort] [--max-levels L] \
        [--operator stencil|ell|matrix_free|sumfac] \
        [--smoother chebyshev|sgs|gs-lex-dealii|ilu] \
        [--device-pipeline] [--mesh cube|ball|adaptive] \
        [--partitioner block|rcb|metis]

Builds mfmg_tpu's hierarchy (x64 enabled, on the CPU) for the main
configuration of bench.py:97-103 (float32 with bf16 preconditioner planes,
Chebyshev degree 2, 4x4x4 agglomerates, direct coarse solve) on the
"linear" Laplace hyper_cube, optionally distorted (distort_random, seed 0),
and runs solve_cg(b, tol=1e-5, maxiter=50) with
b = default_rng(0).uniform(size=n) in float32, the right-hand side of
chip_smoke.py.  Prints the level sizes, the iteration count, the recursive
relres and the true relres ||b - A x|| / ||b|| in float64.  129^3 (N_REF 7,
DEGREE 1) takes about a minute of setup.  --operator ell takes the
assembled path (ELL at every level, the host SpGEMM Galerkin product; the
bf16 coeff_dtype applies to stencil planes only, so it has no effect
there).  --operator matrix_free / sumfac take the matrix-free operators
(the cell matrices, or the sum-factorized apply; the "auto" constrained
mode is then "identity", and level 0 is set up on the host).  --smoother
replaces Chebyshev degree 2 at every level: "sgs" multicolor symmetric
Gauss-Seidel (lattice colors on stencils, greedy colors on ELL),
"gs-lex-dealii" lexicographic Gauss-Seidel in deal.II's dof order and "ilu"
ILU(0), the last two with --operator ell on a level 0 of at most 8,192
dofs; deal.II's order exists on level 0 only, so "gs-lex-dealii" takes
--max-levels 2 (e.g. "3 1 --operator ell --smoother gs-lex-dealii
--max-levels 2": 5 iterations at 729 dofs).

--mesh ball takes hyper_ball(3, N_REF) and --mesh adaptive
adaptive_cube(3, N_REF, x, y, z < 0.5) (Q1 only; DEGREE must be 1) in
place of the hyper_cube, with operator="ell" (the stencil needs a
structured mesh).  --partitioner picks the agglomerates: "block" (4x4x4,
the unstructured block walk on these meshes), "rcb" or "metis" with
n_cells // 64 parts.  On these meshes the right-hand side is zero at the
constrained dofs (Dirichlet and hanging), as in chip_smoke.py's phase 10,
so that the hanging slaves of the solution stay 0; the script prints the
largest of them.  ``hyper_ball(3, 5)`` takes about three minutes of setup.

--device-pipeline sets level 0 up the way mfmg_tpu does on its accelerator:
its device eigensolve (mfmg_tpu/eigen/device_eig.py, with supports()
patched to True and the pipeline run with x64 off, its accelerator's
types) and the Galerkin blocks against the batch it keeps
(MFMG_DEVICE_GALERKIN).  The patches live in this script; mfmg_tpu is not
edited.  The script fails if the hierarchy did not take that route.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_ref", type=int)
    ap.add_argument("degree", type=int)
    ap.add_argument("--distort", action="store_true")
    ap.add_argument("--max-levels", type=int, default=3)
    ap.add_argument("--operator", choices=("stencil", "ell", "matrix_free",
                                           "sumfac"), default="stencil")
    ap.add_argument("--smoother", choices=("chebyshev", "sgs", "gs-lex-dealii",
                                           "ilu"), default="chebyshev")
    ap.add_argument("--device-pipeline", action="store_true")
    ap.add_argument("--mesh", choices=("cube", "ball", "adaptive"),
                    default="cube")
    ap.add_argument("--partitioner", choices=("block", "rcb", "metis"),
                    default="block")
    args = ap.parse_args()
    if args.mesh != "cube" and (args.degree != 1 or args.operator
                                in ("stencil", "sumfac")):
        sys.exit("--mesh ball|adaptive takes DEGREE 1 and --operator "
                 "ell|matrix_free")

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import mfmg_tpu.config as cfg
    from mfmg_tpu import Hierarchy, LaplaceProblem

    t0 = time.perf_counter()
    if args.mesh == "cube":
        prob = LaplaceProblem.hyper_cube(3, args.n_ref, degree=args.degree,
                                         material_property="linear",
                                         distort_random=args.distort, seed=0)
    else:
        from mfmg_tpu.fem.adaptive import adaptive_cube
        from mfmg_tpu.fem.mesh import hyper_ball
        mesh = (hyper_ball(3, args.n_ref, distort_random=args.distort)
                if args.mesh == "ball" else
                adaptive_cube(3, args.n_ref,
                              lambda c: np.all(c < 0.5, axis=1)))
        print(f"mesh {time.perf_counter() - t0:.1f} s, {mesh.n_cells} cells, "
              f"{mesh.n_nodes} dofs, "
              f"{0 if mesh.hanging is None else mesh.hanging.n} hanging",
              flush=True)
        prob = LaplaceProblem.from_mesh(mesh, "linear")
    config = cfg.Config(
        max_levels=args.max_levels, operator=args.operator, dtype="float32",
        coeff_dtype="bfloat16",
        eigensolver=cfg.EigensolverConfig(type="lapack", n_eigenvectors=2,
                                          n_eigenvectors_deep=4),
        smoother={"chebyshev": cfg.SmootherConfig(type="chebyshev", degree=2),
                  "sgs": cfg.SmootherConfig(type="symmetric gauss-seidel"),
                  "gs-lex-dealii": cfg.SmootherConfig(
                      type="gauss-seidel", coloring="lexicographic",
                      ordering="dealii"),
                  "ilu": cfg.SmootherConfig(type="ilu")}[args.smoother],
        agglomeration=cfg.AgglomerationConfig(
            partitioner=args.partitioner, nx=4, ny=4, nz=4,
            n_agglomerates=prob.mesh.n_cells // 64),
        coarse=cfg.CoarseConfig(type="direct"))
    if args.device_pipeline:
        from mfmg_tpu.eigen import device_eig
        run = device_eig.device_smallest_eigenpairs

        def pipeline(*a, **k):
            with jax.enable_x64(False):
                return run(*a, **k)

        device_eig.supports = lambda *a, **k: True
        device_eig.device_smallest_eigenpairs = pipeline
        os.environ["MFMG_DEVICE_GALERKIN"] = "1"
    hier = Hierarchy(prob, config)
    if args.device_pipeline and hier._level0_eigendata[0].A_agg is not None:
        sys.exit("the hierarchy did not take the device pipeline")
    print(f"setup {time.perf_counter() - t0:.1f} s, levels "
          f"{[lv.op.shape[0] for lv in hier.levels]}", flush=True)
    b = np.random.default_rng(0).uniform(size=prob.n_dofs).astype(np.float32)
    if args.mesh != "cube":
        b[prob.constrained] = 0.0
    x, info = hier.solve_cg(b, tol=1e-5, maxiter=50)
    b64 = b.astype(np.float64)
    true = (np.linalg.norm(b64 - prob.A @ np.asarray(x, dtype=np.float64))
            / np.linalg.norm(b64))
    if args.mesh != "cube":
        agg = hier._level0_eigendata[0]
        hang = prob.mesh.hanging
        print(f"agglomerate sizes {int(agg.sizes.min())}..{int(agg.sizes.max())} "
              f"dofs; largest |x| at a hanging slave "
              f"{0.0 if hang is None else float(np.abs(np.asarray(x)[hang.slaves]).max())!r}",
              flush=True)
    print(f"mesh {args.mesh} partitioner {args.partitioner} "
          f"n_ref {args.n_ref} degree {args.degree} distort {args.distort} "
          f"max_levels {args.max_levels} operator {args.operator} smoother "
          f"{args.smoother} device_pipeline "
          f"{args.device_pipeline}: {prob.n_dofs} dofs, "
          f"{int(info['iterations'])} iterations, relres "
          f"{float(info['relres']):.3e}, true relres {true:.3e}", flush=True)


if __name__ == "__main__":
    main()
