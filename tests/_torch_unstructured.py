"""Shared pieces of the unstructured-mesh parity tests
(tests/test_torch_unstructured.py, tests/test_torch_adaptive.py): the
configuration both packages run, the quadrant marker of the adaptive cubes,
and one hierarchy comparison.

Both packages get the same Config: operator="ell", the "lapack"
eigensolver in the "pin" constrained mode with 2 eigenvectors (4 on the
deeper levels), Chebyshev smoothing of degree 2 with the converged
"lanczos" interval, and the direct coarse solve.  The reference's ball
goldens (tests/test_ball.py) use the "identity" mode and the "dealii_cg"
estimate, neither of which the port has yet, so those goldens are not
covered here: test_ball_hierarchy_rates_near_reference and
test_ball_matrix_path_goldens_two_sided (its lexicographic Gauss-Seidel is
not ported either).
"""

import numpy as np

# float64 hierarchies of both packages: the same LAPACK calls on the same
# batches, applies summed in another order (read ~1e-15 on these meshes)
RATE_TOL = 1e-10
PCG_TOL = 1e-5


def quadrant(centers):
    """The cells below 0.5 in every coordinate: the adaptive cubes' marks
    (tests/test_adaptive.py)."""
    return np.all(centers < 0.5, axis=1)


def unstructured_config(cfg_mod, dtype, partitioner="block", block=2,
                        n_agglomerates=4, max_levels=3):
    return cfg_mod.Config(
        max_levels=max_levels, operator="ell", dtype=dtype,
        is_preconditioner=dtype == "float32",
        eigensolver=cfg_mod.EigensolverConfig(
            type="lapack", n_eigenvectors=2, n_eigenvectors_deep=4,
            constrained_mode="pin"),
        smoother=cfg_mod.SmootherConfig(type="chebyshev", degree=2,
                                        eig_estimate="lanczos"),
        agglomeration=cfg_mod.AgglomerationConfig(
            partitioner=partitioner, nx=block, ny=block, nz=block,
            n_agglomerates=n_agglomerates),
        coarse=cfg_mod.CoarseConfig(type="direct"))


def rhs(problem, seed=0):
    """Uniform float32 right-hand side, zero at the constrained dofs
    (Dirichlet and hanging), so that the slaves of the solution stay 0."""
    b = np.random.default_rng(seed).uniform(size=problem.n_dofs)
    b = b.astype(np.float32)
    b[problem.constrained] = 0.0
    return b


def compare_hierarchies(j_mesh, t_mesh, jcfg, tcfg, **cfg_kw):
    """Both packages' hierarchies on the same mesh: float64 level shapes and
    V-cycle rate, float32 PCG counts on the same right-hand side.  Returns
    the port's float32 solution and its problem."""
    import torch

    from mfmg_tpu import Hierarchy as JHierarchy
    from mfmg_tpu import LaplaceProblem as JLaplace
    from mfmg_tpu.amge.hierarchy import measure_vcycle_rate as j_rate
    from mfmg_torch import Hierarchy as THierarchy
    from mfmg_torch import LaplaceProblem as TLaplace
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate as t_rate

    jp, tp = JLaplace.from_mesh(j_mesh, "linear"), TLaplace.from_mesh(t_mesh, "linear")
    jh = JHierarchy(jp, unstructured_config(jcfg, "float64", **cfg_kw))
    th = THierarchy(tp, unstructured_config(tcfg, "float64", **cfg_kw),
                    device="cpu")
    assert th._A_shapes == jh._A_shapes
    assert th.setup_route == "host"
    j_r, t_r = j_rate(jh), t_rate(th)
    assert abs(t_r - j_r) <= RATE_TOL, (t_r, j_r)

    jh = JHierarchy(jp, unstructured_config(jcfg, "float32", **cfg_kw))
    th = THierarchy(tp, unstructured_config(tcfg, "float32", **cfg_kw),
                    device="cpu")
    b = rhs(tp)
    _, j_info = jh.solve_cg(b, tol=PCG_TOL, maxiter=50)
    x, t_info = th.solve_cg(torch.from_numpy(b), tol=PCG_TOL, maxiter=50)
    assert t_info["iterations"] == int(j_info["iterations"])
    assert t_info["relres"] <= PCG_TOL
    return x.numpy(), tp, th
