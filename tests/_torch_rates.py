"""Shared pieces of the golden-rate parity tests (tests/test_torch_
gauss_seidel.py, test_torch_matrix_free.py, test_torch_orderings.py): the
reference's goldens, the configuration of tests/test_hierarchy.py
``_cfg_3d`` for either package, and one rate comparison.

Each golden is held on the port's rate at the reference test's tolerance,
and the port's rate against mfmg_tpu's on the same problem and
configuration at RATE_TOL (float64 hierarchies of both packages: the same
LAPACK calls on the same batches, applies summed in another order).
"""

GOLDEN_MF_CHEBYSHEV_3D = 0.0880045475   # test_hierarchy.cc:353
GOLDEN_MATRIX_SGS_3D = 0.0235237332     # test_hierarchy.cc:343
RATE_TOL = 1e-10


def cfg_3d(cfg_mod, **kw):
    """tests/test_hierarchy.py _cfg_3d: standalone V-cycles, the "lapack"
    eigensolver with 2 eigenvectors, 2x2x2 block agglomerates."""
    base = dict(is_preconditioner=False,
                eigensolver=cfg_mod.EigensolverConfig(type="lapack",
                                                      n_eigenvectors=2),
                agglomeration=cfg_mod.AgglomerationConfig(nx=2, ny=2, nz=2))
    base.update(kw)
    return cfg_mod.Config(**base)


def both_rates(jprob, tprob, make_config, n_cycles=20):
    """(port rate, mfmg_tpu rate) of the hierarchies make_config(cfg_mod)
    builds on the same problem in each package (the port on the CPU)."""
    import mfmg_tpu.config as jcfg
    import mfmg_torch.config as tcfg
    from mfmg_tpu import Hierarchy as JHierarchy
    from mfmg_tpu.amge.hierarchy import measure_vcycle_rate as j_rate
    from mfmg_torch import Hierarchy as THierarchy
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate as t_rate

    t = t_rate(THierarchy(tprob, make_config(tcfg), device="cpu"), n_cycles)
    j = j_rate(JHierarchy(jprob, make_config(jcfg)), n_cycles)
    return t, j
