"""Rank functions of the distribution tests (not a pytest module).

Run by ``mfmg_torch.parallel.launch`` in spawned ranks of a gloo group on
the CPU; each imports only mfmg_torch, numpy and torch (the parent test
computes mfmg_tpu's numbers in-process and compares).  One world per size
computes every case of that size: ``spmd_world`` the sharded V-cycles,
``setup_world`` the distributed setup.  The CPU worlds take one intra-op
thread per rank: the tier-1 command already runs six test workers.
"""

import dataclasses
import types

import numpy as np
import torch


def _levels(case):
    from mfmg_torch.amge.hierarchy import levels_from_arrays
    return levels_from_arrays(case["arrays"], case["meta"], device="cpu")


def _carried(case):
    """A hierarchy of the reference's levels carried across (levels and the
    config the sharded cycle reads)."""
    from mfmg_torch.config import Config
    return types.SimpleNamespace(levels=_levels(case), config=Config())


def _spmd_out(mesh, hier, case):
    from mfmg_torch.parallel.spmd import build_spmd_vcycle
    sv = build_spmd_vcycle(hier, mesh, case.get("mesh_shape"))
    b, x = (torch.from_numpy(case[k]) for k in ("b", "x0"))
    return sv.from_grid(sv.fn(sv.to_grid(b), sv.to_grid(x))).numpy()


def _rate(mesh, hier, case, n_cycles=12):
    """tests/test_spmd.py's rate of the sharded V-cycle from x0 with b = 0:
    the residual of the fine operator on the gathered iterate, the iterate
    renormalized every cycle."""
    from mfmg_torch.parallel.spmd import build_spmd_vcycle
    sv = build_spmd_vcycle(hier, mesh, case.get("mesh_shape"))
    op = hier.levels[0].op
    x = torch.from_numpy(case["x0"])
    bg = sv.to_grid(torch.zeros_like(x))
    res_prev = rate = None
    for _ in range(n_cycles):
        x = sv.from_grid(sv.fn(bg, sv.to_grid(x)))
        res = float(torch.linalg.norm(op(x)))
        if res_prev:
            rate = res / res_prev
        nrm = float(torch.linalg.norm(x))
        x, res_prev = x / nrm, res / nrm
    return rate


def _row_sharded(mesh, levels, case):
    from mfmg_torch.amge.hierarchy import vcycle
    from mfmg_torch.parallel.sharding import (gather_vector, shard_hierarchy,
                                              shard_vector, unpad_vector)
    sharded = shard_hierarchy(levels, mesh)
    b, x = (shard_vector(mesh, torch.from_numpy(case[k])) for k in ("b", "x0"))
    out = vcycle(sharded, b, x, n_smoothing_steps=1, is_preconditioner=False)
    return unpad_vector(gather_vector(mesh, out), len(case["b"])).numpy()


def spmd_world(mesh, cases):
    """{case name: result} for every case of this world size.  kinds:
    "spmd" (the reference's levels carried across), "own" (a hierarchy the
    port built and saved, loaded here), "rate", "ell" / "mf" (the
    row-sharded hierarchy of carried ELL levels / of a saved matrix-free
    hierarchy)."""
    from mfmg_torch import Hierarchy
    torch.set_num_threads(1)
    out = {}
    for case in cases:
        kind = case["kind"]
        if kind == "spmd":
            out[case["name"]] = _spmd_out(mesh, _carried(case), case)
        elif kind == "own":
            out[case["name"]] = _spmd_out(
                mesh, Hierarchy.load(case["path"], device="cpu"), case)
        elif kind == "rate":
            out[case["name"]] = _rate(mesh, _carried(case), case)
        elif kind == "ell":
            out[case["name"]] = _row_sharded(mesh, _levels(case), case)
        elif kind == "mf":
            out[case["name"]] = _row_sharded(
                mesh, Hierarchy.load(case["path"], device="cpu").levels, case)
    out["stats"] = dict(mesh.stats)
    return out


def setup_world(mesh, cfg_dict, b, x0):
    """The distributed setup against the replicated one in this world
    (tests/_multiproc_worker.py:80-110): slab facts, the gaps of R and of
    A_c at levels 1 and 2, both rates, and the distributed hierarchy's
    slab-sharded (and, in a world of 4, (2, 2) pencil) V-cycle against the
    replicated hierarchy's single-process V-cycle."""
    from mfmg_torch import Hierarchy, LaplaceProblem
    from mfmg_torch.amge.hierarchy import measure_vcycle_rate, vcycle
    from mfmg_torch.utils.serialize import config_from_dict

    torch.set_num_threads(1)
    cfg = config_from_dict(cfg_dict)
    prob = LaplaceProblem.hyper_cube(3, 3, material_property="linear")
    h3 = Hierarchy(prob, cfg, device="cpu")
    hd = Hierarchy(prob, dataclasses.replace(cfg, distributed_setup=True),
                   device="cpu")
    batch_slab, agg_sels = hd._dist_slab
    out = dict(
        distributed=hd._distributed(), slab_n_agg=batch_slab.n_agg,
        n_agg=hd._level0_eigendata[0].n_agg, n_sels=len(agg_sels),
        light=hd._level0_eigendata[0].A_agg is None,
        route=hd.setup_route,
        R_shapes=(h3._R_composed.shape, hd._R_composed.shape),
        dR=float(abs(h3._R_composed - hd._R_composed).max()),
        dA=[float(abs(h3._A_per_level[lv] - hd._A_per_level[lv]).max())
            for lv in (1, 2)],
        rates=(measure_vcycle_rate(h3, n_cycles=10, seed=0),
               measure_vcycle_rate(hd, n_cycles=10, seed=0)))
    # each rank's super-aligned slab eigensolved and gathered to every rank
    from mfmg_torch.amge.agglomeration import build_agglomerates
    from mfmg_torch.amge.local_problems import build_agglomerate_batch
    from mfmg_torch.amge.multilevel import group_agglomerates
    from mfmg_torch.parallel import dist_setup
    ids = build_agglomerates(prob.mesh, cfg.agglomeration)
    sup, _ = group_agglomerates(prob.mesh, ids, cfg.agglomeration.block_dims(3))
    agg_sel, _, _, agg_sels = dist_setup.super_partition(sup)
    slab = build_agglomerate_batch(prob.mesh, prob.A_loc, ids, agg_range=agg_sel)
    evals, evecs = dist_setup.distributed_eigensolve(
        slab, agg_sels, int(ids.max()) + 1, h3._eigensolve)
    full = h3._eigensolve(build_agglomerate_batch(prob.mesh, prob.A_loc, ids))
    out["eig_gap"] = max(float(np.abs(a - np.asarray(f)).max())
                         for a, f in zip((evals, evecs), full))
    ref = vcycle(h3.levels, torch.from_numpy(b), torch.from_numpy(x0),
                 n_smoothing_steps=1, is_preconditioner=False).numpy()
    case = dict(b=b, x0=x0)
    out["ref"] = ref
    out["slab"] = _spmd_out(mesh, hd, case)
    if mesh.size == 4:
        out["pencil"] = _spmd_out(mesh, hd, dict(case, mesh_shape=(2, 2)))
    return out


def card_world(mesh, path, b, x0):
    """The sharded V-cycle of a saved hierarchy on mesh.device: the
    gathered output and the kernel launches of one cycle."""
    from mfmg_torch import Hierarchy
    from mfmg_torch.ops import cuda_library as cl
    from mfmg_torch.parallel.spmd import build_spmd_vcycle
    sv = build_spmd_vcycle(Hierarchy.load(path, device="cpu"), mesh)
    bg, xg = sv.to_grid(b), sv.to_grid(x0)
    cl.reset_launch_counts()
    y = sv.fn(bg, xg)
    launches = {k: v for k, v in cl.LAUNCHES.items() if v}
    return dict(out=sv.from_grid(y).cpu().numpy(), launches=launches)
