"""The port's sharded V-cycles (mfmg_torch/parallel/spmd.py, sharding.py)
against mfmg_tpu on the CPU, in float64, over gloo.

Counterparts of every case of tests/test_spmd.py, on the reference's
meshes and seeds: the reference's levels are carried across
(levels_from_arrays), so both packages cycle the same hierarchy, and the
ranks' gathered output is held at the reference's tolerances against
mfmg_tpu's single-device ``vcycle`` (and, for the slabs, against its own
``build_spmd_vcycle`` at the same P):

- slabs at P = 2, 4, 8 (1e-12 x max|ref|), the rate over 12 cycles at P = 4
  (rel 1e-8), three levels at P = 2 and 8, 2-D at P = 2 and 4, pencils
  (2, 2), (4, 2), (2, 4) and three levels on (2, 2);
- the row-sharded ELL V-cycle at P = 4 (atol 1e-12);
- beside them, hierarchies the port built itself and saved (Hierarchy.save),
  loaded by the ranks: a three-level stencil hierarchy on slabs and pencils,
  and the row-sharded matrix-free hierarchy, against the port's own
  single-process V-cycle.

One world of spawned ranks per size (tests/_torch_spmd_worker.py) computes
every case of that size.  The guards raise the reference's errors, and a
CUDA device or NCCL is refused on a host without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfmg_tpu.config as jcfg
import mfmg_torch.config as tcfg
from mfmg_tpu import Hierarchy as JHierarchy
from mfmg_tpu import LaplaceProblem as JLaplace
from mfmg_tpu.amge.hierarchy import vcycle as j_vcycle
from mfmg_tpu.parallel.spmd import build_spmd_vcycle as j_build_spmd
from mfmg_tpu.solve.operator import apply_op as j_apply_op
from mfmg_torch import Hierarchy as THierarchy
from mfmg_torch import LaplaceProblem as TLaplace
from mfmg_torch.amge.hierarchy import vcycle as t_vcycle
from mfmg_torch.parallel import launch
from mfmg_torch.parallel.process import Mesh
from mfmg_torch.parallel.spmd import build_spmd_vcycle

from _torch_carry import flatten_levels
from _torch_spmd_worker import spmd_world

SLAB_TOL = 1e-12          # x max|ref| (the reference's test_spmd.py bounds)
RATE_TOL = 1e-8
ELL_ATOL = 1e-12
WORLD_TIMEOUT = 240


def _config(cfg, **kw):
    agg = dict(nx=2, ny=2, nz=2) if kw.pop("dim", 3) == 3 else dict(nx=2, ny=2)
    return cfg.Config(dtype="float64", is_preconditioner=False,
                      smoother=cfg.SmootherConfig(type="chebyshev", degree=2),
                      agglomeration=cfg.AgglomerationConfig(**agg),
                      **{"operator": "stencil", **kw})


def _rhs(n_dofs, constrained, seed):
    rng = np.random.default_rng(seed)
    b = rng.uniform(size=n_dofs)
    b[constrained] = 0.0
    x0 = rng.uniform(size=n_dofs)
    x0[constrained] = 0.0
    return b, x0


def _j_ref(jh, b, x0):
    return np.asarray(j_vcycle(jh.levels, jnp.asarray(b), jnp.asarray(x0),
                               n_smoothing_steps=1, is_preconditioner=False))


def _j_spmd(jh, b, x0, n):
    sv = j_build_spmd(jh, n_devices=n)
    return sv.from_grid(sv.fn(sv.to_grid(b), sv.to_grid(x0)))


def _j_rate(jh, x0):
    """tests/test_spmd.py's single-device rate over 12 cycles, b = 0."""
    op = jh.levels[0].op
    zero = jnp.zeros_like(jnp.asarray(x0))
    x, res_prev, rate = x0, None, None
    for _ in range(12):
        x = j_vcycle(jh.levels, zero, jnp.asarray(x), n_smoothing_steps=1,
                     is_preconditioner=False)
        res = float(jnp.linalg.norm(j_apply_op(op, jnp.asarray(x))))
        if res_prev:
            rate = res / res_prev
        nrm = float(np.linalg.norm(np.asarray(x)))
        x, res_prev = np.asarray(x) / nrm, res / nrm
    return rate


# (name, world size, kind, setup, seed, mesh_shape): the setups are
# "3d" (hyper_cube(3, 3), two levels), "3d3" (three levels), "2d"
# (hyper_cube(2, 5)) and "ell" (operator="ell")
CASES = [
    ("slab", 2, "spmd", "3d", 0, None),
    ("slab", 4, "spmd", "3d", 0, None),
    ("slab", 8, "spmd", "3d", 0, None),
    ("rate", 4, "rate", "3d", 0, None),
    ("multilevel", 2, "spmd", "3d3", 1, None),
    ("multilevel", 8, "spmd", "3d3", 1, None),
    ("2d", 2, "spmd", "2d", 2, None),
    ("2d", 4, "spmd", "2d", 2, None),
    ("pencil", 4, "spmd", "3d", 3, (2, 2)),
    ("pencil", 8, "spmd", "3d", 3, (4, 2)),
    ("pencil_t", 8, "spmd", "3d", 3, (2, 4)),
    ("pencil_multilevel", 4, "spmd", "3d3", 4, (2, 2)),
    ("ell", 4, "ell", "ell", 0, None),
    ("own_slab", 2, "own", "3d3", 1, None),
    ("own_pencil", 4, "own", "3d3", 4, (2, 2)),
    ("mf", 4, "mf", "mf", 0, None),
]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """mfmg_tpu's hierarchies, levels flattened for the ranks, and its
    outputs; the port's own saved hierarchies with their V-cycles."""
    tmp = tmp_path_factory.mktemp("spmd")
    probs = {"3d": (3, 3), "3d3": (3, 3), "2d": (2, 5), "ell": (3, 3),
             "mf": (3, 3)}
    extra = {"3d3": dict(max_levels=3), "2d": dict(dim=2),
             "ell": dict(operator="ell"), "mf": dict(operator="matrix_free")}
    setups = {}
    for key, (dim, n_ref) in probs.items():
        jp = JLaplace.hyper_cube(dim, n_ref, material_property="linear")
        s = dict(constrained=jp.constrained, n_dofs=jp.n_dofs)
        if key != "mf":
            s["jh"] = JHierarchy(jp, _config(jcfg, **extra.get(key, {})))
            s["arrays"], s["meta"] = flatten_levels(s["jh"].levels)
        if key in ("3d3", "mf"):
            th = THierarchy(TLaplace.hyper_cube(dim, n_ref,
                                                material_property="linear"),
                            _config(tcfg, **extra[key]), device="cpu")
            s["path"] = str(tmp / f"{key}.pt")
            th.save(s["path"])
            s["th"] = th
        setups[key] = s
    worlds, expect = {}, {}
    for name, n, kind, key, seed, shape in CASES:
        s = setups[key]
        b, x0 = _rhs(s["n_dofs"], s["constrained"], seed)
        case = dict(name=name, kind=kind, b=b, x0=x0, mesh_shape=shape)
        if kind in ("spmd", "rate", "ell"):
            case.update(arrays=s["arrays"], meta=s["meta"])
        else:
            case["path"] = s["path"]
        worlds.setdefault(n, []).append(case)
        if kind == "rate":
            expect[name, n] = _j_rate(s["jh"], x0)
        elif kind in ("own", "mf"):
            expect[name, n] = t_vcycle(
                s["th"].levels, torch.from_numpy(b), torch.from_numpy(x0),
                n_smoothing_steps=1, is_preconditioner=False).numpy()
        else:
            expect[name, n] = _j_ref(s["jh"], b, x0)
            if name == "slab":
                expect["reference spmd", n] = _j_spmd(s["jh"], b, x0, n)
    return worlds, expect


@pytest.fixture(scope="module")
def results(reference):
    worlds, _ = reference
    out = {}
    for n, cases in sorted(worlds.items()):
        ranks = launch(spmd_world, n, args=(cases,), device="cpu",
                       timeout=WORLD_TIMEOUT)
        for r in ranks[1:]:
            for case in cases:
                np.testing.assert_array_equal(np.asarray(r[case["name"]]),
                                              np.asarray(ranks[0][case["name"]]))
        out.update({(name, n): v for name, v in ranks[0].items()})
    return out


def _check(results, reference, name, n, tol=SLAB_TOL):
    _, expect = reference
    ref = expect[name, n]
    got = results[name, n]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_slabs_match_the_reference(results, reference, n):
    """Slabs at P = n against mfmg_tpu's single-device V-cycle and its own
    sharded one at the same P."""
    _check(results, reference, "slab", n)
    ref_spmd = reference[1]["reference spmd", n]
    np.testing.assert_allclose(results["slab", n], ref_spmd, rtol=0,
                               atol=SLAB_TOL * np.abs(ref_spmd).max())


def test_rate_matches_the_reference(results, reference):
    assert results["rate", 4] == pytest.approx(reference[1]["rate", 4],
                                               rel=RATE_TOL)


@pytest.mark.parametrize("name,n", [("multilevel", 2), ("multilevel", 8),
                                    ("2d", 2), ("2d", 4), ("pencil", 4),
                                    ("pencil", 8), ("pencil_t", 8),
                                    ("pencil_multilevel", 4)])
def test_sharded_cycles_match_the_reference(results, reference, name, n):
    """Three levels on slabs, 2-D slabs, and the (2, 2), (4, 2), (2, 4)
    pencils (three levels on (2, 2))."""
    _check(results, reference, name, n)


def test_row_sharded_ell_matches_the_reference(results, reference):
    ref = reference[1]["ell", 4]
    np.testing.assert_allclose(results["ell", 4], ref, rtol=0, atol=ELL_ATOL)


@pytest.mark.parametrize("name,n", [("own_slab", 2), ("own_pencil", 4),
                                    ("mf", 4)])
def test_saved_hierarchies_shard_like_one_process(results, reference, name, n):
    """The port's own hierarchies, saved and loaded by every rank: a
    three-level stencil hierarchy on slabs and (2, 2) pencils, and the
    row-sharded matrix-free hierarchy, against the port's single-process
    V-cycle."""
    _check(results, reference, name, n)


def test_halo_exchanges_per_vcycle(results):
    """Five applies, one restriction and one prolongation: seven exchanges
    per sharded axis and V-cycle (the world of two runs four slab
    cycles)."""
    assert results["stats", 2]["exchanges"] == 4 * 7
    assert results["stats", 2]["halo_bytes"] > 0


def _fake_mesh(shape, size):
    return Mesh(shape=tuple(shape), coords=(0,) * len(shape), rank=0,
                size=size, device=torch.device("cpu"), backend="gloo")


def test_guards_raise_the_reference_errors():
    """A non-stencil operator, a non-direct coarse solve and bad mesh shapes
    raise the reference's errors, before any collective."""
    def both(kw, j_kwargs, t_shape, size, match):
        tp = TLaplace.hyper_cube(3, 2, material_property="linear")
        jp = JLaplace.hyper_cube(3, 2, material_property="linear")
        th = THierarchy(tp, _config(tcfg, **kw(tcfg)), device="cpu")
        jh = JHierarchy(jp, _config(jcfg, **kw(jcfg)))
        with pytest.raises(ValueError, match=match):
            j_build_spmd(jh, **j_kwargs)
        with pytest.raises(ValueError, match=match):
            build_spmd_vcycle(th, _fake_mesh(t_shape, size))

    both(lambda c: dict(operator="ell"), dict(n_devices=2), (2,), 2,
         "needs the stencil operator")
    both(lambda c: dict(coarse=c.CoarseConfig(type="cg")), dict(n_devices=2),
         (2,), 2, "needs the direct coarse solver")
    tp = TLaplace.hyper_cube(3, 2, material_property="linear")
    jp = JLaplace.hyper_cube(3, 2, material_property="linear")
    th = THierarchy(tp, _config(tcfg), device="cpu")
    jh = JHierarchy(jp, _config(jcfg))
    with pytest.raises(ValueError, match="must shard 1..min"):
        j_build_spmd(jh, n_devices=8, mesh_shape=(2, 2, 2))
    with pytest.raises(ValueError, match="must shard 1..min"):
        build_spmd_vcycle(th, _fake_mesh((2, 2, 2), 8))
    with pytest.raises(ValueError, match="does not match the device count"):
        j_build_spmd(jh, n_devices=2, mesh_shape=(3,))
    with pytest.raises(ValueError, match="does not match the device count"):
        build_spmd_vcycle(th, _fake_mesh((2,), 2), mesh_shape=(3,))


def test_no_cuda_no_nccl_without_a_card():
    """A world on the card needs the card, and NCCL needs a card per rank:
    both raise before any rank starts, and nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(spmd_world, 2, args=([],), device="cuda")
    with pytest.raises(ValueError, match="nccl"):
        launch(spmd_world, 2, args=([],), backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        launch(spmd_world, 2, args=([],), backend="nccl", device="cuda")
