"""The plain reference against mfmg_torch on small meshes: its own meshes
are the port's (found through the map of dofs, whatever their numbering),
its operator is the port's assembled, Dirichlet-eliminated A, its readings
of the port's meshes are 0 and catch a broken one, and the judges read what
the answers say."""

import math

import numpy as np
import pytest
import torch

from mfmg_torch.fem.laplace import LaplaceProblem
from mfmg_torch.fem.mesh import hyper_ball
from portbench.reference.fem import Problem
from portbench.reference.judge import decide
from portbench.requests.solve import true_relres
from portbench.requests.vmult import energy_error, linearity_gap

PROBLEMS = {
    "cube_9": (lambda: LaplaceProblem.hyper_cube(3, 3, material_property="linear"),
               "hyper_cube_q1", 3, "linear"),
    "ball_1": (lambda: LaplaceProblem.from_mesh(hyper_ball(3, 1), "linear"),
               "hyper_ball_q1", 1, "linear"),
    "ball_2_constant": (lambda: LaplaceProblem.from_mesh(hyper_ball(3, 2), "constant"),
                        "hyper_ball_q1", 2, "constant"),
}


def reference_of(name, nodes=None, flags=None):
    build, module, n_ref, material = PROBLEMS[name]
    prob = build()
    cfg = {"reference": module, "material_property": {"type": material}}
    nodes = prob.mesh.nodes if nodes is None else nodes
    flags = prob.constrained if flags is None else flags
    return prob, Problem(cfg, n_ref, nodes, flags, "cpu")


@pytest.mark.parametrize("name", PROBLEMS)
def test_operator_equals_the_ports_A(name):
    prob, ref = reference_of(name)
    A = prob.A
    scale = abs(A).max()
    assert ref.op.n == A.shape[0] and ref.op.assembled().nnz == A.nnz
    x = np.random.default_rng(3).standard_normal((prob.n_dofs, 2))
    y = ref.to_program(ref.op.apply(ref.to_ref(torch.from_numpy(x)))).numpy()
    assert np.abs(y - A @ x).max() <= 1e-12 * scale * np.abs(x).max()
    assert ref.op.det_min > 0


@pytest.mark.parametrize("name", PROBLEMS)
def test_readings_of_the_ports_mesh_are_zero(name):
    _, ref = reference_of(name)
    r = ref.readings
    assert r["mesh_node_gap"] <= 1e-14
    assert all(r[k] == 0 for k in r if k != "mesh_node_gap")


@pytest.mark.parametrize("name", ["cube_9", "ball_1"])
def test_readings_catch_a_broken_mesh(name):
    prob, _ = reference_of(name)
    nodes, flags = prob.mesh.nodes, prob.constrained
    interior = np.flatnonzero(~flags)[len(np.flatnonzero(~flags)) // 2]
    moved = nodes.copy()
    moved[interior] += 1e-3
    assert reference_of(name, nodes=moved)[1].readings["mesh_node_gap"] > 9e-4
    twice = nodes.copy()
    twice[interior] = nodes[interior - 1]
    r = reference_of(name, nodes=twice)[1]
    assert r.readings["mesh_numbering_defect"] == 2 and r.to_ref(torch.ones(1)) is None
    wrong = flags.copy()
    wrong[interior] = True
    assert reference_of(name, flags=wrong)[1].readings["mesh_boundary_mismatch"] == 1


def test_another_numbering_is_mapped():
    prob, _ = reference_of("ball_1")
    perm = np.random.default_rng(1).permutation(prob.n_dofs)
    _, ref = reference_of("ball_1", nodes=prob.mesh.nodes[perm],
                          flags=prob.constrained[perm])
    assert all(v <= 1e-14 for v in ref.readings.values())
    x = np.random.default_rng(2).standard_normal(prob.n_dofs)
    y = ref.to_program(ref.op.apply(ref.to_ref(torch.from_numpy(x[perm]))))
    assert np.abs(y.numpy() - (prob.A @ x)[perm]).max() <= 1e-12 * abs(prob.A).max()


def test_judges_and_decide():
    prob, ref = reference_of("cube_9")
    A = prob.A.toarray()
    b = np.random.default_rng(0).uniform(size=prob.n_dofs)
    b[prob.constrained] = 0
    x = np.linalg.solve(A, b)
    B = torch.from_numpy(np.stack([b, b], 1))
    X = torch.from_numpy(np.stack([x, 1.001 * x], 1))
    rel = true_relres(ref.op, B, X)
    assert rel[0] < 1e-13 and abs(rel[1] - 1e-3) < 1e-6
    err = energy_error(ref.op, X, torch.from_numpy(np.stack([x, 0 * x], 1)))
    assert err[0] == 0 and abs(err[1] - 1) < 1e-14
    M = np.linalg.inv(A)
    R = np.random.default_rng(4).standard_normal((prob.n_dofs, 2))
    R = np.concatenate([R, R.sum(1, keepdims=True)], axis=1)   # a group of three
    Y = torch.from_numpy(M @ R)
    assert linearity_gap(ref.op, Y, [0, 1, 2]) < 1e-12
    Y[:, 2] *= 1 + 1e-3
    assert abs(linearity_gap(ref.op, Y, [0, 1, 2]) - 1e-3 / (1 + 1e-3)) < 1e-9
    assert math.isnan(linearity_gap(ref.op, Y, [0, 1, 3]))
    ok, compared = decide({"true_relres_max": max(rel)},
                          {"true_relres_max": {"limit": 3e-4}})
    assert not ok and compared["true_relres_max"]["limit"] == 3e-4
    assert not decide({}, {"x": {"limit": 1}})[0]
    assert not decide({"x": float("nan")}, {"x": {"limit": 1}})[0]
