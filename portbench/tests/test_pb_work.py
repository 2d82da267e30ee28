"""The frozen yardstick against hand counts at the cells' shapes, and its
sizes against the program's own hierarchy at small ones."""

import pytest

from portbench import work
from portbench.system import program_config
from portbench.core import ROOT, load_json


def test_peaks_and_bound():
    assert work.HBM_BYTES_PER_S == 3.35e12 and work.F32_FLOPS == 67e12
    assert work.bound(3.35e12, 1.0) == (1.0, "bytes")
    assert work.bound(1.0, 134e12) == (2.0, "operations")


def test_cube_129_sizes_by_hand():
    s = work.cube_levels(7, 4, 2, 4)
    # 129^3 nodes; 127^3 interior nodes, each with its (3 * 127 - 2)^3 pairs
    assert s["n0"] == 2_146_689
    assert s["a0_nnz"] == 379 ** 3 + (2_146_689 - 127 ** 3) == 54_538_245
    # 32^3 agglomerates x 2, 8^3 supers x 4; 94^3 block pairs of 2 x 2
    assert (s["n1"], s["n2"]) == (65_536, 2_048)
    assert s["a1_nnz"] == 830_584 * 4 == 3_322_336
    assert s["r1_nnz"] == 65_536 * 4


def test_k2_work_at_129_by_hand():
    half = (54_538_245 + 2_146_689) // 2
    assert half == 28_342_467
    pre = work.k2_work(2_146_689, half, 54_538_245, 2, True, 2, 4)
    post = work.k2_work(2_146_689, half, 54_538_245, 2, False, 2, 4)
    assert pre == (56_684_934 + 42_933_780, 327_229_470 + 34_347_024)
    assert post == (56_684_934 + 34_347_024, 218_152_980 + 34_347_024)
    assert work.bound(*pre)[1] == "bytes"


def test_tail_work_at_129_by_hand():
    b, f = work.tail_subcycle_work(65_536, 2_048, 3_322_336, 262_144, 2, 1, 2, 4)
    # (A_1's upper triangle 1,693,936 + R_1 262,144 + inv 2,098,176) x 2 B,
    # invd, b1 and x1 at 4 B
    assert b == 4_054_256 * 2 + 3 * 65_536 * 4 == 8_894_944
    # 4 applies of A_1, restriction and prolongation, the coarse gemv
    assert f == 4 * 2 * 3_322_336 + 4 * 262_144 + 2 * 2_048 ** 2 == 36_015_872
    assert work.bound(b, f)[1] == "bytes"


def test_ell_work_by_hand():
    assert work.ell_work(10, 4, 5, 4, 4, 4) == (10 * 8 + 9 * 4, 20)


@pytest.mark.parametrize("n_ref", [1, 2])
def test_mesh_operator_nnz_is_the_ports(n_ref):
    from mfmg_torch.fem.laplace import LaplaceProblem
    from mfmg_torch.fem.mesh import hyper_ball
    prob = LaplaceProblem.from_mesh(hyper_ball(3, n_ref), "linear")
    assert work.mesh_operator_nnz(prob.mesh.cells, prob.constrained) == prob.A.nnz


def test_mesh_operator_nnz_at_the_ball_cell():
    from mfmg_torch.fem.laplace import LaplaceProblem
    from mfmg_torch.fem.mesh import hyper_ball
    prob = LaplaceProblem.from_mesh(hyper_ball(3, 5), "linear")
    assert prob.n_dofs == 232_609
    assert work.mesh_operator_nnz(prob.mesh.cells, prob.constrained) == prob.A.nnz


@pytest.mark.parametrize("n_ref", [3, 4])
def test_cube_stencil_nnz_is_the_ports(n_ref):
    from mfmg_torch.fem.laplace import LaplaceProblem
    prob = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear")
    assert work.cube_stencil_nnz(2 ** n_ref + 1) == prob.A.nnz


@pytest.mark.parametrize("n_ref", [4, 5])
def test_cube_levels_are_the_ports(n_ref):
    from mfmg_torch.amge.hierarchy import Hierarchy
    from mfmg_torch.fem.laplace import LaplaceProblem
    cfg = load_json(ROOT / "portbench" / "configs" / "cube_q1_129.json")
    prob = LaplaceProblem.hyper_cube(3, n_ref, material_property="linear")
    hier = Hierarchy(prob, program_config(cfg), device="cpu")
    s = work.cube_levels(n_ref, 4, 2, 4)
    assert [int(lv.op.shape[0]) for lv in hier.levels] == [s["n0"], s["n1"], s["n2"]]
    assert hier._A_per_level[1].nnz == s["a1_nnz"]
