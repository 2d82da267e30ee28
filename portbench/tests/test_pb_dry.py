"""Rehearsals of a run on the CPU (``--dry``: the configuration's small
size): the control flow of set-up, warm-up, window and check for every cell,
traced and not; the run without a card refusing to measure; and the check
failing a run whose timed path is broken underneath (faults.py), and the
control."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import core
from portbench.core import ROOT, Cell, load_json

SPEC = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


def dry_run(capsys, cell, trace=0, seconds=1.0, seed=2**31 + 11):
    rc = core.main(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace), "--dry"])
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    return result, err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(capsys, cell, trace):
    result, err = dry_run(capsys, cell, trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1 and result["metrics"] == {}
    assert list(result)[-1] == "compared"
    c = Cell(SPEC, cell)
    wanted = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    # on the CPU only the host-clock and counter readings exist
    assert set(result["rehearsal"]) <= wanted
    for m in (c.per_layer if trace else c.end_to_end):
        if m["source"] in ("host_clock", "program_counter"):
            assert m["name"] in result["rehearsal"]
    last = err.strip().splitlines()[-len(result["compared"]):]
    assert all(line.startswith("compared ") for line in last)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for a machine without one")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(capsys, cell, fault):
    """A run whose timed path answers with a planted fault comes out not
    correct, by one of the cell's numbers at least."""
    from portbench import faults
    with faults.planted(Cell(SPEC, cell).traffic["request"], fault):
        result, _ = dry_run(capsys, cell)
    assert result["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in result["compared"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(capsys, cell):
    """The reference's CG in bfloat16 in the program's place comes out not
    correct by the run's own comparison; the program, and the reference's
    CG in float32, come out correct."""
    from portbench import control
    control.main(["--workload", cell, "--seeds", "7", "--seconds", "1.0",
                  "--dry"])
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()
             if s.startswith("{")]
    by = {r.get("side"): r for r in lines}
    assert by["program"]["correct"] is True
    assert by["control bfloat16"]["correct"] is False
    assert by["control float32"]["correct"] is True


@pytest.mark.cuda
def test_profiler_reads_the_card(card):
    """On the card the profiled stretch of a small hierarchy's V-cycles has
    device operations, a busy time inside its wall time, and the per-call
    device time the V-cycle metric reads."""
    from portbench.system import System
    from portbench.trace import device_ms_per_call, profile
    cfg = load_json(ROOT / "portbench" / "configs" / "cube_q1_129.json")
    system = System(cfg, card, 5)
    b = torch.rand(system.n, device=card)
    p = profile(lambda: system.hier.vmult(b), 10)
    assert p.device and 0 < p.busy_s <= p.wall_s * 1.05
    assert p.device_ops() and p.idle_gaps()
    assert device_ms_per_call(lambda: system.hier.vmult(b), 5) > 0
