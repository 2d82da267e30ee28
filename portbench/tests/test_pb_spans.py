"""The readers of the program's spans (spans.py): on a hand-made stretch,
each reading and the device's idle time by innermost span; on the CPU, at
the rehearsal's size, every new reader reads None and leaves the program's
tracing off, while the host stretch itself holds the program's spans; a
stretch whose spans the program's buffer dropped reads None."""

import types

import pytest
import torch

from mfmg_torch.utils import trace
from mfmg_torch.utils.trace import Span
from portbench import core, spans
from portbench.core import ROOT, Cell, load_json
from portbench.loadgen import run

SPEC = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
SPAN_METRICS = [m["name"] for m in SPEC["per_layer"]
                if (ROOT / "portbench" / "metrics" / f"{m['name']}.py")
                .read_text().count("from portbench import spans")]


def hand_stretch():
    """One solve of 100 ns in a stretch of 120: b's norm, a V-cycle with an
    ELL apply inside its restriction and a prolongation, the loop's test;
    four device operations, one of them with no launch."""
    s = [Span("solve", 0, 100, -1, 1), Span("sync", 0, 5, 0, 1),
         Span("vcycle", 10, 60, 0, 1), Span("L0.restrict", 20, 30, 2, 1),
         Span("ell.apply", 22, 28, 3, 1), Span("L0.prolong", 40, 50, 2, 1),
         Span("sync", 70, 90, 0, 1)]
    device = [(25, 35, "k1", 23), (45, 55, "k2", 41), (60, 80, "k3", 15),
              (100, 101, "k4", None)]
    return spans.Stretch(1, 0, 120, s, {}, device)


def hand_ctx(stages=None):
    st = hand_stretch()
    hier = types.SimpleNamespace(setup_seconds=stages or {})
    return types.SimpleNamespace(cuda=True, notes={}, _spans={"host": st, "device": st},
                                 system=types.SimpleNamespace(hier=hier))


def test_innermost_segments_and_idle_by_span():
    st = hand_stretch()
    segs = spans.innermost(st.spans, st.t0, st.t1)
    assert [(a, b, st.spans[i].name if i >= 0 else None) for a, b, i in segs] == [
        (0, 5, "sync"), (5, 10, "solve"), (10, 20, "vcycle"),
        (20, 22, "L0.restrict"), (22, 28, "ell.apply"), (28, 30, "L0.restrict"),
        (30, 40, "vcycle"), (40, 50, "L0.prolong"), (50, 60, "vcycle"),
        (60, 70, "solve"), (70, 90, "sync"), (90, 100, "solve"), (100, 120, None)]
    assert spans.launched_in(st) == [4, 5, 2, None]
    idle = dict(spans.idle_by_span(st, segs))
    assert idle == pytest.approx({"vcycle": 20e-9, "sync": 15e-9, "solve": 15e-9,
                                  spans.NO_SPAN: 19e-9, "L0.prolong": 5e-9,
                                  "ell.apply": 3e-9, "L0.restrict": 2e-9})


def test_readings_of_a_hand_made_stretch():
    ctx = hand_ctx({"fine operator": 1.0, "light batch L0": 2.0,
                    "device eigensolve L0: eigh": 3.0, "restrictor L0": 4.0,
                    "restrictor L1": 5.0, "restrictor L2": 6.0, "cuda kernels": 0.5})
    assert spans.vcycle_host_ms(ctx) == pytest.approx(50e-6)
    # 100 ns of solve less 50 of V-cycle and 25 of syncs
    assert spans.pcg_host_ms(ctx) == pytest.approx(25e-6)
    # k1 (under the restriction's ELL apply) and k2, one V-cycle
    assert spans.transfer_device_ms(ctx) == pytest.approx(20e-6)
    # idle under program spans other than sync: 45 of 120 ns
    assert spans.dispatch_idle_share(ctx) == pytest.approx(37.5)
    assert spans.stage_sum(ctx, spans.EIGENSOLVE) == 5.0
    assert spans.stage_sum(ctx, spans.RESTRICTOR) == 11.0
    assert ctx.notes["setup_stages_sum_s"] == 21.5
    assert spans.stage_sum(hand_ctx({"fine operator": 1.0}), spans.RESTRICTOR) is None


@pytest.mark.parametrize("cell", CELLS)
def test_readers_read_none_on_the_cpu(cell):
    c = Cell(SPEC, cell)
    n_ref = core.n_refinements(c.config, True)
    system, inputs, serve = core.set_up(c, torch.device("cpu"), n_ref, 2**31 + 3)
    pool = inputs["pool"]
    window = run(c.traffic, serve, pool, 0.2, 2**31 + 3)
    ctx = core.Context(c, system, pool, serve, window, 1.0, n_ref)
    wanted = [m["name"] for m in c.per_layer if m["name"] in SPAN_METRICS]
    assert len(wanted) == (6 if cell.endswith(".solve") else 4)
    for name in wanted:
        assert core.load_reader(name)(ctx) is None
        assert not trace.enabled()
    assert not hasattr(ctx, "_spans") and ctx.notes == {}
    # the host stretch itself runs on the CPU: the traffic's requests with
    # the program's spans, tracing off again after it
    ctx.traffic = dict(c.traffic, trace_requests=2)
    st = spans._run(ctx, trace)
    assert not trace.enabled() and trace.take() == []
    roots = [s for s in st.spans if s.parent == -1]
    assert len(roots) == 2 and st.t0 <= roots[0].start_ns
    assert roots[-1].end_ns <= st.t1
    solve = cell.endswith(".solve")
    assert {s.name for s in roots} == {"solve" if solve else "vmult"}
    assert st.counts["vcycle"] >= 2
    # and so do its readings, had the run a card
    ctx.cuda = True
    assert spans.vcycle_host_ms(ctx) > 0 and not trace.enabled()
    assert (spans.pcg_host_ms(ctx) > 0) if solve else spans.pcg_host_ms(ctx) is None
    assert ctx.notes["spans_per_request"]["vcycle"] >= 1


def test_a_stretch_that_dropped_spans_reads_none(monkeypatch):
    """Where the program's buffer was full, the stretch and its readers are
    None rather than numbers of a cut-off span list."""
    c = Cell(SPEC, CELLS[0])
    n_ref = core.n_refinements(c.config, True)
    system, inputs, serve = core.set_up(c, torch.device("cpu"), n_ref, 2**31 + 5)
    ctx = core.Context(c, system, inputs["pool"], serve, None, 1.0, n_ref)
    ctx.traffic = dict(c.traffic, trace_requests=1)
    monkeypatch.setattr(trace, "MAX_SPANS", 4)
    assert spans._run(ctx, trace) is None
    assert ctx.notes["spans_dropped"] > 0
    assert not trace.enabled() and trace.dropped() == 0 and trace.take() == []
    ctx.cuda = True
    assert spans.vcycle_host_ms(ctx) is None and spans.pcg_host_ms(ctx) is None
