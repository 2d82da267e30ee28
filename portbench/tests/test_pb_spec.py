"""BENCHMARK.json against the rules the harness reads it by, and every name in it
resolving to the files of portbench/."""

import json
import re

import pytest

from portbench.core import HERE, ROOT, Cell, load_json
from portbench.loadgen import check_traffic

SPEC = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(text_ok(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in SPEC["paths"])
            assert (ROOT / w).exists()


def test_names_units_and_entries():
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"]) and text_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        seen.add(c["name"])
    assert len(seen) == len(SPEC["configs"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in seen and w["chips"] in (1, 4) and text_ok(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    names = []
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text_ok(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert "setup_s" in names


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = Cell(SPEC, cell)
    check_traffic(c.traffic)
    assert c.config["name"] == c.workload["config"]
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in c.end_to_end:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    assert all("limit" in v for v in c.limits.values())
    for fn in ("inputs", "serve", "summary", "judge"):
        assert callable(getattr(c.request, fn))
    assert (HERE / "reference" / f"{c.config['reference']}.py").is_file()


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    for key in cfg["changed"]:
        assert key.split(".")[0] in cfg["reduced"]
    assert len(cfg["levels"]) == cfg["max_levels"]
    files = [e["file"] for e in SPEC["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_loops(loop):
    """The one generator's loops over a stand-in request: every request
    answered in turn over the pool, the window closed after the last
    arrival, as many answers kept of each pool row (7 over 4 rows: 2), an
    open loop's latency counted from each arrival."""
    import time

    import torch

    from portbench.loadgen import run
    traffic = {"loop": loop, "clients": 1, "rate_per_s": 400.0, "input": "uniform",
               "sample": 7}
    check_traffic(traffic)
    served = []

    def fn(x):
        time.sleep(0.001)
        served.append(int(x[0]))
        return x * 2, {"ok": True}
    pool = torch.arange(4.0)[:, None]
    w = run(traffic, fn, pool, 0.2, seed=2**31 + 5)
    assert w.completed == len(served) >= 20 and w.seconds >= 0.2
    assert served == [i % 4 for i in range(len(served))]
    assert sorted(j for _, j, _ in w.sample) == [0, 0, 1, 1, 2, 2, 3, 3]
    assert all(out[0] == 2 * (i % 4) and j == i % 4 for i, j, out in w.sample)
    assert min(w.latencies) >= 0.001
    if loop == "open":
        assert 0.5 * 400 * 0.2 <= w.completed <= 2 * 400 * 0.2
    with pytest.raises(ValueError):
        check_traffic(dict(traffic, loop="bursty"))
