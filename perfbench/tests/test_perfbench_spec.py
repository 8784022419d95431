"""`BENCHMARK.json` against the files the harness finds by name, and
against the rules its format keeps (names, units, keys, bounds)."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and (ROOT / p).is_dir()


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells():
    names, pairs = set(), set()
    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])
        assert w["name"] not in names and (w["config"], w["traffic"]) not in pairs
        names.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        traffic = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PB / "traffic" / f"{traffic['generator']}.py").is_file()
        limits = json.loads((PB / "workloads" / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v > 0 for v in limits.values())
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_metric_entries():
    seen = set()
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and TEXT.match(m["layer"])
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
    for m in _metrics():
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moves = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert _reports(moves, cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(m, cell) for m in BENCH["per_layer"])
    # a step's share of the peak stands beside each kernel roofline
    layers = [m for m in BENCH["per_layer"] if _reports(m, cell)]
    for m in layers:
        if "roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"] for o in layers)


def test_files_are_named_from_names():
    for path in PB.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT)))
