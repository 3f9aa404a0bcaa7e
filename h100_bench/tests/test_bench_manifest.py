"""BENCHMARK.json against the rules a benchmark is refused by, and every
cell's files found by name."""
import json
import re

import pytest

from bench_cells import harness

BENCH = harness.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
               and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", list(KEYS))
def test_entries_names_and_keys(section):
    entries = BENCH[section]
    assert 1 <= len(entries) <= {"configs": 24, "workloads": 24, "end_to_end": 16, "per_layer": 128}[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and not (section == "per_layer" and key == "source"):
                assert LINE.fullmatch(e[key]), (e["name"], key)


def test_metrics_bounds_and_sources():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert w in cells and w in moved.get("workloads", [w]), (m["name"], w)
    for w in cells:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", [w])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.load_cell(w)["per_layer"], w


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_are_found_by_name(workload):
    entry = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert entry["chips"] == 1
    cell = harness.load_cell(workload)
    assert (harness.HERE / "drivers" / f"{cell['traffic']['driver']}.py").exists()
    assert (harness.HERE / "reference" / f"{cell['config']['reference']}.py").exists()
    for m in cell["per_layer"]:
        assert hasattr(harness.reader(m["name"]), "read")
    config = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert config["file"].startswith(BENCH["paths"][0] + "/")
    assert all(NAME.fullmatch(k) for k in config["reduced"]) and len(config["reduced"]) <= 16
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())
