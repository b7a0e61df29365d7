"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from benchmark.spec import HERE, ROOT, Spec, load_by_name

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(data):
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= data["run_seconds"] <= 51 and isinstance(data["run_seconds"], int)
    assert data["paths"] == ["benchmark"]
    assert len(data["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units(data):
    names = ([c["name"] for c in data["configs"]]
             + [w["name"] for w in data["workloads"]]
             + [m["name"] for m in data["end_to_end"] + data["per_layer"]])
    names += [w["config"] for w in data["workloads"]]
    names += [w["traffic"] for w in data["workloads"]]
    names += [k for c in data["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    metrics = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len({w["name"] for w in data["workloads"]}) == len(data["workloads"])
    assert len({c["name"] for c in data["configs"]}) == len(data["configs"])
    pairs = [(w["config"], w["traffic"]) for w in data["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metric_entries(data):
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in data["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in data["end_to_end"] + data["per_layer"]:
        for w in m.get("workloads", []):
            assert w in cells, (m["name"], w)


def test_workloads_list_existing_cells_and_every_cell_reports(data):
    spec = Spec()
    for w in data["workloads"]:
        e2e = {m["name"] for m in spec.metrics(w["name"], False)}
        layer = spec.metrics(w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in e2e


def test_files_found_by_name(data):
    spec = Spec()
    for c in data["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        assert set(c["reduced"]) <= set(cfg["reduced"]) | set(cfg)
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in data["workloads"]:
        assert w["chips"] in (1, 4)
        tool = spec.tool(spec.config(w["config"])["tool"])
        assert tool.faults
        spec.traffic(w["traffic"])
        load_by_name("generators", spec.traffic(w["traffic"])["generator"])
        limits = spec.limits(w["name"])
        assert all(k in limits for k in ("order_errors", "bad_records", "nm_errors"))
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in data["end_to_end"] + data["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_no_file_outside_paths(data):
    for word in data["command"]:
        assert not word.startswith("/") and ".." not in word
    for p in data["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert HERE == ROOT / "benchmark"


def test_unknown_tool_is_refused():
    with pytest.raises(KeyError):
        Spec().tool("featureCounts")
