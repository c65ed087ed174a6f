"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

from __future__ import annotations

import json
import re

import pytest

from h100bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = harness.load_benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for path in BENCH["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert (harness.ROOT / path).is_dir()


def test_run_seconds_fits_the_check_budget():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"].startswith("h100bench/") and (harness.ROOT / entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and _line(cell["why"])
    spec = harness.cell_spec(BENCH, cell["name"])
    assert spec["config"]["name"] == cell["config"]
    assert harness.driver(spec["traffic"]["driver"])
    assert spec["limits"], "every cell has its limits file"
    for m in harness.cell_metrics(BENCH, cell["name"], False) + harness.cell_metrics(
            BENCH, cell["name"], True):
        assert callable(harness.reader(m["name"]))


def test_configuration_and_traffic_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(CELLS) == len(BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    base = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == base | {"bound"}
        assert metric["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == base | {"layer", "moves"}
        assert metric["source"] in SOURCES and _line(metric["layer"])
        assert metric["moves"] in E2E
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", [])) <= set(CELLS)


def test_names_are_unique():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_lists_only_cells_that_report_what_it_moves(metric):
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", CELLS)


def test_layer_names_are_consistent():
    """One spelling a layer: no two names that differ in case or spaces."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({layer.lower().replace(" ", "") for layer in layers}) == len(layers)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, True)


def test_setup_bound():
    assert E2E["setup_s"]["bound"] <= 0.25


def test_files_under_paths_are_named_from_name_characters():
    for path in (harness.BENCH).rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert all(NAME.match(part) for part in rel.split("/")), rel
