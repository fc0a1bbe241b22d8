"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re

import pytest

from portbench import harness
from portbench.tiny import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"] and (ROOT / "portbench").is_dir()
    assert MAN["command"][:2] == ["python3", "portbench/run.py"] and len(MAN["command"]) <= 32
    assert all(TEXT.match(w) for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    # a full check of 24 cells fits its time
    assert 2 + 14 * 24 * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 and cells <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = [x["name"] for x in MAN["configs"] + MAN["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for x in MAN["configs"] + MAN["workloads"] + METRICS:
        assert NAME.match(x["name"]), x["name"]
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MAN["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_config_keeps_a_cell_and_chips_stay_in_bounds():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    chips = [w["chips"] for w in MAN["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        c = harness.Cell(ROOT, w["name"])
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert harness.applies(e2e[m["moves"]], MAN, w), (m["name"], w)
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert TEXT.match(m["layer"])


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_declares_what_the_manifest_says(m):
    reader = harness.load_reader(m["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (
        m["layer"], m["unit"], m["moves"], m["source"])
    assert callable(reader.read)


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(w):
    c = harness.Cell(ROOT, w["name"])
    assert c.cfg["name"] == w["config"]
    assert harness.kind_module(c.traffic["kind"]).Bench
    assert c.limits and all(v > 0 for v in c.limits.values())
    conf = next(x for x in MAN["configs"] if x["name"] == w["config"])
    assert (ROOT / conf["file"]).is_file() and conf["file"].startswith("portbench/")
    assert conf["reduced"] == c.cfg["reduced"]


def test_files_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p
