"""BENCHMARK.json against its format rules (names, units, keys, the cells
of each metric), and every file it names found by name."""

import json
import re

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry and isinstance(entry[key], str):
            assert _line(entry[key])


def test_names_unique_and_keys_exact():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and c["reduced"] == []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def _cells_reporting(metric):
    return metric.get("workloads", [w["name"] for w in SPEC["workloads"]])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in _cells_reporting(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_cells_exist_and_report_what_it_moves(metric):
    cells = {w["name"] for w in SPEC["workloads"]}
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= cells
    assert set(metric["workloads"]) <= set(_cells_reporting(moved))
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert metric["layer"] in layers


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_by_name(w):
    from portbench.harness import cell as cell_lib
    from portbench.harness import judge

    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert conf["file"].startswith("portbench/configs/") and (ROOT / conf["file"]).exists()
    cell = cell_lib.load(w["name"])
    assert cell.traffic["name"] == w["traffic"]
    assert set(cell.limits) and set(cell.limits) <= set(judge.NUMBERS)
    for m in cell.per_layer:
        assert callable(cell_lib.reader(m["name"]))
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").exists()


@pytest.mark.parametrize("name", ["munich-bf16", "native-bf16"])
def test_configuration_file_is_the_ports_preset(name):
    """The file holds the configuration as the port's presets run it."""
    import dataclasses

    from semantic_depth_tpu_torch import config as pc
    from portbench.harness.cell import port_config

    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    want = pc.munich_pipeline_config(compute_dtype="bfloat16", input_height=c["input_height"],
                                     input_width=c["input_width"])
    if not c["networks"]["monodepth"]["flip_average"]:  # build_pipeline(native_s2d=True)
        want = dataclasses.replace(want, monodepth=dataclasses.replace(want.monodepth,
                                                                       flip_average=False))
    assert port_config(c) == want
