"""The second window's reduction (``harness.program``) on a hand-made
timeline, its readers, the proposed manifest entries
(``program_metrics.json``), and the window itself on a tiny CPU cell."""

import json

import pytest

from conftest import BENCH, ROOT
from portbench.harness import cell as cell_lib
from portbench.harness import program, setup

NAMES = ["networks_span_ms", "tail_span_ms", "upload_span_ms", "kernels_span_ms",
         "host_syncs", "idle_entry_share", "idle_networks_share", "idle_tail_share",
         "idle_outside_share"]
PROPOSED = json.loads((BENCH / "program_metrics.json").read_text())

# ns: the harness's call and readback, the program's ranges, the device's work
HARNESS = [(0, 100, "portbench.call"), (100, 120, "portbench.readback")]
SPANS = [(5, 95, "sd.call"), (5, 15, "sd.upload"), (20, 50, "sd.networks"),
         (25, 45, "sd.fcn"), (50, 90, "sd.tail"), (52, 80, "sd.road"), (60, 62, "sd.k2")]
WORK = [(10, 30, "Memcpy HtoD"), (40, 55, "conv"), (61, 70, "mad_cluster_kernel"),
        (100, 105, "Memcpy DtoH")]
SYNCS = [95, 12, 61, 96, 5]  # the end of sd.call is outside it


def _reduced():
    return program.reduce(WORK, SPANS, SYNCS, HARNESS, frames=2)


def test_idle_time_goes_to_the_innermost_range_and_adds_up():
    red = _reduced()
    ns = {k: round(v * 1e9) for k, v in red["idle_s"].items()}
    assert ns == dict(entry=10, networks=10, tail=26, outside=25)
    assert round(red["idle_window_s"] * 1e9) == 71 == sum(ns.values())
    assert round(red["window_s"] * 1e9) == 120
    assert {k: round(v * 1e9) for k, v in red["idle_by_span"].items()} == {
        "outside": 25, "sd.upload": 5, "sd.fcn": 10, "sd.road": 15, "sd.k2": 1,
        "sd.tail": 10, "sd.call": 5}
    assert red["kernel_ms"] == {"K2": pytest.approx(9e-6)}


def test_syncs_count_inside_the_call_by_innermost_range():
    red = _reduced()
    assert red["syncs"] == 3 and red["syncs_by_span"] == {"sd.upload": 2, "sd.k2": 1}
    assert red["sync_spans"] == ["sd.upload", "sd.upload", "sd.k2"]  # in time order


def test_stages_follow_the_subtree():
    assert program.stage_of([]) == "outside"
    assert program.stage_of(["sd.call"]) == program.stage_of(["sd.call", "sd.upload"]) == "entry"
    assert program.stage_of(["sd.call", "sd.networks", "sd.monodepth"]) == "networks"
    assert program.stage_of(["sd.call", "sd.tail", "sd.fence", "sd.k2"]) == "tail"
    assert program.stage_of(["sd.k4"]) == "tail"


def _t():
    red = _reduced()
    red["spans"] = {"sd.call": dict(calls=1, device_ms=8.0, host_ms=9.0),
                    "sd.networks": dict(calls=1, device_ms=3.0, host_ms=3.5),
                    "sd.tail": dict(calls=1, device_ms=4.0, host_ms=4.5),
                    "sd.k2": dict(calls=4, device_ms=0.5, host_ms=0.1),
                    "sd.k3": dict(calls=1, device_ms=0.25, host_ms=0.1),
                    "sd.fcn": dict(calls=1, device_ms=None, host_ms=2.0)}
    return dict(program=red)


def test_readers_per_frame_and_the_shares_add_up():
    t = _t()
    got = {n: cell_lib.reader(n)(t) for n in NAMES}
    assert got["networks_span_ms"] == 1.5 and got["tail_span_ms"] == 2.0
    assert got["kernels_span_ms"] == 0.375 and got["upload_span_ms"] is None
    assert got["host_syncs"] == 1.5
    shares = [got[f"idle_{s}_share"] for s in program.STAGES]
    assert sum(shares) == pytest.approx(100.0 * 71 / 120)
    assert got["idle_tail_share"] == pytest.approx(100.0 * 26 / 120)


@pytest.mark.parametrize("t", [{}, {"program": None}, "no_call"], ids=str)
def test_readers_read_nothing_where_the_span_never_opened(t):
    if t == "no_call":
        t = _t()
        t["program"]["spans"] = {"sd.fcn": dict(calls=1, device_ms=None, host_ms=1.0)}
    for name in NAMES:
        assert cell_lib.reader(name)(t) is None, name


def test_proposed_entries_keep_the_manifest_rules():
    """The 18 entries that put these readers in BENCHMARK.json, as its
    per-layer metrics are written and checked (test_portbench_manifest)."""
    from test_portbench_manifest import NAME, UNIT, _line

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in spec["workloads"]}
    layers = {m["layer"] for m in spec["per_layer"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    taken = {m["name"] for m in spec["per_layer"] + spec["end_to_end"]}
    assert [m["name"] for m in PROPOSED] == [f"{n}.{s}" for n in NAMES for s in ("b", "f1")]
    for m in PROPOSED:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and m["name"] not in taken and UNIT.match(m["unit"])
        assert m["better"] == "lower" and m["source"] in ("program_span", "device_trace")
        assert _line(m["layer"]) and m["layer"] in layers
        assert set(m["workloads"]) <= cells & set(e2e[m["moves"]]["workloads"])
        assert (m["moves"] == "frame_ms_p95") == m["name"].endswith(".f1")
        assert callable(cell_lib.reader(m["name"]))
    spec["per_layer"] += PROPOSED
    assert len(json.dumps(spec, indent=1)) <= 64 * 1024 and len(spec["per_layer"]) <= 128


def test_window_on_a_tiny_cpu_cell(tiny):
    """No card: every moment of the window is idle, no sync is counted, the
    spans come once a call and their device ms are absent."""
    manifest, data = tiny
    cell = cell_lib.load("munich-bf16.batch8", manifest, data)
    bench = setup.build(cell, 2 ** 31 + 5, "cpu")
    p = program.window(bench, 0.0)
    assert p["calls"] == 1 and p["frames"] == bench.batch
    assert p["spans"]["sd.call"]["calls"] == 1 and p["spans"]["sd.k2"]["calls"] == 4
    assert p["idle_window_s"] == pytest.approx(p["window_s"]) and p["syncs"] == 0
    assert sum(p["idle_s"].values()) == pytest.approx(p["window_s"])
    assert p["idle_s"]["tail"] > 0 and p["idle_s"]["networks"] > 0
    t = dict(program=p)
    assert cell_lib.reader("tail_span_ms")(t) is None  # no card, no CUDA events
    assert cell_lib.reader("idle_outside_share")(t) > 0.0


def test_window_reads_nothing_from_a_program_without_tracing(tiny, monkeypatch):
    from semantic_depth_tpu_torch import runtime

    manifest, data = tiny
    bench = setup.build(cell_lib.load("munich-bf16.frame1", manifest, data), 7, "cpu")
    monkeypatch.delattr(runtime, "tracing")
    assert program.window(bench, 0.0) is None
