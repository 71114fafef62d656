"""A cell of ``BENCHMARK.json`` resolved to its data files.

A cell names a configuration (``configs[].file``) and a traffic mix
(``traffic/<name>.json``); its comparison limits are in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<name before the first dot>.py``; each network's reference is
the module of the encoder its configuration names (``reference/nets.py``).
Adding a cell, a configuration, a mix, a metric or an encoder adds files
and entries; nothing here names one. A new network brings its reference
module (``reference/<kind>_<encoder>.py``, ``layers`` or ``params``), a
configuration file whose slot names the encoder and, where the port builds
it with another class, that class under ``port``
(``harness/setup.port_class``), its cells' limits and any metrics of its
own; no file that is there is edited.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Dict, List

from ..reference import frame as ref_frame

BENCH_DIR = Path(__file__).resolve().parent.parent  # portbench/
ROOT = BENCH_DIR.parent  # the checkout
MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", None) in e2e_names if "moves" in metric else True


def load(workload: str, manifest: Path = MANIFEST, data: Path = BENCH_DIR) -> Cell:
    """The cell ``workload``; ``data`` holds its ``traffic/`` and ``limits/``."""
    spec = json.loads(manifest.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    try:  # each network's reference, before any weight is drawn
        ref_frame.references(config)
    except LookupError as e:
        raise SystemExit(f"{workload}: {e}") from None
    traffic = json.loads((data / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = data / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text())["limits"] if limits_path.exists() else {}
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def reader(metric_name: str):
    """The ``read(trace) -> float or None`` of a per-layer metric."""
    base = metric_name.split(".")[0]
    return importlib.import_module(f"portbench.metrics.{base}").read


def port_config(c: Dict):
    """The port's ``PipelineConfig`` holding the configuration file's values."""
    from semantic_depth_tpu_torch import config as pc

    road, fence, seg = c["road"], c["fence"], c["segmenter"]
    return pc.PipelineConfig(
        camera=pc.CameraConfig(**c["camera"]),
        segmenter=pc.SegmenterConfig(num_classes=seg["num_classes"], threshold=seg["threshold"],
                                     road_rgba=tuple(seg["road_rgba"]),
                                     fence_rgba=tuple(seg["fence_rgba"])),
        monodepth=pc.MonodepthConfig(encoder=c["networks"]["monodepth"]["encoder"],
                                     flip_average=c["networks"]["monodepth"]["flip_average"]),
        road=pc.RoadDenoiseConfig(
            z_keep_beyond=road["z_keep_beyond"], mad_y=pc.MadFilterConfig(1, road["mad_y"]),
            mad_x=pc.MadFilterConfig(0, road["mad_x"]),
            plane=pc.PlaneFitConfig(1, road["plane"], (200, 200, 200)),
            stat_nb_neighbors=road["stat_k"], stat_std_ratio=road["stat_std_ratio"],
            stat_mode=road["stat_mode"], stat_window=tuple(road["stat_window"]),
            radius_nb_points=road["radius_nb_points"], radius=road["radius"],
            neighbor_capacity=road["capacity"]),
        fence=pc.FenceDenoiseConfig(
            mad_y=pc.MadFilterConfig(1, fence["mad_y"]), z_abs_threshold=fence["z_abs"],
            mad_x_left=pc.MadFilterConfig(0, fence["mad_x_left"]),
            mad_x_right=pc.MadFilterConfig(0, fence["mad_x_right"]),
            plane_left=pc.PlaneFitConfig(0, fence["plane"], (40, 70, 40)),
            plane_right=pc.PlaneFitConfig(0, fence["plane"], (40, 70, 40))),
        input_height=c["input_height"], input_width=c["input_width"], approach=c["approach"],
        depth=c["depth"], rw_depth_offset=c["rw_depth_offset"],
        rw_slab_halfwidth=c["rw_slab_halfwidth"], rw_estimator=c["rw_estimator"],
        compute_dtype=c["compute_dtype"])
