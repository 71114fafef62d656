"""Tiny cells for the CPU tests: the benchmark's cells with the networks cut
to 1/16 of their channels (fc 32; the native ones to 1/4, fc 512), 128x256 networks on 256x512 frames
(256x512 for the stand-in scenes, whose slab needs the reference's
resolution) and a road capacity of 1024, in a temporary manifest. The
limits are the cells' own."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
BENCH = ROOT / "portbench"


def tiny_config(name: str, scenes: bool = False) -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    native = c["networks"]["fcn8s"]["input_s2d"]
    # the native networks at 1/16 of their channels average the control's
    # float8 error away: a quarter keeps it (0.053 against 0.0075 sound)
    c["networks"]["width_mult"] = 0.25 if native else 0.0625
    c["networks"]["fcn8s"]["fc_channels"] = 512 if native else 32
    c["road"]["capacity"] = 1024
    if not c["networks"]["fcn8s"]["input_s2d"]:
        c["input_height"], c["input_width"] = (256, 512) if scenes else (128, 256)
    else:
        c["input_height"], c["input_width"] = 256, 512
    return c


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(manifest, data dir) of the tiny cells."""
    d = tmp_path_factory.mktemp("tiny")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (d / "traffic").mkdir()
    shutil.copytree(BENCH / "limits", d / "limits")
    for w in spec["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        scenes = t["networks"] == "scenes"
        c = tiny_config(w["config"], scenes)
        c["name"] = f"{w['config']}.{w['traffic']}"
        (d / f"{c['name']}.json").write_text(json.dumps(c))
        spec["configs"].append(dict(name=c["name"], source="tests", file=str(d / f"{c['name']}.json"),
                                    reduced=[], why="tests"))
        w["config"] = c["name"]
        frame = c["input_height"] * (1 if c["networks"]["fcn8s"]["input_s2d"] else 2)
        t.update(frame_height=frame, frame_width=2 * frame, batch=min(t["batch"], 2),
                 pool=2 if scenes else 4, check_batches=2, warmup_calls=1)
        (d / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (d / "BENCHMARK.json").write_text(json.dumps(spec))
    return d / "BENCHMARK.json", d
