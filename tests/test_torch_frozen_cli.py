"""Frozen serving through the port's CLIs on the CPU (the port's side of
tests/test_cli.py::test_export_cli_and_frozen_serving): ``cli.export_pipeline``
writes the programs, ``cli.semantic_depth --use_frozen`` and ``cli.sequence
--use_frozen`` serve from them, and what they write equals a live run's."""

import os

import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu_torch.cli import export_pipeline as texp
from semantic_depth_tpu_torch.cli import semantic_depth as tsd
from semantic_depth_tpu_torch.cli import sequence as tseq

from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

_GRID = ["--input_height", "128", "--input_width", "256", "--depth", "13.4"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Tiny msgpack weights (numpy-seeded, flax layout), three 96x192 noise
    frames, and three programs exported by the CLI: single-frame
    scalars-only, single-frame full outputs, batch-2 full outputs."""
    root = tmp_path_factory.mktemp("frozen")
    x = np.zeros((1, 128, 256, 3), np.float32)
    weights = []
    for flag, name, module, seed in (
            ("--semantic_model", "fcn", JaxFCN8s(num_classes=3, width_mult=0.0625,
                                                 fc_channels=32), 0),
            ("--monodepth_checkpoint", "mono", JaxMonodepth("vgg", width_mult=0.0625), 1)):
        path = root / f"{name}.msgpack"
        path.write_bytes(serialization.to_bytes(numpy_params(module, x, seed=seed)))
        weights += [flag, str(path)]
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in (1, 2, 3):
        Image.fromarray(rng.integers(0, 256, (96, 192, 3)).astype(np.uint8)).save(
            frames / f"test_{i}.png")
    progs = {}
    for key, extra in (("scalars", []), ("full", ["--full_outputs"]),
                       ("b2", ["--full_outputs", "--batch", "2"])):
        progs[key] = str(root / f"{key}.pt2")
        texp.main([*weights, *_GRID, "--frame_height", "96", "--frame_width", "192",
                   "--output", progs[key], "--dev_tiny", "--device", "cpu", *extra])
    return dict(weights=weights, frames=frames, **progs)


def _single(served, out_dir, *extra):
    tsd.main(["--input_frame", str(served["frames"] / "test_1.png"), *_GRID, "--device", "cpu",
              "--results_dir", str(out_dir), *extra])
    return out_dir / "test_1"


def test_scalars_program_serves_the_live_distances(tmp_path, served, monkeypatch):
    monkeypatch.chdir(tmp_path)
    live = _single(served, tmp_path / "live", *served["weights"], "--dev_tiny")
    frozen = _single(served, tmp_path / "frozen", "--use_frozen", served["scalars"])
    want = (live / "test_1_output_distances.txt").read_text()
    assert (frozen / "test_1_output_distances.txt").read_text() == want
    assert "nan" not in want.split("\n")[0]  # a road width was measured
    with pytest.raises(SystemExit, match="full_outputs"):
        _single(served, tmp_path / "r2", "--use_frozen", served["scalars"], "--save_data")
    with pytest.raises(SystemExit, match="profile_stages"):
        _single(served, tmp_path / "r3", "--use_frozen", served["scalars"], "--profile_stages")


def test_full_program_writes_the_live_artifact_suite(tmp_path, served, monkeypatch):
    monkeypatch.chdir(tmp_path)
    live = _single(served, tmp_path / "live", *served["weights"], "--dev_tiny", "--save_data")
    frozen = _single(served, tmp_path / "frozen", "--use_frozen", served["full"], "--save_data")
    names = sorted(os.listdir(live))
    assert len(names) >= 10 and sorted(os.listdir(frozen)) == names
    for name in names:
        if name.endswith(("_times.txt", ".npz")):  # wall times; a zip's own timestamps
            continue
        assert (frozen / name).read_bytes() == (live / name).read_bytes(), name


def _sequence(served, out_dir, *extra):
    tseq.main(["--input_folder", str(served["frames"] / "*.png"), *_GRID, "--approach", "rw",
               "--device", "cpu", "--results_dir", str(out_dir), "--output_name", "seq",
               *extra])
    return out_dir / "seq"


def _sequence_files(root):
    return (sorted(os.listdir(root / "result_sequence_imgs")),
            sorted(os.listdir(root / "result_sequence_ply")))


_SEQ_FILES = (["test_1.png", "test_2.png", "test_3.png"],
              ["test_1_rw.ply", "test_2_rw.ply", "test_3_rw.ply"])


def test_sequence_serves_a_full_program(tmp_path, served, monkeypatch):
    """The program fixes the Munich camera, depth and approach: the sequence
    writes its suite from them, with a warning for the flags it ignores."""
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="approach=rw is ignored"):
        frozen = _sequence(served, tmp_path / "frozen", "--use_frozen", served["full"])
    assert _sequence_files(frozen) == _SEQ_FILES
    with pytest.raises(SystemExit, match="full_outputs"):
        _sequence(served, tmp_path / "r2", "--use_frozen", served["scalars"])


def test_sequence_pads_the_ragged_tail_of_a_batched_program(tmp_path, served, monkeypatch):
    """Three frames through a program fixed to batch 2: the last batch is
    padded with the last frame and the padding writes nothing; each frame's
    road cloud is the single-frame program's."""
    monkeypatch.chdir(tmp_path)
    single = _sequence(served, tmp_path / "single", "--use_frozen", served["full"])
    frozen = _sequence(served, tmp_path / "frozen", "--use_frozen", served["b2"], "--batch", "2")
    assert _sequence_files(frozen) == _SEQ_FILES
    for name in _SEQ_FILES[1]:
        # the batch-2 and the single-frame networks add in other orders: the
        # clouds agree to a point or two
        got, want = (int((root / "result_sequence_ply" / name).read_text().split("\n")[2]
                         .split()[-1]) for root in (frozen, single))
        assert want > 10 and abs(got - want) <= max(2, want // 100), name
    with pytest.raises(SystemExit, match="pass --batch 2"):
        _sequence(served, tmp_path / "r2", "--use_frozen", served["b2"], "--batch", "3")
