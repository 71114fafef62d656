"""Sharded frozen serving and the CLIs' ``--mesh`` on the CPU: two gloo ranks
(``launch.run_ranks``; one case through ``torch.distributed.run``, the
launcher the CLIs are meant for) against the unsharded port. What a sharded
CLI writes must equal what the unsharded CLI writes at the ranks' own batch
(byte for byte under dp and pp, within the sharded tests' tolerances under
sp), a road width must have been measured, and only rank 0 may write."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from flax import serialization

from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu_torch import export as texport
from semantic_depth_tpu_torch.cli.common import FrozenPipeline
from semantic_depth_tpu_torch.cli import export_pipeline as texp
from semantic_depth_tpu_torch.cli import semantic_depth as tsd
from semantic_depth_tpu_torch.cli import sequence as tseq
from semantic_depth_tpu_torch.config import munich_pipeline_config
from semantic_depth_tpu_torch.export import load_pipeline
from semantic_depth_tpu_torch.io.ply import read_ply
from semantic_depth_tpu_torch.parallel.launch import run_ranks

import test_torch_parallel_ranks as cases
from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

REPO = Path(__file__).resolve().parent.parent
_TIMEOUT = 240  # seconds for the group of ranks, its collectives included
_GRID = ["--input_height", "128", "--input_width", "256", "--depth", "13.4"]
_SEQ_GRID = [*_GRID[:-1], "9.2"]
_SEQ = "semantic_depth_tpu_torch.cli.sequence"
_SD = "semantic_depth_tpu_torch.cli.semantic_depth"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Tiny msgpack weights (numpy-seeded, flax layout), three 96x192 noise
    frames, and two full-output programs exported by the CLI on the CPU:
    batch 1 (batched) and single-frame. With these weights the Munich
    camera measures a road width at 13.4 m; the sequence camera's
    disparity multiplier (3800) puts that road 0.9 m away, where the cloud
    is empty, so the sequence runs take a monodepth whose disparity heads
    are biased down by 3 (the road at 9.2 m)."""
    root = tmp_path_factory.mktemp("sharded")
    x = np.zeros((1, 128, 256, 3), np.float32)
    fcn = numpy_params(JaxFCN8s(num_classes=3, width_mult=0.0625, fc_channels=32), x, seed=0)
    mono = numpy_params(JaxMonodepth("vgg", width_mult=0.0625), x, seed=1)
    mono_seq = {"params": dict(mono["params"])}
    for level in (1, 2, 3, 4):
        head = dict(mono_seq["params"][f"disp{level}"])
        head["bias"] = head["bias"] - np.float32(3.0)
        mono_seq["params"][f"disp{level}"] = head
    for name, tree in (("fcn", fcn), ("mono", mono), ("mono_seq", mono_seq)):
        (root / f"{name}.msgpack").write_bytes(serialization.to_bytes(tree))
    tail = ["--dev_tiny", "--device", "cpu"]
    nets = ["--semantic_model", str(root / "fcn.msgpack"),
            "--monodepth_checkpoint", str(root / "mono.msgpack"), *tail]
    seq_nets = ["--semantic_model", str(root / "fcn.msgpack"),
                "--monodepth_checkpoint", str(root / "mono_seq.msgpack"), *tail]
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in (1, 2, 3):
        Image.fromarray(rng.integers(0, 256, (96, 192, 3)).astype(np.uint8)).save(
            frames / f"test_{i}.png")
    progs = {}
    for key, extra in (("b1", ["--batch", "1"]), ("single", [])):
        progs[key] = str(root / f"{key}.pt2")
        texp.main([*nets, *_GRID, "--approach", "rw", "--frame_height", "96",
                   "--frame_width", "192", "--full_outputs", "--output", progs[key], *extra])
    return dict(root=root, frames=frames, nets=nets, seq_nets=seq_nets, **progs)


def _seq_args(served, *extra):
    return ["--input_folder", str(served["frames"] / "*.png"), *_SEQ_GRID,
            *served["seq_nets"], "--results_dir", "r", *extra]


def _sd_args(served, *extra):
    return ["--input_frame", str(served["frames"] / "test_1.png"), *_GRID, *served["nets"],
            "--save_data", "--results_dir", "r", *extra]


# (name, module, flags, unsharded flags): the CLI runs of the group, each
# against the unsharded run at the batch each rank runs (dp: 2 frames over 2
# ranks; pp: microbatches of 1; a CPU convolution over a batch of 2 may add
# in another order than over one frame)
_RUNS = (
    ("seq_dp", _SEQ, ["--batch", "2", "--mesh", "dp"], []),
    ("seq_pp", _SEQ, ["--batch", "2", "--mesh", "pp"], []),
    ("seq_sp", _SEQ, ["--mesh", "sp"], []),
    ("sd_sp", _SD, ["--mesh", "sp"], []),
    ("seq_frozen_dp", _SEQ, ["--batch", "2", "--mesh", "dp", "--use_frozen", "b1"],
     ["--use_frozen", "b1"]),
)


def _argv(served, module, flags):
    flags = [served[f] if f in ("b1", "single") else f for f in flags]
    if "--use_frozen" in flags:  # a program carries its weights and grid
        return ["--input_folder", str(served["frames"] / "*.png"), *_GRID, "--device", "cpu",
                "--approach", "rw", "--results_dir", "r", *flags]
    return (_seq_args if module == _SEQ else _sd_args)(served, *flags)


@pytest.fixture(scope="module")
def ranks(served):
    """One group of two ranks: sharded frozen serving, then every CLI run,
    each rank in its own working directory."""
    root = served["root"]
    frames = np.stack([np.asarray(Image.open(served["frames"] / f"test_{i}.png"))
                       for i in (1, 2)])
    steps = [("run_frozen", (served["b1"], frames, 380.0, 192.0)),
             ("run_frozen_single", (served["single"],)),
             ("run_frozen_other_device", (served["b1"],))]
    for name, module, flags, _ in _RUNS:
        dirs = []
        for r in range(2):
            d = root / name / f"rank{r}"
            d.mkdir(parents=True)
            dirs.append(str(d))
        steps.append(("run_cli", (module, _argv(served, module, flags), dirs)))
    wrong = root / "wrong_batch"
    wrong.mkdir()
    steps.append(("run_cli", (_SEQ, _argv(served, _SEQ, ["--batch", "3", "--mesh", "dp",
                                                        "--use_frozen", "b1"]),
                              [str(wrong)] * 2)))
    return run_ranks(cases.run_steps, 2, steps, timeout_s=_TIMEOUT, device="cpu")


def _files(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_sharded_frozen_program_equals_the_per_shard_program(served, ranks):
    frames = np.stack([np.asarray(Image.open(served["frames"] / f"test_{i}.png"))
                       for i in (1, 2)])
    single = load_pipeline(served["b1"])
    want = [single(frames[i:i + 1], 380.0, 192.0) for i in range(2)]
    for rank in ranks:
        got = rank[0]
        assert got["global_batch"] == 2
        assert got["digest"] == ranks[0][0]["digest"]
        for f in cases.FIELDS:
            np.testing.assert_array_equal(
                got["out"][f], np.concatenate([getattr(w, f).numpy() for w in want]))
        assert "sharded frozen serving takes batch 2" in got["wrong_batch"]
        assert "BATCHED" in rank[1]


def test_sharded_frozen_serving_keeps_the_program_on_its_device_type(served, ranks):
    """As on one device, a program exported on the CPU is refused for a
    card (and the reverse): a mesh moves a program between cards only."""
    want = "--use_frozen: {} was exported for cpu; serve it there or export again on cuda:0"
    for rank in ranks:
        assert rank[2] == want.format(served["b1"])
    with pytest.raises(SystemExit, match="was exported for cpu"):
        FrozenPipeline(served["b1"], munich_pipeline_config(), device="cuda:0")


def test_a_program_moves_to_another_device(served):
    """``load_pipeline_sharded`` moves a program exported on another card to
    the rank's own (``export._moved``, ``move_to_device_pass``): its weights
    and constants go along. Here to the meta device, where the kernels'
    fake implementations give the outputs' shapes."""
    program = torch.export.load(served["b1"])
    assert texport._moved(program, torch.device("cpu")) is program
    call = texport._serve(texport._moved(program, torch.device("meta")))
    assert call.device == torch.device("meta")
    out = call(np.zeros((1, 96, 192, 3), np.uint8), 380.0, 192.0)
    assert out.disparity.device.type == "meta" and out.disparity.shape == (1, 128, 256)


def _assert_close(got: Path, want: Path):
    """An sp artifact against the unsharded one: the rows of each rank's
    convolutions add in other orders, so values agree within the sharded
    tests' tolerances (rtol 1e-4; a PNG's 8-bit levels within one)."""
    if want.suffix == ".png":
        np.testing.assert_allclose(np.asarray(Image.open(got), np.int16),
                                   np.asarray(Image.open(want), np.int16), atol=1)
    elif want.suffix == ".ply":
        for g, w in zip(read_ply(str(got)), read_ply(str(want))):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    elif want.name.endswith("_distances.txt"):
        np.testing.assert_allclose(np.loadtxt(got, delimiter=":", usecols=1),
                                   np.loadtxt(want, delimiter=":", usecols=1), rtol=1e-4)
    else:
        assert got.read_bytes() == want.read_bytes(), got.name


def _width_measured(root: Path) -> bool:
    """Whether a run under ``root`` measured a road width: a finite first
    distance (single frame), or a measurement line, the (250, 0, 0) points,
    in a frame's road cloud (sequence)."""
    for path in root.rglob("*_distances.txt"):
        return bool(np.isfinite(np.loadtxt(path, delimiter=":", usecols=1)[0]))
    return any((read_ply(str(p))[1] == (250, 0, 0)).all(axis=1).any()
               for p in root.rglob("*_rw.ply"))


@pytest.mark.parametrize("name,module,flags,plain", _RUNS, ids=[r[0] for r in _RUNS])
def test_mesh_cli_writes_what_the_unsharded_cli_writes(served, ranks, name, module, flags,
                                                       plain, tmp_path, monkeypatch):
    step = 3 + [r[0] for r in _RUNS].index(name)
    assert all(rank[step] is None for rank in ranks)  # no rank exited early
    got_dir = served["root"] / name / "rank0"
    assert _files(served["root"] / name / "rank1") == []  # only rank 0 writes
    monkeypatch.chdir(tmp_path)
    main = tseq.main if module == _SEQ else tsd.main
    main(_argv(served, module, plain))
    names = _files(got_dir)
    assert names == _files(tmp_path) and names
    assert _width_measured(tmp_path)
    for rel in names:
        if rel.endswith(("_times.txt", ".npz")):  # wall times; a zip's own timestamps
            continue
        if "--mesh" in flags and flags[flags.index("--mesh") + 1] == "sp":
            _assert_close(got_dir / rel, tmp_path / rel)
        else:
            assert (got_dir / rel).read_bytes() == (tmp_path / rel).read_bytes(), rel


def test_frozen_mesh_cli_rejects_a_batch_it_does_not_serve(ranks):
    for rank in ranks:
        assert "--mesh dp over this frozen export serves batch 2" in rank[-1]


def test_mesh_flags_rejected_up_front(served):
    with pytest.raises(SystemExit, match="--mesh sp/pp cannot serve a frozen export"):
        tseq.main(_argv(served, _SEQ, ["--mesh", "sp", "--use_frozen", "b1"]))
    with pytest.raises(SystemExit, match="--mesh cannot serve a frozen export"):
        tsd.main(_sd_args(served, "--mesh", "sp", "--use_frozen", served["single"]))
    with pytest.raises(SystemExit, match="--profile_stages times the single-device"):
        tsd.main(_sd_args(served, "--mesh", "sp", "--profile_stages"))
    for mesh in ("dp", "pp", "sp"):
        with pytest.raises(SystemExit, match="torchrun"):
            tseq.main(_seq_args(served, "--mesh", mesh))


@pytest.mark.parametrize("mesh,batch,n,match", [
    ("dp", 3, 2, "--batch 3 must be a multiple of 2"),
    ("pp", 2, 3, "needs an even device count >= 2, got 3"),
    ("pp", 3, 4, "--batch 3 must be a multiple of 2"),
])
def test_mesh_shapes_rejected_with_the_jax_messages(mesh, batch, n, match):
    args = argparse.Namespace(mesh=mesh, batch=batch)
    with pytest.raises(SystemExit, match=match):
        tseq._sharded(None, args, n)


def test_sequence_mesh_under_torchrun(served, tmp_path, monkeypatch):
    """The launch path the CLIs are for: ``python -m torch.distributed.run``
    (torchrun) with two CPU ranks, ``--mesh pp``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", _SEQ, *_argv(served, _SEQ, ["--batch", "2", "--mesh", "pp"])]
    run_dir = tmp_path / "torchrun"
    run_dir.mkdir()
    proc = subprocess.run(cmd, cwd=run_dir, env=env, capture_output=True, text=True,
                          timeout=_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "backend gloo, world size 2" in proc.stdout
    want = tmp_path / "single"
    want.mkdir()
    monkeypatch.chdir(want)
    tseq.main(_seq_args(served))  # pp streams microbatches of one frame
    names = _files(want)
    assert _files(run_dir) == names and names
    for rel in names:
        assert (run_dir / rel).read_bytes() == (want / rel).read_bytes(), rel
