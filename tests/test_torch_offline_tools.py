"""The port's offline tools on the CPU, each against its JAX counterpart
where they share a computation: ``tools/pin_window_torch.py`` (keep sets of
four windows against JAX's statistical filter on the same scene),
``tools/train_monodepth_synth_torch.py`` (the JAX tool's stereo generator
bit for bit, a falling loss), ``tools/native_mae_curve_torch.py`` (a curve
file with the JAX file's keys, written where asked), and the two
profilers' flags and one tiny call each."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import native_mae_curve_torch as curve_tool
from tools import pin_window_torch, profile_blocks_torch, profile_pipeline_stages_torch
from tools import train_monodepth_synth_torch as synth

torch.set_num_threads(2)  # six xdist workers share the machine

REPO = Path(__file__).resolve().parent.parent


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pin_window_keep_sets_match_jax_at_128x256():
    """The tool's scene and its four windows' keep sets against JAX's
    ``statistical_outlier_filter_grid`` on the scene the JAX tool builds."""
    from semantic_depth_tpu import camera as jcamera
    from semantic_depth_tpu.config import munich_pipeline_config
    from semantic_depth_tpu.ops import neighbors as jneighbors
    from semantic_depth_tpu.utils.bench_scenes import render_scene, scaled_camera

    h, w = 128, 256
    lines = []
    got = pin_window_torch.run(h, w, device="cpu", log=lines.append)
    assert len(lines) == 4 + 3 and got["device"] == "cpu"

    cfg = munich_pipeline_config(input_height=h, input_width=w)
    rng = np.random.default_rng(0)
    _, labels, disp_norm, _, _ = render_scene(rng, h, w)
    pts = jcamera.reproject_disparity(jnp.asarray(disp_norm * 2048.0 * (w / 512.0)),
                                      scaled_camera(cfg.camera, h, w))
    valid = jnp.asarray((labels == 7) & ~(rng.uniform(size=labels.shape) < 0.3))
    assert got["valid"] == int(valid.sum())
    k, ratio = cfg.road.stat_nb_neighbors, cfg.road.stat_std_ratio
    keeps = {}
    for window in pin_window_torch.WINDOWS:
        keep = np.asarray(jax.jit(lambda p, v, win=window: (
            jneighbors.statistical_outlier_filter_grid(p, v, k, ratio, win)))(pts, valid))
        keeps[window] = keep
        mine = got["windows"][str(window)]["keep"]
        assert abs(mine - int(keep.sum())) <= 1e-4 * keep.sum(), (window, mine, keep.sum())
    for window in pin_window_torch.WINDOWS[1:]:
        want = int((keeps[window] != keeps[(5, 21)]).sum())
        assert abs(got["windows"][str(window)]["differ"] - want) <= 1e-4 * keeps[(5, 21)].sum()


def test_synthetic_stereo_pairs_equal_the_jax_tools():
    jtool = _load(REPO / "tools" / "train_monodepth_synth.py")
    h, w = 64, 128
    pairs, held, rng = synth.make_data(h, w, n_train=3)
    jrng = np.random.default_rng(0)
    want = [jtool.make_pair(jrng, h, w, slope=jrng.uniform(0.08, 0.2)) for _ in range(3)]
    want_held = jtool.make_pair(jrng, h, w, slope=0.15)
    for got, ref in zip(pairs + [held], want + [want_held]):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(rng.integers(0, 24, size=8), jrng.integers(0, 24, size=8))


def test_synthetic_stereo_training_lowers_the_loss_on_the_cpu():
    args = synth.parser().parse_args([
        "--steps", "16", "--batch", "4", "--height", "128", "--width", "256",
        "--width_mult", "0.0625", "--lr", "1e-3", "--device", "cpu"])
    lines = []
    res = synth.run(args, log=lines.append)
    losses = res["losses"]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < losses[0]
    assert np.isfinite(res["corr"]) and np.isfinite(res["mae_px"])
    assert lines[-1].startswith("held-out: corr(pred, true)=")


def _docs_state():
    return {p.name: p.stat().st_mtime_ns for p in (REPO / "docs").iterdir()}


def test_native_mae_curve_writes_the_jax_files_keys_where_asked(tmp_path):
    before = _docs_state()
    args = ["--device", "cpu", "--tiny", "--hw", "256", "512", "--warm_steps", "2",
            "--train_scenes", "2", "--fcn_steps", "2", "--mono_steps", "4", "--eval_every", "2",
            "--eval_scenes", "2", "--batch", "2", "--out_dir", str(tmp_path / "w"),
            "--curve", str(tmp_path / "curve.json")]
    out = curve_tool.main(args)
    assert _docs_state() == before  # no docs/ file touched
    written = json.loads((tmp_path / "curve.json").read_text())
    jax_keys = set(json.loads((REPO / "docs" / "NATIVE_MAE_CURVE.json").read_text()))
    assert jax_keys - {"seed0_report_rw_mae_m"} <= set(written)  # that one: --report_seed0
    assert [p["step"] for p in written["curve"]] == [2, 4]
    assert "swa_rw_mae_m" in written["curve"][1]
    assert set(written["step_s"]) == {"fcn", "monodepth", "fcn_fullres", "monodepth_fullres",
                                      "fcn_native", "monodepth_native"}
    assert written == json.loads(json.dumps(out))
    assert (tmp_path / "w" / "native_mae_curve_torch.json").is_file()
    for name in ("fcn8s_native.msgpack", "monodepth_fullres.msgpack"):
        assert (tmp_path / "w" / name).is_file()
    assert curve_tool.CURVE_DOC.endswith("docs/NATIVE_MAE_CURVE_TORCH.json")
    assert curve_tool.HEADLINE_CURVE_DOC.endswith("docs/HEADLINE_MAE_CURVE_TORCH.json")


def test_profile_blocks_flags_and_a_tiny_cpu_call():
    args = profile_blocks_torch.parser().parse_args([])
    assert (args.h, args.w, args.batch, args.net, args.tiny) == (1024, 2048, 4, "both", False)
    lines = []
    res = profile_blocks_torch.run(profile_blocks_torch.parser().parse_args(
        ["--h", "256", "--w", "512", "--batch", "1", "--iters", "1", "--tiny",
         "--device", "cpu"]), log=lines.append)
    for net, blocks in (("fcn", {"block1", "block5", "fc6", "fc7", "head (scores, upscore)"}),
                        ("mono", {"enc1", "enc7", "dec0", "dec7"})):
        for dtype in ("float32", "bfloat16"):
            got = res["nets"][net][dtype]
            assert blocks | {profile_blocks_torch.BETWEEN, "forward"} <= set(got)
            assert got["forward"] > 0 and all(np.isfinite(list(got.values())))
    assert profile_blocks_torch.block_of("mono", "iconv3") == "dec3"
    assert profile_blocks_torch.block_of("fcn", "conv4_2") == "block4"
    assert any(line.startswith("--- mono (input_s2d)") for line in lines)


def test_profile_pipeline_stages_flags_and_a_tiny_cpu_call(tmp_path, monkeypatch):
    args = profile_pipeline_stages_torch.parser().parse_args(["--native"])
    assert args.native and args.batch == 8 and (args.h, args.w) == (1024, 2048)
    assert not args.tiny and args.device == "cuda"
    monkeypatch.chdir(tmp_path)  # no .bench_weights here: seeded random weights
    lines = []
    res = profile_pipeline_stages_torch.run(profile_pipeline_stages_torch.parser().parse_args(
        ["--tiny", "--device", "cpu", "--batch", "1", "--h", "256", "--w", "512"]),
        log=lines.append, iters=1)
    assert list(res["stages"]) == ["resize", "fcn forward", "softmax + thresholds",
                                   "mono forward + flip blend", "reproject",
                                   "geometry (road + rw)", "overlay", "whole process_batch"]
    assert res["weights"] == "random" and all(v > 0 for v in res["stages"].values())
    assert res["networks"] == [256, 512] and len(lines) == len(res["stages"]) + 1
