"""The port's CLI layer against the JAX package's on the CPU: the artifact
writers, the matplotlib-free disparity PNG, the artifact suite on an
analytic scene, and both entry points end to end (``--device cpu``) on the
same frames with the same tiny msgpack weights."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu.cli import common as jcommon
from semantic_depth_tpu.cli import semantic_depth as jsd
from semantic_depth_tpu.cli import sequence as jseq
from semantic_depth_tpu.io import artifacts as jart
from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import graphs as tgraphs
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch.cli import common as tcommon
from semantic_depth_tpu_torch.cli import semantic_depth as tsd
from semantic_depth_tpu_torch.cli import sequence as tseq
from semantic_depth_tpu_torch.io import artifacts as tart
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

# The tiny random networks put the road cloud of these noise frames at
# z = -13.7 .. -13.0 m (the native pair at -13.1 .. -12.4 m): measuring
# there finds the road's width, so the checks compare a found rw as well as
# f2f.
_DEPTH = "13.4"
_NATIVE_DEPTH = "12.8"


# --- artifact writers ----------------------------------------------------------


def test_text_writers_bytes_equal_the_jax_writers(tmp_path):
    times = {"read": 0.25, "semantic": 1e-3, "road": 3.0, "global": 7.5}
    data = np.array([[5.3, 5.1, np.nan, 0.2, np.nan], [4.4, 4.0, 6.1, 0.4, 1.7]])
    for mod, name in ((jart, "jax"), (tart, "port")):
        d = tmp_path / name
        d.mkdir()
        mod.write_times(str(d / "f"), times)
        mod.write_distances(str(d / "f"), 5.123456789, float("nan"))
        mod.write_sweep_data(str(d), data, 5)
        mod.write_best_focal_lengths(str(d), 380, 580.0, None)
    for fname in ("f_times.txt", "f_distances.txt", "data.txt", "best_focal_lengths.txt"):
        assert (tmp_path / "jax" / fname).read_bytes() == (tmp_path / "port" / fname).read_bytes()


def test_plane_mesh_and_measurement_line_equal_the_jax_ones():
    rng = np.random.default_rng(0)
    pts = rng.uniform([-3, -1.6, -14], [3, -1.4, -7], size=(500, 3))
    for axis, coeffs in ((1, [0.01, -1.0, 0.02, -1.5]), (0, [-1.0, 0.1, 0.0, 3.0]),
                         (1, [np.nan, -1.0, 0.0, 0.0])):
        for got, want in zip(tart.plane_mesh(pts, coeffs, axis, [0, 255, 0]),
                             jart.plane_mesh(pts, coeffs, axis, [0, 255, 0])):
            np.testing.assert_array_equal(got, want)
    for left in ([-2.5, -1.5, -10.0], [np.nan, 0, 0]):
        for got, want in zip(tart.measurement_line(left, [2.5, -1.5, -10.0], [250, 0, 0]),
                             jart.measurement_line(left, [2.5, -1.5, -10.0], [250, 0, 0])):
            np.testing.assert_array_equal(got, want)


# --- disparity PNG without matplotlib --------------------------------------------


def _rgba(path):
    return np.asarray(Image.open(path).convert("RGBA"))


@pytest.mark.parametrize("codec", ["cv2", "PIL"])
def test_disparity_png_equals_plt_imsave(tmp_path, monkeypatch, codec):
    """Every gray level (a ramp whose normalised uint8 map holds all 256),
    a map with a small range, and a constant map (plt.imsave writes it as
    level 0): the decoded RGBA equals the JAX writer's, which calls
    plt.imsave."""
    if codec == "PIL":
        monkeypatch.setattr(tcommon, "_HAS_CV2", False)
    ramp = np.linspace(0.0, 0.3, 16 * 32, dtype=np.float32).reshape(16, 32)
    narrow = 0.2 + np.random.default_rng(1).uniform(0, 0.001, (16, 32)).astype(np.float32)
    for name, disp in (("ramp", ramp), ("narrow", narrow),
                       ("constant", np.full((16, 32), 0.1, np.float32))):
        jcommon.save_disparity_png(disp, str(tmp_path / f"jax_{name}"), 16, 32)
        tcommon.save_disparity_png(disp, str(tmp_path / f"port_{name}"), 16, 32)
        want = _rgba(tmp_path / f"jax_{name}_disp.png")
        got = _rgba(tmp_path / f"port_{name}_disp.png")
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert len(np.unique(_rgba(tmp_path / "port_ramp_disp.png")[..., 0])) == 256 - 24
    assert (_rgba(tmp_path / "port_constant_disp.png") == [0, 0, 0, 255]).all()


def test_gray_colormap_equals_matplotlib():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import colorizer

    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (40, 60)), rng.integers(17, 19, (8, 8)),
            np.full((5, 5), 200), np.arange(256).reshape(16, 16)]
    for img in imgs:
        img = img.astype(np.uint8)
        want = colorizer.Colorizer(cmap="gray").to_rgba(img, bytes=True)
        np.testing.assert_array_equal(tcommon.gray_colormap_rgba(img), want)


# --- the artifact suite on an analytic scene ----------------------------------------


def _ply_vertices(path):
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(next(ln for ln in lines if "element vertex" in ln).split()[-1])
    start = next(i for i, ln in enumerate(lines) if ln.strip() == "end_header") + 1
    rows = [ln.split() for ln in lines[start:start + n]]
    return np.array(rows, dtype=np.float64).reshape(n, 6) if n else np.zeros((0, 6))


def test_save_frame_artifacts_match_jax_on_an_analytic_scene(tmp_path):
    imgs, labels, disp_norm, _, _ = scene_pool(1, 256, 512, seed=0)
    small = imgs.astype(np.float32)
    road, fence = labels == 7, labels == 13
    disp = (disp_norm * np.float32(2048.0)).astype(np.float32)
    original = scene_pool(1, 384, 768, seed=0)[0][0]  # the frame size the suite upsamples to

    jcfg = jconfig.munich_pipeline_config()
    jpipe = jpipeline.SemanticDepthPipeline.__new__(jpipeline.SemanticDepthPipeline)
    jpipe.config = jcfg  # the geometry tail reads only the config
    jcam, _ = jpipeline._scaled_camera(jcfg, jnp.float32(jcfg.camera.focal))
    jout = jpipe._batch_geometry(
        jnp.asarray(small), jnp.asarray(road), jnp.asarray(fence), jnp.asarray(disp), jcam)
    jout = jax.tree.map(lambda x: x[0], jout)

    tcfg = tconfig.munich_pipeline_config()
    tpipe = tpipeline.SemanticDepthPipeline.__new__(tpipeline.SemanticDepthPipeline)
    tpipe.config = tcfg
    tpipe.tail_graphs = tgraphs.Cache()
    tcam, _ = tpipeline._scaled_camera(tcfg, tcfg.camera.focal)
    with torch.inference_mode():
        tout = tpipe._batch_geometry(
            torch.from_numpy(small), torch.from_numpy(road), torch.from_numpy(fence),
            torch.from_numpy(disp), tcam)
    tout = tcommon.fetch(tout.frame(0))()
    assert bool(tout.rw_found) and np.isfinite(float(tout.dist_f2f))

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jcommon.save_frame_artifacts(jout, jcfg, str(tmp_path / "jax" / "f"), original, False)
    tcommon.save_frame_artifacts(tout, tcfg, str(tmp_path / "port" / "f"), original, False)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        jpath, tpath = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".ply"):
            want, got = _ply_vertices(jpath), _ply_vertices(tpath)
            assert got.shape == want.shape, name
            assert np.isfinite(got).all(), name
            np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=1e-4, err_msg=name)
            np.testing.assert_array_equal(got[:, 3:], want[:, 3:], err_msg=name)
        elif name.endswith(".npz"):
            with np.load(jpath) as want, np.load(tpath) as got:
                assert sorted(want.files) == sorted(got.files)
                for key in want.files:
                    np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                               err_msg=key)
        elif name == "f.png":
            want, got = _rgba(jpath), _rgba(tpath)
            assert got.shape == want.shape == original.shape[:2] + (4,)
            assert (got != want).any(-1).mean() <= 1e-3
    # the mesh and both measurement lines landed in the combined cloud
    combined = _ply_vertices(tmp_path / "port" / "f.ply")
    assert (combined[:, 3:] == [250, 0, 0]).all(-1).sum() == 1001
    assert (combined[:, 3:] == [0, 255, 0]).all(-1).sum() == 1001


# --- the entry points end to end --------------------------------------------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """Tiny msgpack weights written by the JAX package's save_params (the
    flax layout), for the plain and the native networks, and 96x192 noise
    frames named as the Munich sweep expects."""
    root = tmp_path_factory.mktemp("cli")
    x = np.zeros((1, 128, 256, 3), np.float32)
    xn = np.zeros((1, 256, 512, 3), np.float32)
    nets = {
        "fcn": (JaxFCN8s(num_classes=3, width_mult=0.0625, fc_channels=32), x, 0),
        "mono": (JaxMonodepth(encoder="vgg", width_mult=0.0625), x, 1),
        "fcn_native": (JaxFCN8s(num_classes=3, width_mult=0.0625, fc_channels=32,
                                input_s2d=True), xn, 3),
        "mono_native": (JaxMonodepth(encoder="vgg", width_mult=0.0625, input_s2d=True), xn, 13),
    }
    paths = {}
    for name, (module, inp, seed) in nets.items():
        paths[name] = str(root / f"{name}.msgpack")
        with open(paths[name], "wb") as f:
            f.write(serialization.to_bytes(numpy_params(module, inp, seed=seed)))
    frames = root / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(1, 6):
        Image.fromarray(rng.integers(0, 256, size=(96, 192, 3)).astype(np.uint8)).save(
            frames / f"test_{i}.png")
    return dict(root=root, frames=frames, **paths)


def _weights(inp, native=False):
    sfx = "_native" if native else ""
    return ["--semantic_model", inp["fcn" + sfx], "--monodepth_checkpoint", inp["mono" + sfx]]


def _run_both(jmain, tmain, args, tmp_path):
    jmain(args + ["--results_dir", str(tmp_path / "jax")])
    tmain(args + ["--results_dir", str(tmp_path / "port"), "--device", "cpu"])
    return tmp_path / "jax", tmp_path / "port"


def _distances(path):
    lines = open(path).read().splitlines()
    return np.array([float(ln.split(":")[1]) for ln in lines])


def _close_or_both_nan(got, want, atol=1e-3):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=True)


def test_single_frame_cli_matches_jax(tmp_path, cli_inputs, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--input_frame", str(cli_inputs["frames"] / "test_1.png"), *_weights(cli_inputs),
            "--input_height", "128", "--input_width", "256", "--depth", _DEPTH,
            "--save_data", "--dev_tiny"]
    jdir, tdir = _run_both(jsd.main, tsd.main, args, tmp_path)
    names = sorted(os.listdir(jdir / "test_1"))
    assert names == sorted(os.listdir(tdir / "test_1"))
    assert "test_1_output_disp.png" in names and "test_1_output_FENCE.ply" in names
    got = _distances(tdir / "test_1" / "test_1_output_distances.txt")
    want = _distances(jdir / "test_1" / "test_1_output_distances.txt")
    assert np.isfinite(want).all()  # both the road width and f2f were measured
    _close_or_both_nan(got, want)


def test_munich_sweep_cli_matches_jax(tmp_path, cli_inputs, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--input_frame", "", "--input_folder", str(cli_inputs["frames"]),
            *_weights(cli_inputs), "--input_height", "128", "--input_width", "256",
            "--depth", _DEPTH, "--dev_tiny"]
    jdir, tdir = _run_both(jsd.main, tsd.main, args, tmp_path)
    for f in ("380", "580"):
        want = np.loadtxt(jdir / f / "data.txt")
        got = np.loadtxt(tdir / f / "data.txt")
        assert got.shape == want.shape == (6, 5)
        _close_or_both_nan(got, want)
    assert ((tdir / "best_focal_lengths.txt").read_text()
            == (jdir / "best_focal_lengths.txt").read_text())


@pytest.mark.parametrize("batch", ["1", "2"])
def test_sequence_cli_matches_jax(tmp_path, cli_inputs, monkeypatch, batch):
    """Double-buffered (batch 1) and batched with a ragged tail, an
    unreadable frame in the glob: the same files come out."""
    monkeypatch.chdir(tmp_path)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in (1, 2, 3):
        (frames / f"test_{i}.png").write_bytes((cli_inputs["frames"] / f"test_{i}.png").read_bytes())
    (frames / "test_1a_corrupt.png").write_bytes(b"not a png at all")
    args = ["--input_folder", str(frames / "*.png"), *_weights(cli_inputs),
            "--input_height", "128", "--input_width", "256", "--dev_tiny", "--batch", batch,
            "--output_name", "seq"]
    jdir, tdir = _run_both(jseq.main, tseq.main, args, tmp_path)
    for sub, want in (("result_sequence_imgs", ["test_1.png", "test_2.png", "test_3.png"]),
                      ("result_sequence_ply", ["test_1_rw.ply", "test_2_rw.ply", "test_3_rw.ply"])):
        assert sorted(os.listdir(jdir / "seq" / sub)) == want
        assert sorted(os.listdir(tdir / "seq" / sub)) == want
    assert os.path.isdir(tdir / "seq" / "rendered_sequence")
    for name in ("test_1", "test_3"):
        want = _ply_vertices(jdir / "seq" / "result_sequence_ply" / f"{name}_rw.ply")
        got = _ply_vertices(tdir / "seq" / "result_sequence_ply" / f"{name}_rw.ply")
        assert abs(got.shape[0] - want.shape[0]) <= max(2, want.shape[0] // 100)


def test_profile_stages_times_file_layout(tmp_path, cli_inputs, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--input_frame", str(cli_inputs["frames"] / "test_2.png"), *_weights(cli_inputs),
            "--input_height", "128", "--input_width", "256", "--dev_tiny", "--profile_stages"]
    jdir, tdir = _run_both(jsd.main, tsd.main, args, tmp_path)
    rows = {}
    for key, d in (("jax", jdir), ("port", tdir)):
        text = (d / "test_2" / "test_2_output_times.txt").read_text().splitlines()
        rows[key] = [(ln.split(":")[0], float(ln.split(":")[1])) for ln in text]
    assert [k for k, _ in rows["port"]] == [k for k, _ in rows["jax"]]
    assert len(rows["port"]) == 9
    times = dict(rows["port"])
    assert times["Time semantic"] > 0 and times["Time disparity"] > 0 and times["Time road"] > 0
    assert times["Time global"] >= times["Time road"]


def test_native_s2d_cli_matches_jax(tmp_path, cli_inputs, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--input_frame", str(cli_inputs["frames"] / "test_3.png"),
            *_weights(cli_inputs, native=True), "--input_height", "256", "--input_width", "512",
            "--depth", _NATIVE_DEPTH, "--native_s2d", "--dev_tiny"]
    jdir, tdir = _run_both(jsd.main, tsd.main, args, tmp_path)
    got = _distances(tdir / "test_3" / "test_3_output_distances.txt")
    want = _distances(jdir / "test_3" / "test_3_output_distances.txt")
    assert np.isfinite(want).all()
    _close_or_both_nan(got, want)


# --- device and flags -------------------------------------------------------------


@pytest.mark.parametrize("extra,match", [
    (["--use_frozen", "blob.shlo"], "no frozen program at blob.shlo"),
    (["--mesh", "sp"], "no process group: launch one process per mesh position with torchrun"),
])
def test_queued_serving_flags_exit(tmp_path, cli_inputs, extra, match):
    args = ["--input_frame", str(cli_inputs["frames"] / "test_1.png"), *_weights(cli_inputs),
            "--dev_tiny", "--device", "cpu", "--results_dir", str(tmp_path)] + extra
    with pytest.raises(SystemExit, match=match):
        tsd.main(args)
    seq_args = ["--input_folder", str(cli_inputs["frames"] / "*.png"), *_weights(cli_inputs),
                "--dev_tiny", "--device", "cpu", "--results_dir", str(tmp_path)] + extra
    with pytest.raises(SystemExit, match=match):
        tseq.main(seq_args)


def test_clis_run_on_the_card_unless_told_cpu(tmp_path, cli_inputs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    for main, src in ((tsd.main, ["--input_frame", str(cli_inputs["frames"] / "test_1.png")]),
                      (tseq.main, ["--input_folder", str(cli_inputs["frames"] / "*.png")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(src + [*_weights(cli_inputs), "--dev_tiny", "--results_dir", str(tmp_path)])
    parser = tsd.build_arg_parser()
    assert tcommon.cli_device(parser.parse_args(["--CUDA_DEVICE_NUMBER", "3"])) == "cuda:3"
    assert tcommon.cli_device(parser.parse_args(["--device", "cpu"])) == "cpu"
    # a bare --use_frozen and --use_xla keep their compatibility meaning
    bare = parser.parse_args(["--use_frozen", "--use_xla"])
    assert bare.use_frozen is None and bare.use_xla and bare.mesh is None


def test_build_pipeline_native_checks_and_flip_average():
    cfg = tconfig.munich_pipeline_config(input_height=128, input_width=256)
    with pytest.raises(ValueError, match="multiples of 256"):
        tcommon.build_pipeline(cfg, "random", "random", tiny=True, native_s2d=True, device="cpu")
    cfg_rn = dataclasses.replace(
        cfg, monodepth=dataclasses.replace(cfg.monodepth, encoder="resnet50"))
    pipe = tcommon.build_pipeline(cfg_rn, "random", "random", tiny=True, native_s2d=True,
                                  device="cpu")
    assert pipe.config.monodepth.flip_average is False
    assert pipe.mono.encoder == "resnet50" and pipe.mono.input_s2d and pipe.fcn.input_s2d
    out = pipe.process_batch(np.zeros((1, 128, 256, 3), np.uint8))
    assert tuple(out.disparity.shape) == (1, 128, 256)
    assert tcommon.apply_encoder_override(cfg, "resnet50").monodepth.encoder == "resnet50"
    with pytest.raises(ValueError, match="unknown monodepth encoder"):
        tcommon.apply_encoder_override(cfg, "vgg19")


def test_fetch_copies_the_asked_fields():
    rng = np.random.default_rng(4)
    pipe = tcommon.build_pipeline(tconfig.munich_pipeline_config(input_height=128, input_width=256),
                                  "random", "random", tiny=True, device="cpu")
    out = pipe.process_batch(rng.integers(0, 256, (2, 96, 192, 3)).astype(np.uint8))
    host = tcommon.fetch(out, ("dist_rw", "road_cloud"))()
    assert isinstance(host.dist_rw, np.ndarray) and host.dist_rw.shape == (2,)
    assert isinstance(host.road_cloud.valid, np.ndarray) and host.disparity is None
    one = host.frame(1)
    np.testing.assert_array_equal(one.road_cloud.xyz, out.road_cloud.xyz[1].numpy())
    assert one.overlay_small is None
