"""CLI end-to-end smoke tests (tiny networks, random weights, synthetic
frames) — exercise the full entry-point surface including every artifact."""

import os

import numpy as np
import pytest
from PIL import Image


@pytest.fixture()
def frame_dir(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "frames"
    d.mkdir()
    for name in ["test_1.png", "test_2.png"]:
        img = rng.integers(0, 256, size=(96, 192, 3)).astype(np.uint8)
        Image.fromarray(img).save(d / name)
    return d


def test_single_frame_cli_writes_artifacts(tmp_path, frame_dir, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from semantic_depth_tpu.cli import semantic_depth as cli

    cli.main(
        [
            "--input_frame", str(frame_dir / "test_1.png"),
            "--semantic_model", "random",
            "--monodepth_checkpoint", "random",
            "--input_height", "128",
            "--input_width", "256",
            "--save_data",
            "--dev_tiny",
            "--results_dir", str(tmp_path / "results"),
        ]
    )
    out_dir = tmp_path / "results" / "test_1"
    base = out_dir / "test_1_output"
    for suffix in [
        ".png",
        "_only_segmentation.png",
        "_disp.png",
        "_road_mask.png",
        "_fence_mask.png",
        "_raw.ply",
        "_pointCloud.npz",
        "_ROAD.ply",
        "_ALL.ply",
        "_times.txt",
        "_distances.txt",
    ]:
        assert (out_dir / f"test_1_output{suffix}").exists() or os.path.exists(
            str(base) + suffix
        ), f"missing artifact {suffix}"
    # times file format parity
    lines = open(str(base) + "_times.txt").read().splitlines()
    assert lines[0].startswith("Time read:")
    assert lines[-1].startswith("Time global:")
    dist = open(str(base) + "_distances.txt").read()
    assert dist.startswith("rw distance:")


def test_sequence_cli_runs_double_buffered(tmp_path, frame_dir, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from semantic_depth_tpu.cli import sequence as cli

    cli.main(
        [
            "--input_folder", str(frame_dir / "*.png"),
            "--semantic_model", "random",
            "--monodepth_checkpoint", "random",
            "--input_height", "128",
            "--input_width", "256",
            "--dev_tiny",
            "--results_dir", str(tmp_path / "results"),
            "--output_name", "seq",
        ]
    )
    imgs = tmp_path / "results" / "seq" / "result_sequence_imgs"
    plys = tmp_path / "results" / "seq" / "result_sequence_ply"
    assert sorted(p.name for p in imgs.iterdir()) == ["test_1.png", "test_2.png"]
    assert sorted(p.name for p in plys.iterdir()) == ["test_1_rw.ply", "test_2_rw.ply"]
    # PLY header sanity
    head = open(plys / "test_1_rw.ply").read(200)
    assert head.startswith("ply\n")
    assert "element vertex" in head


def test_sequence_cli_native_s2d(tmp_path, frame_dir, monkeypatch):
    """--native_s2d drives the input_s2d variants end to end through the
    sequence CLI (grid 256x512 so the packed vgg trunk sees 128x256)."""
    monkeypatch.chdir(tmp_path)
    from semantic_depth_tpu.cli import sequence as cli

    cli.main(
        [
            "--input_folder", str(frame_dir / "*.png"),
            "--semantic_model", "random",
            "--monodepth_checkpoint", "random",
            "--input_height", "256",
            "--input_width", "512",
            "--dev_tiny",
            "--native_s2d",
            "--batch", "2",
            "--results_dir", str(tmp_path / "results"),
            "--output_name", "seqn",
        ]
    )
    imgs = tmp_path / "results" / "seqn" / "result_sequence_imgs"
    assert sorted(p.name for p in imgs.iterdir()) == ["test_1.png", "test_2.png"]


@pytest.mark.heavy
def test_sequence_cli_mesh_sharded(tmp_path, frame_dir, monkeypatch):
    """--mesh serves the sequence from the GSPMD-sharded program: 'sp'
    shards image rows across all 8 virtual devices (latency mode, batch 1),
    'dp' shards the frame batch (throughput mode) and pads the ragged
    2-frame tail to the device-divisible --batch. Artifacts must match the
    single-device suite's."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    monkeypatch.chdir(tmp_path)
    from semantic_depth_tpu.cli import sequence as cli

    base = [
        "--input_folder", str(frame_dir / "*.png"),
        "--semantic_model", "random",
        "--monodepth_checkpoint", "random",
        "--input_height", "128",
        "--input_width", "256",
        "--dev_tiny",
        "--results_dir", str(tmp_path / "results"),
    ]
    cli.main(base + ["--mesh", "sp", "--output_name", "seq_sp"])
    imgs = tmp_path / "results" / "seq_sp" / "result_sequence_imgs"
    assert sorted(p.name for p in imgs.iterdir()) == ["test_1.png", "test_2.png"]

    cli.main(base + ["--mesh", "dp", "--batch", "8", "--output_name", "seq_dp"])
    imgs = tmp_path / "results" / "seq_dp" / "result_sequence_imgs"
    plys = tmp_path / "results" / "seq_dp" / "result_sequence_ply"
    # padding frames must not leak into the artifact suite
    assert sorted(p.name for p in imgs.iterdir()) == ["test_1.png", "test_2.png"]
    assert sorted(p.name for p in plys.iterdir()) == ["test_1_rw.ply", "test_2_rw.ply"]

    cli.main(base + ["--mesh", "pp", "--batch", "8", "--output_name", "seq_pp"])
    imgs = tmp_path / "results" / "seq_pp" / "result_sequence_imgs"
    plys = tmp_path / "results" / "seq_pp" / "result_sequence_ply"
    assert sorted(p.name for p in imgs.iterdir()) == ["test_1.png", "test_2.png"]
    assert sorted(p.name for p in plys.iterdir()) == ["test_1_rw.ply", "test_2_rw.ply"]

    # indivisible --batch under dp/pp is a usable error, not a shard crash.
    # pp's constraint is divisibility by dp = n/2 (not n: batch 12 on 8
    # chips is valid — mb=4, T=3), so 6 is the indivisible case on 8.
    with pytest.raises(SystemExit, match="multiple"):
        cli.main(base + ["--mesh", "dp", "--batch", "3", "--output_name", "x"])
    with pytest.raises(SystemExit, match="multiple"):
        cli.main(base + ["--mesh", "pp", "--batch", "6", "--output_name", "x"])
    # frozen serving is single-device by construction
    with pytest.raises(SystemExit, match="frozen"):
        cli.main(base + ["--mesh", "sp", "--use_frozen", "blob", "--output_name", "x"])

    # the single-frame entry's latency mode: sp-sharded full artifact suite
    from semantic_depth_tpu.cli import semantic_depth as sd_cli

    sd_cli.main(
        [
            "--input_frame", str(frame_dir / "test_1.png"),
            "--semantic_model", "random",
            "--monodepth_checkpoint", "random",
            "--input_height", "128",
            "--input_width", "256",
            "--save_data",
            "--dev_tiny",
            "--mesh", "sp",
            "--results_dir", str(tmp_path / "results_sp1"),
        ]
    )
    out_dir = tmp_path / "results_sp1" / "test_1"
    for suffix in [".png", "_ROAD.ply", "_times.txt", "_distances.txt"]:
        assert (out_dir / f"test_1_output{suffix}").exists(), suffix
    with pytest.raises(SystemExit, match="profile_stages"):
        sd_cli.main(
            [
                "--input_frame", str(frame_dir / "test_1.png"),
                "--semantic_model", "random", "--monodepth_checkpoint", "random",
                "--dev_tiny", "--mesh", "sp", "--profile_stages",
            ]
        )


def test_export_cli_and_frozen_serving(tmp_path, monkeypatch):
    """cli.export_pipeline -> semantic_depth --use_frozen round trip: the
    optimized_graph.pb workflow (semantic_depth.py:472-513) with StableHLO.
    Scalars-only blobs serve distances; --full_outputs blobs also feed the
    artifact suite; scalars-only + --save_data fails with a usable error."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    frame = tmp_path / "f.png"
    Image.fromarray(rng.integers(0, 256, (96, 192, 3)).astype(np.uint8)).save(frame)

    from semantic_depth_tpu.cli import export_pipeline as exp_cli
    from semantic_depth_tpu.cli import semantic_depth as sd_cli

    blob = str(tmp_path / "tiny.shlo")
    exp_cli.main([
        "--semantic_model", "random", "--monodepth_checkpoint", "random",
        "--input_height", "128", "--input_width", "256",
        "--frame_height", "96", "--frame_width", "192",
        "--output", blob, "--dev_tiny", "--approach", "rw",
    ])
    sd_cli.main([
        "--input_frame", str(frame), "--use_frozen", blob,
        "--input_height", "128", "--input_width", "256", "--approach", "rw",
        "--results_dir", str(tmp_path / "r1"),
    ])
    assert (tmp_path / "r1" / "f" / "f_output_distances.txt").exists()

    with pytest.raises(SystemExit, match="full_outputs"):
        sd_cli.main([
            "--input_frame", str(frame), "--use_frozen", blob,
            "--input_height", "128", "--input_width", "256", "--approach", "rw",
            "--save_data", "--results_dir", str(tmp_path / "r2"),
        ])

    full = str(tmp_path / "tiny_full.shlo")
    exp_cli.main([
        "--semantic_model", "random", "--monodepth_checkpoint", "random",
        "--input_height", "128", "--input_width", "256",
        "--frame_height", "96", "--frame_width", "192",
        "--output", full, "--dev_tiny", "--approach", "rw", "--full_outputs",
    ])
    sd_cli.main([
        "--input_frame", str(frame), "--use_frozen", full,
        "--input_height", "128", "--input_width", "256", "--approach", "rw",
        "--save_data", "--results_dir", str(tmp_path / "r3"),
    ])
    arts = list((tmp_path / "r3" / "f").iterdir())
    assert len(arts) >= 10  # full artifact suite from the frozen program

    # the sequence entry serves from full-outputs blobs too (its artifact
    # suite needs dense fields; the reference sequence script also carries
    # the --use_frozen flag)
    from semantic_depth_tpu.cli import sequence as seq_cli

    seqf = str(tmp_path / "seq_full.shlo")
    exp_cli.main([
        "--semantic_model", "random", "--monodepth_checkpoint", "random",
        "--input_height", "128", "--input_width", "256",
        "--frame_height", "96", "--frame_width", "192",
        "--output", seqf, "--dev_tiny", "--approach", "rw", "--full_outputs",
    ])
    seq_cli.main([
        "--input_folder", str(tmp_path / "*.png"),
        "--use_frozen", seqf,
        "--input_height", "128", "--input_width", "256", "--approach", "rw",
        "--results_dir", str(tmp_path / "rseq"), "--output_name", "fz",
    ])
    imgs = tmp_path / "rseq" / "fz" / "result_sequence_imgs"
    assert sorted(p.name for p in imgs.iterdir()) == ["f.png"]

    # batched frozen serving with a RAGGED TAIL: the blob is pinned to
    # --batch 2 but only one frame exists — the tail is padded by repeating
    # the last frame and the padding dropped from the artifacts
    seqb = str(tmp_path / "seq_b2.shlo")
    exp_cli.main([
        "--semantic_model", "random", "--monodepth_checkpoint", "random",
        "--input_height", "128", "--input_width", "256",
        "--frame_height", "96", "--frame_width", "192", "--batch", "2",
        "--output", seqb, "--dev_tiny", "--approach", "rw", "--full_outputs",
    ])
    seq_cli.main([
        "--input_folder", str(tmp_path / "*.png"),
        "--use_frozen", seqb, "--batch", "2",
        "--input_height", "128", "--input_width", "256", "--approach", "rw",
        "--results_dir", str(tmp_path / "rseqb"), "--output_name", "fzb",
    ])
    imgs_b = tmp_path / "rseqb" / "fzb" / "result_sequence_imgs"
    assert sorted(p.name for p in imgs_b.iterdir()) == ["f.png"]

    # batched export: the streamed-sequence serving shape
    from semantic_depth_tpu.export import load_pipeline

    b2 = str(tmp_path / "tiny_b2.shlo")
    exp_cli.main([
        "--semantic_model", "random", "--monodepth_checkpoint", "random",
        "--input_height", "128", "--input_width", "256",
        "--frame_height", "96", "--frame_width", "192", "--batch", "2",
        "--output", b2, "--dev_tiny", "--approach", "rw",
    ])
    import jax.numpy as jnp

    frames = jnp.asarray(
        rng.uniform(0, 255, (2, 96, 192, 3)).astype(np.float32))
    out = load_pipeline(b2)(frames, jnp.float32(380.0), jnp.float32(192.0))
    assert np.asarray(out[0]).shape == (2,)  # per-frame scalars


@pytest.mark.heavy
def test_sharded_frozen_serving(tmp_path, frame_dir, monkeypatch):
    """--mesh dp over a BATCHED frozen export (VERDICT r3 #7): the blob's
    per-shard StableHLO program runs on each of the 8 virtual devices under
    one shard_map, serving batch = export_batch x dp. Results must match the
    unsharded blob shard-by-shard, and the sequence CLI must serve it."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(1)

    from semantic_depth_tpu.cli import export_pipeline as exp_cli

    common_flags = [
        "--semantic_model", "random", "--monodepth_checkpoint", "random",
        "--input_height", "128", "--input_width", "256",
        "--frame_height", "96", "--frame_width", "192",
        "--dev_tiny", "--approach", "rw",
    ]
    blob = str(tmp_path / "b1.shlo")
    exp_cli.main(common_flags + ["--batch", "1", "--output", blob])
    single_blob = str(tmp_path / "single.shlo")
    exp_cli.main(common_flags + ["--output", single_blob])

    from semantic_depth_tpu.export import load_pipeline, load_pipeline_sharded
    from semantic_depth_tpu.parallel import make_mesh

    mesh = make_mesh(8, dp=8, tp=1)
    call = load_pipeline_sharded(blob, mesh)
    assert call.global_batch == 8

    frames = rng.uniform(0, 255, (8, 96, 192, 3)).astype(np.float32)
    out = call(frames, 380.0, 192.0)
    single = load_pipeline(blob)
    got = np.asarray(out[0])
    want = np.concatenate(
        [np.asarray(single(frames[i : i + 1], 380.0, 192.0)[0]) for i in range(8)]
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # wrong global batch and non-batched blobs are usable errors
    with pytest.raises(ValueError, match="batch 8"):
        call(frames[:4], 380.0, 192.0)
    with pytest.raises(ValueError, match="BATCHED"):
        load_pipeline_sharded(single_blob, mesh)

    # sequence CLI end-to-end: full-outputs batched blob over --mesh dp
    from semantic_depth_tpu.cli import sequence as seq_cli

    full_blob = str(tmp_path / "bfull.shlo")
    exp_cli.main(common_flags + ["--batch", "1", "--full_outputs",
                                 "--output", full_blob])
    base = [
        "--input_folder", str(frame_dir / "*.png"), "--use_frozen", full_blob,
        "--input_height", "128", "--input_width", "256", "--approach", "rw",
        "--results_dir", str(tmp_path / "results"),
    ]
    seq_cli.main(base + ["--mesh", "dp", "--batch", "8", "--output_name", "fzdp"])
    imgs = tmp_path / "results" / "fzdp" / "result_sequence_imgs"
    assert sorted(p.name for p in imgs.iterdir()) == ["test_1.png", "test_2.png"]

    # a --batch that disagrees with export_batch x n is rejected up front
    with pytest.raises(SystemExit, match="--batch 8"):
        seq_cli.main(base + ["--mesh", "dp", "--batch", "4", "--output_name", "x"])
    # sp/pp still cannot serve a frozen blob
    with pytest.raises(SystemExit, match="frozen"):
        seq_cli.main(base + ["--mesh", "pp", "--batch", "8", "--output_name", "x"])


def test_monodepth_encoder_flag_reaches_config():
    """--monodepth_encoder must actually select the encoder (reference flag
    semantic_depth.py:721-722) — it was once parsed but silently ignored."""
    from semantic_depth_tpu.cli import semantic_depth as sd_cli

    args = sd_cli.build_arg_parser().parse_args(
        ["--input_frame", "x.png", "--monodepth_encoder", "resnet50"]
    )
    assert sd_cli.make_config(args).monodepth.encoder == "resnet50"


def test_native_s2d_size_validation_is_encoder_aware():
    """build_pipeline rejects sizes the packed trunk can't take, with the
    per-encoder granularity (vgg: %256 — 7 halvings on the half grid;
    resnet50: %128 — 6 halvings), and native mode disables flip_average."""
    import dataclasses

    import pytest as _pytest

    from semantic_depth_tpu.cli import common
    from semantic_depth_tpu.config import munich_pipeline_config

    cfg = munich_pipeline_config(input_height=128, input_width=256)
    with _pytest.raises(ValueError, match="multiples of 256"):
        common.build_pipeline(cfg, "random", "random", tiny=True, native_s2d=True)

    cfg_rn = dataclasses.replace(
        cfg, monodepth=dataclasses.replace(cfg.monodepth, encoder="resnet50")
    )
    # 128x256 is legal for the resnet50 trunk — and the built pipeline must
    # run single-forward disparity (flip_average off), like every other
    # native surface
    pipe = common.build_pipeline(cfg_rn, "random", "random", tiny=True,
                                 native_s2d=True)
    assert pipe.config.monodepth.flip_average is False
    out = pipe.process_batch(np.zeros((1, 128, 256, 3), np.uint8))
    assert np.asarray(out.disparity).shape == (1, 128, 256)


def test_munich_sweep_mode(tmp_path, monkeypatch):
    """--input_frame='' runs the 5-image sweep over two focal lengths with
    MAE data files and the best-focal report (semantic_depth.py:843-944)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(1)
    frames = tmp_path / "munich"
    frames.mkdir()
    for name in ["test_1.png", "test_2.png", "test_3.png", "test_4.png", "test_5.png"]:
        img = rng.integers(0, 256, size=(96, 192, 3)).astype(np.uint8)
        Image.fromarray(img).save(frames / name)

    from semantic_depth_tpu.cli import semantic_depth as cli

    cli.main(
        [
            "--input_frame", "",
            "--input_folder", str(frames),
            "--semantic_model", "random",
            "--monodepth_checkpoint", "random",
            "--input_height", "128",
            "--input_width", "256",
            "--dev_tiny",
            "--results_dir", str(tmp_path / "results"),
        ]
    )
    for f in ("380", "580"):
        data = (tmp_path / "results" / f / "data.txt").read_text().splitlines()
        assert len(data) == 6  # 5 frames + MAE row
        assert all(len(row.split()) == 5 for row in data)
    best = (tmp_path / "results" / "best_focal_lengths.txt").read_text()
    assert best.startswith("Best f road's width:")


def test_sequence_skips_corrupt_frames(tmp_path, frame_dir, monkeypatch):
    """Fault injection: an unreadable frame is skipped with a warning; the
    stream continues (the reference would crash)."""
    monkeypatch.chdir(tmp_path)
    (frame_dir / "test_1a_corrupt.png").write_bytes(b"not a png at all")
    from semantic_depth_tpu.cli import sequence as cli

    cli.main(
        [
            "--input_folder", str(frame_dir / "*.png"),
            "--semantic_model", "random",
            "--monodepth_checkpoint", "random",
            "--input_height", "128",
            "--input_width", "256",
            "--dev_tiny",
            "--results_dir", str(tmp_path / "results"),
            "--output_name", "seq2",
        ]
    )
    imgs = tmp_path / "results" / "seq2" / "result_sequence_imgs"
    assert sorted(p.name for p in imgs.iterdir()) == ["test_1.png", "test_2.png"]


def test_profile_stages_times_file(tmp_path, frame_dir, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from semantic_depth_tpu.cli import semantic_depth as cli

    cli.main(
        [
            "--input_frame", str(frame_dir / "test_1.png"),
            "--semantic_model", "random",
            "--monodepth_checkpoint", "random",
            "--input_height", "128",
            "--input_width", "256",
            "--dev_tiny",
            "--profile_stages",
            "--results_dir", str(tmp_path / "results"),
        ]
    )
    times = (tmp_path / "results" / "test_1" / "test_1_output_times.txt").read_text()
    lines = dict(
        (ln.split(":")[0], float(ln.split(":")[1])) for ln in times.splitlines()
    )
    # staged mode must produce nonzero per-stage wall times
    assert lines["Time semantic"] > 0
    assert lines["Time disparity"] > 0
    assert lines["Time road"] > 0


def test_sequence_batched_mode(tmp_path, frame_dir, monkeypatch):
    """--batch >1 routes through the fused batch program; artifacts match
    the frame list, including a ragged tail batch."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(96, 192, 3)).astype(np.uint8)
    Image.fromarray(img).save(frame_dir / "test_3.png")

    from semantic_depth_tpu.cli import sequence as cli

    cli.main(
        [
            "--input_folder", str(frame_dir / "*.png"),
            "--semantic_model", "random",
            "--monodepth_checkpoint", "random",
            "--input_height", "128",
            "--input_width", "256",
            "--dev_tiny",
            "--batch", "2",
            "--results_dir", str(tmp_path / "results"),
            "--output_name", "seqb",
        ]
    )
    imgs = tmp_path / "results" / "seqb" / "result_sequence_imgs"
    assert sorted(p.name for p in imgs.iterdir()) == [
        "test_1.png", "test_2.png", "test_3.png"
    ]


def test_monodepth_infer_cli(tmp_path, frame_dir, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from semantic_depth_tpu.cli import monodepth_infer as cli

    cli.main(
        [
            "--input", str(frame_dir / "*.png"),
            "--monodepth_checkpoint", "random",
            "--input_height", "128",
            "--input_width", "256",
            "--dev_tiny",
            "--save_npy",
            "--out_dir", str(tmp_path / "disp"),
        ]
    )
    outs = sorted(p.name for p in (tmp_path / "disp").iterdir())
    assert "test_1_disp.png" in outs and "test_1_disp.npy" in outs
    d = np.load(tmp_path / "disp" / "test_1_disp.npy")
    assert d.shape == (128, 256)
    assert d.min() >= 0 and d.max() <= 0.3 + 1e-6  # normalized disparity


def test_sequence_cli_dispatches_uint8(tmp_path, frame_dir, monkeypatch):
    """The sequence entry must ship frames to the device as uint8 — upcasting
    on host quadruples traffic on the host->device link (the reference feeds
    uint8 BGR from cv2.imread, semantic_depth.py:105)."""
    monkeypatch.chdir(tmp_path)
    from semantic_depth_tpu.cli import common, sequence as cli

    seen = []
    orig_build = common.build_pipeline

    def spying_build(*a, **k):
        pipe = orig_build(*a, **k)
        orig_frame, orig_batch = pipe.process_frame, pipe.process_batch

        def spy_frame(frame, *aa, **kk):
            seen.append(np.asarray(frame).dtype)
            return orig_frame(frame, *aa, **kk)

        def spy_batch(frames, *aa, **kk):
            seen.append(np.asarray(frames).dtype)
            return orig_batch(frames, *aa, **kk)

        pipe.process_frame = spy_frame
        pipe.process_batch = spy_batch
        return pipe

    monkeypatch.setattr(cli.common, "build_pipeline", spying_build)
    for batch in ("1", "2"):
        seen.clear()
        cli.main(
            [
                "--input_folder", str(frame_dir / "*.png"),
                "--semantic_model", "random",
                "--monodepth_checkpoint", "random",
                "--input_height", "128",
                "--input_width", "256",
                "--batch", batch,
                "--output_name", f"sequ8_{batch}",
                "--results_dir", str(tmp_path / "results"),
                "--dev_tiny",
            ]
        )
        assert seen and all(d == np.uint8 for d in seen), seen


def test_annotation_pil_fallback(monkeypatch):
    """Without cv2 the annotation must still render (PIL), not silently
    return the un-annotated image."""
    from semantic_depth_tpu.cli import common

    monkeypatch.setattr(common, "_HAS_CV2", False)
    img = np.full((200, 400, 3), 40, np.uint8)
    out = common.annotate_sequence(
        img.copy(), 10.0, True, 5.25, np.array([-2.6, 0, -10.0]),
        np.array([2.65, 0, -10.0]),
    )
    assert out.shape == img.shape
    assert (out != img).any(), "PIL fallback must draw the band + text"
    # header band filled with the reference gray
    assert (out[0, 0] == np.array([156, 157, 159])).all()

    out2 = common.annotate_sequence(img.copy(), 10.0, False)
    assert (out2 != img).any(), "'Cannot compute width' text must render"

    out3 = common.annotate_single(
        img.copy(), 10.0, True, "rw", 5.0, np.array([-2.5, 0, -10.0]),
        np.array([2.5, 0, -10.0]),
    )
    assert (out3 != img).any()


def test_prefetch_decoded_preserves_order_and_none_frames():
    """The threaded decode prefetcher (VERDICT r4 #4) must yield frames in
    input order, including the None placeholders the loaders return for
    unreadable frames (the skip guard relies on them)."""
    from semantic_depth_tpu.cli import common as c

    def load(p):
        return None if p == "bad" else p.upper()

    paths = ["a", "bad", "b", "c", "d", "e"]
    got = list(c.prefetch_decoded(paths, load, depth=3))
    assert got == [(p, None if p == "bad" else p.upper()) for p in paths]
    # degenerate depths/few items still drain completely
    assert list(c.prefetch_decoded(["x"], load, depth=8)) == [("x", "X")]
    assert list(c.prefetch_decoded([], load)) == []


def test_port_cli_dpt_large_encoder(tmp_path, frame_dir, monkeypatch):
    """The PyTorch port's --monodepth_encoder dpt_large: accepted, builds
    ``models.DPT`` (the --dev_tiny sizes, the seeded pair of scale and
    shift), runs the sequence CLI on the CPU, and loads a ``torch.save``d
    state dict of its own keys; --native_s2d is refused with its message;
    an unknown encoder still raises."""
    import torch

    from semantic_depth_tpu_torch.cli import common
    from semantic_depth_tpu_torch.cli import sequence as seq
    from semantic_depth_tpu_torch.config import munich_pipeline_config
    from semantic_depth_tpu_torch.models import DPT

    cfg = common.apply_encoder_override(
        munich_pipeline_config(input_height=128, input_width=256), "dpt_large")
    assert cfg.monodepth.encoder == "dpt_large"
    pipe = common.build_pipeline(cfg, "random", "random", tiny=True, device="cpu")
    assert isinstance(pipe.mono, DPT) and pipe.config.monodepth.flip_average
    assert len(pipe.mono.blocks) == common.DPT_TINY["layers"]
    assert (pipe.mono.scale, pipe.mono.shift) == (common.DPT_SEEDED["scale"],
                                                  common.DPT_SEEDED["shift"])
    state = {k: torch.full_like(v, 0.01) for k, v in pipe.mono.state_dict().items()}
    torch.save(state, tmp_path / "dpt.pt")
    loaded = common.build_pipeline(cfg, "random", str(tmp_path / "dpt.pt"), tiny=True,
                                   device="cpu")
    assert all(torch.equal(v, state[k]) for k, v in loaded.mono.state_dict().items())
    with pytest.raises(ValueError, match="--native_s2d: DPT-Large has no input_s2d form"):
        common.build_pipeline(cfg, "random", "random", tiny=True, native_s2d=True,
                              device="cpu")
    for bad in ("vit_large", "dpt"):
        with pytest.raises(ValueError, match="unknown monodepth encoder"):
            common.apply_encoder_override(cfg, bad)
    monkeypatch.chdir(tmp_path)
    seq.main(["--input_folder", str(frame_dir / "*.png"), "--semantic_model", "random",
              "--monodepth_checkpoint", "random", "--monodepth_encoder", "dpt_large",
              "--input_height", "128", "--input_width", "256", "--dev_tiny", "--device", "cpu",
              "--batch", "2", "--output_name", "dpt"])
    imgs = tmp_path / "results" / "dpt" / "result_sequence_imgs"
    assert sorted(os.listdir(imgs)) == ["test_1.png", "test_2.png"]
