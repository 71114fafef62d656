"""The port's FCN-8s training path against the JAX package on the CPU: the
metrics, the losses, the numpy resize twins, the data loader, the mockup
generator, dropout and init, one and two Adam steps, checkpoints, the
metric logs, msgpack weights in both directions and the FCN CLI.

Sizes are small: FCN-8s at width 0.125 with fc 32 on 32x64 images. Every
comparison states its tolerance."""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu.cli import fcn as jcli
from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import weights as jweights
from semantic_depth_tpu.models.fcn8s import decoder_l2_loss as jax_decoder_l2_loss
from semantic_depth_tpu.ops import resize as jresize
from semantic_depth_tpu.train import data as jdata
from semantic_depth_tpu.train import metrics as jmetrics
from semantic_depth_tpu.train import trainer as jtrainer
from semantic_depth_tpu.utils import make_mockup as jmockup
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch.cli import fcn as tcli
from semantic_depth_tpu_torch.models import FCN8s
from semantic_depth_tpu_torch.models.fcn8s import DECODER_LAYERS, decoder_l2_loss
from semantic_depth_tpu_torch.models.from_flax import (
    adam_state_from_optax, load_flax, optax_from_adam_state)
from semantic_depth_tpu_torch.ops import resize as tresize
from semantic_depth_tpu_torch.train import data as tdata
from semantic_depth_tpu_torch.train import metrics as tmetrics
from semantic_depth_tpu_torch.train import trainer as ttrainer
from semantic_depth_tpu_torch.utils import make_mockup as tmockup

from torch_helpers import flax_flat, numpy_params, port_flat

torch.set_num_threads(2)  # six xdist workers share the machine

_SMALL = dict(width_mult=0.125, fc_channels=32)
_HW = (32, 64)
_LR = 1e-3  # large enough that a step moves float32 parameters well past their rounding


def _toy_batch(seed, n=2, h=32, w=64):
    """Learnable: the class is the vertical third, painted into a channel."""
    rng = np.random.default_rng(seed)
    cls = np.digitize(np.arange(h), [h // 3, 2 * h // 3])
    labels = np.broadcast_to(np.eye(3, dtype=np.float32)[cls][None, :, None], (n, h, w, 3))
    images = labels * 200 + rng.normal(0, 8, (n, h, w, 3))
    return images.astype(np.float32), np.ascontiguousarray(labels)


# --- metrics and losses -------------------------------------------------------------


@pytest.mark.parametrize("absent", [False, True])
def test_confusion_matrix_and_mean_iou_equal_jax(absent):
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 3, 10000)
    preds = np.where(rng.random(10000) < 0.7, labels, rng.integers(0, 3, 10000))
    if absent:  # class 2 in neither labels nor predictions: left out of the mean
        labels, preds = labels % 2, preds % 2
    want_cm = np.asarray(jmetrics.confusion_matrix(jnp.asarray(labels), jnp.asarray(preds), 3))
    got_cm = tmetrics.confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds), 3)
    assert got_cm.dtype == torch.float32
    np.testing.assert_array_equal(got_cm.numpy(), want_cm)  # exact counts
    assert float(tmetrics.mean_iou_from_cm(got_cm)) == float(
        jmetrics.mean_iou_from_cm(jnp.asarray(want_cm)))  # exact
    jm, tm = jmetrics.MeanIoU(3), tmetrics.MeanIoU(3)
    for i in range(0, 10000, 2500):
        jm.update(jnp.asarray(labels[i:i + 2500]), jnp.asarray(preds[i:i + 2500]))
        tm.update(labels[i:i + 2500], preds[i:i + 2500])
    assert tm.result() == jm.result()
    tm.reset()
    assert tm.result() == 0.0


def test_softmax_xent_and_decoder_l2_equal_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (2, 8, 16, 3)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 8, 16))]
    want = float(jtrainer.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(ttrainer.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)

    x = np.zeros((1, *_HW, 3), np.float32)
    params = numpy_params(JaxFCN8s(num_classes=3, **_SMALL), x, seed=1)
    net = load_flax(FCN8s(num_classes=3, **_SMALL), params)
    want = float(jax_decoder_l2_loss(params, 1e-3))
    with torch.no_grad():
        assert float(decoder_l2_loss(net, 1e-3)) == pytest.approx(want, rel=1e-6)


def test_train_config_equals_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.TrainConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.TrainConfig)]
    assert tf == jf


# --- host resize and data -----------------------------------------------------------


@pytest.mark.parametrize("method", ["cubic", "linear", "nearest"])
def test_resize_np_equals_jax(method):
    rng = np.random.default_rng(6)
    for img, hw in ((rng.uniform(0, 255, (37, 70, 3)), (16, 32)),
                    (rng.integers(0, 30, (50, 90)).astype(np.uint8), (64, 128)),
                    (rng.uniform(0, 1, (20, 40, 3)).astype(np.float32), (20, 40))):
        np.testing.assert_array_equal(tresize.resize_np(img, hw, method),
                                      jresize.resize_np(img, hw, method))  # exact
        np.testing.assert_array_equal(tresize.resize_clip_u8_np(img, hw, method),
                                      jresize.resize_clip_u8_np(img, hw, method))


def test_make_mockup_writes_the_jax_bytes(tmp_path):
    roots = [mod.make_mockup(str(tmp_path / name), counts=(2, 1, 1), hw=(48, 96), seed=3)
             for mod, name in ((jmockup, "jax"), (tmockup, "port"))]
    files = sorted(os.path.relpath(os.path.join(d, f), roots[0])
                   for d, _, fs in os.walk(roots[0]) for f in fs)
    assert len(files) == 8
    for rel in files:
        with open(os.path.join(roots[0], rel), "rb") as a, open(os.path.join(roots[1], rel),
                                                                "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("dataset", ["cityscapes", "roborace750"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_prepare_ground_truth_equals_jax(dataset, mode):
    ids = np.arange(40, dtype=np.uint8).reshape(5, 8)
    np.testing.assert_array_equal(tdata.prepare_ground_truth(dataset, ids, mode=mode),
                                  jdata.prepare_ground_truth(dataset, ids, mode=mode))


@pytest.fixture(scope="module")
def wide_tree(tmp_path_factory):
    """400x800 frames: wider than 770 px, so train batches take the random
    crop path; both packages read the same files."""
    out = tmp_path_factory.mktemp("seg")
    jmockup.make_mockup(str(out), "cityscapes_toy", counts=(3, 2, 2), hw=(400, 800), seed=1)
    return str(out)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_segmentation_batches_bit_equal_to_jax(wide_tree, mode):
    kw = dict(image_shape=_HW, seed=7)
    jds = jdata.SegmentationDataset(wide_tree, "cityscapes_toy", **kw)
    tds = tdata.SegmentationDataset(wide_tree, "cityscapes_toy", **kw)
    assert tds.num_images(mode) == jds.num_images(mode)
    for _ in range(2):  # two epochs: the shared stream goes on in step
        want = list(jds.batches(2, mode=mode))
        got = list(tds.batches(2, mode=mode, prefetch=0 if mode == "val" else 2))
        assert len(got) == len(want) > 0
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == wi.dtype == np.float32
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_prefetched_releases_its_producer_on_early_exit():
    finished = threading.Event()

    def items():
        try:
            for i in range(1000):
                yield i
        finally:
            finished.set()

    it = tdata._prefetched(items(), depth=2)
    assert next(it) == 0
    it.close()  # the consumer stops after one item
    assert finished.wait(5.0)

    def broken():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):  # the producer's error reaches the consumer
        list(tdata._prefetched(broken(), depth=1))


# --- dropout and init ---------------------------------------------------------------


def test_dropout_identity_scale_rate_and_stream():
    x = torch.rand((1, 2, 4, 8), generator=torch.Generator().manual_seed(0)) + 0.5
    net = FCN8s(num_classes=3, dropout_keep_prob=1.0, **_SMALL)
    assert net._dropout(x, torch.Generator()) is x  # keep 1: flax returns the input
    net = FCN8s(num_classes=3, dropout_keep_prob=0.7, **_SMALL)
    big = torch.rand((1, 64, 64, 64), generator=torch.Generator().manual_seed(1)) + 0.5
    out = net._dropout(big, torch.Generator().manual_seed(2))
    kept = out != 0
    torch.testing.assert_close(out[kept], big[kept] / torch.tensor(0.7), rtol=0, atol=0)
    n, frac = big.numel(), kept.float().mean().item()
    assert abs(frac - 0.7) < 3 * (0.7 * 0.3 / n) ** 0.5, frac  # within 3 sigma
    again = net._dropout(big, torch.Generator().manual_seed(2))
    assert torch.equal(again, out)  # the same generator seed gives the same mask
    images = torch.from_numpy(_toy_batch(0, n=1)[0])
    with torch.no_grad():
        a = net(images, train=True, generator=torch.Generator().manual_seed(3))
        b = net(images, train=True, generator=torch.Generator().manual_seed(3))
        c = net(images, train=True, generator=torch.Generator().manual_seed(4))
        d = net(images)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_fcn_init_moments_match_flax_per_layer():
    """Each kernel's std against flax's init of the same layer: within 5%,
    or within 4 sigma of the two samples' std estimates where a layer has
    too few weights for 5% (conv1_1, the score layers)."""
    kw = dict(width_mult=0.25, fc_channels=64)
    want = flax_flat(jax.jit(JaxFCN8s(num_classes=3, **kw).init)(jax.random.PRNGKey(0),
                                                             jnp.zeros((1, *_HW, 3))))
    got = port_flat(FCN8s(num_classes=3, generator=torch.Generator().manual_seed(0), **kw))
    assert got.keys() == want.keys()
    for name, w in got.items():
        if name.endswith("bias"):
            assert not w.any() and not want[name].any(), name
            continue
        n = w.size
        tol = max(0.05, 4 * np.sqrt(1 / n))  # std of each estimate ~ 1/sqrt(2n)
        assert abs(w.std() / want[name].std() - 1) < tol, (name, w.std(), want[name].std())
        assert abs(w.mean()) < 4 * want[name].std() / np.sqrt(n), name
        if name.split(".")[0] in DECODER_LAYERS:  # truncated_normal(0.01): cut at +-2 sigma
            assert np.abs(w).max() <= 0.02 and np.abs(want[name]).max() <= 0.02


# --- train and eval steps against the JAX trainer -----------------------------------


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX trainer's first two steps from numpy-seeded parameters, at
    keep 1.0 (dropout masks cannot match across the frameworks)."""
    images, labels = _toy_batch(1)
    params = numpy_params(JaxFCN8s(num_classes=3, **_SMALL), images, seed=2)
    cfg = jconfig.TrainConfig(learning_rate=_LR, image_shape=_HW, batch_size=2)
    jt = jtrainer.FCNTrainer(cfg, model=JaxFCN8s(num_classes=3, dropout_keep_prob=1.0, **_SMALL),
                             init_params=params)
    states, metrics = [jax.tree.map(np.asarray, params)], []
    opt_states = []
    for _ in range(2):
        metrics.append(jt.train_batch(jnp.asarray(images), jnp.asarray(labels)))
        states.append(jax.tree.map(np.asarray, jt.state.params))
        opt_states.append(jax.tree.map(np.asarray, jt.state.opt_state))
    evals = jt.eval_batch(jnp.asarray(images), jnp.asarray(labels))
    return dict(images=images, labels=labels, states=states, metrics=metrics,
                opt_states=opt_states, eval=evals, cfg=cfg)


def _port_trainer(params, **kw):
    cfg = tconfig.TrainConfig(learning_rate=_LR, image_shape=_HW, batch_size=2)
    return ttrainer.FCNTrainer(cfg, model=FCN8s(num_classes=3, dropout_keep_prob=1.0, **_SMALL),
                               init_params=params, device="cpu", **kw)


def _check_step(tt, got_m, want_m, before, after, grads_want):
    """Loss rel 1e-5, cm within 0.1% of the pixels (at least one), the
    gradients (rtol 1e-4, atol 1e-4 of the layer's largest), then the
    post-step parameters on the elements where |g| > 1e-4 max|g|: Adam's
    steps are lr * g / (|g| + eps)-like, so an element whose gradient is
    float32 noise may step either way; elsewhere within 2e-6 (0.2% of lr)."""
    assert got_m["loss"] == pytest.approx(want_m["loss"], rel=1e-5)
    pixels = want_m["cm"].sum()
    assert np.abs(got_m["cm"] - want_m["cm"]).sum() / 2 <= max(1, 1e-3 * pixels)
    grads = port_flat(tt.model, grads=True)
    params = port_flat(tt.model)
    for name, g_want in grads_want.items():
        scale = np.abs(g_want).max()
        np.testing.assert_allclose(grads[name], g_want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
        big = np.abs(g_want) > 1e-4 * scale
        np.testing.assert_allclose(params[name][big], after[name][big], rtol=0, atol=2e-6,
                                   err_msg=name)
        assert not np.array_equal(after[name][big], before[name][big]), name


def test_fcn_train_step_matches_jax(jax_steps):
    js = jax_steps
    tt = _port_trainer(js["states"][0])
    m = tt.train_batch(js["images"], js["labels"])
    # optax's first moment after step 1 is (1 - b1) * g
    mu = flax_flat(js["opt_states"][0][0].mu)
    grads_want = {k: v / np.float32(0.1) for k, v in mu.items()}
    _check_step(tt, m, js["metrics"][0], flax_flat(js["states"][0]), flax_flat(js["states"][1]),
                grads_want)
    assert m["iou"] == pytest.approx(js["metrics"][0]["iou"], abs=1e-3)


def test_fcn_second_step_from_the_jax_adam_state(jax_steps):
    js = jax_steps
    tt = _port_trainer(js["states"][1])
    sd = tt.optimizer.state_dict()
    sd["state"] = adam_state_from_optax(js["opt_states"][0], tt.model)
    tt.optimizer.load_state_dict(sd)
    back = optax_from_adam_state(tt.optimizer.state_dict()["state"], tt.model)
    assert int(back["count"]) == int(js["opt_states"][0][0].count) == 1
    for key in ("mu", "nu"):
        want = flax_flat(getattr(js["opt_states"][0][0], key))
        for name, v in flax_flat(back[key]).items():
            np.testing.assert_array_equal(v, want[name])  # the mapping round-trips exactly
    m = tt.train_batch(js["images"], js["labels"])
    # step 2's gradient: mu_2 = b1 * mu_1 + (1 - b1) * g_2
    mu1, mu2 = flax_flat(js["opt_states"][0][0].mu), flax_flat(js["opt_states"][1][0].mu)
    grads_want = {k: (mu2[k] - np.float32(0.9) * mu1[k]) / np.float32(0.1) for k in mu1}
    _check_step(tt, m, js["metrics"][1], flax_flat(js["states"][1]), flax_flat(js["states"][2]),
                grads_want)


def test_fcn_eval_batch_matches_jax(jax_steps):
    js = jax_steps
    tt = _port_trainer(js["states"][2])
    got, want = tt.eval_batch(js["images"], js["labels"]), js["eval"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert np.abs(got["cm"] - want["cm"]).sum() / 2 <= max(1, 1e-3 * want["cm"].sum())
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0, atol=1e-5)


def test_fcn_checkpoint_resumes_like_an_uninterrupted_run(tmp_path):
    cfg = tconfig.TrainConfig(learning_rate=_LR, image_shape=_HW)
    model = lambda: FCN8s(num_classes=3, generator=torch.Generator().manual_seed(5),  # noqa: E731
                          **_SMALL)
    images, labels = _toy_batch(2, n=1)
    a = ttrainer.FCNTrainer(cfg, model=model(), seed=1, device="cpu")
    a.train_batch(images, labels)
    a.save_checkpoint(str(tmp_path))
    assert os.path.isfile(tmp_path / "step_1" / "state.pt")
    b = ttrainer.FCNTrainer(cfg, model=model(), seed=9, device="cpu")
    b.restore_checkpoint(str(tmp_path), 1)
    assert b.step == 1
    assert a.eval_batch(images, labels)["loss"] == b.eval_batch(images, labels)["loss"]
    b.generator.set_state(a.generator.get_state())  # align the dropout stream (keep 0.5)
    ma, mb = a.train_batch(images, labels), b.train_batch(images, labels)
    assert ma["loss"] == mb["loss"]
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name


def test_write_metric_logs_csv_bytes_equal_jax(tmp_path):
    vals = ([1.0986122886681098, 0.5, float("nan")], [1.1, 0.25, 0.125], [1, 2, 3])
    jtrainer.write_metric_logs(str(tmp_path / "jax"), "m", "loss", *vals)
    path = ttrainer.write_metric_logs(str(tmp_path / "port"), "m", "loss", *vals)
    jax_csv = [p for p in os.listdir(tmp_path / "jax" / "m" / "loss") if p.endswith(".csv")]
    assert os.listdir(tmp_path / "port" / "m" / "loss") == [os.path.basename(path)]
    with open(path, "rb") as f, open(tmp_path / "jax" / "m" / "loss" / jax_csv[0], "rb") as g:
        assert f.read() == g.read()


# --- weights across the packages and the CLI ----------------------------------------


def test_port_trained_msgpack_gives_the_same_logits_in_jax(tmp_path):
    images, labels = _toy_batch(3, n=1)
    cfg = tconfig.TrainConfig(learning_rate=_LR, image_shape=_HW)
    tt = ttrainer.FCNTrainer(cfg, model=FCN8s(num_classes=3, **_SMALL), device="cpu")
    tt.train_batch(images, labels)
    path = tt.save_msgpack(str(tmp_path / "fcn8s.msgpack"))
    jnet = JaxFCN8s(num_classes=3, **_SMALL)
    template = jax.eval_shape(lambda x: jnet.init(jax.random.PRNGKey(0), x), jnp.asarray(images))
    want = np.asarray(jnet.apply(jweights.load_params(template, path), jnp.asarray(images)))
    with torch.no_grad():
        got = tt.model(torch.from_numpy(images)).numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _cli_args(tree, tmp_path, dataset="cityscapes_toy"):
    return ["--dataset", dataset, "--data_dir", tree, "--image_shape", "(32,64)",
            "--model_dir", str(tmp_path / "models"), "--logging_dir", str(tmp_path / "log"),
            "--runs_dir", str(tmp_path / "runs"), "--dev_tiny"]


def _test_iou(log_dir):
    (name,) = [p for p in os.listdir(log_dir) if p.startswith("test_set_iou_")]
    with open(os.path.join(log_dir, name)) as f:
        return float(f.read().splitlines()[-1].split(":")[1])


def test_fcn_cli_train_then_test_on_the_cpu(tmp_path, wide_tree, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = _cli_args(wide_tree, tmp_path) + ["--device", "cpu"]
    tcli.main(["--mode", "train", "--epochs", "2", "--inference_flag"] + args)
    name = "2-Epochs-cityscapes_toy"
    model_dir = tmp_path / "models" / name
    assert (model_dir / "fcn8s.msgpack").is_file()
    assert (model_dir / "checkpoints" / "step_6" / "state.pt").is_file()  # 2 x 3 images
    for metric in ("loss", "iou"):
        assert any(p.suffix == ".csv" for p in (tmp_path / "log" / name / metric).iterdir())
    (run_dir,) = (tmp_path / "runs" / name).iterdir()
    assert sorted(p.name for p in run_dir.iterdir()) == sorted(
        os.listdir(os.path.join(wide_tree, "cityscapes_toy", "leftImg8bit", "test", "mockup")))
    assert len((tmp_path / "times.txt").read_text().splitlines()) == 2
    trained = _test_iou(tmp_path / "log" / name / "iou")
    os.remove(next((tmp_path / "log" / name / "iou").iterdir()))
    tcli.main(["--mode", "test", "--model", name] + args)
    assert _test_iou(tmp_path / "log" / name / "iou") == trained
    with pytest.raises(SystemExit, match="semantic_depth_tpu.models.convert"):
        tcli.main(["--mode", "train", "--epochs", "1", "--init_from",
                   str(tmp_path / "vgg16_tf_ckpt")] + args)
    with pytest.raises(SystemExit, match="multi-device training is not ported yet"):
        tcli.main(["--mode", "train", "--epochs", "1", "--mesh"] + args)


def test_fcn_cli_test_mode_on_a_jax_msgpack_gives_the_jax_iou(tmp_path, wide_tree,
                                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    name = "7-Epochs-cityscapes_toy"
    (tmp_path / "models" / name).mkdir(parents=True)
    x = np.zeros((1, *_HW, 3), np.float32)
    params = numpy_params(JaxFCN8s(num_classes=3, **_SMALL), x, seed=3)
    jweights.save_params(params, str(tmp_path / "models" / name / "fcn8s.msgpack"))
    args = _cli_args(wide_tree, tmp_path)
    jcli.main(["--mode", "test", "--model", name] + args)
    want = _test_iou(tmp_path / "log" / name / "iou")
    os.remove(next((tmp_path / "log" / name / "iou").iterdir()))
    tcli.main(["--mode", "test", "--model", name, "--device", "cpu"] + args)
    assert 0.0 < want < 1.0
    assert _test_iou(tmp_path / "log" / name / "iou") == pytest.approx(want, rel=1e-6)
