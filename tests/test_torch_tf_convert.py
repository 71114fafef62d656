"""The port's TF1 converters (``models/weights.py``), its convert CLI and the
CLIs' TF loading against the JAX package's converters, on checkpoints that
TensorFlow wrote (skipped without TensorFlow) and on the committed fixtures
(read with no TensorFlow). Converted trees must be bit-equal; the networks
loaded from them agree with the JAX networks within the model parity
tests' tolerances."""

import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu.models import weights as JW
from semantic_depth_tpu_torch.cli import common
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.models import convert as tconvert
from semantic_depth_tpu_torch.models import weights as W
from semantic_depth_tpu_torch.models.from_flax import flax_from_module

from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "tf1"
_FCN_TINY = dict(num_classes=3, width_mult=0.0625, fc_channels=16)


def _flat(tree):
    return {(layer, kind): np.asarray(v) for layer, leaf in tree["params"].items()
            for kind, v in leaf.items()}


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key


def _tf1_save(prefix, var_specs):
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    with tf1.Graph().as_default():
        for name, arr in var_specs.items():
            tf1.get_variable(name, initializer=tf.constant(arr))
        saver = tf1.train.Saver(save_relative_paths=True)
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, prefix, write_meta_graph=False)
    return prefix


def _mono_specs(params, enc_order, n_ups, deconv=False, slots=False):
    """slim names of a monodepth tree (``Conv2d_transpose`` numbered apart
    under ``deconv``), with Adam slots and the step counters."""
    p = params["params"]
    specs = {}
    ci = di = 0
    for our in enc_order:
        specs[f"model/encoder/{'Conv' if ci == 0 else f'Conv_{ci}'}"] = p[our]
        ci += 1
    ci = 0
    for our in JW._monodepth_decoder_order(n_ups):
        if deconv and our.startswith("upconv"):
            base, di = ("Conv2d_transpose" if di == 0 else f"Conv2d_transpose_{di}"), di + 1
        else:
            base, ci = ("Conv" if ci == 0 else f"Conv_{ci}"), ci + 1
        specs[f"model/decoder/{base}"] = p[our]
    out = {}
    for scope, leaf in specs.items():
        for tf_kind, kind in (("weights", "kernel"), ("biases", "bias")):
            out[f"{scope}/{tf_kind}"] = np.asarray(leaf[kind])
            if slots:
                out[f"{scope}/{tf_kind}/Adam"] = np.asarray(leaf[kind]) * 0.5
                out[f"{scope}/{tf_kind}/Adam_1"] = np.asarray(leaf[kind]) ** 2
    if slots:
        out.update(beta1_power=np.float32(0.9), beta2_power=np.float32(0.999),
                   global_step=np.int64(77))
    return out


def _fcn_specs(params, naming):
    p = params["params"]
    w, b = {"filter": ("filter", "biases"), "weights": ("weights", "biases"),
            "kernel": ("kernel", "bias")}[naming]
    specs = {}
    for scope, our in JW._FCN_VGG_NAME_MAP.items():
        specs[f"{scope}/{w}"] = np.asarray(p[our]["kernel"])
        specs[f"{scope}/{b}"] = np.asarray(p[our]["bias"])
    for base, order in (("conv2d", JW._FCN_DECODER_CONV_ORDER),
                        ("conv2d_transpose", JW._FCN_DECODER_DECONV_ORDER)):
        for i, our in enumerate(order):
            scope = base if i == 0 else f"{base}_{i}"
            specs[f"{scope}/kernel"] = np.asarray(p[our]["kernel"])
            specs[f"{scope}/bias"] = np.asarray(p[our]["bias"])
    return specs


def _frames(seed, b=1, h=128, w=256, scale=1.0):
    return (np.random.default_rng(seed).uniform(0, 1, size=(b, h, w, 3)) * scale).astype(
        np.float32)


@pytest.mark.parametrize("encoder,deconv", [("vgg", False), ("vgg", True), ("resnet50", False)],
                         ids=["vgg", "vgg_deconv", "resnet50"])
def test_monodepth_conversion_bit_equal_to_jax_and_forward_agrees(tmp_path, encoder, deconv):
    x = _frames(3)
    jnet = JaxMonodepth(encoder=encoder, width_mult=0.0625, use_deconv=deconv)
    params = numpy_params(jnet, x, seed=5)
    enc = (JW._MONODEPTH_VGG_ENCODER if encoder == "vgg"
           else JW._monodepth_resnet_encoder_order())
    n_ups = 7 if encoder == "vgg" else 6
    ckpt = _tf1_save(str(tmp_path / "m" / "model"),
                     _mono_specs(params, enc, n_ups, deconv, slots=True))
    want = JW.convert_monodepth_checkpoint(ckpt, encoder=encoder, use_deconv=deconv)
    got = W.convert_monodepth_checkpoint(ckpt, encoder=encoder, use_deconv=deconv)
    _assert_bit_equal(got, want)
    _assert_bit_equal(got, jnp_tree(params))
    assert W._monodepth_decoder_order(n_ups) == JW._monodepth_decoder_order(n_ups)
    net = W.as_torch_params(Monodepth(encoder, width_mult=0.0625, use_deconv=deconv), got)
    with torch.no_grad():
        disps = net.eval()(torch.from_numpy(x))
    jdisps = jnet.apply(want, jnp.asarray(x))
    assert len(disps) == len(jdisps) == 4
    for d, jd in zip(disps, jdisps):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


def jnp_tree(params):
    return {"params": {k: {n: np.asarray(v) for n, v in leaf.items()}
                       for k, leaf in params["params"].items()}}


def test_monodepth_conversion_errors_match_jax(tmp_path):
    x = _frames(4)
    jnet = JaxMonodepth(encoder="resnet50", width_mult=0.0625)
    params = numpy_params(jnet, x, seed=6)
    specs = _mono_specs(params, JW._monodepth_resnet_encoder_order(), 6)
    short = {k: v for k, v in specs.items() if not k.startswith("model/encoder/Conv_64/")}
    ckpt = _tf1_save(str(tmp_path / "short" / "model"), short)
    for conv in (JW.convert_monodepth_checkpoint, W.convert_monodepth_checkpoint):
        with pytest.raises(ValueError, match="has 64 encoder convs; expected 65"):
            conv(ckpt, encoder="resnet50")
    no_bias = {k: v for k, v in specs.items() if k != "model/decoder/Conv_3/biases"}
    ckpt = _tf1_save(str(tmp_path / "nobias" / "model"), no_bias)
    for conv in (JW.convert_monodepth_checkpoint, W.convert_monodepth_checkpoint):
        with pytest.raises(KeyError, match="model/decoder/Conv_3/biases not in checkpoint"):
            conv(ckpt, encoder="resnet50")
    for conv in (JW.convert_monodepth_checkpoint, W.convert_monodepth_checkpoint):
        with pytest.raises(ValueError, match="mobilenet"):
            conv(ckpt, encoder="mobilenet")


@pytest.mark.parametrize("naming", ["filter", "weights", "kernel"])
def test_fcn_conversion_bit_equal_to_jax_under_every_naming(tmp_path, naming):
    x = _frames(5, h=64, w=128, scale=255.0)
    jnet = JaxFCN8s(**_FCN_TINY)
    params = numpy_params(jnet, x, seed=7)
    ckpt = _tf1_save(str(tmp_path / "variables" / "saved_model"), _fcn_specs(params, naming))
    want = JW.convert_fcn_checkpoint(ckpt)
    got = W.convert_fcn_checkpoint(ckpt)
    _assert_bit_equal(got, want)
    _assert_bit_equal(W.convert_vgg_checkpoint(ckpt), JW.convert_vgg_checkpoint(ckpt))
    if naming != "filter":
        return
    net = W.as_torch_params(FCN8s(**_FCN_TINY), got).eval()
    with torch.no_grad():
        logits = net(torch.from_numpy(x)).numpy()
    jlogits = np.asarray(jnet.apply(want, jnp.asarray(x)))
    assert np.abs(jlogits).max() > 0.3
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4 * np.abs(jlogits).max())
    # a shape mismatch and a missing layer raise as as_jax_params does
    with pytest.raises(ValueError, match="shape mismatch at"):
        W.as_torch_params(FCN8s(num_classes=3, width_mult=0.0625, fc_channels=8), got)
    partial = {"params": {k: v for k, v in got["params"].items() if k != "upscore8"}}
    with pytest.raises(KeyError, match="missing converted weight"):
        W.as_torch_params(FCN8s(**_FCN_TINY), partial)


def test_encoder_only_vgg_grafts_as_jax_does(tmp_path):
    """The encoder-only VGG16 (the Udacity layout: ``/filter``, no state
    file) through ``graft_partial``: the encoder from the checkpoint, the
    decoder's seeded init untouched, the loaded names the JAX ones."""
    x = _frames(6, h=64, w=128, scale=255.0)
    params = numpy_params(JaxFCN8s(**_FCN_TINY), x, seed=8)
    specs = {k: v for k, v in _fcn_specs(params, "filter").items() if not k.startswith("conv2d")}
    ckpt = _tf1_save(str(tmp_path / "vgg" / "variables" / "variables"), specs)
    os.remove(tmp_path / "vgg" / "variables" / "checkpoint")
    want = JW.convert_vgg_checkpoint(ckpt)
    got = W.convert_vgg_checkpoint(ckpt)
    _assert_bit_equal(got, want)
    with pytest.raises(KeyError):
        W.convert_fcn_checkpoint(ckpt)
    net = FCN8s(**_FCN_TINY, generator=torch.Generator().manual_seed(3))
    before = flax_from_module(net)
    loaded = W.graft_partial(net, got)
    assert loaded == sorted(JW._FCN_VGG_NAME_MAP.values())  # JAX's loaded names
    after = flax_from_module(net)
    for layer, leaf in after["params"].items():
        src = got["params"][layer] if layer in loaded else before["params"][layer]
        for kind in ("kernel", "bias"):
            np.testing.assert_array_equal(leaf[kind], src[kind])
    bad = {"params": dict(got["params"], fc7={"kernel": np.zeros((1, 1, 16, 8), np.float32),
                                              "bias": np.zeros(8, np.float32)})}
    with pytest.raises(ValueError, match="shape mismatch at"):
        W.graft_partial(net, bad)


def test_full_width_monodepth_through_the_convert_cli(tmp_path):
    """A full-width monodepth-vgg set (31M parameters, 125 MB, with Adam
    slots' names) written by TensorFlow, through the port's convert CLI
    (a directory: its latest checkpoint): the .msgpack flax reads equals the
    JAX converter's tree."""
    from flax import serialization

    rng = np.random.default_rng(9)
    with torch.device("meta"):
        template = W.module_template(Monodepth("vgg"))
    params = {"params": {layer: {k: rng.standard_normal(v.shape, np.float32) * np.float32(0.01)
                                 for k, v in leaf.items()}
                         for layer, leaf in template["params"].items()}}
    n = sum(v.size for leaf in params["params"].values() for v in leaf.values())
    assert 31e6 < n < 32e6
    specs = _mono_specs(params, JW._MONODEPTH_VGG_ENCODER, 7)
    specs["global_step"] = np.int64(5)
    specs["model/encoder/Conv/weights/Adam"] = specs["model/encoder/Conv/weights"] + np.float32(1)
    ckpt_dir = tmp_path / "model_cityscapes"
    _tf1_save(str(ckpt_dir / "model_cityscapes"), specs)
    out = tmp_path / "monodepth.msgpack"
    tconvert.main(["monodepth", "--checkpoint", str(ckpt_dir), "--out", str(out)])
    with open(out, "rb") as f:
        written = serialization.msgpack_restore(f.read())
    want = JW.convert_monodepth_checkpoint(str(ckpt_dir / "model_cityscapes"))
    _assert_bit_equal(written, want)
    _assert_bit_equal(written, params)


def test_cli_loaders_read_tf_checkpoints(tmp_path):
    """``load_fcn_params``: a model directory's ``variables/`` checkpoint;
    a prefix is no FCN weight path (the JAX rule: latest_checkpoint of a
    prefix is None) and raises. ``load_mono_params``: a prefix and a
    directory's latest checkpoint."""
    tf = pytest.importorskip("tensorflow")
    fx = _frames(7, h=64, w=128, scale=255.0)
    fparams = numpy_params(JaxFCN8s(**_FCN_TINY), fx, seed=10)
    model_dir = tmp_path / "100-Epochs-roborace750"
    prefix = _tf1_save(str(model_dir / "variables" / "saved_model"),
                       _fcn_specs(fparams, "filter"))
    fcn = common.load_fcn_params(FCN8s(**_FCN_TINY), str(model_dir))
    _assert_bit_equal(flax_from_module(fcn), jnp_tree(fparams))
    assert tf.train.latest_checkpoint(prefix) is None
    with pytest.raises(FileNotFoundError, match="no FCN weights found under"):
        common.load_fcn_params(FCN8s(**_FCN_TINY), prefix)

    mx = _frames(8)
    mparams = numpy_params(JaxMonodepth(encoder="vgg", width_mult=0.0625), mx, seed=11)
    mono_prefix = _tf1_save(str(tmp_path / "model_kitti" / "model_kitti"),
                            _mono_specs(mparams, JW._MONODEPTH_VGG_ENCODER, 7, slots=True))
    for path in (mono_prefix, str(tmp_path / "model_kitti")):
        mono = common.load_mono_params(Monodepth("vgg", width_mult=0.0625), path)
        _assert_bit_equal(flax_from_module(mono), jnp_tree(mparams))
    with pytest.raises(FileNotFoundError, match="no TF checkpoint at"):
        common.load_mono_params(Monodepth("vgg", width_mult=0.0625), str(tmp_path / "nothing"))


def test_committed_fixtures_convert_bit_equal_to_the_jax_msgpack(tmp_path):
    """No TensorFlow: the fixtures through the port's converters equal the
    JAX converters' output committed beside them, and the CLI loaders take
    them as they lie (a model directory, a Udacity-layout prefix, a
    monodepth directory)."""
    fcn = W.convert_fcn_checkpoint(str(FIXTURES / "fcn8s_tiny" / "variables"))
    vgg = W.convert_vgg_checkpoint(str(FIXTURES / "vgg16_tiny" / "variables" / "variables"))
    mono = W.convert_monodepth_checkpoint(str(FIXTURES / "monodepth_tiny"))
    for got, name in ((fcn, "fcn8s_tiny"), (vgg, "vgg16_tiny"), (mono, "monodepth_tiny")):
        _assert_bit_equal(got, W.load_params(str(FIXTURES / f"{name}.msgpack")))
    net = common.load_fcn_params(
        FCN8s(num_classes=3, width_mult=0.03125, fc_channels=8), str(FIXTURES / "fcn8s_tiny"))
    _assert_bit_equal(flax_from_module(net), fcn)
    net = common.load_mono_params(Monodepth("vgg", width_mult=0.03125),
                                  str(FIXTURES / "monodepth_tiny"))
    _assert_bit_equal(flax_from_module(net), mono)
    # the converted files and the .msgpack route load the same network
    shutil.copytree(FIXTURES / "fcn8s_tiny", tmp_path / "m")
    W.save_params(fcn, str(tmp_path / "m" / "fcn8s.msgpack"))
    net2 = common.load_fcn_params(
        FCN8s(num_classes=3, width_mult=0.03125, fc_channels=8), str(tmp_path / "m"))
    _assert_bit_equal(flax_from_module(net2), fcn)
