"""Regenerate the TF1 checkpoint fixtures of this directory (needs
TensorFlow and the JAX package):

    python tests/fixtures/tf1/make_fixtures.py

Three tiny-width weight sets, from numpy seeds, written by TensorFlow's own
``tf.compat.v1.train.Saver``:

* ``fcn8s_tiny/variables/saved_model``: FCN-8s (width 1/32, fc 8) with the
  VGG16 layers under the Udacity SavedModel's ``<layer>/filter`` /
  ``/biases`` and the decoder under tf.layers' ``conv2d{_i}/kernel`` and
  ``conv2d_transpose{_i}/kernel`` (a ``checkpoint`` state file beside it);
* ``vgg16_tiny/variables/variables``: the encoder-only VGG16 of the same
  widths, as the Udacity download lays it out (no state file);
* ``monodepth_tiny/model_tiny``: monodepth-vgg (width 1/32) under slim's
  ``model/encoder/Conv{_i}`` and ``model/decoder/Conv{_i}``, with Adam
  slots, ``beta1_power``, ``beta2_power`` and ``global_step``, as in the
  published sets (a state file beside it).

Beside each, ``<name>.msgpack``: the JAX package's converter output
(``convert_fcn_checkpoint``, ``convert_vgg_checkpoint``,
``convert_monodepth_checkpoint``) written by its ``save_params``. The port
reads the checkpoints with no TensorFlow and must give these bit for bit.
"""

import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

FCN_TINY = dict(num_classes=3, width_mult=0.03125, fc_channels=8)
MONO_TINY = dict(encoder="vgg", width_mult=0.03125)


def tf_names_fcn(params, vgg_only=False):
    from semantic_depth_tpu.models import weights as W

    out = {}
    for scope, ours in W._FCN_VGG_NAME_MAP.items():
        out[f"{scope}/filter"] = params[ours]["kernel"]
        out[f"{scope}/biases"] = params[ours]["bias"]
    if vgg_only:
        return out
    for base, order in (("conv2d", W._FCN_DECODER_CONV_ORDER),
                        ("conv2d_transpose", W._FCN_DECODER_DECONV_ORDER)):
        for i, ours in enumerate(order):
            scope = base if i == 0 else f"{base}_{i}"
            out[f"{scope}/kernel"] = params[ours]["kernel"]
            out[f"{scope}/bias"] = params[ours]["bias"]
    return out


def tf_names_monodepth(params, rng):
    from semantic_depth_tpu.models import weights as W

    out = {}
    for scope, order in (("model/encoder", W._MONODEPTH_VGG_ENCODER),
                         ("model/decoder", W._monodepth_decoder_order(7))):
        for i, ours in enumerate(order):
            conv = "Conv" if i == 0 else f"Conv_{i}"
            for tf_kind, kind in (("weights", "kernel"), ("biases", "bias")):
                name = f"{scope}/{conv}/{tf_kind}"
                out[name] = params[ours][kind]
                for slot in ("Adam", "Adam_1"):
                    out[f"{name}/{slot}"] = rng.normal(
                        0.0, 1e-3, params[ours][kind].shape).astype(np.float32)
    out["beta1_power"] = np.float32(0.9 ** 1000)
    out["beta2_power"] = np.float32(0.999 ** 1000)
    out["global_step"] = np.int64(1000)
    return out


def tf1_save(prefix, tensors, state_file=True):
    """Write ``tensors`` with TensorFlow's TF1 Saver; keep only the bundle
    (and the state file, relative)."""
    import tensorflow as tf

    tf1 = tf.compat.v1
    d = os.path.dirname(prefix)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with tf1.Graph().as_default():
        for name, arr in tensors.items():
            if name == "global_step":
                tf1.get_variable(name, initializer=tf.constant(arr), trainable=False)
            else:
                tf1.get_variable(name, initializer=tf.constant(arr))
        saver = tf1.train.Saver(save_relative_paths=True)
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, prefix, write_meta_graph=False)
    if not state_file:
        os.remove(os.path.join(d, "checkpoint"))


def main():
    from torch_helpers import numpy_params

    from semantic_depth_tpu.models import FCN8s, Monodepth
    from semantic_depth_tpu.models import weights as W

    fcn = numpy_params(FCN8s(**FCN_TINY), np.zeros((1, 64, 128, 3), np.float32), seed=11)
    mono = numpy_params(Monodepth(**MONO_TINY), np.zeros((2, 128, 256, 3), np.float32), seed=12)
    fcn = {"params": {k: {n: np.asarray(v) for n, v in leaf.items()}
                      for k, leaf in fcn["params"].items()}}
    mono = {"params": {k: {n: np.asarray(v) for n, v in leaf.items()}
                       for k, leaf in mono["params"].items()}}

    sets = (
        ("fcn8s_tiny", os.path.join("fcn8s_tiny", "variables", "saved_model"),
         tf_names_fcn(fcn["params"]), True, W.convert_fcn_checkpoint),
        ("vgg16_tiny", os.path.join("vgg16_tiny", "variables", "variables"),
         tf_names_fcn(fcn["params"], vgg_only=True), False, W.convert_vgg_checkpoint),
        ("monodepth_tiny", os.path.join("monodepth_tiny", "model_tiny"),
         tf_names_monodepth(mono["params"], np.random.default_rng(13)), True,
         W.convert_monodepth_checkpoint),
    )
    for name, rel, tensors, state_file, convert in sets:
        prefix = os.path.join(HERE, rel)
        tf1_save(prefix, tensors, state_file)
        W.save_params(convert(prefix), os.path.join(HERE, f"{name}.msgpack"))
        print(f"wrote {rel} ({len(tensors)} variables) and {name}.msgpack")


if __name__ == "__main__":
    main()
