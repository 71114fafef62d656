"""The port's weight files (``models/weights.py``, numpy only) against flax's
msgpack serialization, and the CLIs' weight-path rules, on the CPU."""

import struct

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu_torch.cli import common
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.models import weights
from semantic_depth_tpu_torch.models.from_flax import (flax_from_module, load_flax,
                                                       state_dict_from_flax)

from torch_helpers import numpy_params

_X = np.zeros((1, 128, 256, 3), np.float32)


@pytest.fixture(scope="module")
def tiny_trees():
    return {
        "fcn": numpy_params(JaxFCN8s(num_classes=3, width_mult=0.0625, fc_channels=32), _X),
        "mono": numpy_params(JaxMonodepth(encoder="vgg", width_mult=0.0625), _X, seed=1),
    }


def _leaves_equal(a, b):
    leaves_a, tree_a = jax.tree.flatten(a)
    leaves_b, tree_b = jax.tree.flatten(b)
    assert tree_a == tree_b
    for x, y in zip(leaves_a, leaves_b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("net", ["fcn", "mono"])
def test_flax_file_reads_bit_equal(tmp_path, tiny_trees, net):
    path = tmp_path / f"{net}.msgpack"
    path.write_bytes(serialization.to_bytes(tiny_trees[net]))
    got = weights.load_params(str(path))
    _leaves_equal(got, jax.tree.map(np.asarray, tiny_trees[net]))
    leaf = got["params"][next(iter(got["params"]))]["kernel"]
    assert not leaf.flags.writeable  # a view of the file's bytes, not a copy
    module = (FCN8s(num_classes=3, width_mult=0.0625, fc_channels=32) if net == "fcn"
              else Monodepth("vgg", width_mult=0.0625))
    load_flax(module, got)  # strict: every layer name and shape matches


@pytest.mark.parametrize("net", ["fcn", "mono"])
def test_port_writer_round_trips_through_flax(tmp_path, tiny_trees, net):
    path = weights.save_params(tiny_trees[net], str(tmp_path / f"{net}.msgpack"))
    data = open(path, "rb").read()
    assert data == serialization.to_bytes(tiny_trees[net])
    _leaves_equal(serialization.msgpack_restore(data), jax.tree.map(np.asarray, tiny_trees[net]))


def test_reader_decodes_msgpack_scalars_and_containers():
    doc = {"none": None, "t": True, "f": False, "s": "x" * 40, "b": b"\x01" * 300,
           "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129, -2**40],
           "floats": [1.25, -0.0], "nested": {str(i): i for i in range(20)}}
    got = weights.unpackb(msgpack.packb(doc, use_bin_type=True))
    assert bytes(got.pop("b")) == doc.pop("b")
    assert got == doc
    assert weights.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    assert weights.packb(doc) == msgpack.packb(doc, use_bin_type=True)


def _ext3_file():
    return serialization.to_bytes({"step": np.float32(3.0)})  # a numpy scalar: ext type 3


def _ext2_file():
    return msgpack.packb({"c": msgpack.ExtType(2, msgpack.packb((1.0, 2.0)))})


def _chunked_file():
    return msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}})


@pytest.mark.parametrize("make,match", [
    (lambda d: d[: len(d) // 2], "truncated"),
    (lambda d: d[:-1], "truncated"),
    (lambda d: _ext3_file(), "ext type 3"),
    (lambda d: _ext2_file(), "ext type 2"),
    (lambda d: _chunked_file(), "chunked"),
    (lambda d: d + b"\x00", "trailing"),
])
def test_reader_rejects_what_it_cannot_read(tmp_path, tiny_trees, make, match):
    path = tmp_path / "bad.msgpack"
    path.write_bytes(make(serialization.to_bytes(tiny_trees["mono"])))
    with pytest.raises(weights.MsgpackError, match=match):
        weights.load_params(str(path))


def test_writer_rejects_leaves_over_the_chunk_limit(monkeypatch):
    monkeypatch.setattr(weights, "_MAX_LEAF_BYTES", 64)
    with pytest.raises(weights.MsgpackError, match="over 2"):
        weights.packb({"w": np.zeros(17, np.float32)})
    assert weights.packb({"w": np.zeros(16, np.float32)})


def test_weight_path_rules(tmp_path, tiny_trees):
    """A .msgpack file, a directory holding fcn8s.msgpack / monodepth.msgpack,
    monodepth.msgpack beside a checkpoint prefix, 'random'; anything else
    (a TF checkpoint) raises and names the converter."""
    fcn = FCN8s(num_classes=3, width_mult=0.0625, fc_channels=32)
    mono = Monodepth("vgg", width_mult=0.0625)
    want_fcn = torch.from_numpy(np.asarray(tiny_trees["fcn"]["params"]["fc7"]["bias"]))
    want_mono = torch.from_numpy(np.asarray(tiny_trees["mono"]["params"]["disp1"]["bias"]))
    d = tmp_path / "w"
    d.mkdir()
    weights.save_params(tiny_trees["fcn"], str(d / "fcn8s.msgpack"))
    weights.save_params(tiny_trees["mono"], str(d / "monodepth.msgpack"))
    for path in (str(d / "fcn8s.msgpack"), str(d), str(d) + "/"):
        fcn.fc7.bias.data.zero_()
        assert torch.equal(common.load_fcn_params(fcn, path).fc7.bias.data, want_fcn)
    for path in (str(d / "monodepth.msgpack"), str(d), str(d) + "/", str(d / "model_cityscapes")):
        mono.disp1.bias.data.zero_()
        assert torch.equal(common.load_mono_params(mono, path).disp1.bias.data, want_mono)
    before = mono.disp1.bias.data.clone()
    assert torch.equal(common.load_mono_params(mono, "random").disp1.bias.data, before)
    empty = tmp_path / "tf_ckpt"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="semantic_depth_tpu.models.convert"):
        common.load_fcn_params(fcn, str(empty / "variables"))
    with pytest.raises(FileNotFoundError, match="semantic_depth_tpu.models.convert"):
        common.load_mono_params(mono, str(empty / "model_cityscapes"))


def test_msgpack_struct_layout_of_an_array_leaf():
    """One float32 leaf, by hand: ext 1 around (shape, dtype name, bytes)."""
    arr = np.arange(3, dtype=np.float32)
    inner = b"\x93\x91\x03\xa7float32\xc4\x0c" + arr.tobytes()
    want = b"\x81\xa1w\xc7" + struct.pack(">Bb", len(inner), 1) + inner
    assert weights.packb({"w": arr}) == want == serialization.to_bytes({"w": arr})
    np.testing.assert_array_equal(weights.unpackb(want)["w"], arr)


@pytest.mark.parametrize("variant", ["fcn_s2d", "resnet50", "vgg_s2d", "resnet50_s2d"])
def test_module_to_flax_tree_matches_the_jax_tree(tmp_path, variant):
    """A port module written as a flax tree has the JAX network's layer
    names and shapes, reads back into the module strictly, and flax reads
    the file the port writes."""
    import jax.numpy as jnp

    x = np.zeros((1, 256, 512, 3), np.float32)
    small = dict(width_mult=0.0625)
    jnet, tnet = {
        "fcn_s2d": (JaxFCN8s(num_classes=3, fc_channels=32, input_s2d=True, **small),
                    FCN8s(num_classes=3, fc_channels=32, input_s2d=True, **small)),
        "resnet50": (JaxMonodepth(encoder="resnet50", **small), Monodepth("resnet50", **small)),
        "vgg_s2d": (JaxMonodepth(encoder="vgg", input_s2d=True, **small),
                    Monodepth("vgg", input_s2d=True, **small)),
        "resnet50_s2d": (JaxMonodepth(encoder="resnet50", input_s2d=True, **small),
                         Monodepth("resnet50", input_s2d=True, **small)),
    }[variant]
    shapes = jax.eval_shape(lambda a: jnet.init(jax.random.PRNGKey(0), a), jnp.asarray(x))
    tree = flax_from_module(tnet)
    assert jax.tree.map(lambda a: a.shape, tree) == jax.tree.map(lambda a: a.shape, dict(shapes))
    sd = state_dict_from_flax(tree)
    assert all(torch.equal(sd[k], v) for k, v in tnet.state_dict().items())
    path = weights.save_params(tree, str(tmp_path / "w.msgpack"))
    restored = serialization.from_bytes(jax.tree.map(np.asarray, dict(shapes)),
                                        open(path, "rb").read())
    _leaves_equal(restored, tree)
