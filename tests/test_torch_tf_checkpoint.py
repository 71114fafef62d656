"""The port's TF1 checkpoint reader (``models/tf_checkpoint.py``) against
TensorFlow's own reader on checkpoints TensorFlow wrote, its checks against
corrupted files, its CRC-32C, and the test-only bundle writer
(``tools/tf_bundle_writer_torch.py``) read back by TensorFlow. The committed
fixtures (``tests/fixtures/tf1``) are read with no TensorFlow at all."""

import os
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

from semantic_depth_tpu_torch.models import tf_checkpoint as T
from semantic_depth_tpu_torch.native import build as native_build
from tools import tf_bundle_writer_torch as B

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "tf1"


def _tf():
    return pytest.importorskip("tensorflow")


def _tf1_save(prefix, specs, relative=False):
    """``specs``: name -> (numpy value or a tf tensor builder)."""
    tf = _tf()
    tf1 = tf.compat.v1
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    with tf1.Graph().as_default():
        for name, value in specs.items():
            init = value() if callable(value) else tf.constant(value)
            tf1.get_variable(name, initializer=init, trainable=False)
        saver = tf1.train.Saver(save_relative_paths=relative)
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, prefix, write_meta_graph=False)
    return prefix


def _assert_same_as_tf(prefix):
    """Names, dtypes, shapes and bytes equal to ``tf.train.load_checkpoint``'s."""
    tf = _tf()
    theirs = tf.train.load_checkpoint(prefix)
    ours = T.CheckpointReader(prefix)
    shapes = theirs.get_variable_to_shape_map()
    assert sorted(ours.names()) == sorted(shapes)
    assert ours.shapes() == {n: list(s) for n, s in shapes.items()}
    assert ours.dtypes() == {n: d.name for n, d in theirs.get_variable_to_dtype_map().items()}
    for name in shapes:
        if ours.dtypes()[name] == "string":
            # object dtype: numpy's bytes dtype would drop trailing NULs
            want = np.asarray(theirs.get_tensor(name), dtype=object)
            got = ours.read(name)
            assert got.shape == want.shape
            assert [bytes(x) for x in got.reshape(-1)] == [bytes(x) for x in want.reshape(-1)]
            continue
        want = np.asarray(theirs.get_tensor(name))
        if ours.dtypes()[name] == "bfloat16":
            assert ours.read_bytes(name) == want.view(np.uint16).tobytes()
            np.testing.assert_array_equal(ours.read(name), want.astype(np.float32))
        else:
            got = ours.read(name)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == want.tobytes(), name
    return ours


@pytest.fixture(scope="module")
def every_dtype(tmp_path_factory):
    """One TF1 Saver checkpoint holding every dtype the reader decodes, a
    scalar, a zero-size tensor, Adam slots, the step counters and 300 names
    (the most a TF-written index holds in one data block here: 8.5 KB)."""
    tf = _tf()
    rng = np.random.default_rng(0)
    specs = {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(5),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "bf16": lambda: tf.cast(tf.constant(rng.standard_normal(7).astype(np.float32)),
                                tf.bfloat16),
        "i8": np.array([-128, 0, 127], np.int8),
        "i16": np.array([-32768, 5, 32767], np.int16),
        "i32": np.array([[1, -2], [3, 2**31 - 1]], np.int32),
        "i64": np.array([-(2**63), 2**40], np.int64),
        "u8": np.arange(250, 256, dtype=np.uint8),
        "flag": np.array([True, False, True]),
        "words": np.array([b"", b"a", b"x" * 300], dtype=object),
        "word": np.array(b"scalar string", dtype=object),
        "scalar": np.float32(3.5),
        "empty": np.zeros((0, 3), np.float32),
        "beta1_power": np.float32(0.9),
        "beta2_power": np.float32(0.999),
        "global_step": np.int64(12345),
    }
    for i in range(300):
        w = rng.standard_normal((1, 1, 2, i % 3 + 1)).astype(np.float32)
        specs[f"model/encoder/Conv_{i}/weights"] = w
        if i < 4:
            specs[f"model/encoder/Conv_{i}/weights/Adam"] = w * 0.5
            specs[f"model/encoder/Conv_{i}/weights/Adam_1"] = w * 0.25
            specs[f"model/encoder/Conv_{i}/Momentum"] = w
    return _tf1_save(str(tmp_path_factory.mktemp("every") / "model"), specs), specs


def test_reader_matches_tensorflow_on_every_dtype(every_dtype):
    prefix, specs = every_dtype
    ours = _assert_same_as_tf(prefix)
    assert ours.read("scalar").shape == () and ours.read("empty").shape == (0, 3)
    assert ours.read("word").shape == () and ours.read("word").item() == b"scalar string"
    assert ours.dtypes()["bf16"] == "bfloat16" and ours.read("bf16").dtype == np.float32


def test_read_checkpoint_drops_slots_and_counters_before_reading(every_dtype, monkeypatch):
    prefix, specs = every_dtype
    read = []
    raw = T.CheckpointReader._raw

    def spy(self, entry, f=None):
        read.append(entry.name)
        return raw(self, entry, f)

    monkeypatch.setattr(T.CheckpointReader, "_raw", spy)
    got = T.read_checkpoint(prefix)
    dropped = {n for n in specs if n.endswith(("/Adam", "/Adam_1", "/Momentum"))} | {
        "beta1_power", "beta2_power", "global_step"}
    assert len(dropped) == 15
    assert set(got) == set(specs) - dropped == set(read)
    np.testing.assert_array_equal(got["model/encoder/Conv_7/weights"],
                                  specs["model/encoder/Conv_7/weights"])


def test_bundle_writer_output_reads_back_in_tensorflow_over_many_index_blocks(tmp_path):
    """The test-only writer's 4 KiB blocks: an index of several data blocks
    (which TensorFlow itself writes only past 8.5 KB of names), read back
    equal by TensorFlow and by the port."""
    rng = np.random.default_rng(1)
    tensors = {f"model/decoder/Conv_{i}/biases": rng.standard_normal(i % 4).astype(np.float32)
               for i in range(400)}
    tensors.update(global_step=np.int64(9), half=np.float16(1.5), flag=np.array([True]),
                   empty=np.zeros((2, 0), np.float64), small=np.arange(3, dtype=np.int8))
    prefix = str(tmp_path / "w" / "m")
    B.write_bundle(prefix, tensors)
    index = (tmp_path / "w" / "m.index").read_bytes()
    n_blocks = sum(1 for _ in T._block_entries(_index_block(index), "index"))
    assert n_blocks >= 3
    ours = _assert_same_as_tf(prefix)
    for name, value in tensors.items():
        np.testing.assert_array_equal(ours.read(name), value)
    assert T.latest_checkpoint(str(tmp_path / "w")) == prefix


def _index_block(table: bytes):
    footer = table[-48:]
    pos = 0
    for _ in range(2):
        offset, pos = T._varint(footer, pos, "footer")
        size, pos = T._varint(footer, pos, "footer")
    return T._block(table, offset, size, "index")


def test_latest_checkpoint_matches_tensorflow(tmp_path, every_dtype):
    tf = _tf()
    rel = _tf1_save(str(tmp_path / "rel" / "saved_model"), {"v": np.float32(1)}, relative=True)
    absolute = _tf1_save(str(tmp_path / "abs" / "ckpt"), {"v": np.float32(1)})
    saved = tmp_path / "savedmodel"

    class M(tf.Module):
        def __init__(self):
            self.v = tf.Variable(np.arange(4, dtype=np.float32))

    tf.saved_model.save(M(), str(saved))
    gone = tmp_path / "gone"
    gone.mkdir()
    (gone / "checkpoint").write_text('model_checkpoint_path: "deleted"\n')
    cases = [tmp_path / "rel", tmp_path / "abs", saved / "variables", saved, rel, absolute,
             every_dtype[0], tmp_path / "missing", gone]
    for d in cases:
        assert T.latest_checkpoint(str(d)) == tf.train.latest_checkpoint(str(d)), d
    assert T.latest_checkpoint(str(tmp_path / "rel")) == rel
    assert T.latest_checkpoint(str(saved / "variables")) is None
    # a directory is its latest checkpoint, as for tf.train.load_checkpoint
    assert T.CheckpointReader(str(tmp_path / "abs")).prefix == absolute
    for d in (saved / "variables", gone):
        with pytest.raises(ValueError, match="Couldn't find 'checkpoint' file"):
            tf.train.load_checkpoint(str(d))
        with pytest.raises(ValueError, match="Couldn't find 'checkpoint' file"):
            T.CheckpointReader(str(d))
    # the SavedModel's object-graph bundle (a serialized proto as a string
    # scalar) reads as TensorFlow reads it
    _assert_same_as_tf(str(saved / "variables" / "variables"))


def test_committed_fixtures_read_without_tensorflow():
    """The fixtures' variable sets (TensorFlow wrote them; this reads them
    through the port alone)."""
    fcn = T.CheckpointReader(str(FIXTURES / "fcn8s_tiny" / "variables"))
    assert fcn.prefix.endswith("saved_model") and len(fcn.names()) == 42
    assert "conv2d_transpose_2/kernel" in fcn.names() and "fc7/filter" in fcn.names()
    assert T.latest_checkpoint(str(FIXTURES / "vgg16_tiny" / "variables")) is None
    vgg = T.CheckpointReader(str(FIXTURES / "vgg16_tiny" / "variables" / "variables"))
    assert len(vgg.names()) == 30
    mono = T.CheckpointReader(str(FIXTURES / "monodepth_tiny"))
    assert len(mono.names()) == 195 and mono.read("global_step") == 1000
    assert len(T.read_checkpoint(str(FIXTURES / "monodepth_tiny"))) == 64  # 32 convs


def _copy_fixture(tmp_path):
    d = tmp_path / "m"
    shutil.copytree(FIXTURES / "monodepth_tiny", d)
    return d, str(d / "model_tiny")


def _flip(path, offset):
    data = bytearray(path.read_bytes())
    data[offset] ^= 0x01
    path.write_bytes(bytes(data))


def _rewrite_index(prefix, edit, block_size=4096):
    """The bundle's index rewritten (valid checksums) with ``edit(key,
    value) -> value`` applied to every entry."""
    entries = [(k, edit(k, bytes(v))) for k, v in T._table_entries(prefix + ".index")]
    with open(prefix + ".index", "wb") as f:
        table = B._Table(f, block_size)
        for k, v in entries:
            table.add(k, v)
        table.finish()


_W0 = b"model/encoder/Conv/weights"


def _fault_data_byte(d, prefix):
    entry = T.CheckpointReader(prefix).entries[_W0.decode()]
    _flip(Path(prefix + ".data-00000-of-00001"), entry.offset + entry.size // 2)
    return lambda: T.CheckpointReader(prefix).read(_W0.decode()), "data fails its crc32c"


def _fault_index_byte(d, prefix):
    _flip(Path(prefix + ".index"), 40)
    return lambda: T.CheckpointReader(prefix), "fails its crc32c"


def _fault_sliced_entry(d, prefix):
    _rewrite_index(prefix, lambda k, v: v + b"\x3a\x00" if k == _W0 else v)
    return lambda: T.CheckpointReader(prefix), "partitioned variable"


def _fault_big_endian(d, prefix):
    _rewrite_index(prefix, lambda k, v: v + b"\x10\x01" if k == b"" else v)
    return lambda: T.CheckpointReader(prefix), "big-endian"


def _fault_compressed_block(d, prefix):
    table = bytearray(Path(prefix + ".index").read_bytes())
    footer = bytes(table[-48:])
    pos = 0
    for _ in range(2):
        offset, pos = T._varint(footer, pos, "footer")
        size, pos = T._varint(footer, pos, "footer")
    handle = next(iter(T._block_entries(_index_block(bytes(table)), "index")))[1]
    off, p = T._varint(handle, 0, "handle")
    n, _ = T._varint(handle, p, "handle")
    table[off + n] = 1  # snappy, with a valid checksum
    table[off + n + 1:off + n + 5] = struct.pack("<I", T.mask_crc(T.crc32c(table[off:off + n + 1])))
    Path(prefix + ".index").write_bytes(bytes(table))
    return lambda: T.CheckpointReader(prefix), r"compressed \(snappy, type 1\)"


def _fault_unread_dtype(d, prefix):
    _rewrite_index(prefix, lambda k, v: v + b"\x08\x08" if k == _W0 else v)  # complex64
    return lambda: T.CheckpointReader(prefix), "complex64"


def _fault_bad_magic(d, prefix):
    _flip(Path(prefix + ".index"), os.path.getsize(prefix + ".index") - 1)
    return lambda: T.CheckpointReader(prefix), "not a TensorFlow table"


def _fault_truncated_data(d, prefix):
    data = Path(prefix + ".data-00000-of-00001")
    data.write_bytes(data.read_bytes()[:100])
    return lambda: T.read_checkpoint(prefix), "bytes at"


@pytest.mark.parametrize("fault", [
    _fault_data_byte, _fault_index_byte, _fault_sliced_entry, _fault_big_endian,
    _fault_compressed_block, _fault_unread_dtype, _fault_bad_magic, _fault_truncated_data,
], ids=lambda f: f.__name__[7:])
def test_corrupt_checkpoints_raise(tmp_path, fault):
    d, prefix = _copy_fixture(tmp_path)
    T.read_checkpoint(prefix)  # intact
    call, message = fault(d, prefix)
    with pytest.raises(T.CheckpointError, match=message):
        call()


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no TF checkpoint"):
        T.CheckpointReader(str(tmp_path / "nothing"))


def test_crc32c_native_and_plain_agree():
    lib = native_build.library()
    assert lib is not None  # g++ builds it here and on the card host
    assert T.crc32c(b"123456789") == T.crc32c_plain(b"123456789") == 0xE3069283
    assert T.crc32c(b"") == T.crc32c_plain(b"") == 0
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, 100_003, dtype=np.uint8)
    for lo, hi in ((0, 1), (3, 11), (5, 4096), (1, 100_003)):
        chunk = data[lo:hi]
        assert T.crc32c(chunk) == T.crc32c_plain(chunk), (lo, hi)
    # continuing a checksum equals one pass (crc32c::Extend)
    assert T.crc32c(data[500:], T.crc32c(data[:500])) == T.crc32c(data)
    assert T.crc32c_plain(data[7:900], T.crc32c_plain(data[:7])) == T.crc32c(data[:900])
    assert T.mask_crc(0) == 0xA282EAD8


def test_crc32c_without_the_native_library(monkeypatch, tmp_path):
    """The plain version serves where there is no library, with the same
    checks: a fixture reads, a flipped byte still raises."""
    monkeypatch.setattr(T, "native_library", lambda: None)
    got = T.read_checkpoint(str(FIXTURES / "fcn8s_tiny" / "variables"))
    assert len(got) == 42
    d, prefix = _copy_fixture(tmp_path)
    call, message = _fault_data_byte(d, prefix)
    with pytest.raises(T.CheckpointError, match=message):
        call()
