"""The port's weight acquisition (``models/get_weights.py``) with injected
fetchers, never the network: the six cases of ``tests/test_get_weights.py``
(wget -nc skip, checksum, zip extraction and cleanup, the VGG re-download
rules, convert on download, the offline exit), on the port alone."""

import hashlib
import os
import zipfile

import numpy as np
import pytest

from semantic_depth_tpu_torch.models import get_weights as G
from semantic_depth_tpu_torch.models import weights as W
from tools.tf_bundle_writer_torch import seeded_bundle


def _zip_bytes_to(path, members, compression=zipfile.ZIP_DEFLATED):
    with zipfile.ZipFile(path, "w", compression) as zf:
        for name, data in members.items():
            zf.writestr(name, data)


def _mock_fetcher_for(members, compression=zipfile.ZIP_DEFLATED):
    calls = []

    def fetcher(url, out_path):
        calls.append(url)
        _zip_bytes_to(out_path, members, compression)

    return fetcher, calls


def test_monodepth_download_extract_cleanup(tmp_path):
    members = {
        "model_kitti/model_kitti.index": b"idx",
        "model_kitti/model_kitti.data-00000-of-00001": b"data",
    }
    fetcher, calls = _mock_fetcher_for(members)
    out = tmp_path / "md"
    prefix = G.get_monodepth_model("model_kitti", str(out), fetcher=fetcher)
    assert calls == [G.MONODEPTH_URL.format(name="model_kitti")]
    assert prefix == str(out / "model_kitti" / "model_kitti")
    assert os.path.exists(prefix + ".index")
    assert not os.path.exists(out / "model_kitti.zip")  # zip removed (sh:21)


def test_fetch_skips_existing_and_verifies_checksum(tmp_path):
    target = tmp_path / "f.zip"
    target.write_bytes(b"cached")
    calls = []

    def fetcher(url, out_path):  # must NOT be called (wget -nc)
        calls.append(url)

    G.fetch("http://x/f.zip", str(target), fetcher=fetcher)
    assert calls == []
    good = hashlib.sha256(b"cached").hexdigest()
    G.fetch("http://x/f.zip", str(target), fetcher=fetcher, sha256=good)
    with pytest.raises(ValueError, match="checksum mismatch"):
        G.fetch("http://x/f.zip", str(target), fetcher=fetcher, sha256="0" * 64)
    assert not target.exists()  # bad file removed


def test_fetch_cleans_partial_on_failure(tmp_path):
    def fetcher(url, out_path):
        with open(out_path, "wb") as f:
            f.write(b"partial")
        raise OSError("connection reset")

    with pytest.raises(OSError):
        G.fetch("http://x/f.zip", str(tmp_path / "f.zip"), fetcher=fetcher)
    assert list(tmp_path.iterdir()) == []


def test_vgg_download_and_skip(tmp_path):
    members = {
        "vgg/saved_model.pb": b"pb",
        "vgg/variables/variables.index": b"i",
        "vgg/variables/variables.data-00000-of-00001": b"d",
    }
    fetcher, calls = _mock_fetcher_for(members)
    path = G.maybe_download_pretrained_vgg(str(tmp_path), fetcher=fetcher)
    assert calls == [G.VGG_URL]
    assert path == str(tmp_path / "vgg")
    assert os.path.exists(os.path.join(path, "saved_model.pb"))
    assert not os.path.exists(os.path.join(path, "vgg.zip"))
    G.maybe_download_pretrained_vgg(str(tmp_path), fetcher=fetcher)  # all three there
    assert len(calls) == 1
    os.remove(os.path.join(path, "saved_model.pb"))  # one missing: clean re-download
    G.maybe_download_pretrained_vgg(str(tmp_path), fetcher=fetcher)
    assert len(calls) == 2
    assert os.path.exists(os.path.join(path, "saved_model.pb"))
    # a corrupt archive is removed, so the next call fetches again
    bad_dir = tmp_path / "bad"
    with pytest.raises(OSError, match="not a valid zip"):
        G.maybe_download_pretrained_vgg(
            str(bad_dir), fetcher=lambda url, out: open(out, "wb").write(b"<html>"))
    assert not (bad_dir / "vgg" / "vgg.zip").exists()


def test_monodepth_convert_on_download(tmp_path):
    """The zip carries a full-width monodepth-vgg checkpoint (with Adam slots
    and global_step); ``convert=True`` converts it through the port's convert
    CLI, no TensorFlow anywhere, into a .msgpack equal to the seeded set."""
    build = tmp_path / "build" / "model_kitti"
    tree, _ = seeded_bundle("monodepth", str(build / "model_kitti"), seed=2)
    members = {f"model_kitti/{fn}": (build / fn).read_bytes() for fn in os.listdir(build)}
    fetcher, _ = _mock_fetcher_for(members, zipfile.ZIP_STORED)
    out = G.get_monodepth_model("model_kitti", str(tmp_path / "md"), fetcher=fetcher,
                                convert=True)
    assert out == str(tmp_path / "md" / "model_kitti.msgpack")
    got = W.load_params(out)
    assert sorted(got["params"]) == sorted(tree["params"])
    for layer, leaf in tree["params"].items():
        for kind, value in leaf.items():
            np.testing.assert_array_equal(got["params"][layer][kind], value)


def test_cli_offline_graceful(tmp_path, capsys, monkeypatch):
    """A failed download (here a fetcher that raises as an offline host's
    does) prints a helpful message and returns 1."""
    def offline(url, out_path):
        raise OSError("[Errno -3] Temporary failure in name resolution")

    monkeypatch.setattr(G, "_default_fetcher", offline)
    assert G.main(["monodepth", "model_kitti", str(tmp_path / "x")]) == 1
    assert "offline" in capsys.readouterr().out
    assert G.main(["vgg", str(tmp_path / "data")]) == 1
    assert "offline" in capsys.readouterr().out
