"""Weight acquisition: download, verify, extract and optionally convert the
reference's published weight sets (port of
``semantic_depth_tpu/models/get_weights.py``; standard library only).

The two acquisition paths of the reference:

* ``monodepth``: the checkpoint zips from visual.cs.ucl.ac.uk
  (models/get_monodepth_model.sh:1-21: wget -nc, unzip, rm);
* ``vgg``: the Udacity VGG16 SavedModel from S3 (fcn8s/helper.py:60-94:
  check the three files, re-download cleanly, extract, delete the zip).

Beyond the reference: an optional sha256 check, optional conversion on
download to a native .msgpack through this package's ``models.convert``
(no TensorFlow needed), and a clear message with exit code 1 instead of a
stack trace when the download fails (offline hosts). The fetcher is
injectable, so the logic is tested without a network.

    python -m semantic_depth_tpu_torch.models.get_weights monodepth \
        model_cityscapes models/monodepth --convert
"""

from __future__ import annotations

import hashlib
import os
import shutil
import zipfile
from typing import Callable, Optional

MONODEPTH_URL = "http://visual.cs.ucl.ac.uk/pubs/monoDepth/models/{name}.zip"
VGG_URL = "https://s3-us-west-1.amazonaws.com/udacity-selfdrivingcar/vgg.zip"

# Known monodepth model names (get_monodepth_model.sh takes the name as $1;
# these are the published zips the reference pipeline consumes).
MONODEPTH_MODELS = (
    "model_kitti",
    "model_eigen",
    "model_cityscapes",
    "model_city2kitti",
    "model_city2eigen",
    "model_kitti_resnet50",
    "model_cityscapes_resnet50",
)

Fetcher = Callable[[str, str], None]


def _default_fetcher(url: str, out_path: str) -> None:
    from urllib.request import urlretrieve

    urlretrieve(url, out_path)  # nosec: fixed, documented upstream URLs


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch(
    url: str,
    out_path: str,
    fetcher: Optional[Fetcher] = None,
    sha256: Optional[str] = None,
) -> str:
    """Download ``url`` to ``out_path`` (skipped when the file already exists,
    wget -nc semantics); verify the checksum when given. Removes partial
    files on failure."""
    fetcher = fetcher or _default_fetcher
    downloaded = False
    if not os.path.exists(out_path):
        tmp = out_path + ".part"
        try:
            fetcher(url, tmp)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        os.replace(tmp, out_path)
        downloaded = True
    if sha256 is not None:
        # Pinned digest: verify on every call (cheap insurance against a
        # corrupted cache is the point of pinning).
        got = _sha256(out_path)
        if got != sha256:
            os.remove(out_path)
            raise ValueError(
                f"checksum mismatch for {out_path}: got {got}, expected {sha256}"
            )
    elif downloaded:
        # No pinned digest exists for the published sets yet: print what
        # was fetched so the first networked run can freeze it in
        # WEIGHTS.md. Only on a fresh download: re-hashing cached zips of
        # hundreds of MB on every call would add seconds of IO a run.
        print(
            f"sha256({os.path.basename(out_path)}) = {_sha256(out_path)}\n"
            "  (unpinned — record this digest in models/WEIGHTS.md and pass "
            "--sha256 on future fetches)"
        )
    return out_path


def get_monodepth_model(
    model_name: str,
    output_location: str,
    fetcher: Optional[Fetcher] = None,
    sha256: Optional[str] = None,
    convert: bool = False,
    encoder: Optional[str] = None,
) -> str:
    """get_monodepth_model.sh equivalent: download <name>.zip, extract into
    ``output_location``, delete the zip. With ``convert=True``, also convert
    the extracted TF1 checkpoint to ``<output_location>/<name>.msgpack``.

    Returns the checkpoint prefix (or the msgpack path when converting)."""
    os.makedirs(output_location, exist_ok=True)
    zip_path = os.path.join(output_location, f"{model_name}.zip")
    fetch(MONODEPTH_URL.format(name=model_name), zip_path, fetcher, sha256)
    _extract_zip(zip_path, output_location)
    os.remove(zip_path)

    # the zips contain <name>/<name>.data-... (checkpoint prefix <name>/<name>)
    candidates = (
        os.path.join(output_location, model_name, model_name),
        os.path.join(output_location, model_name),
    )
    prefix = next(
        (c for c in candidates if os.path.exists(c + ".index")), None
    )
    if prefix is None:
        raise OSError(
            f"{model_name}.zip extracted but no checkpoint index found at "
            f"{candidates[0]}.index or {candidates[1]}.index — unexpected "
            "archive layout; inspect the extracted tree"
        )
    if not convert:
        return prefix
    if encoder is None:
        encoder = "resnet50" if "resnet" in model_name else "vgg"
    from . import convert as convert_cli

    out = os.path.join(output_location, f"{model_name}.msgpack")
    convert_cli.main(
        ["monodepth", "--checkpoint", prefix, "--encoder", encoder, "--out", out]
    )
    return out


def maybe_download_pretrained_vgg(
    data_dir: str, fetcher: Optional[Fetcher] = None, sha256: Optional[str] = None
) -> str:
    """helper.py:60-94 equivalent: ensure ``<data_dir>/vgg`` holds the Udacity
    VGG16 SavedModel (saved_model.pb + variables/*); re-download when any of
    the three files is missing. Returns the vgg path."""
    vgg_path = os.path.join(data_dir, "vgg")
    expected = [
        os.path.join(vgg_path, "variables/variables.data-00000-of-00001"),
        os.path.join(vgg_path, "variables/variables.index"),
        os.path.join(vgg_path, "saved_model.pb"),
    ]
    if all(os.path.exists(p) for p in expected):
        return vgg_path
    if os.path.exists(vgg_path):
        shutil.rmtree(vgg_path)
    os.makedirs(vgg_path)
    zip_path = os.path.join(vgg_path, "vgg.zip")
    fetch(VGG_URL, zip_path, fetcher, sha256)
    _extract_zip(zip_path, data_dir)  # the zip contains the vgg/ tree (helper.py:88)
    os.remove(zip_path)
    return vgg_path


def _extract_zip(zip_path: str, dest: str) -> None:
    """Extract, deleting the archive on corruption: a truncated download or
    an HTTP error page saved as the zip would otherwise poison the cache —
    fetch()'s wget -nc semantics never re-download an existing file."""
    try:
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(dest)
    except zipfile.BadZipFile as e:
        os.remove(zip_path)
        raise OSError(
            f"{zip_path} is not a valid zip (truncated download or an HTTP "
            f"error page?): {e}. The bad file was removed; re-run to "
            "re-download."
        ) from e


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Download the reference's published weight sets."
    )
    sub = p.add_subparsers(dest="which", required=True)
    pm = sub.add_parser("monodepth", help="monodepth ckpt zip (get_monodepth_model.sh)")
    pm.add_argument("model_name", choices=MONODEPTH_MODELS)
    pm.add_argument("output_location")
    pm.add_argument("--sha256", default=None)
    pm.add_argument("--convert", action="store_true",
                    help="also convert to native .msgpack after download")
    pv = sub.add_parser("vgg", help="Udacity VGG16 SavedModel (helper.py:60-94)")
    pv.add_argument("data_dir")
    pv.add_argument("--sha256", default=None)
    args = p.parse_args(argv)

    try:
        if args.which == "monodepth":
            out = get_monodepth_model(
                args.model_name, args.output_location,
                sha256=args.sha256, convert=args.convert,
            )
        else:
            out = maybe_download_pretrained_vgg(args.data_dir, sha256=args.sha256)
    except OSError as e:  # offline, DNS failure, HTTP error
        print(
            f"Download failed ({e}). This environment may be offline — fetch "
            "the file on a connected machine and place it at the target path; "
            "see models/WEIGHTS.md for the conversion step."
        )
        return 1
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
