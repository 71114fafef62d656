"""Build and bind the host-side C++ of this directory: the ASCII PLY writer
(``ply_writer.cpp``) and row parser (``ply_reader.cpp``), the fast paths of
``io/ply.py``, and the CRC-32C of TensorFlow checkpoints (``crc32c.cpp``),
the fast path of ``models/tf_checkpoint.py``.

At first use ``g++ -O3`` compiles both sources into one shared library under
``_build/``, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads; the library is renamed into place
atomically, so processes that build at once never load half a file. It is
bound with ``ctypes``. On a machine with no ``g++`` there is no library:
``io/ply.py`` formats and parses with numpy, byte for byte the same, and
``models/tf_checkpoint.py`` checksums in Python, to the same value.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
SOURCES = ("ply_writer.cpp", "ply_reader.cpp", "crc32c.cpp")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_P_DOUBLE = ctypes.POINTER(ctypes.c_double)
# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    "write_ply_ascii": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p, _P_DOUBLE, _P_DOUBLE,
                                       ctypes.c_int64]),
    "read_ply_rows": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64, _P_DOUBLE,
                                       ctypes.c_int64, ctypes.c_int32]),
    "crc32c_extend": (ctypes.c_uint32, [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int64]),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libsd_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if the one for these sources is missing; returns
    its path. Raises if ``g++`` fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / so.name
        cmd = ["g++", *FLAGS, "-o", str(tmp_so), *(str(SRC_DIR / s) for s in SOURCES)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp_so, so)
    return so


@functools.lru_cache(maxsize=None)
def library() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None where there is no
    ``g++``."""
    if shutil.which("g++") is None and not library_path().exists():
        return None
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib
