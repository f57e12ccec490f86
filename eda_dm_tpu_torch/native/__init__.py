"""The parallel PNG writer (``imgio.cpp``, the JAX package's
``native/imgio.cpp`` kept as the port's own copy), bound with ``ctypes``.

The library is built on first use with the system toolchain
(``g++ -O2 -shared -fPIC imgio.cpp -lpng -lz``) into the git-ignored
``eda_dm_tpu_torch/_build/``, named by a hash of the source, and loaded
from there.  Nothing here runs at import.  Where no toolchain or libpng
is present, ``load_imgio`` returns None and ``eval/io.py::save_images``
writes through its own zlib encoder instead.  This is a host file writer,
not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "imgio.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"libedmimgio-{digest}.so"


def _build(out: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", str(_SRC), "-lpng", "-lz", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def load_imgio() -> Optional[ctypes.CDLL]:
    """The imgio library, built on first use; None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.edm_write_png_batch.restype = ctypes.c_int
        lib.edm_write_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),     # data
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),    # paths
            ctypes.c_int, ctypes.c_int,         # n_threads, compress_level
        ]
        _lib = lib
        return _lib


def write_png_batch(images_u8: np.ndarray, paths, n_threads: int = 0,
                    compress_level: int = 6) -> bool:
    """Write a (N, H, W, C) uint8 batch as PNGs through the native writer.
    False (having written nothing, or a part) where the library is missing
    or an image fails: the caller then writes them another way."""
    lib = load_imgio()
    if lib is None:
        return False
    arr = np.ascontiguousarray(images_u8)
    if arr.ndim != 4 or arr.dtype != np.uint8:
        raise ValueError("expected (N, H, W, C) uint8")
    n, h, w, c = arr.shape
    if len(paths) != n:
        raise ValueError("paths/images length mismatch")
    if n_threads <= 0:
        n_threads = min(n, os.cpu_count() or 1)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.edm_write_png_batch(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, c, c_paths, n_threads, compress_level)
    return failures == 0
