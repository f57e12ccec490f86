"""Build and load the hand-written CUDA kernels; count their launches.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``_build/<name>-<hash>.so`` at first use, then loaded
with ``ctypes``: no PyTorch headers, so a build takes seconds.  The hash
covers the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.

Nothing here runs at import: the package imports on machines without
``nvcc`` or a card.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
CUDA_SOURCES = ("int8_conv", "int8_bmm", "softmax_codes", "int8_attention",
                "int8_flash_attention", "int8_flash_sweep", "gn_int8", "fakequant_matmul",
                "quantized_matmul", "mma_chain", "wgmma_chain")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches of each hand-written kernel; a wrapper adds one where it launches
# its kernel and nowhere else (the plain versions never count)
launch_counts: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = CUDA_SOURCES) -> float:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together.  Returns the wall seconds; raises on a failure
    with the compiler's output.  ``ptxas`` register and spill reports go to
    ``_build/<name>.log``.  With ``EDM_NO_KERNEL_BUILD=1`` (the ranks of
    ``parallel/launch.py``) a source that is not built yet raises instead:
    the parent builds, the ranks load."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        if os.environ.get("EDM_NO_KERNEL_BUILD") == "1":
            raise RuntimeError(f"kernel {name} is not built: build it before "
                               "starting the ranks (ops/_build.py::build)")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp,
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def cuda_lib(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use), with
    ``argtypes`` set from ``signatures`` (function name -> ctypes types;
    every entry point returns the ``cudaGetLastError`` code as an int)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = load_lib(_lib_path(name), signatures)
    return lib


def load_lib(path: Path, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Load a built kernel library and set its entry points' types."""
    lib = ctypes.CDLL(str(path))
    lib.edm_error_string.argtypes = [ctypes.c_int]
    lib.edm_error_string.restype = ctypes.c_char_p
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.edm_error_string(err).decode()}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for ``None``."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
