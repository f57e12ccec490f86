"""Image output for FID sample sets (port of ``eda_dm_tpu/eval/io.py``:
``to_uint8`` and ``save_images``).  PNGs are written with the standard
library's ``zlib`` (8-bit RGB, no filter), so no imaging package is
needed; other formats go through PIL."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[0,1] float NHWC → uint8, rounding like torchvision's save_image
    (mul(255).add_(0.5).clamp_(0,255))."""
    return np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _png_bytes(img: np.ndarray) -> bytes:
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_images(images: np.ndarray, out_dir: str, start_index: int = 0,
                fmt: str = "png") -> int:
    """Write NHWC float images in [0,1] as {index}.{fmt}; returns count."""
    os.makedirs(out_dir, exist_ok=True)
    arr = to_uint8(np.asarray(images))
    for i in range(arr.shape[0]):
        path = os.path.join(out_dir, f"{start_index + i}.{fmt}")
        if fmt == "png":
            with open(path, "wb") as f:
                f.write(_png_bytes(arr[i]))
        else:
            from PIL import Image
            Image.fromarray(arr[i]).save(path)
    return arr.shape[0]
