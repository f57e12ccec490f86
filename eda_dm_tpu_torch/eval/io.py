"""Image files for FID sample sets (port of ``eda_dm_tpu/eval/io.py``):
``to_uint8``, ``save_images``, ``make_grid``, the watermark, ``save_grid``
and ``save_prompts``, and a PNG reader.

PNG batches go through the native thread-pool writer (``native/``, built
on first use) where it builds, and otherwise through this module's own
encoder (8-bit, no filter, the standard library's ``zlib``), so no imaging
package is needed; other formats go through PIL, as the JAX package writes
them.

``read_pngs`` reads back what either writer makes (8-bit RGB, colour type
2, not interlaced) without PIL: inflate, then undo the five row filters
(libpng chooses one a row).  A batch of same-sized files is unfiltered
together, one pixel column at a time across the batch.  ``png_info``
says whether a file is such a PNG; ``data/datasets.py`` sends every other
file to PIL.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(img_u8: np.ndarray, path: str) -> None:
    """One (H, W, C) uint8 image as a PNG through this module's encoder."""
    with open(path, "wb") as f:
        f.write(_png_bytes(img_u8 if img_u8.ndim == 3 else img_u8[..., None]))


def png_writer() -> str:
    """Which writer ``save_images`` uses for PNGs: ``"native"`` (the
    libpng thread pool) where it builds, else ``"zlib"``."""
    from ..native import load_imgio
    return "native" if load_imgio() is not None else "zlib"


def save_images(images: np.ndarray, out_dir: str, start_index: int = 0,
                fmt: str = "png", native: bool = True) -> int:
    """Write NHWC float images in [0,1] as {index}.{fmt}; returns count."""
    os.makedirs(out_dir, exist_ok=True)
    arr = to_uint8(np.asarray(images))
    paths = [os.path.join(out_dir, f"{start_index + i}.{fmt}")
             for i in range(arr.shape[0])]
    if fmt == "png":
        from ..native import write_png_batch
        if not (native and write_png_batch(arr, paths)):
            for img, path in zip(arr, paths):
                write_png(img, path)
        return arr.shape[0]
    from PIL import Image
    for img, path in zip(arr, paths):
        Image.fromarray(img).save(path)
    return arr.shape[0]


# --------------------------------------------------------------------------
# reading back
# --------------------------------------------------------------------------

def png_info(path: str) -> Optional[Tuple[int, int]]:
    """(height, width) of an 8-bit RGB, non-interlaced PNG (the kind
    ``save_images`` writes), else None."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 33 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        return None
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", head[16:29])
    if (depth, color, comp, filt, interlace) != (8, 2, 0, 0, 0):
        return None
    return h, w


def _filtered_rows(path: str) -> Tuple[np.ndarray, int, int]:
    """The inflated scanlines of an 8-bit RGB PNG: (h, 1 + 3w) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, []
    w = h = None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body[:13])
            if (depth, color, interlace) != (8, 2, 0):
                raise ValueError(f"{path}: not an 8-bit RGB non-interlaced PNG")
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw.reshape(h, 1 + 3 * w), h, w


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_pngs(paths: Sequence[str]) -> np.ndarray:
    """Same-sized 8-bit RGB PNGs → (N, H, W, 3) uint8, without PIL.  Rows
    are unfiltered together across the batch: None, Sub and Up by whole
    rows, Average and Paeth (which chain along a row) a pixel at a time."""
    rows = [_filtered_rows(p) for p in paths]
    h, w = rows[0][1], rows[0][2]
    if any((r[1], r[2]) != (h, w) for r in rows):
        raise ValueError("read_pngs: the images differ in size")
    stack = np.stack([r[0] for r in rows])                 # (N, h, 1 + 3w)
    ftype = stack[:, :, 0]
    filt = stack[:, :, 1:].reshape(len(paths), h, w, 3).astype(np.int16)
    out = np.zeros((len(paths), h, w, 3), np.int16)
    prior = np.zeros((len(paths), w, 3), np.int16)
    for y in range(h):
        t, f = ftype[:, y], filt[:, y]
        if np.any(t > 4):
            raise ValueError(f"read_pngs: unknown row filter {int(t.max())}")
        cur = np.where((t == 2)[:, None, None], (f + prior) & 0xFF, f)
        sub = t == 1
        if sub.any():
            cur[sub] = np.cumsum(f[sub], axis=1) & 0xFF
        chained = (t == 3) | (t == 4)
        if chained.any():
            fc, pc = f[chained], prior[chained]
            avg = (t[chained] == 3)[:, None]
            left = np.zeros_like(fc[:, 0])
            up_left = np.zeros_like(fc[:, 0])
            for x in range(w):
                up = pc[:, x]
                pred = np.where(avg, (left + up) >> 1, _paeth(left, up, up_left))
                left = (fc[:, x] + pred) & 0xFF
                up_left = up
                fc[:, x] = left
            cur[chained] = fc
        out[:, y] = prior = cur
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """One 8-bit RGB PNG → (H, W, 3) uint8, without PIL."""
    return read_pngs([path])[0]


# --------------------------------------------------------------------------
# grids, watermark, prompts
# --------------------------------------------------------------------------

def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile NHWC float images into one (H', W', C) grid, in the geometry of
    ``torchvision.utils.make_grid``: ``nrow`` images a row, ``padding``
    pixels between and around the tiles."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    gh = nrows * (h + padding) + padding
    gw = ncol * (w + padding) + padding
    grid = np.full((gh, gw, c), pad_value, images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def put_watermark(img_u8: np.ndarray, text: str = "StableDiffusionV1") -> np.ndarray:
    """Embed ``text`` in a uint8 HWC image as a ±1 LSB code on the last
    channel (``[16-bit length | payload bits]``, tiled row-major):
    invisible (at most 1/255) and read back exactly by
    :func:`read_watermark`.  The JAX package's stand-in for the reference's
    DWT-DCT watermark."""
    payload = text.encode("utf-8")
    bits = np.unpackbits(np.frombuffer(
        np.uint16(len(payload)).tobytes() + payload, np.uint8))
    out = img_u8.copy()
    blue = out[..., -1].reshape(-1)
    if bits.size > blue.size:
        raise ValueError("image too small for watermark payload")
    reps = blue.size // bits.size
    tiled = np.tile(bits, reps)
    blue[:tiled.size] = (blue[:tiled.size] & 0xFE) | tiled
    out[..., -1] = blue.reshape(out.shape[:-1])
    return out


def read_watermark(img_u8: np.ndarray) -> str:
    """Recover a :func:`put_watermark` payload (a majority vote over the
    tiles)."""
    blue = img_u8[..., -1].reshape(-1) & 1
    n_len = int(np.packbits(blue[:16]).view(np.uint16)[0])
    span = 16 + 8 * n_len
    reps = blue.size // span
    votes = blue[:reps * span].reshape(reps, span).mean(0) >= 0.5
    data = np.packbits(votes.astype(np.uint8))
    return data[2:2 + n_len].tobytes().decode("utf-8")


def save_grid(images: np.ndarray, path: str, nrow: int = 8,
              watermark: Optional[str] = None) -> None:
    """An image grid (float [0,1] NHWC) as one PNG, watermarked where
    ``watermark`` is given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grid = to_uint8(make_grid(images, nrow=nrow))
    if watermark:
        grid = put_watermark(grid, watermark)
    write_png(grid, path)


def save_prompts(prompts: List[str], out_dir: str) -> None:
    """One ``{i:05}.txt`` a prompt."""
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(prompts):
        with open(os.path.join(out_dir, f"{i:05}.txt"), "w") as f:
            f.write(p)
