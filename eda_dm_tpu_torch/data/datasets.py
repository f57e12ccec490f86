"""Dataset readers and pixel transforms for FID reference sets (port of
``eda_dm_tpu/data/datasets.py``): CIFAR-10, CelebA, FFHQ, LSUN, image
folders, and the ``data_transform`` / ``inverse_data_transform`` pixel
codecs.  Host-side numpy; batches reach the card as tensors.

Images are float32 in [0, 1], NHWC.  An 8-bit RGB PNG (what
``eval/io.py::save_images`` writes, by either writer) is read by
``eval/io.py::read_pngs`` without PIL, a batch of same-sized ones
together; every other file, and any resize, goes through PIL, which must
then be installed.  On a file both can read, both give the same pixels.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Iterator, List, Optional

import numpy as np

from ..eval.io import png_info, read_png, read_pngs


@dataclasses.dataclass(frozen=True)
class PixelTransform:
    """The part of the reference's data config the codecs read."""
    rescaled: bool = True
    logit_transform: bool = False
    uniform_dequantization: bool = False
    gaussian_dequantization: bool = False


def logit_transform(x: np.ndarray, lam: float = 1e-6) -> np.ndarray:
    x = lam + (1.0 - 2.0 * lam) * x
    return np.log(x) - np.log1p(-x)


def data_transform(cfg: PixelTransform, x: np.ndarray,
                   rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """[0,1] images → model space."""
    rng = rng or np.random.RandomState(0)
    x = np.asarray(x, np.float32)
    if cfg.uniform_dequantization:
        x = x / 256.0 * 255.0 + rng.rand(*x.shape).astype(np.float32) / 256.0
    if cfg.gaussian_dequantization:
        x = x + rng.randn(*x.shape).astype(np.float32) * 0.01
    if cfg.rescaled:
        x = 2.0 * x - 1.0
    elif cfg.logit_transform:
        x = logit_transform(x)
    return x


def inverse_data_transform(cfg: PixelTransform, x: np.ndarray) -> np.ndarray:
    """model space → [0,1] images."""
    x = np.asarray(x, np.float32)
    if cfg.logit_transform:
        x = 1.0 / (1.0 + np.exp(-x))
    elif cfg.rescaled:
        x = (x + 1.0) / 2.0
    return np.clip(x, 0.0, 1.0)


# --------------------------------------------------------------------------
# readers
# --------------------------------------------------------------------------

def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("this image needs PIL, which is not installed: only "
                           "8-bit RGB PNGs at their own size are read without it") from e
    return Image


def load_cifar10(root: str, train: bool = True) -> np.ndarray:
    """The python-pickle CIFAR-10 archive (cifar-10-batches-py) →
    (N, 32, 32, 3) uint8."""
    base = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = root
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    chunks = []
    for n in names:
        with open(os.path.join(base, n), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        chunks.append(np.asarray(d[b"data"], np.uint8))
    return np.concatenate(chunks).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


_IMG_EXT = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _center_box(w: int, h: int):
    s = min(w, h)
    return (w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s


def _load_image(path: str, size: Optional[int], center_crop: bool) -> np.ndarray:
    """One file → (H, W, 3) float32 in [0, 1]."""
    if png_info(path) is not None:
        arr = read_png(path)
        if center_crop:
            left, top, right, bottom = _center_box(arr.shape[1], arr.shape[0])
            arr = arr[top:bottom, left:right]
        if size is None or arr.shape[:2] == (size, size):
            return arr.astype(np.float32) / 255.0
        img = _pil().fromarray(arr)
    else:
        img = _pil().open(path).convert("RGB")
        if center_crop:
            img = img.crop(_center_box(*img.size))
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), _pil().BICUBIC)
    return np.asarray(img, np.float32) / 255.0


def _load_batch(paths: List[str], size: Optional[int], center_crop: bool) -> np.ndarray:
    shapes = {png_info(p) for p in paths}
    if None not in shapes and len(shapes) == 1:
        h, w = shapes.pop()
        if (size is None or (h, w) == (size, size)) and (not center_crop or h == w):
            return read_pngs(paths).astype(np.float32) / 255.0
    return np.stack([_load_image(p, size, center_crop) for p in paths])


def iter_image_folder(path: str, batch_size: int = 64, size: Optional[int] = None,
                      center_crop: bool = False) -> Iterator[np.ndarray]:
    """Stream a directory of images (sorted by name) as float32 [0,1] NHWC
    batches: the reader of generated sample sets and of image-folder
    reference sets."""
    files = sorted(f for f in os.listdir(path) if f.lower().endswith(_IMG_EXT))
    for i in range(0, len(files), batch_size):
        yield _load_batch([os.path.join(path, f) for f in files[i:i + batch_size]],
                          size, center_crop)


def load_celeba(root: str, split: str = "train", size: int = 64,
                limit: Optional[int] = None) -> np.ndarray:
    """Aligned CelebA → (N, size, size, 3) float32 [0,1]: the reference's
    fixed face crop (a 128² box centred at (89, 121)), then a bicubic
    resize.  The split comes from ``list_eval_partition.txt`` where it is
    present, else every image."""
    img_dir = os.path.join(root, "img_align_celeba")
    if not os.path.isdir(img_dir):
        img_dir = root
    part_file = os.path.join(root, "list_eval_partition.txt")
    split_id = {"train": 0, "valid": 1, "test": 2, "all": None}[split]
    if split_id is not None and os.path.isfile(part_file):
        with open(part_file) as f:
            files = [name for line in f if line.strip()
                     for name, sid in [line.split()] if int(sid) == split_id]
    else:
        files = sorted(f for f in os.listdir(img_dir) if f.lower().endswith(_IMG_EXT))
    Image = _pil()
    cx, cy = 89, 121
    out = []
    for fname in files[:limit]:
        img = Image.open(os.path.join(img_dir, fname)).convert("RGB")
        img = img.crop((cx - 64, cy - 64, cx + 64, cy + 64))
        if size != 128:
            img = img.resize((size, size), Image.BICUBIC)
        out.append(np.asarray(img, np.float32) / 255.0)
    if not out:
        raise RuntimeError(f"CelebA: no images found under {root}")
    return np.stack(out)


def load_ffhq(root: str, resolution: int = 256, limit: Optional[int] = None) -> np.ndarray:
    """FFHQ → (N, resolution, resolution, 3) float32 [0,1]: an image folder,
    or the multi-resolution lmdb (``'{resolution}-{index:05d}'`` keys and a
    ``'length'`` record) where the ``lmdb`` package is installed."""
    if os.path.isdir(root) and any(f.lower().endswith(_IMG_EXT) for f in os.listdir(root)):
        return np.concatenate(list(iter_image_folder(
            root, size=resolution, center_crop=True)))[:limit]
    try:
        import lmdb
    except ImportError as e:
        raise RuntimeError(
            f"FFHQ: {root} is not an image folder and the lmdb package is "
            "not installed; export the archive to images first.") from e
    import io
    Image = _pil()
    env = lmdb.open(root, max_readers=32, readonly=True, lock=False,
                    readahead=False, meminit=False)
    with env.begin(write=False) as txn:
        length = int(txn.get(b"length").decode())
        n = length if limit is None else min(limit, length)
        out = []
        for i in range(n):
            raw = txn.get(f"{resolution}-{str(i).zfill(5)}".encode())
            img = Image.open(io.BytesIO(raw)).convert("RGB")
            out.append(np.asarray(img, np.float32) / 255.0)
    return np.stack(out)


def load_lsun(root: str, category: str, limit: Optional[int] = None,
              size: int = 256) -> np.ndarray:
    """An LSUN scene → (N, size, size, 3) float32 [0,1]: the exported
    image folder ``<root>/<category>``, else the ``<category>_lmdb``
    archive where the ``lmdb`` package is installed (centre crop, bicubic
    resize)."""
    folder = os.path.join(root, category)
    if os.path.isdir(folder):
        return np.concatenate(list(iter_image_folder(
            folder, size=size, center_crop=True)))[:limit]
    try:
        import lmdb
    except ImportError as e:
        raise RuntimeError(
            f"LSUN: no image folder at {folder} and the lmdb package is "
            "not installed; export the archive to images first.") from e
    import io
    Image = _pil()
    env = lmdb.open(os.path.join(root, f"{category}_lmdb"), readonly=True, lock=False)
    out = []
    with env.begin(write=False) as txn:
        for i, (_, val) in enumerate(txn.cursor()):
            if limit is not None and i >= limit:
                break
            img = Image.open(io.BytesIO(val)).convert("RGB")
            img = img.crop(_center_box(*img.size))
            out.append(np.asarray(img.resize((size, size), Image.BICUBIC),
                                  np.float32) / 255.0)
    return np.stack(out)
