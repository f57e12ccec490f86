"""The port's metrics, image I/O, data readers and run utilities against the
JAX package's, on the same arrays and the same temporary files.

Every comparison here is exact: the metrics are the same numpy / scipy
operations in the same order (float64), the readers the same pixels, the
writers files whose pixels read back equal (by PIL and by the port's own
PNG reader), the codecs the same floats.  The port's PNG reader is also
held on files the JAX package's writers make (its libpng writer, whose
rows take all five filter types, and PIL), and the port's native writer
(its own copy of ``imgio.cpp``) on a round trip.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_ddpm  # noqa: F401  (each xdist worker's share of the cores)
from eda_dm_tpu.data import coco as jcoco
from eda_dm_tpu.data import datasets as jdata
from eda_dm_tpu.eval import io as jio
from eda_dm_tpu.eval import metrics as jm
from eda_dm_tpu_torch.data import coco as tcoco
from eda_dm_tpu_torch.data import datasets as tdata
from eda_dm_tpu_torch.eval import io as tio
from eda_dm_tpu_torch.eval import metrics as tm


def _feats(seed, n=40, d=12, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3
            + shift).astype(np.float32)


def _probs(seed, n=50, k=9):
    e = np.exp(np.random.default_rng(seed).standard_normal((n, k)) * 2.0)
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


METRICS = {
    "frechet_distance": lambda m: m.frechet_distance(
        m.FeatureStats.from_features(_feats(0)), m.FeatureStats.from_features(_feats(1, shift=0.2))),
    "frechet_distance_singular": lambda m: m.frechet_distance(   # the eps retry
        m.FeatureStats.from_features(_feats(2, n=5)), m.FeatureStats.from_features(_feats(3, n=5))),
    "fid_from_features": lambda m: m.fid_from_features(_feats(4), _feats(5, shift=0.5)),
    "standardized_fid": lambda m: m.standardized_fid(_feats(6) * 1e-4, _feats(7) * 1e-4 + 1e-5),
    "standardized_fid_pool": lambda m: m.standardized_fid(_feats(8), _feats(9),
                                                          pool=np.concatenate([_feats(10)] * 2)),
    "inception_score": lambda m: m.inception_score(_probs(11)),
    "inception_score_splits": lambda m: m.inception_score(_probs(12, n=37), splits=4),
    "spatial_fid": lambda m: m.spatial_fid(_feats(13, d=20), _feats(14, d=20)),
    "clip_score": lambda m: m.clip_score(_feats(15), _feats(16)),
    "center_resize_image": lambda m: m.center_resize_image(
        np.random.default_rng(17).integers(0, 256, (40, 64, 3), dtype=np.uint8), size=24),
    "feature_stats": lambda m: (lambda s: (s.mu, s.sigma))(m.FeatureStats.from_features(_feats(18))),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_equal_jax(name):
    got, want = METRICS[name](tm), METRICS[name](jm)
    assert type(got) is type(want)
    for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _images(seed, n=5, h=12, w=10, c=3):
    return np.random.default_rng(seed).random((n, h, w, c)).astype(np.float32)


IO = {
    "to_uint8": lambda io, d: io.to_uint8(np.linspace(-0.1, 1.1, 97).reshape(97, 1, 1, 1)),
    "make_grid": lambda io, d: io.make_grid(_images(0, n=7), nrow=3),
    "make_grid_pad": lambda io, d: io.make_grid(_images(1, n=2), nrow=8, padding=1,
                                               pad_value=0.5),
    "put_watermark": lambda io, d: io.put_watermark(
        io.to_uint8(_images(2, n=1, h=40, w=40)[0]), "StableDiffusionV1"),
    "read_watermark": lambda io, d: io.read_watermark(jio.put_watermark(
        jio.to_uint8(_images(3, n=1, h=30, w=30)[0]), "a mark")),
}


@pytest.mark.parametrize("name", sorted(IO))
def test_eval_io_equals_jax(name, tmp_path):
    got, want = IO[name](tio, tmp_path), IO[name](jio, tmp_path)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _read_all(d, n, start=0, fmt="png"):
    return np.stack([np.asarray(Image.open(os.path.join(d, f"{start + i}.{fmt}")))
                     for i in range(n)])


@pytest.mark.parametrize("native", [True, False])
def test_save_images_equals_jax(tmp_path, native):
    imgs = _images(4, n=6)
    tio.save_images(imgs, str(tmp_path / "t"), start_index=3, native=native)
    jio.save_images(imgs, str(tmp_path / "j"), start_index=3, native=native)
    t, j = _read_all(tmp_path / "t", 6, 3), _read_all(tmp_path / "j", 6, 3)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, tio.to_uint8(imgs))
    paths = [str(tmp_path / "j" / f"{3 + i}.png") for i in range(6)]
    np.testing.assert_array_equal(tio.read_pngs(paths), j)


def test_save_images_other_format_goes_through_pil(tmp_path):
    imgs = _images(5, n=2)
    tio.save_images(imgs, str(tmp_path / "t"), fmt="bmp")
    jio.save_images(imgs, str(tmp_path / "j"), fmt="bmp")
    np.testing.assert_array_equal(_read_all(tmp_path / "t", 2, fmt="bmp"),
                                  _read_all(tmp_path / "j", 2, fmt="bmp"))


def test_save_grid_and_prompts_equal_jax(tmp_path):
    imgs = _images(6, n=10, h=16, w=16)
    for io, d in ((tio, "t"), (jio, "j")):
        io.save_grid(imgs, str(tmp_path / d / "grid.png"), nrow=4, watermark="StableDiffusionV1")
        io.save_prompts(["a cat", "two dogs", ""], str(tmp_path / d / "prompts"))
    t, j = (np.asarray(Image.open(tmp_path / d / "grid.png")) for d in "tj")
    np.testing.assert_array_equal(t, j)
    assert tio.read_watermark(t) == "StableDiffusionV1"
    for name in sorted(os.listdir(tmp_path / "j" / "prompts")):
        assert (tmp_path / "t" / "prompts" / name).read_text() == \
            (tmp_path / "j" / "prompts" / name).read_text()


def test_png_reader_on_every_row_filter(tmp_path):
    """The port's reader on libpng's files (the JAX writer: its adaptive
    filter picks all five row filters on these images) and PIL's, equal to
    PIL's reading; one batch of same-sized files at once."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:32, 0:32] / 31.0
    smooth = np.stack([np.stack([yy * a, xx * (1 - a), (yy + xx) / 2], -1)
                       for a in np.linspace(0, 1, 20)])
    imgs = np.concatenate([rng.random((20, 32, 32, 3)), smooth]).astype(np.float32)
    jio.save_images(imgs, str(tmp_path / "lib"))                   # libpng
    jio.save_images(imgs[:4], str(tmp_path / "pil"), native=False)  # PIL
    libpng = [str(tmp_path / "lib" / f"{i}.png") for i in range(40)]
    filters = np.concatenate([tio._filtered_rows(p)[0][:, 0] for p in libpng])
    assert set(np.unique(filters)) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(tio.read_pngs(libpng), _read_all(tmp_path / "lib", 40))
    np.testing.assert_array_equal(tio.read_png(str(tmp_path / "pil" / "2.png")),
                                  _read_all(tmp_path / "pil", 4)[2])
    assert tio.png_info(libpng[0]) == (32, 32)
    Image.fromarray(tio.to_uint8(imgs[0])).convert("RGBA").save(tmp_path / "rgba.png")
    assert tio.png_info(str(tmp_path / "rgba.png")) is None


def test_native_writer_round_trip(tmp_path):
    from eda_dm_tpu_torch.native import load_imgio, write_png_batch
    if load_imgio() is None:
        pytest.skip("no C++ toolchain or libpng here")
    imgs = np.random.default_rng(8).integers(0, 256, (7, 24, 16, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"{i}.png") for i in range(7)]
    assert write_png_batch(imgs, paths, n_threads=4)
    np.testing.assert_array_equal(tio.read_pngs(paths), imgs)
    np.testing.assert_array_equal(_read_all(tmp_path, 7), imgs)
    assert not write_png_batch(imgs[:2], [paths[0], str(tmp_path / "no" / "x.png")])
    assert tio.png_writer() == "native"


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

CODECS = {
    "data_transform": lambda d, x: d.data_transform(d.PixelTransform(), x),
    "data_transform_dequant": lambda d, x: d.data_transform(d.PixelTransform(
        uniform_dequantization=True, gaussian_dequantization=True), x,
        np.random.RandomState(3)),
    "data_transform_logit": lambda d, x: d.data_transform(d.PixelTransform(
        rescaled=False, logit_transform=True), x),
    "inverse_data_transform": lambda d, x: d.inverse_data_transform(d.PixelTransform(),
                                                                    4 * x - 2),
    "inverse_data_transform_logit": lambda d, x: d.inverse_data_transform(
        d.PixelTransform(logit_transform=True), 6 * x - 3),
    "logit_transform": lambda d, x: d.logit_transform(x),
}


@pytest.mark.parametrize("name", sorted(CODECS))
def test_pixel_codecs_equal_jax(name):
    x = _images(9, n=3)
    got, want = CODECS[name](tdata, x), CODECS[name](jdata, x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """Folders of PNGs (the JAX package's native writer), and of
    non-square PNGs with a JPEG and a greyscale PNG (all 20×20 once
    centre-cropped), a CelebA layout, a fake CIFAR-10 pickle archive and
    COCO caption files."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(10)
    jio.save_images(rng.random((7, 20, 20, 3)).astype(np.float32), str(root / "pngs"))
    mixed = root / "church_outdoor"
    jio.save_images(rng.random((3, 20, 28, 3)).astype(np.float32), str(mixed))
    Image.fromarray(rng.integers(0, 256, (26, 20, 3), dtype=np.uint8)).save(
        mixed / "x.jpg", quality=90)
    Image.fromarray(rng.integers(0, 256, (20, 20), dtype=np.uint8)).save(mixed / "grey.png")
    celeba = root / "celeba" / "img_align_celeba"
    celeba.mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (218, 178, 3), dtype=np.uint8)).save(
            celeba / f"{i:06d}.png")
    (root / "celeba" / "list_eval_partition.txt").write_text(
        "000000.png 0\n000001.png 1\n000002.png 0\n")
    cifar = root / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8)}, f)
    (root / "captions.json").write_text(json.dumps(
        {"annotations": [{"caption": f" caption {i} "} for i in range(9)]}))
    (root / "prompts.txt").write_text("a\n\n b \nc\nd\n")
    return root


READERS = {
    "iter_image_folder": lambda d, r: list(d.iter_image_folder(str(r / "pngs"), batch_size=3)),
    "iter_image_folder_resize": lambda d, r: list(d.iter_image_folder(
        str(r / "pngs"), batch_size=4, size=12)),
    "iter_image_folder_mixed_crop": lambda d, r: list(d.iter_image_folder(
        str(r / "church_outdoor"), batch_size=2, center_crop=True)),
    "iter_image_folder_mixed_crop_resize": lambda d, r: list(d.iter_image_folder(
        str(r / "church_outdoor"), batch_size=8, size=10, center_crop=True)),
    "load_lsun_folder": lambda d, r: d.load_lsun(str(r), "church_outdoor", size=16, limit=3),
    "load_ffhq_folder": lambda d, r: d.load_ffhq(str(r / "pngs"), resolution=8, limit=5),
    "load_celeba": lambda d, r: d.load_celeba(str(r / "celeba"), size=32),
    "load_celeba_all": lambda d, r: d.load_celeba(str(r / "celeba"), split="all", size=128),
    "load_cifar10_train": lambda d, r: d.load_cifar10(str(r / "cifar")),
    "load_cifar10_test": lambda d, r: d.load_cifar10(str(r / "cifar"), train=False),
    "load_coco_json": lambda d, r: (tcoco if d is tdata else jcoco).load_coco_prompts(
        str(r / "captions.json"), limit=5),
    "load_coco_txt": lambda d, r: (tcoco if d is tdata else jcoco).load_coco_prompts(
        str(r / "prompts.txt"), shuffle=False),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_equal_jax(name, image_root):
    got, want = READERS[name](tdata, image_root), READERS[name](jdata, image_root)
    if isinstance(want, list) and want and isinstance(want[0], str):
        assert got == want
        return
    got, want = (np.concatenate(a) if isinstance(a, list) else a for a in (got, want))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_readers_without_pil_read_the_port_pngs(tmp_path, monkeypatch):
    """With PIL unimportable, a folder of the port's PNGs still reads (the
    values equal to the PIL path's), and any other file raises clearly."""
    imgs = _images(11, n=4, h=9, w=9)
    tio.save_images(imgs, str(tmp_path / "a"))
    want = np.concatenate(list(jdata.iter_image_folder(str(tmp_path / "a"), batch_size=3)))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    got = np.concatenate(list(tdata.iter_image_folder(str(tmp_path / "a"), batch_size=3)))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="needs PIL"):
        list(tdata.iter_image_folder(str(tmp_path / "a"), size=4))


# --------------------------------------------------------------------------
# run utilities
# --------------------------------------------------------------------------

def test_run_utilities(tmp_path):
    from eda_dm_tpu_torch.pipelines.cifar import CifarConfig
    from eda_dm_tpu_torch.utils import run
    g = run.seed_everything(5)
    assert isinstance(g, torch.Generator)
    a = torch.randn(3, generator=g)
    assert torch.equal(a, torch.randn(3, generator=torch.Generator().manual_seed(5)))
    assert np.random.rand() == np.random.RandomState(5).rand()
    run_dir = run.setup_run_dir(str(tmp_path), "samples")
    assert os.path.isdir(os.path.join(run_dir, "img"))
    run.dump_config(CifarConfig(), run_dir)
    dumped = [f for f in os.listdir(run_dir) if f.startswith("sampling_config")]
    assert dumped
    timer = run.PhaseTimer()
    for _ in range(2):
        with timer.phase("a"):
            pass
    assert set(timer.summary()) == {"a"} and timer.summary()["a"] >= 0
    with run.profile_trace(str(tmp_path / "trace"), label="tiny"):
        torch.ones(4).sum()
    assert os.path.exists(tmp_path / "trace" / "tiny.json")
    run.hard_sync()
