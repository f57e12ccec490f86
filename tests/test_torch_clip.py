"""CLIP in the port (``models/clip.py``, ``models/clip_tokenizer.py``,
``eval/clip.py::CLIPScorer``, ``models/encoders.py::FrozenCLIPTextEncoder``
and ``sample_ldm --text_encoder clip``) against the JAX package's CLIP
classes, which wrap ``transformers``' Flax CLIP, on the CPU at tiny sizes.

* the towers and ``CLIPScorer`` on a tiny random ``FlaxCLIPModel`` (the
  sizes of ``tests/test_clip_score.py``, every parameter moved off its
  init by seeded noise), carried over by ``clip_from_flax_params``:
  image and text features and the score within 1e-5 of the largest |JAX|
  value, at ``eos_token_id`` 2 (argmax pooling) and at one inside the
  vocabulary (first-eos pooling), with and without a padding mask;
* ``FrozenCLIPTextEncoder`` on a tiny checkout (the vocabulary of
  ``tests/test_weights_loaders.py`` plus real merges; Flax weights for
  the JAX class, the same weights as ``model.safetensors``,
  ``pytorch_model.bin`` or, in a Flax-only checkout, ``flax_model.msgpack``
  alone for the port, written by ``transformers``): hidden states within
  1e-5, once through each file format; ``CLIPScorer`` likewise on a
  two-tower checkout of each format;
* the tokenizer: ids and masks equal to ``transformers.CLIPTokenizer``'s on
  that vocabulary and on a synthetic one of the published size, at
  ``max_length`` 77 and 16;
* the safetensors reader bit-equal to ``safetensors.numpy.load_file``
  (F32, F16, BF16); the Flax msgpack reader bit-equal to
  ``flax.serialization.msgpack_restore`` (F32, F16, BF16, integers,
  scalars and a chunked array), and a truncated or malformed file raises;
* a missing checkout, or one without a weight file, raises
  ``RuntimeError`` from both classes; without a card and without
  ``device="cpu"`` they raise;
* ``sample_ldm.build_coco_context`` with ``--text_encoder clip`` against
  the JAX script's, and ``sample_ldm.main`` through the tiny checkout.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import test_torch_ddpm  # noqa: F401  (each xdist worker's share of the cores)

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from eda_dm_tpu.eval import clip as jclip  # noqa: E402
from eda_dm_tpu.models import encoders as jenc  # noqa: E402
from eda_dm_tpu_torch import sample_ldm  # noqa: E402
from eda_dm_tpu_torch.eval import clip as tclip  # noqa: E402
from eda_dm_tpu_torch.models import clip as tc  # noqa: E402
from eda_dm_tpu_torch.models import clip_tokenizer as ttok  # noqa: E402
from eda_dm_tpu_torch.models import encoders as tenc  # noqa: E402
from eda_dm_tpu_torch.models import latent_diffusion as tld  # noqa: E402
from eda_dm_tpu_torch.models import ldm_unet as tldm  # noqa: E402
from eda_dm_tpu_torch.models import vae as tvae  # noqa: E402
from eda_dm_tpu_torch.pipelines import latent as tlatent  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 32                          # the tiny text tower's width
PROMPTS = ["a cat on a mat", "the dog", "", "a red bus on the bridge"]
TOKENIZER_TEXTS = [
    "a cat on a mat", "", "It's a Café — naïve 猫 cat!!\x07 they'll 2023 ½ ①  \t\n x",
    "Ünïcödé ÀÉÎ ß ǅ ﬁ 🙂 emoji… ​zero width", "<|endoftext|>the<|startoftext|> dog",
    "we've, I'd; you're: 3.14 % $5 [x] {y} <z> a_b c-d e/f 'quoted'",
    " ".join(f"word{i}" for i in range(60))]       # past 75 tokens: truncated


def _close(out, ref, what, tol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
    print(f"{what}: max |d| {err:.3g} of largest |JAX| {scale:.3g}")
    assert err <= tol * scale, what


def _perturb(params, seed):
    """Every leaf moved by seeded N(0, 0.02²) noise, so LayerNorm scales
    and biases are not their init (ones, zeros)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + rng.normal(0, 0.02, np.shape(p)), jnp.float32),
        params)


# ---------------------------------------------------------------------------
# the towers and CLIPScorer against JAX's on a tiny FlaxCLIPModel
# ---------------------------------------------------------------------------

def _tiny_flax_clip(eos):
    from transformers import CLIPConfig, CLIPTextConfig, CLIPVisionConfig, FlaxCLIPModel
    cfg = CLIPConfig.from_text_vision_configs(
        CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, max_position_embeddings=77, vocab_size=99,
                       eos_token_id=eos),
        CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, image_size=224, patch_size=32),
        projection_dim=16)
    model = FlaxCLIPModel(cfg, seed=0)
    model.params = _perturb(model.params, eos)
    return model, cfg


@pytest.mark.parametrize("eos", [2, 60], ids=["argmax_pooling", "first_eos_pooling"])
def test_clip_scorer_matches_jax(eos, checkouts):
    from transformers import CLIPTokenizer
    flax_model, hf_cfg = _tiny_flax_clip(eos)
    cfg = tc.CLIPConfig.from_dict(hf_cfg.to_dict())
    assert cfg.text.eos_token_id == eos and cfg.projection_dim == 16
    port = tc.clip_from_flax_params(flax_model.params, cfg, device="cpu")
    d = checkouts["bin"]                     # a vocabulary inside the tiny model's 99
    jax_scorer = jclip.CLIPScorer(model=flax_model, tokenizer=CLIPTokenizer.from_pretrained(d))
    scorer = tclip.CLIPScorer(model=port, tokenizer=ttok.CLIPTokenizer.from_pretrained(d),
                              device="cpu")

    rng = np.random.RandomState(0)
    images = rng.rand(3, 64, 64, 3).astype(np.float32)
    _close(scorer.image_features(images), jax_scorer.image_features(images), "image features")
    # the largest id, the eos id and the mask's end at different positions
    ids = rng.randint(3, 59, size=(3, 77))
    ids[:, 0] = 1
    ids[0, 5], ids[0, 9] = 60, 98            # first eos at 5, argmax at 9
    ids[1, 20], ids[1, 3] = 60, 97           # first eos at 20, argmax at 3
    ids[2, 40] = 60                          # eos and argmax at 40
    mask = np.ones_like(ids)                 # padding, and keys masked before the pooled row
    mask[0, 2:4], mask[0, 12:], mask[1, 1], mask[1, 30:] = 0, 0, 0, 0
    mask[2, 10:20], mask[2, 41:] = 0, 0
    assert ids.argmax(-1).tolist() == [9, 3, 40]
    assert (ids == 60).argmax(-1).tolist() == [5, 20, 40]
    feats = []
    for m in (None, mask):
        feats.append(scorer.text_features(input_ids=ids, attention_mask=m))
        _close(feats[-1], jax_scorer.text_features(input_ids=ids, attention_mask=m),
               f"text features, mask {m is not None}")
    assert np.abs(feats[0] - feats[1]).max(-1).min() > 1e-4      # the mask moved every row
    _close(scorer.text_features(PROMPTS[:3]), jax_scorer.text_features(PROMPTS[:3]),
           "text features of prompts")
    for kw in (dict(input_ids=ids), dict(prompts=PROMPTS[:3])):
        s, ref = scorer.score(images, **kw), jax_scorer.score(images, **kw)
        print(f"score {s!r} JAX {ref!r}")
        assert abs(s - ref) <= 1e-5 * abs(ref) and -100.0 <= s <= 100.0


def test_text_pooling_branches():
    """``eos_token_id`` 2 pools at the largest id, any other at its first
    occurrence (0 where it is absent)."""
    cfg = tc.CLIPConfig(tc.CLIPTextConfig(vocab_size=99, hidden_size=8, intermediate_size=16,
                                          num_hidden_layers=1, num_attention_heads=2,
                                          eos_token_id=2), None, projection_dim=None)
    ids = torch.tensor([[1, 7, 60, 98, 60, 0], [1, 5, 5, 5, 5, 5]])
    for eos, want in ((2, [3, 1]), (60, [2, 0])):
        c = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=eos))
        m = tc.CLIPModel(c, device="cpu", seed=0)
        h, pooled = m.text_model(ids)
        torch.testing.assert_close(pooled, h[torch.arange(2), torch.tensor(want)],
                                   rtol=0, atol=0)


def test_config_layouts_and_published_widths():
    """Both ``config.json`` layouts; the defaults are ``transformers``'; the
    published ViT-L/14 widths give its parameter counts."""
    from transformers import CLIPConfig, CLIPTextConfig
    hf = CLIPConfig()
    two = tc.CLIPConfig.from_dict(hf.to_dict())
    for ours, theirs in ((two.text, hf.text_config), (two.vision, hf.vision_config)):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert two.projection_dim == hf.projection_dim
    flat = tc.CLIPConfig.from_dict(CLIPTextConfig(hidden_size=48).to_dict())
    assert flat.vision is None and flat.projection_dim is None and flat.text.hidden_size == 48
    assert tc.CLIPConfig.from_dict({}).text == tc.CLIPTextConfig()
    legacy = tc.CLIPConfig.from_dict({"text_config": {"hidden_size": 64},
                                      "text_config_dict": {"hidden_size": 768}})
    assert legacy.text.hidden_size == 768
    meta = torch.device("meta")
    with torch.device(meta):
        text = tc.CLIPTextTransformer(tc.vit_l14_config().text)
        vision = tc.CLIPVisionTransformer(tc.vit_l14_config().vision)
    assert sum(p.numel() for p in text.parameters()) == 123_060_480
    assert sum(p.numel() for p in vision.parameters()) == 303_179_776


# ---------------------------------------------------------------------------
# a tiny checkout: FrozenCLIPTextEncoder against JAX's
# ---------------------------------------------------------------------------

MERGES = [("c", "a"), ("ca", "t</w>"), ("o", "n</w>"), ("m", "a"), ("ma", "t</w>"),
          ("t", "h"), ("th", "e</w>"), ("d", "o"), ("do", "g</w>"), ("r", "e"),
          ("re", "d</w>"), ("b", "u"), ("bu", "s</w>")]


def _tiny_vocab():
    """``tests/test_weights_loaders.py``'s vocabulary, then one token a merge."""
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for ch in "abcdefghijklmnopqrstuvwxyz ":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for a, b in MERGES:
        vocab[a + b] = len(vocab)
    return vocab


@pytest.fixture(scope="module")
def checkouts(tmp_path_factory):
    """Three tiny text checkouts with the same weights: Flax msgpack for the
    JAX class in each, and for the port ``model.safetensors`` in one,
    ``pytorch_model.bin`` in another and nothing more in the third (Flax
    only); the tokenizer files in all."""
    from transformers import CLIPTextConfig, CLIPTextModel, CLIPTokenizer, FlaxCLIPTextModel
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model
    vocab = _tiny_vocab()
    cfg = CLIPTextConfig(hidden_size=WIDTH, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77,
                         vocab_size=len(vocab))
    flax_model = FlaxCLIPTextModel(cfg, seed=0)
    flax_model.params = _perturb(flax_model.params, 1)
    pt = CLIPTextModel(cfg)
    load_flax_weights_in_pytorch_model(pt, flax_model.params)
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False), ("msgpack", None)):
        d = tmp_path_factory.mktemp(f"clip_{fmt}")
        (d / "vocab.json").write_text(json.dumps(vocab))
        (d / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in MERGES))
        CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt")).save_pretrained(str(d))
        flax_model.save_pretrained(str(d))
        if safe is not None:
            pt.save_pretrained(str(d), safe_serialization=safe)
        dirs[fmt] = str(d)
    assert os.path.isfile(os.path.join(dirs["safetensors"], "model.safetensors"))
    assert os.path.isfile(os.path.join(dirs["bin"], "pytorch_model.bin"))
    assert not os.path.isfile(os.path.join(dirs["bin"], "model.safetensors"))
    weights = [n for n in os.listdir(dirs["msgpack"]) if n in tc.WEIGHT_NAMES]
    assert weights == ["flax_model.msgpack"]
    return dirs


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "msgpack"])
def test_frozen_clip_text_encoder_matches_jax(checkouts, fmt):
    d = checkouts[fmt]
    ref = np.asarray(jenc.FrozenCLIPTextEncoder(d).encode(PROMPTS))
    enc = tenc.FrozenCLIPTextEncoder(d, device="cpu")
    out = enc.encode(PROMPTS)
    assert out.dtype == torch.float32 and tuple(out.shape) == (len(PROMPTS), 77, WIDTH)
    _close(out.numpy(), ref, f"hidden states through {fmt}")
    from transformers import CLIPTokenizer
    hf = CLIPTokenizer.from_pretrained(d)
    np.testing.assert_array_equal(enc.tokenize(PROMPTS), hf(
        PROMPTS, truncation=True, max_length=77, padding="max_length",
        return_tensors="np")["input_ids"])


@pytest.fixture(scope="module")
def scorer_checkouts(tmp_path_factory, checkouts):
    """A tiny two-tower checkout in each format (``checkouts``' with
    ``_tiny_flax_clip``'s weights, first-eos pooling at the tokenizer's
    end-of-text id) and ``checkouts``' tokenizer files."""
    from transformers import CLIPModel
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model
    flax_model, hf_cfg = _tiny_flax_clip(_tiny_vocab()["<|endoftext|>"])
    pt = CLIPModel(hf_cfg)
    load_flax_weights_in_pytorch_model(pt, flax_model.params)
    src = checkouts["bin"]
    dirs = {}
    for fmt, safe in (("safetensors", True), ("bin", False), ("msgpack", None)):
        d = tmp_path_factory.mktemp(f"clip_pair_{fmt}")
        for name in os.listdir(src):
            if name != tc.CONFIG_NAME and name not in tc.WEIGHT_NAMES:
                shutil.copy(os.path.join(src, name), d / name)
        flax_model.save_pretrained(str(d))
        if safe is not None:
            pt.save_pretrained(str(d), safe_serialization=safe)
        dirs[fmt] = str(d)
    return dirs


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "msgpack"])
def test_clip_scorer_checkout_matches_jax(scorer_checkouts, fmt):
    """``CLIPScorer(model_path=...)`` against JAX's on the same checkout."""
    d = scorer_checkouts[fmt]
    jax_scorer = jclip.CLIPScorer(model_path=d)
    scorer = tclip.CLIPScorer(model_path=d, device="cpu")
    images = np.random.RandomState(1).rand(len(PROMPTS), 64, 64, 3).astype(np.float32)
    _close(scorer.image_features(images), jax_scorer.image_features(images),
           f"image features through {fmt}")
    _close(scorer.text_features(PROMPTS), jax_scorer.text_features(PROMPTS),
           f"text features through {fmt}")
    s, ref = scorer.score(images, prompts=PROMPTS), jax_scorer.score(images, prompts=PROMPTS)
    print(f"score through {fmt} {s!r} JAX {ref!r}")
    assert abs(s - ref) <= 1e-5 * abs(ref) and -100.0 <= s <= 100.0


def test_load_clip_checkpoint_towers(checkouts):
    """A flat text checkout: the text tower, no projection; asking for the
    vision tower alone finds none."""
    m = tc.load_clip_checkpoint(checkouts["safetensors"], device="cpu")
    assert hasattr(m, "text_model") and not hasattr(m, "vision_model")
    assert not hasattr(m, "text_projection")
    with pytest.raises(RuntimeError, match="local CLIP checkpoint"):
        tc.load_clip_checkpoint(checkouts["safetensors"], device="cpu", towers=("vision",))


# ---------------------------------------------------------------------------
# the tokenizer against transformers'
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synthetic_vocab(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_vocab")
    enc = ttok.write_synthetic_vocab(str(d), TOKENIZER_TEXTS[:4] + PROMPTS)
    assert len(enc) == 49408 and enc["<|startoftext|>"] == 49406
    assert enc["<|endoftext|>"] == 49407
    return str(d)


@pytest.mark.parametrize("max_length", [77, 16])
@pytest.mark.parametrize("vocab", ["tiny", "synthetic"])
def test_tokenizer_matches_transformers(checkouts, synthetic_vocab, vocab, max_length):
    from transformers import CLIPTokenizer
    d = checkouts["safetensors"] if vocab == "tiny" else synthetic_vocab
    hf = CLIPTokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"))
    ours = ttok.CLIPTokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"))
    a = ours(TOKENIZER_TEXTS, max_length=max_length)
    b = hf(TOKENIZER_TEXTS, truncation=True, max_length=max_length, padding="max_length",
           return_tensors="np")
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    assert a["input_ids"][-1, -1] == hf.eos_token_id        # the long row was cut
    for t in TOKENIZER_TEXTS:
        assert ours.tokenize(t) == hf.tokenize(t), t


def test_tokenizer_config_pad_token(tmp_path, checkouts):
    """A pad token named in ``tokenizer_config.json`` pads the rows."""
    d = tmp_path / "pad"
    shutil.copytree(checkouts["safetensors"], d)
    cfg = json.loads((d / "tokenizer_config.json").read_text())
    cfg["pad_token"] = "a</w>"
    (d / "tokenizer_config.json").write_text(json.dumps(cfg))
    from transformers import CLIPTokenizer
    hf = CLIPTokenizer.from_pretrained(str(d))
    ours = ttok.CLIPTokenizer.from_pretrained(str(d))
    assert ours.pad_token_id == hf.pad_token_id == _tiny_vocab()["a</w>"]
    np.testing.assert_array_equal(
        ours(PROMPTS)["input_ids"],
        hf(PROMPTS, truncation=True, max_length=77, padding="max_length",
           return_tensors="np")["input_ids"])


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

def test_safetensors_reader_bit_equal(tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    tensors = {f"{name}_{i}": torch.randn(shape, generator=g).to(dtype)
               for name, dtype in (("f32", torch.float32), ("f16", torch.float16),
                                   ("bf16", torch.bfloat16))
               for i, shape in enumerate([(3, 5), (7,), (), (2, 3, 4), (0, 3)])}
    tensors["position_ids"] = torch.arange(77)[None]          # I64, as older checkouts hold
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    ours, ref = tc.read_safetensors(path), load_file(path)
    assert sorted(ours) == sorted(ref) == sorted(tensors)
    ints = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32), 8: (torch.int64, np.int64)}
    for k, t in ours.items():
        assert t.dtype == tensors[k].dtype and tuple(t.shape) == ref[k].shape, k
        tbits, nbits = ints[t.element_size()]
        np.testing.assert_array_equal(t.view(tbits).numpy(), ref[k].view(nbits), err_msg=k)
        torch.testing.assert_close(t, tensors[k], rtol=0, atol=0)


def _assert_tree_bit_equal(ours, ref, where="tree"):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(ref), where
        for k in ref:
            _assert_tree_bit_equal(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (np.ndarray, np.generic)):
        ref = np.asarray(ref)
        assert isinstance(ours, torch.Tensor), where
        assert str(ours.dtype).removeprefix("torch.") == ref.dtype.name, where
        assert tuple(ours.shape) == ref.shape, where
        bits = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.int16),
                4: (torch.int32, np.int32), 8: (torch.int64, np.int64)}
        tbits, nbits = bits[ref.dtype.itemsize]
        np.testing.assert_array_equal(ours.view(tbits).numpy(), ref.view(nbits), err_msg=where)
    else:
        assert type(ours) is type(ref) and ours == ref, where


def _flax_tree():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "text_model": {
            "dense": {"kernel": f32(5, 3), "bias": f32(3)},
            "norm": {"scale": f32(3).astype(np.float16), "empty": f32(0, 4)},
            "half": jnp.asarray(f32(2, 3, 4), jnp.bfloat16),
            "bf16_scalar": jnp.asarray(1.5, jnp.bfloat16),
        },
        "ints": {"i8": rng.integers(-128, 127, (4, 4), dtype=np.int8),
                 "u8": rng.integers(0, 255, (6,), dtype=np.uint8),
                 "i16": rng.integers(-2 ** 15, 2 ** 15, (3,), dtype=np.int16),
                 "i32": np.arange(-3, 77, dtype=np.int32)[None],
                 "i64": np.array([-2 ** 40, 0, 2 ** 62], np.int64),
                 "bool": np.array([True, False, True])},
        "f64": rng.standard_normal((2, 2)),
        "scalars": {"np": np.float32(0.25), "step": 7, "neg": -40, "big": 2 ** 40,
                    "negbig": -2 ** 40, "ratio": 0.1, "name": "ü" * 40, "none": None,
                    "flag": True},
        "chunked": f32(10, 21),                          # past the patched chunk size
        "a" * 300: {},                                   # a key past 255 bytes
    }


def test_flax_msgpack_reader_bit_equal(monkeypatch, tmp_path):
    """``read_flax_msgpack`` against ``flax.serialization.msgpack_restore`` on
    ``to_bytes`` of f32, f16, bf16, f64, integer, bool and scalar leaves, with
    the chunk size cut so that one array is chunked."""
    from flax import serialization
    from eda_dm_tpu_torch.models.flax_msgpack import read_flax_msgpack
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 512)
    data = serialization.to_bytes(_flax_tree())
    assert data.count(b"__msgpack_chunked_array__") == 1
    path = tmp_path / "flax_model.msgpack"
    path.write_bytes(data)
    ours, ref = read_flax_msgpack(str(path)), serialization.msgpack_restore(data)
    assert isinstance(ref["chunked"], np.ndarray) and ref["chunked"].shape == (10, 21)
    _assert_tree_bit_equal(ours, ref)
    state = tc.flax_to_state_dict({"text_model": ours["text_model"]})
    torch.testing.assert_close(state["text_model.dense.weight"],
                               torch.from_numpy(np.asarray(ref["text_model"]["dense"]["kernel"]).T),
                               rtol=0, atol=0)


def test_flax_msgpack_reader_refuses_bad_files(tmp_path):
    from flax import serialization
    from eda_dm_tpu_torch.models.flax_msgpack import read_flax_msgpack
    data = serialization.to_bytes({"w": np.ones((4, 4), np.float32), "b": np.zeros(4, np.float32)})
    cases = {"truncated": data[:-7], "cut_header": data[:3], "empty": b"",
             "trailing": data + b"\x00",
             "not_a_map": serialization.to_bytes(np.ones(3, np.float32)),
             "complex": serialization.to_bytes({"c": 1 + 2j}),
             "reserved_byte": b"\x81\xa1w\xc1"}
    for name, blob in cases.items():
        path = tmp_path / f"{name}.msgpack"
        path.write_bytes(blob)
        with pytest.raises(RuntimeError, match="not a Flax msgpack checkpoint") as e:
            read_flax_msgpack(str(path))
        assert str(path) in str(e.value), name
    path = tmp_path / "truncated.msgpack"
    with pytest.raises(RuntimeError, match="truncated"):
        read_flax_msgpack(str(path))
    d = tmp_path / "checkout"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"hidden_size": 8, "num_attention_heads": 2}))
    (d / "flax_model.msgpack").write_bytes(data[:-7])
    with pytest.raises(RuntimeError, match="truncated"):
        tc.load_clip_checkpoint(str(d), device="cpu")


# ---------------------------------------------------------------------------
# missing checkouts and the device rule
# ---------------------------------------------------------------------------

def test_missing_checkpoint_raises(tmp_path, checkouts):
    no_weights = tmp_path / "no_weights"
    no_weights.mkdir()
    for name in ("config.json", "vocab.json", "merges.txt"):
        shutil.copy(os.path.join(checkouts["bin"], name), no_weights / name)
    for path in ("/nonexistent/clip", str(no_weights)):
        with pytest.raises(RuntimeError, match="local CLIP checkpoint") as e:
            tenc.FrozenCLIPTextEncoder(path, device="cpu")
        assert path in str(e.value) and "pytorch_model.bin" in str(e.value)
        with pytest.raises(RuntimeError, match="local CLIP checkpoint"):
            tclip.CLIPScorer(model_path=path, device="cpu")
    no_vocab = tmp_path / "no_vocab"
    shutil.copytree(checkouts["bin"], no_vocab)
    os.remove(no_vocab / "vocab.json")
    with pytest.raises(RuntimeError, match="local CLIP checkpoint") as e:
        tenc.FrozenCLIPTextEncoder(str(no_vocab), device="cpu")
    assert "it lacks vocab.json" in str(e.value)
    with pytest.raises(RuntimeError, match="CLIPScorer needs a local CLIP checkpoint"):
        tclip.CLIPScorer(model_path=str(no_vocab), device="cpu")


def test_clip_classes_refuse_the_host_without_cpu_opt_in(checkouts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.FrozenCLIPTextEncoder(checkouts["bin"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclip.CLIPScorer(model_path=checkouts["bin"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.CLIPModel(tc.CLIPConfig(tc.CLIPTextConfig(hidden_size=8, num_attention_heads=2)))


# ---------------------------------------------------------------------------
# the COCO entry point with --text_encoder clip
# ---------------------------------------------------------------------------

def _tiny_coco():
    """A tiny text-conditional latent model whose context width is the tiny
    text tower's."""
    unet = tldm.LDMUNetConfig(image_size=8, in_channels=4, out_channels=4, model_channels=32,
                              num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                              num_heads=4, use_spatial_transformer=True, context_dim=WIDTH,
                              legacy=False)
    vae = tvae.VAEConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                         in_channels=3, resolution=16, z_channels=4, double_z=True,
                         embed_dim=4, n_embed=None)
    return tld.LatentDiffusionConfig(unet=unet, vae=vae, timesteps=50, linear_start=0.00085,
                                     linear_end=0.0120, scale_factor=0.18215, cond="text")


@pytest.fixture
def jax_sample_ldm():
    spec = importlib.util.spec_from_file_location(
        "jax_sample_diffusion_ldm", os.path.join(ROOT, "scripts", "sample_diffusion_ldm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_coco_context_clip_matches_jax(checkouts, jax_sample_ldm, tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a red bus\nthe cat on the mat\n")
    args = types.SimpleNamespace(text_encoder="clip", clip_path=checkouts["safetensors"],
                                 prompts_file=str(prompts))
    pipe = tlatent.LDMPipeline(tlatent.task_config("coco", custom_steps=5), _tiny_coco(),
                               device="cpu")
    assert pipe.mc.unet.context_dim == WIDTH
    ctx, unc = sample_ldm.build_coco_context(args, pipe, 3)
    jctx, junc = jax_sample_ldm.build_coco_context(args, None, 3)
    assert tuple(ctx.shape) == (3, 77, WIDTH) and ctx.device.type == "cpu"
    _close(ctx.numpy(), jctx, "coco contexts")
    _close(unc.numpy(), junc, "coco unconditional rows")


def test_sample_ldm_coco_clip(checkouts, tmp_path, monkeypatch):
    """``--text_encoder clip --clip_path`` runs the COCO task end to end
    (TDAC, CALIB_W / CALIB_A, one reconstruction iteration, the int8
    export's plain versions); with the default path it raises, naming it."""
    monkeypatch.setitem(tlatent.MODEL_CONFIGS, "coco", _tiny_coco)
    flags = ["--task", "coco", "--custom_steps", "5", "--calib_num_samples", "2",
             "--batch_samples", "2", "--iters", "1", "--n_samples", "2", "--batch_size", "2",
             "--device", "cpu", "--skip_grid", "--serve", "int8"]
    out = sample_ldm.main(flags + ["--text_encoder", "clip", "--clip_path",
                                   checkouts["bin"], "--logdir", str(tmp_path / "run")])
    assert len(os.listdir(out["img_dir"])) == 2
    with pytest.raises(RuntimeError, match="local CLIP checkpoint at "
                       "'openai/clip-vit-large-patch14'"):
        sample_ldm.main(flags + ["--logdir", str(tmp_path / "default")])
