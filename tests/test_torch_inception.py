"""The port's FID InceptionV3 (``eda_dm_tpu_torch/eval/inception.py``)
against the JAX package's ``eda_dm_tpu/eval/inception.py``.

* ``load_fid_inception_params`` on a pt_inception-layout state dict (the
  generator of ``tests/test_weights_loaders.py``, copied here): the port's
  tree bit-equal to JAX's, and congruent with the port's own network;
* the five outputs of ``FIDInceptionV3`` on that converted tree, at the
  least input the graph takes (75×75), in one JAX run: full float32 on
  both sides, so within rtol = 1e-4 and atol = 1e-5·max|JAX| (the
  summation order of the convolutions only);
* ``resize_like_jax`` against ``jax.image.resize`` (antialiased bilinear at
  32, 256 and 512 → 299; Keys cubic at 512 and 64 → 224), ``preprocess``
  and ``clip_preprocess`` likewise: within 1e-5 of images in [0, 1];
* ``StreamingStats`` against ``FeatureStats.from_features`` (float64
  sums: within 1e-10);
* the extractor on random weights is seeded, and refuses the host unless
  asked for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ddpm  # noqa: F401  (each xdist worker's share of the cores)
from eda_dm_tpu.eval import clip as jclip
from eda_dm_tpu.eval import inception as ji
from eda_dm_tpu.eval.metrics import FeatureStats
from eda_dm_tpu_torch.eval import clip as tclip
from eda_dm_tpu_torch.eval import inception as ti
from eda_dm_tpu_torch.models.bridge import load_jax_variables, to_jax_variables


def _torch_layout_state_dict(params, rng):
    """A pt_inception-layout state dict covering the flax tree:
    ``<prefix>.conv.weight`` (OIHW) and ``.bn.{weight,bias,running_mean,
    running_var,num_batches_tracked}`` per conv, ``fc.weight`` (out, in)
    and ``fc.bias``: every key a real pt_inception-2015-12-05 dict has for
    these modules, ``num_batches_tracked`` included (the loader ignores
    it)."""
    state = {}

    def walk(node, path):
        if "conv" in node and isinstance(node["conv"], dict):
            kern = node["conv"]["kernel"]          # HWIO
            kh, kw, ci, co = kern.shape
            pre = ".".join(path)
            fan_in = ci * kh * kw                  # keeps 20+ random layers finite
            state[f"{pre}.conv.weight"] = (
                rng.randn(co, ci, kh, kw) / np.sqrt(fan_in)).astype(np.float32)
            state[f"{pre}.bn.weight"] = rng.rand(co).astype(np.float32) + 0.5
            state[f"{pre}.bn.bias"] = (0.1 * rng.randn(co)).astype(np.float32)
            state[f"{pre}.bn.running_mean"] = (0.1 * rng.randn(co)).astype(np.float32)
            state[f"{pre}.bn.running_var"] = rng.rand(co).astype(np.float32) + 0.5
            state[f"{pre}.bn.num_batches_tracked"] = np.int64(1000)
        for k, v in node.items():
            if k != "conv" and isinstance(v, dict):
                walk(v, path + [k])

    walk({k: v for k, v in params.items() if k != "fc"}, [])
    fc = params["fc"]
    state["fc.weight"] = rng.randn(*fc["kernel"].shape[::-1]).astype(np.float32)
    state["fc.bias"] = rng.randn(fc["bias"].shape[0]).astype(np.float32)
    return state


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def weights():
    """The state dict (on the tree of the port's network), the JAX and the
    port conversions of it, and both networks' outputs at 75×75."""
    shape_tree = to_jax_variables(ti.FIDInceptionV3())["params"]
    state = _torch_layout_state_dict(shape_tree, np.random.RandomState(7))
    jparams = ji.load_fid_inception_params(state)
    tparams = ti.load_fid_inception_params(
        {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    x = (2.0 * np.random.default_rng(3).random((2, 75, 75, 3)) - 1.0).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jout = ji.FIDInceptionV3().apply({"params": jax.tree.map(jnp.asarray, jparams)},
                                         jnp.asarray(x))
    model = load_jax_variables(ti.FIDInceptionV3(), {"params": tparams})
    with torch.no_grad():
        tout = model(torch.from_numpy(x))
    return dict(shape_tree=shape_tree, jparams=jparams, tparams=tparams,
                jout={k: np.asarray(v) for k, v in jout.items()},
                tout={k: v.numpy() for k, v in tout.items()})


def test_load_fid_inception_params_matches_jax(weights):
    ft, fj, fs = (_flat(weights[k]) for k in ("tparams", "jparams", "shape_tree"))
    assert sorted(ft) == sorted(fj) == sorted(fs)
    for k in ft:
        assert ft[k].dtype == fj[k].dtype == np.float32, k
        assert ft[k].shape == fj[k].shape == fs[k].shape, k
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


@pytest.mark.parametrize("name,dim", [("pool3", 2048), ("logits", 1008), ("feat64", 64),
                                      ("feat192", 192), ("feat768", 768)])
def test_fid_inception_outputs_match_jax(weights, name, dim):
    ref, out = weights["jout"][name], weights["tout"][name]
    assert out.shape == ref.shape == (2, dim)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n_in,n_out,method", [(32, 299, "bilinear"), (256, 299, "bilinear"),
                                               (512, 299, "bilinear"), (512, 224, "cubic"),
                                               (64, 224, "cubic")])
def test_resize_like_jax(n_in, n_out, method):
    x = np.random.default_rng(n_in + n_out).random((2, n_in, n_in, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, n_out, n_out, 3), method))
    out = ti.resize_like_jax(torch.from_numpy(x), (n_out, n_out), method).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if n_in > n_out:
        # antialiased: not the plain two-tap interpolation torch does
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(n_out, n_out),
            mode="bilinear" if method == "bilinear" else "bicubic",
            align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(plain - ref).max() > 1e-3


@pytest.mark.parametrize("size", [32, 299])
def test_preprocess_matches_jax(size):
    x = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    ref = np.asarray(ji.preprocess(jnp.asarray(x)))
    out = ti.preprocess(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [64, 224])
def test_clip_preprocess_matches_jax(size):
    x = np.random.default_rng(size).random((2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jclip.clip_preprocess(jnp.asarray(x)))
    out = tclip.clip_preprocess(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 / 0.26130258)


def test_streaming_stats_matches_feature_stats():
    feats = np.random.default_rng(0).standard_normal((103, 16)).astype(np.float32)
    stats = ti.StreamingStats(16)
    for part in np.array_split(feats, 5):
        stats.update(part)
    got, want = stats.finalize(), FeatureStats.from_features(feats)
    assert stats.n == 103
    np.testing.assert_allclose(got.mu, want.mu, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sigma, want.sigma, rtol=0, atol=1e-10)


def test_extractor_random_init_is_seeded_and_needs_a_device():
    a = ti.InceptionExtractor(device="cpu", seed=1)
    b = ti.InceptionExtractor(device="cpu", seed=1)
    c = ti.InceptionExtractor(device="cpu", seed=2)
    wa, wb, wc = (e.model.Mixed_7c.branch_pool.conv.weight for e in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert a.random_init
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ti.InceptionExtractor()
