"""The port's range search (``eda_dm_tpu_torch/quant/search.py``) against
the JAX package's (``eda_dm_tpu/quant/search.py``), on the CPU.

Every function is run on the same seeded numpy inputs through both.  The
rule: the chosen (min, max) are equal; where a choice differs, JAX's score
of the port's choice is within 1e-6 relative of JAX's score of its own
choice.  Such a difference is a near tie decided another way: ``|·|**2.4``
and the mean's order round differently in the two packages, and XLA
folds some constant products of the jitted candidate grid into one
constant (a candidate then differs in its last bit).  Each comparison
prints how many choices differ.  The histogram and the one-side codes
are exact and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.quant import affine as jaff
from eda_dm_tpu.quant import search as js
from eda_dm_tpu_torch.quant import affine as taff
from eda_dm_tpu_torch.quant import search as ts


def _data(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 0.7 + 0.1
    if kind == "pos":
        x = np.abs(x)
    elif kind == "neg":
        x = -np.abs(x)
    elif kind == "skewed":                 # heavy-tailed, asymmetric, two-sided
        x = np.abs(rng.standard_normal(shape)) ** 3 - 0.3
    return x.astype(np.float32)


def _np(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v).reshape(-1)


def _assert_same_or_tie(got, want, score, what):
    """``got`` (the port's) and ``want`` (JAX's) (min, max) pairs; ``score``
    maps (mins, maxs) to JAX's score of each."""
    gmin, gmax = map(_np, got)
    wmin, wmax = map(_np, want)
    differ = (gmin != wmin) | (gmax != wmax)
    print(f"[{what}] {int(differ.sum())} of {differ.size} choices differ")
    if differ.any():
        sg, sw = (np.asarray(score(a, b)).reshape(-1) for a, b in ((gmin, gmax), (wmin, wmax)))
        assert np.all(np.abs(sg - sw)[differ] <= 1e-6 * np.abs(sw)[differ]), (sg, sw)


def _elem_score(x, levels):
    """JAX's L^2.4 score of windows on ``x`` (K,) or (C, K)."""
    x2 = jnp.asarray(x.reshape(-1 if x.ndim == 2 else 1, x.shape[-1]))
    return lambda lo, hi: js._score(x2, jnp.asarray(lo), jnp.asarray(hi), levels)


def _hist_score(x, levels, bins):
    centers, counts, _, _ = js._exact_histogram(jnp.asarray(x), bins)
    return lambda lo, hi: js._score_hist(centers, counts, jnp.asarray(lo),
                                         jnp.asarray(hi), levels)


@pytest.mark.parametrize("kind,code", [("pos", ts.ONE_SIDE_POS), ("neg", ts.ONE_SIDE_NEG),
                                       ("two", ts.ONE_SIDE_NO)])
def test_detect_one_side(kind, code):
    x = _data(kind, (40, 7))
    got = ts.detect_one_side(torch.from_numpy(x))
    assert got.dtype == torch.int32 and int(got) == code == int(js.detect_one_side(x))


@pytest.mark.parametrize("levels", [16, 256])
@pytest.mark.parametrize("shape", [(4096,), (16, 300)], ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("kind", ["two", "pos", "neg"])
def test_search_range_1d(kind, shape, levels):
    x = _data(kind, shape, seed=levels)
    side = int(js.detect_one_side(x))
    want = js.search_range_1d(jnp.asarray(x), levels, jnp.int32(side))
    got = ts.search_range_1d(torch.from_numpy(x), levels, side)
    assert got[0].shape == tuple(want[0].shape) and got[0].dtype == torch.float32
    _assert_same_or_tie(got, want, _elem_score(x, levels), f"1d {kind} {shape} L={levels}")


@pytest.mark.parametrize("levels,num", [(16, 40), (256, 10)])
@pytest.mark.parametrize("shape", [(8192,), (8, 600)], ids=["per_tensor", "per_channel"])
def test_search_range_2d(shape, levels, num):
    x = _data("skewed", shape, seed=2)
    want = js.search_range_2d(jnp.asarray(x), levels, num=num)
    got = ts.search_range_2d(torch.from_numpy(x), levels, num=num)
    assert got[0].shape == tuple(want[0].shape)
    _assert_same_or_tie(got, want, _elem_score(x, levels), f"2d {shape} L={levels}")


def test_search_range_2d_anchored_grid():
    """``x_min``/``x_max`` anchor the grid of a subsample."""
    x = _data("skewed", (2048,), seed=3)
    lo, hi = np.float32(-0.5), np.float32(9.0)
    want = js.search_range_2d(jnp.asarray(x), 16, num=20, x_min=jnp.float32(lo),
                              x_max=jnp.float32(hi))
    got = ts.search_range_2d(torch.from_numpy(x), 16, num=20, x_min=torch.tensor(lo),
                             x_max=torch.tensor(hi))
    _assert_same_or_tie(got, want, _elem_score(x, 16), "2d anchored")


@pytest.mark.parametrize("static_side", [None, ts.ONE_SIDE_POS, ts.ONE_SIDE_NO])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("kind", ["pos", "skewed"])
def test_search_range_dispatch(kind, symmetric, static_side):
    """1-D when symmetric or one-sided (``static_side`` first), else 2-D."""
    x = _data(kind, (3000,), seed=4)
    side = int(js.detect_one_side(x))
    want = js.search_range(jnp.asarray(x), 16, jnp.int32(side), symmetric, num=20,
                           static_side=static_side)
    got = ts.search_range(torch.from_numpy(x), 16, torch.tensor(side, dtype=torch.int32),
                          symmetric, num=20, static_side=static_side)
    _assert_same_or_tie(got, want, _elem_score(x, 16),
                        f"dispatch {kind} sym={symmetric} static={static_side}")


@pytest.mark.parametrize("chunk", [None, 1000], ids=["whole", "chunked"])
@pytest.mark.parametrize("bins", [64, 4096])
def test_exact_histogram(bins, chunk, monkeypatch):
    """Centers, counts and range equal; chunking against the shared edges
    gives the same counts."""
    x = _data("skewed", (4500,), seed=5)
    x[:7] = x.max()                        # elements equal to x_max land in the last bin
    if chunk:
        monkeypatch.setattr(js, "_HIST_CHUNK", chunk)
        monkeypatch.setattr(ts, "_HIST_CHUNK", chunk)
    want = js._exact_histogram(jnp.asarray(x), bins)
    got = ts._exact_histogram(torch.from_numpy(x), bins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1].sum()) == x.size


@pytest.mark.parametrize("levels", [16, 256])
@pytest.mark.parametrize("kind", ["two", "pos", "neg"])
def test_search_range_1d_hist(kind, levels):
    x = _data(kind, (6000,), seed=6)
    side = int(js.detect_one_side(x))
    want = js.search_range_1d_hist(jnp.asarray(x), levels, jnp.int32(side), bins=512)
    got = ts.search_range_1d_hist(torch.from_numpy(x), levels, side, bins=512)
    _assert_same_or_tie(got, want, _hist_score(x, levels, 512),
                        f"1d hist {kind} L={levels}")


@pytest.mark.parametrize("levels,num", [(16, 40), (256, 10)])
def test_search_range_2d_hist(levels, num):
    x = _data("skewed", (6000,), seed=7)
    want = js.search_range_2d_hist(jnp.asarray(x), levels, num=num, bins=512)
    got = ts.search_range_2d_hist(torch.from_numpy(x), levels, num=num, bins=512)
    _assert_same_or_tie(got, want, _hist_score(x, levels, 512), f"2d hist L={levels}")


@pytest.mark.parametrize("static_side", [None, ts.ONE_SIDE_NO])
@pytest.mark.parametrize("symmetric", [True, False])
def test_search_range_hist_dispatch(symmetric, static_side):
    x = _data("skewed", (5000,), seed=8)
    side = int(js.detect_one_side(x))
    want = js.search_range_hist(jnp.asarray(x), 16, jnp.int32(side), symmetric, num=20,
                                bins=256, static_side=static_side)
    got = ts.search_range_hist(torch.from_numpy(x), 16, side, symmetric, num=20, bins=256,
                               static_side=static_side)
    _assert_same_or_tie(got, want, _hist_score(x, 16, 256),
                        f"hist dispatch sym={symmetric} static={static_side}")


def test_histogram_search_is_per_tensor():
    with pytest.raises(ValueError, match="per-tensor"):
        ts.search_range_1d_hist(torch.zeros(2, 8), 16, ts.ONE_SIDE_NO)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_channelwise_view(axis):
    w = _data("two", (3, 4, 5, 6), seed=9)
    np.testing.assert_array_equal(ts.channelwise_view(torch.from_numpy(w), axis).numpy(),
                                  np.asarray(js.channelwise_view(jnp.asarray(w), axis)))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("channel_axis", [None, 0, 1, -1])
def test_weight_qparams(channel_axis, symmetric):
    """(Δ, zp) equal, or JAX's L^2.4 fake-quant error of the port's pair
    within 1e-6 relative of its own, channel by channel."""
    w = (_data("skewed", (6, 5, 3, 8), seed=10) * 0.2).astype(np.float32)
    want = js.weight_qparams(jnp.asarray(w), 16, symmetric, channel_axis)
    got = ts.weight_qparams(torch.from_numpy(w), 16, symmetric, channel_axis)
    assert tuple(got[0].shape) == tuple(want[0].shape) == tuple(got[1].shape)
    axes = tuple(a for a in range(w.ndim)
                 if channel_axis is None or a != channel_axis % w.ndim)
    shape = want[0].shape

    def score(d, z):
        fq = jaff.fake_quant_nograd(jnp.asarray(w), jnp.asarray(d).reshape(shape),
                                    jnp.asarray(z).reshape(shape), 16)
        return jnp.mean(jnp.abs(fq - w) ** js.SEARCH_P, axis=axes)
    _assert_same_or_tie(got, want, score,
                        f"weight_qparams axis={channel_axis} sym={symmetric}")


def test_fake_quant_nograd():
    x = _data("two", (50, 9), seed=11) * 3
    d, z = np.float32(0.037), np.float32(121.0)
    got = taff.fake_quant_nograd(torch.from_numpy(x), torch.tensor(d), torch.tensor(z), 256)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jaff.fake_quant_nograd(jnp.asarray(x), d, z, 256)))


@pytest.mark.parametrize("one_sided", [False, True])
def test_search_range_1d_in_channel_chunks(one_sided, monkeypatch):
    """The per-channel 1-D search scores its channels in chunks of at most
    ``SCORE_ELEMS`` elements (a full-width SD conv's scores would not fit
    the card otherwise): the chunked search returns the one-pass result,
    bit for bit, at chunks of 1, 3 and all 7 channels."""
    from eda_dm_tpu_torch.quant import search
    rng = np.random.default_rng(11)
    w = rng.standard_normal((7, 50)).astype(np.float32)
    if one_sided:
        w = np.abs(w)
    x = torch.from_numpy(w)
    side = search.detect_one_side(x)
    want = search.search_range_1d(x, 16, side)
    for rows in (1, 3, 7):
        monkeypatch.setattr(search, "SCORE_ELEMS", rows * 200 * 50)
        got = search.search_range_1d(x, 16, side)
        assert all(torch.equal(g, t) for g, t in zip(got, want)), rows
