"""The port's tiled int8 attention (K5's plain version) against the JAX
package on the CPU.

* ``int8_flash_attention_heads`` against the Pallas kernel
  (``int8_flash_attention_heads``, interpret mode) at the JAX package's
  own test shapes, the SD head width 40, ImageNet's 384 and a 16-level
  softmax quantizer, on seeded numpy inputs: within rtol = atol = 1e-4.  A larger difference
  is allowed on at most 0.1 % of the elements, and only on query rows
  where a softmax code differs from JAX's: the JAX kernel adds each row's
  normalizer in float32 with a running rescale, the port in float64 (so a
  probability on a rounding tie of its code may take the other code).
  JAX's codes are its two passes replayed with ``jnp``, tile by tile.
* K5's plain version equals K4's, bit for bit, where Sq = Skv, whatever
  the chunk of query rows.
* ``CrossAttentionL`` at 2048 tokens, where both packages serve the
  self-attention with the flash kernel: a JAX-calibrated block, exported
  for int8, within rtol = atol = 2e-5 module by module on JAX's input
  (the int8 denses bit for bit), the output within 1e-4 where no code
  flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.ops import int8_einsum as jein
from eda_dm_tpu.ops import pallas_attention as jpa
from eda_dm_tpu.ops import serving_policy as jpolicy
from eda_dm_tpu.quant import QuantConfig as JQC
from eda_dm_tpu.quant import export as jexport
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models.bridge import load_jax_variables
from eda_dm_tpu_torch.ops.int8_attention import (
    attention_scalars, int8_flash_attention_heads, int8_flash_attention_plain,
    int8_fused_attention_plain)
from eda_dm_tpu_torch.quant import DEPLOY_INT8, QuantConfig

from test_torch_ddpm import _against_jax_args, _np
from test_torch_sd import _calibrate

T = lambda a: torch.from_numpy(np.array(a))


def _codes_inputs(seed, b, sq, skv, h, c, n_levels_w):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, sq, h, c)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((b, skv, h, c)) * 0.4).astype(np.float32)
    v = (rng.standard_normal((b, skv, h, c)) * 0.6).astype(np.float32)
    p = {n: np.float32(x) for n, x in dict(
        dq=0.01, zq=120.0, dk=0.012, zk=130.0, dv=0.02, zv=128.0,
        dw=1.0 / (n_levels_w - 1), zw=0.0).items()}
    (Q, cq), (K, ck), (V, cv) = (
        jein.quantize_act_int8(jnp.asarray(x), p["d" + n], p["z" + n], 256)
        for x, n in ((q, "q"), (k, "k"), (v, "v")))
    return Q, cq, K, ck, V, cv, p


def _jax_flash_codes(Q, cq, dq, K, ck, dk, attn_scale, dw, zw, n_lv):
    """``_flash_kernel``'s two passes up to the codes, with jnp: the
    running max and rescaled f32 normalizer over key tiles of 512, then the
    final probabilities.  (B, H, Sq, Skv)."""
    c, skv = Q.shape[-1], K.shape[1]
    tk = min(skv, 512)
    lsc = jnp.asarray(dq, jnp.float32) * jnp.asarray(dk, jnp.float32) * attn_scale
    q = jnp.transpose(Q, (0, 2, 1, 3)).astype(jnp.float32)
    k = jnp.transpose(K, (0, 2, 1, 3)).astype(jnp.float32)
    sum_q = jnp.sum(q, -1, keepdims=True)
    lg = [(jnp.einsum("bhic,bhjc->bhij", q, k[:, :, j:j + tk]) + ck * sum_q
           + cq * jnp.sum(k[:, :, j:j + tk], -1)[:, :, None, :]
           + cq * ck * float(c)) * lsc for j in range(0, skv, tk)]
    m = jnp.full(sum_q.shape, -1e30, jnp.float32)
    l = jnp.zeros(sum_q.shape, jnp.float32)
    for t in lg:
        m2 = jnp.maximum(m, jnp.max(t, -1, keepdims=True))
        l = l * jnp.exp(m - m2) + jnp.sum(jnp.exp(t - m2), -1, keepdims=True)
        m = m2
    w = jnp.exp(jnp.concatenate(lg, -1) - m) / l
    cw = n_lv / 2 - zw
    return np.asarray(jnp.clip(jnp.round(w / dw), -zw, float(n_lv - 1) - zw) - cw)


@pytest.mark.parametrize("sq,skv,h,c,levels", [
    (256, 256, 2, 128, 256), (128, 256, 2, 32, 256), (512, 512, 1, 64, 256),
    (512, 512, 2, 40, 256), (128, 128, 1, 128, 16),
    (256, 256, 1, 384, 256)])    # ImageNet's head width (its 32×32 site: one head of 384)
def test_flash_attention_matches_the_pallas_kernel(sq, skv, h, c, levels):
    Q, cq, K, ck, V, cv, p = _codes_inputs(sq + c, 2, sq, skv, h, c, levels)
    scale = c ** -0.5
    ref = np.asarray(jpa.int8_flash_attention_heads(
        Q, cq, p["dq"], K, ck, p["dk"], V, cv, p["dv"], scale, p["dw"],
        p["zw"], levels, interpret=True))
    ref_codes = _jax_flash_codes(Q, cq, p["dq"], K, ck, p["dk"], scale,
                                 p["dw"], p["zw"], levels)
    out = int8_flash_attention_heads(
        T(Q), T(cq), T(p["dq"]), T(K), T(ck), T(p["dk"]), T(V), T(cv),
        T(p["dv"]), scale, T(p["dw"]), T(p["zw"]), levels).numpy()
    assert out.shape == ref.shape == (2, sq, h, c)
    # the port's codes, (B, H, Sq, Skv), from its own plain version
    sc = attention_scalars(T(cq), T(p["dq"]), T(ck), T(p["dk"]), T(cv),
                           T(p["dv"]), scale, T(p["dw"]), T(p["zw"]), "cpu")
    hb = lambda a: T(a).permute(0, 2, 1, 3).reshape(2 * h, -1, c)
    _, codes = int8_flash_attention_plain(hb(Q), hb(K), hb(V), sc, levels, True)
    codes = codes.reshape(2, h, sq, skv).numpy()
    flipped_rows = (codes != ref_codes).any(-1).transpose(0, 2, 1)   # (B, Sq, H)
    off = ~np.isclose(out, ref, rtol=1e-4, atol=1e-4)
    print(f"\n  {int((codes != ref_codes).sum())} codes differ from JAX's; "
          f"{int(off.sum())} of {off.size} outputs beyond 1e-4")
    assert np.abs(codes - ref_codes).max() <= 1
    assert off.mean() <= 1e-3
    assert not (off & ~flipped_rows[..., None]).any()


@pytest.mark.parametrize("rows", [1, 64, 100, 512])
def test_flash_plain_is_fused_plain(rows):
    rng = np.random.default_rng(rows)
    Q, K, V = (torch.from_numpy(rng.integers(-128, 128, (3, 256, 40)).astype(np.int8))
               for _ in range(3))
    sc = attention_scalars(3.0, 0.021, -5.0, 0.017, 1.0, 0.025, 40 ** -0.5,
                           1 / 255, 0.0, "cpu")
    out, codes = int8_fused_attention_plain(Q, K, V, sc, 256, True)
    out_f, codes_f = int8_flash_attention_plain(Q, K, V, sc, 256, True, rows=rows)
    assert torch.equal(codes, codes_f) and torch.equal(out, out_f)


def test_cross_attention_serves_2048_tokens_with_flash(monkeypatch):
    qc, jqc = QuantConfig(weight_bit=4, act_bit=8), JQC(weight_bit=4, act_bit=8)
    heads, dim_head, n = 2, 32, 2048
    jblk = jldm.CrossAttentionL(heads, dim_head, 64, jqc.wq, jqc.aq,
                                jqc.aq_softmax(always_zero=True))
    x = np.random.default_rng(6).standard_normal((1, n, 64)).astype(np.float32)
    tree = jexport.export_serving_int8(_calibrate(jblk, jnp.asarray(x), None),
                                       jqc, dtype=jnp.float32)
    blk = tldm.CrossAttentionL(64, 64, heads, dim_head, 64, qc.wq, qc.aq,
                               qc.aq_softmax(always_zero=True))
    load_jax_variables(blk, _np(tree))
    seen = {"jax": [], "port": []}
    for side, module in (("jax", jldm), ("port", tldm)):
        impl = module.attention_impl

        def spy(*site, _impl=impl, _side=side):
            seen[_side].append(_impl(*site))
            return seen[_side][-1]
        monkeypatch.setattr(module, "attention_impl", spy)
    ref, out, flips = _against_jax_args(jblk, tree, blk, (x, None),
                                        jexport.DEPLOY_INT8, DEPLOY_INT8,
                                        attn_code_flips=True, int8_exact=True,
                                        tag="n=2048")
    assert set(seen["jax"]) == set(seen["port"]) == {"flash"}
    assert jpolicy.attention_impl(1, heads, n, n, dim_head) == "flash"
    assert out.shape == ref.shape == (1, n, 64)
    if not flips:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
