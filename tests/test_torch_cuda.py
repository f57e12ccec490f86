"""The port's hand-written kernels against their plain versions on the card.

Marked ``cuda``: they skip on a machine without a card.  On the H100
machine (no JAX there, so without the JAX conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Shapes are the ragged ones the CIFAR path does not reach: M, N not
multiples of the 128 tile, Cin not a multiple of 32 (the byte-gather path
of K1), softmax rows that are not a power of two.  Integer accumulators
must be bit-equal; the f32 epilogues run the same operations in the same
order, so outputs must be equal too; softmax codes may flip by one where
Triton's exp/division round differently (≥ 99.9 % equal).  Last, the tiny
UNet in DEPLOY_INT8 on the card against the same model on the host, module
by module and as a whole.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _codes(g, shape, lo=-128, hi=127):
    return torch.randint(lo, hi + 1, shape, generator=g, device="cuda",
                         dtype=torch.int32).to(torch.int8)


CONV = [  # n, hw, cin, cout, k, stride, pads (None = SAME)
    (3, 7, 32, 40, 3, 1, None),
    (2, 9, 64, 64, 3, 2, ((0, 1), (0, 1))),
    (2, 8, 3, 32, 3, 1, None),
    (2, 6, 96, 130, 1, 1, ((0, 0), (0, 0))),
    (2, 5, 48, 16, 3, 1, None),
]


@pytest.mark.parametrize("case", CONV, ids=lambda c: "x".join(map(str, c[:6])))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_conv_kernel(gen, case, out_dtype):
    from eda_dm_tpu_torch.ops.int8_conv import (border_map, int8_conv,
                                                int8_conv_plain, same_pads)
    n, hw, cin, cout, k, s, pads = case
    pads = pads or same_pads(hw, hw, k, k, s, s)
    x = _codes(gen, (n, hw, hw, cin))
    w = _codes(gen, (cout, k, k, cin), -8, 7)
    isum = w.float().sum((1, 2, 3))
    border = border_map(w, hw, hw, (s, s), pads) if pads != ((0, 0), (0, 0)) else None
    args = (x, w, isum, torch.tensor(21.0, device="cuda"),
            torch.rand(cout, generator=gen, device="cuda") * 1e-2,
            torch.randn(cout, generator=gen, device="cuda"), (s, s), pads, border)
    out = int8_conv(*args, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, int8_conv_plain(*args, out_dtype))


@pytest.mark.parametrize("batch,m,n,k", [(3, 17, 130, 20), (1, 5, 48, 512),
                                         (2, 200, 64, 256)])
def test_int8_bmm_kernel(gen, batch, m, n, k):
    from eda_dm_tpu_torch.ops.int8_einsum import int8_bmm_nt, int8_bmm_nt_plain
    A, B = _codes(gen, (batch, m, k)), _codes(gen, (batch, n, k))
    kw = dict(row_add=torch.randn(batch, m, generator=gen, device="cuda"),
              col_add=torch.randn(batch, n, generator=gen, device="cuda"),
              k_add=torch.tensor(3.5, device="cuda"),
              scale=torch.rand(n, generator=gen, device="cuda"),
              bias=torch.randn(n, generator=gen, device="cuda"))
    out = int8_bmm_nt(A, B, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, int8_bmm_nt_plain(A, B, **kw))


@pytest.mark.parametrize("s", [16, 64, 77, 256, 300])
def test_softmax_codes_kernel(gen, s):
    from eda_dm_tpu_torch.ops.softmax_codes import (softmax_int8_codes,
                                                    softmax_int8_codes_plain)
    logits = 6.0 * torch.randn(333, s, generator=gen, device="cuda")
    d, z = torch.tensor(0.004, device="cuda"), torch.tensor(7.0, device="cuda")
    codes, c = softmax_int8_codes(logits, d, z, 256)
    diff = (codes.int() - softmax_int8_codes_plain(logits, d, z, 256).int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    assert float(c) == 128.0 - 7.0


TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)


def _tiny_int8_model(state):
    """The tiny UNet on the host, exported by ``export_serving_int8`` with an
    f32 carrier, and a seeded input.  Quant state ``uniform``: every act
    range [-3, 3], every weight Δ 0.02 with zp 8; ``minmax``: act ranges
    from the min/max one FP forward records, weights on their symmetric
    per-channel range with round-to-nearest alphas."""
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.nn.layers import ActQuantizer, QConv, QDense
    from eda_dm_tpu_torch.parity import tap
    from eda_dm_tpu_torch.quant import FP, QuantConfig
    from eda_dm_tpu_torch.quant.adaround import init_alpha
    from eda_dm_tpu_torch.quant.affine import calculate_qparams
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    qc = QuantConfig()
    model = DDPMUNet(DDPMConfig(**TINY), qc, device="cpu")
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    t = torch.full((2,), 50.0)
    with torch.no_grad():
        if state == "uniform":
            for m in model.modules():
                if isinstance(m, ActQuantizer):
                    m.delta, m.zero_point = calculate_qparams(
                        torch.tensor(-3.0), torch.tensor(3.0), m.spec.n_levels)
            for name, p in model.named_buffers():
                if name.endswith("_delta") and p.dim() == 1:
                    p.fill_(0.02)
                elif name.endswith("_zp"):
                    p.fill_(8.0)
        else:
            with tap(model, ActQuantizer) as rec:
                model(x, t, FP)
            for name, calls in rec.items():
                q, v = model.get_submodule(name), calls[0][0]
                q.delta, q.zero_point = calculate_qparams(
                    v.min(), v.max(), q.spec.n_levels, q.spec.always_zero)
            for m in model.modules():
                if isinstance(m, (QConv, QDense)):
                    for part, s, e in m._parts:
                        w = m.weight[:, s:e]
                        amax = w.abs().reshape(w.shape[0], -1).amax(1)
                        d, zp = calculate_qparams(-amax, amax, m.wq.n_levels)
                        setattr(m, f"{part}_delta", d)
                        setattr(m, f"{part}_zp", zp)
                        setattr(m, f"{part}_alpha", init_alpha(w, m._per_channel(d)))
    export_serving_int8(model, qc, torch.float32)
    return model, x, t


@pytest.mark.parametrize("state", ["uniform", "minmax"])
def test_tiny_model_on_the_card_matches_the_host(gen, state):
    """DEPLOY_INT8 through the kernels on the card against the plain
    versions on the host.

    Each module on the host's input (teacher forcing, ``parity.tap``): the
    int8 convs and denses give the host's output bit for bit; GroupNorm,
    the folded layers (cuDNN / cuBLAS) and the ops between modules differ
    by f32 association only (rtol = atol = 2e-5).  Run freely, the first
    act code that differs sits on a rounding tie: its quantizer's input is
    within that same bound of the host's.  The flip then spreads through
    GroupNorm and attention, so the whole output keeps the flip-aware
    median / max bounds.  The ``uniform`` state puts activations on ties
    by construction (every weight Δ is 0.02 and every act Δ is equal, so a
    residual sum of int8-layer outputs is a multiple of Δ/50 and every
    25th multiple is a .5 tie): there the median drift is 8.5e-4 on the
    card, well above the 2e-4 bound, and only the max bound is held."""
    from eda_dm_tpu_torch.nn.layers import ActQuantizer, GNorm, QConv, QDense
    from eda_dm_tpu_torch.ops.int8_einsum import tf32_off
    from eda_dm_tpu_torch.ops.serving_policy import int8_conv_serving
    from eda_dm_tpu_torch.parity import act_code_flips, tap
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    model, x, t = _tiny_int8_model(state)
    kinds = (QConv, QDense, GNorm)
    with torch.no_grad(), tf32_off():
        with tap(model, ActQuantizer) as host_q, tap(model, kinds) as host:
            ref = model(x, t, DEPLOY_INT8)
        model.to("cuda")
        with tap(model, ActQuantizer) as card_q:
            out = model(x.cuda(), t.cuda(), DEPLOY_INT8).cpu()
        with tap(model, kinds, replace=host) as forced:
            model(x.cuda(), t.cuda(), DEPLOY_INT8)
    mods = dict(model.named_modules())
    n_int8, worst_in, worst_out = 0, (0.0, ""), (0.0, "")
    for name, calls in forced.items():
        m = mods[name]
        int8 = not isinstance(m, GNorm) and int8_conv_serving(
            DEPLOY_INT8, m.wq, m.aq, m.disable_act_quant, getattr(m, "split", 0))
        for (x_card, o_card), (x_host, o_host) in zip(calls, host[name]):
            torch.testing.assert_close(x_card, x_host, rtol=2e-5, atol=2e-5,
                                       msg=f"input of {name}")
            worst_in = max(worst_in, (float((x_card - x_host).abs().max()), name))
            if int8:
                assert torch.equal(o_card, o_host), name
                n_int8 += 1
            else:
                torch.testing.assert_close(o_card, o_host, rtol=2e-5,
                                           atol=2e-5, msg=f"output of {name}")
                worst_out = max(worst_out,
                                (float((o_card - o_host).abs().max()), name))
    rows = act_code_flips(model, host_q, card_q)
    first = next((r for r in rows if r[2]), None)
    assert first is None or first[3] <= 2e-5, first
    d = (out - ref).abs()
    print(f"\n[{state}] on the host's inputs: {n_int8} int8 modules bit-equal;"
          f" worst other module output {worst_out}, worst input {worst_in}\n"
          f"[{state}] free run: {sum(r[2] for r in rows)} act codes of "
          f"{sum(r[1] for r in rows)} differ, the first in {first}; whole "
          f"model: median {float(d.median()):.3g} max {float(d.max()):.3g} "
          f"mean {float(d.mean()):.3g} share<2e-4 "
          f"{float((d < 2e-4).float().mean()):.4f}")
    assert torch.isfinite(out).all()
    assert float(d.max()) < 0.15
    if state == "minmax":
        assert float(d.median()) < 2e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    from eda_dm_tpu_torch.ops.int8_einsum import int8_bmm_nt
    A = _codes(gen, (2, 8, 6))                     # K % 4 != 0
    with pytest.raises(ValueError, match="K % 4"):
        int8_bmm_nt(A, A)
    with pytest.raises(ValueError, match="int8"):
        int8_bmm_nt(A.float(), A)
