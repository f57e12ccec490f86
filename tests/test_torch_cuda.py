"""The port's hand-written kernels against their plain versions on the card.

Marked ``cuda``: they skip on a machine without a card.  On the H100
machine (no JAX there, so without the JAX conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Shapes are the ragged ones the CIFAR path does not reach: M, N not
multiples of the 128 tile, K1 at each load route (16-byte copies with K
steps that cross taps at Cin = 224, 8-byte at Cin = 24, the byte gather at
the conv_ins' Cin = 3 and 4, each at both tiles), stride 2, VALID over
padded codes, K not a
multiple of 4 (K2's tail, SD's 77 context tokens), softmax rows that are
not a power of two, query and key lengths that are not
multiples of K5's 32-row and 64-key tiles, K5 on each side of its plan's
cluster sizes, on its one-buffer route for wide heads (ImageNet's C = 384
and others up to 512) and past them on its sweep route (heads past its
resident 1024 columns included), GroupNorm groups of 3, 7, 21 and 40 channels, each
side of K6's plan's cluster sizes, the gate's widest slice and spans past
one warp's and one block's vectors (K6), and fake-quant matmuls with
ragged M, N, K and strided weights (K7).  Integer accumulators
must be bit-equal; the f32 epilogues run the same operations in the same
order, so outputs must be equal too; softmax codes may flip by one where
a kernel's float64 row sum rounds to another float32 than the plain
version's (≥ 99.9 % equal); K6's codes likewise (its statistics are
float64 sums too); K7 within 1e-5·(|xq|·|w| + |bias|) of a float64
product, plus one bf16 step on a bf16 output; K8 (int8 quantized
matmul) accumulators and outputs bit-equal at ragged M, N, K; P1's int8
chain bit-equal after 40 steps and its bf16 chain within the probe's
stated tolerance.  Last, the tiny DDPM, LDM
and SD UNets in DEPLOY_INT8 on the card against the same model on the
host, module by module and as a whole, and the tiny DDPM so again with
the fused GroupNorm and in DEPLOY_FUSED.  Then the scoring path: the FID
InceptionV3 on the card against the host, and full-width reference-layout
checkpoints (CIFAR, church) loaded on the card bit-equal.  Last, two gloo
ranks sharing the card (``parallel/launch.py``): the tiny DDPM's
``dp_calibrate_acts`` bit-equal to one process's act calibration on its
quantizer inputs (free-running under the free-running calibrations'
gate), and its
tp = 2 DEPLOY_INT8 forward bit-equal to the unsharded one.  Spatial
parallelism: K1 on each rank's rows, halo and pads at every conv
geometry of the models (bit-equal to the plain version, the shards
concatenated bit-equal to the unsharded output), and the tiny DDPM's
DEPLOY_INT8 forward with its height over two gloo ranks sharing the card
against one process.
"""

import numpy as np
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


VALID = ((0, 0), (0, 0))
CONV = [  # n, hw, cin, cout, k, stride, pads (None = SAME)
    (3, 7, 32, 40, 3, 1, None),
    (2, 9, 64, 64, 3, 2, ((0, 1), (0, 1))),
    (2, 8, 3, 32, 3, 1, None),
    (2, 6, 96, 130, 1, 1, VALID),
    (2, 5, 48, 16, 3, 1, None),
    (2, 9, 224, 224, 3, 1, None),            # 16-byte copies, K steps across taps
    (2, 7, 24, 40, 3, 1, None),              # the 8-byte route
    (2, 10, 4, 320, 3, 1, None),             # SD's conv_in: the byte gather
    (3, 11, 64, 96, 3, 2, ((1, 1), (1, 1))), # stride 2, symmetric pads
    (2, 10, 32, 48, 3, 1, VALID),            # VALID over padded codes (K6's route)
    (1, 5, 16, 24, 3, 1, None),              # M and Cout under one tile
]


def _conv_args(gen, case):
    from eda_dm_tpu_torch.ops.int8_conv import border_map, same_pads
    n, hw, cin, cout, k, s, pads = case
    pads = pads or same_pads(hw, hw, k, k, s, s)
    x = _codes(gen, (n, hw, hw, cin))
    w = _codes(gen, (cout, k, k, cin), -8, 7)
    isum = w.float().sum((1, 2, 3))
    border = border_map(w, hw, hw, (s, s), pads) if pads != VALID else None
    return (x, w, isum, torch.tensor(21.0, device="cuda"),
            torch.rand(cout, generator=gen, device="cuda") * 1e-2,
            torch.randn(cout, generator=gen, device="cuda"), (s, s), pads, border)


@pytest.mark.parametrize("case", CONV, ids=lambda c: "x".join(map(str, c[:6])))
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_conv_kernel(gen, case, out_dtype):
    from eda_dm_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain
    args = _conv_args(gen, case)
    out = int8_conv(*args, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, int8_conv_plain(*args, out_dtype))


@pytest.mark.parametrize("tile", [0, 1], ids=["128x128", "128x64"])
@pytest.mark.parametrize("case,route", [
    ((2, 9, 224, 200, 3, 1, None), 16), ((2, 7, 24, 40, 3, 1, None), 8),
    ((2, 10, 4, 70, 3, 1, None), 1)], ids=["16-byte", "8-byte", "gather"])
def test_int8_conv_routes(gen, case, route, tile):
    """Each load route of K1 at each tile, equal to the plain version: the
    int32 sums through a unit epilogue, and the bf16 output."""
    from eda_dm_tpu_torch.ops.int8_conv import (_int8_conv_cuda, conv_plan,
                                                int8_conv_acc_plain, int8_conv_plain)
    x, w, isum, c, scale, bias, stride, pads, border = _conv_args(gen, case)
    cout = w.shape[0]
    assert conv_plan(x.shape[-1], cout, x.data_ptr(), w.data_ptr())[1] == route
    acc = _int8_conv_cuda(x, w, isum, torch.zeros((), device="cuda"),
                          torch.ones(cout, device="cuda"), None, stride, pads, border,
                          torch.float32, tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(acc.to(torch.int32), int8_conv_acc_plain(x, w, stride, pads))
    args = (x, w, isum, c, scale, bias, stride, pads, border)
    assert torch.equal(_int8_conv_cuda(*args, torch.bfloat16, tile=tile),
                       int8_conv_plain(*args, torch.bfloat16))


BMM = [  # batch, m, n, k: each tile (128 x 128; 64 x 64 where N <= 80)
    # with each load route (16-byte: K % 16 == 0; 8-byte: K % 8 == 0; the
    # byte gather: SD's 77 context tokens, K % 4 != 0), M or N under 16 and
    # under 64, ragged M and N, K of one 32-byte slice and of many steps
    (3, 17, 130, 20), (1, 5, 48, 512), (2, 200, 64, 256), (16, 300, 40, 77),
    (5, 64, 77, 40), (3, 9, 10, 6), (2, 200, 300, 256), (2, 130, 260, 40),
    (2, 129, 150, 77), (4, 256, 256, 32), (3, 100, 90, 16), (1, 70, 500, 160),
    (2, 300, 97, 80), (2, 5, 300, 48), (1, 1000, 700, 320)]


@pytest.mark.parametrize("batch,m,n,k", BMM)
def test_int8_bmm_kernel(gen, batch, m, n, k):
    """K2 at every tile and load route: the epilogue's float32 output (and
    so its int32 sums) equal to the plain version's."""
    from eda_dm_tpu_torch.ops.int8_einsum import int8_bmm_nt, int8_bmm_nt_plain
    A, B = _codes(gen, (batch, m, k)), _codes(gen, (batch, n, k))
    acc = int8_bmm_nt(A, B)
    torch.cuda.synchronize()
    assert torch.equal(acc, int8_bmm_nt_plain(A, B, scale=torch.ones((), device="cuda")))
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


def _softmax_gate(codes, plain, what):
    """K3's codes against the plain version's: within ±1, ≥ 99.9 % equal;
    prints the rows that differ (0 expected, apart from f64 row sums that
    straddle an f32 rounding boundary)."""
    diff = (codes.int() - plain.int()).abs()
    rows = int((diff != 0).reshape(-1, diff.shape[-1]).any(-1).sum())
    print(f"\n  K3 {what}: {rows} of {diff.numel() // diff.shape[-1]} rows differ")
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999


@pytest.mark.parametrize("s", [16, 64, 77, 256, 300])
def test_softmax_codes_kernel_bf16_logits(gen, s):
    """bf16 logits, upcast in the kernel as the JAX kernel upcasts them."""
    from eda_dm_tpu_torch.ops.softmax_codes import (softmax_int8_codes,
                                                    softmax_int8_codes_plain)
    logits = (6.0 * torch.randn(333, s, generator=gen, device="cuda")).to(torch.bfloat16)
    d, z = torch.tensor(0.004, device="cuda"), torch.tensor(7.0, device="cuda")
    codes, _ = softmax_int8_codes(logits, d, z, 256)
    torch.cuda.synchronize()
    _softmax_gate(codes, softmax_int8_codes_plain(logits, d, z, 256), f"bf16 (333, {s})")


@pytest.mark.parametrize("r,s", [(500 * 256, 256), (500 * 16, 16), (50 * 28 * 64, 64),
                                 (64 * 4096, 77)], ids=["cifar", "cifar16", "bedroom", "sd"])
def test_softmax_codes_kernel_smoke_shapes(gen, r, s):
    """K3 at ``chip_smoke.py``'s four shapes, with its quantizer."""
    from eda_dm_tpu_torch.ops.softmax_codes import (softmax_int8_codes,
                                                    softmax_int8_codes_plain)
    logits = 6.0 * torch.randn(r, s, generator=gen, device="cuda")
    d, z = torch.tensor(1.0 / 255.0, device="cuda"), torch.tensor(0.0, device="cuda")
    codes, _ = softmax_int8_codes(logits, d, z, 256)
    torch.cuda.synchronize()
    _softmax_gate(codes, softmax_int8_codes_plain(logits, d, z, 256), f"({r}, {s})")


@pytest.mark.parametrize("r,s", [(7, 1), (5, 33), (40, 1024), (3, 4096), (2, 5000),
                                 (2, 8193), (1, 32768)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off16"])
def test_softmax_codes_kernel_rows_of_any_width(gen, r, s, offset):
    """Rows of one element, rows a warp takes with several elements a
    lane, rows over several warps (1024, 4096 and 5000), past a block of
    256 threads (8193) and a block's widest; logits off a 16-byte boundary (a view one element in), so the
    tile's ragged head and tail go by scalar loads."""
    from eda_dm_tpu_torch.ops.softmax_codes import (softmax_int8_codes,
                                                    softmax_int8_codes_plain)
    buf = 4.0 * torch.randn(r * s + offset, generator=gen, device="cuda")
    logits = buf[offset:].view(r, s)
    d, z = torch.tensor(0.004, device="cuda"), torch.tensor(7.0, device="cuda")
    codes, _ = softmax_int8_codes(logits, d, z, 256)
    torch.cuda.synchronize()
    _softmax_gate(codes, softmax_int8_codes_plain(logits, d, z, 256), f"({r}, {s}) +{offset}")


@pytest.mark.parametrize("sigma", [1.0, 77.0, 4096.0, 8192.0 - 2.0 ** -11],
                         ids=["1", "77", "4096", "below_8192"])
@pytest.mark.parametrize("delta, zp, levels", [(1.0 / 255.0, 0.0, 256), (0.004, 7.0, 256),
                                               (2.0 ** -24, 0.0, 256), (0.0731, 3.0, 16)])
def test_softmax_fast_division_matches_ieee(gen, sigma, delta, zp, levels):
    """K3's e/Σ on its fast path equals ``__fdiv_rn`` at every float e in
    [2⁻⁸⁰, 1], and its code equals that of ``__fdiv_rn`` → ``__fdiv_rn`` →
    ``rintf`` at every float e in [0, 1]; Δ inside the fast range and
    below it (2⁻²⁴: both divisions by ``__fdiv_rn``)."""
    from eda_dm_tpu_torch.ops.softmax_codes import softmax_check_arith
    bad = softmax_check_arith(sigma, delta, zp, levels)
    torch.cuda.synchronize()
    assert bad == {"quotients": 0, "codes": 0}, bad


def _attention_case(g, n, s, c):
    from eda_dm_tpu_torch.ops.int8_attention import attention_scalars
    Q, K, V = (_codes(g, (n, s, c)) for _ in range(3))
    sc = attention_scalars(3.0, 0.021, -5.0, 0.017, 1.0, 0.025,
                           float(c) ** -0.5, 1.0 / 255.0, 0.0, "cuda")
    return Q, K, V, sc


@pytest.mark.parametrize("s", [8, 16, 72, 264, 1024, 1240])
@pytest.mark.parametrize("c", [8, 24, 32, 40, 80, 160, 256])
def test_int8_attention_kernel(gen, s, c):
    """K4 at ragged shapes, SD's head widths (80, 160) and CIFAR's 4×4
    site (S = 16): codes within ±1 and ≥ 99.9 % equal, the output within
    rtol = atol = 1e-5 on the rows whose codes agree; a shape outside the
    TPU kernel's gate is refused."""
    from eda_dm_tpu_torch.ops.int8_attention import (
        _int8_fused_attention_cuda, fused_attention_applicable,
        int8_fused_attention_plain)
    n = max(2, 4096 // s)
    Q, K, V, sc = _attention_case(gen, n, s, c)
    if not fused_attention_applicable(s, c, narrow_lanes=True):
        with pytest.raises(ValueError, match="gate"):
            _int8_fused_attention_cuda(Q, K, V, sc, 256, False)
        return
    out, codes = _int8_fused_attention_cuda(Q, K, V, sc, 256, True)
    torch.cuda.synchronize()
    ref, ref_codes = int8_fused_attention_plain(Q, K, V, sc, 256, True)
    diff = (codes.int() - ref_codes.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    rows = (diff == 0).all(-1)
    torch.testing.assert_close(out[rows], ref[rows], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s, c", [(1240, 8), (1048, 256), (8, 4096)])
def test_int8_attention_kernel_plan_corners(gen, s, c):
    """K4 at the gate's corners, where its plan changes: the longest rows
    (S = 1240 at C = 8, K tiles of two 256-key chunks), the most shared
    memory (S = 1048 at C = 256) and C in several 128-byte chunks (S = 8 at
    C = 4096: 24 of a block's 32 query rows past S, the Q tile streamed
    with K, W·V in 256-column chunks): codes within ±1 and ≥ 99.9 % equal,
    the output within 1e-5 on the rows whose codes agree."""
    from eda_dm_tpu_torch.ops.int8_attention import (
        _int8_fused_attention_cuda, fused_attention_applicable,
        int8_fused_attention_plain)
    assert fused_attention_applicable(s, c, narrow_lanes=True)
    Q, K, V, sc = _attention_case(gen, 3, s, c)
    out, codes = _int8_fused_attention_cuda(Q, K, V, sc, 256, True)
    torch.cuda.synchronize()
    ref, ref_codes = int8_fused_attention_plain(Q, K, V, sc, 256, True)
    diff = (codes.int() - ref_codes.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    rows = (diff == 0).all(-1)
    torch.testing.assert_close(out[rows], ref[rows], rtol=1e-5, atol=1e-5)


FLASH = [  # n, sq, skv, c: ragged tiles, Sq != Skv, wide heads, SD's 4096
    (3, 64, 64, 40), (4, 100, 77, 40), (2, 256, 512, 32), (5, 33, 300, 8),
    (2, 130, 4096, 40), (2, 64, 128, 160), (2, 40, 200, 384), (1, 1, 1, 4),
    (16, 4096, 4096, 40),                                    # SD at 2 rows
    # each side of the plan's cluster sizes at C = 40 (1 | 2 | 4 | 8 blocks)
    # and past them (the sweep route); a head too wide for the one pass
    (2, 40, 832, 40), (2, 40, 833, 40), (2, 40, 1665, 40), (2, 40, 3329, 40),
    (2, 40, 6656, 40), (2, 40, 6657, 40), (2, 40, 100, 516), (2, 8, 300, 1024),
    # heads wider than the sweep route's resident chunk of 1024 columns
    (1, 1024, 1024, 1088), (1, 256, 512, 1280), (1, 64, 128, 4096),
    # the one-pass-wide route (one W·V buffer): ragged query tiles, a ragged
    # last key slice, slices of 192 and 256 keys, the widest head
    (2, 40, 1024, 384), (2, 100, 1000, 384), (2, 33, 1280, 320), (2, 64, 2048, 256),
    (2, 64, 512, 512), (2, 130, 1024, 448)]


@pytest.mark.parametrize("case", FLASH, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("levels", [256, 16])
def test_int8_flash_attention_kernel(gen, case, levels):
    """K5 against its plain version, on the route its plan takes: codes
    within ±1 and ≥ 99.9 % equal, the output within rtol = atol = 1e-5 on
    the rows whose codes agree."""
    from eda_dm_tpu_torch.ops.int8_attention import (
        _int8_flash_attention_cuda, attention_scalars, int8_flash_attention_plain)
    n, sq, skv, c = case
    Q = _codes(gen, (n, sq, c))
    K, V = _codes(gen, (n, skv, c)), _codes(gen, (n, skv, c))
    dw = 1.0 / (levels - 1)
    sc = attention_scalars(3.0, 0.021, -5.0, 0.017, 1.0, 0.025,
                           float(c) ** -0.5, dw, 0.0, "cuda")
    out, codes = _int8_flash_attention_cuda(Q, K, V, sc, levels, True)
    torch.cuda.synchronize()
    ref, ref_codes = int8_flash_attention_plain(Q, K, V, sc, levels, True)
    diff = (codes.int() - ref_codes.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    rows = (diff == 0).all(-1)
    torch.testing.assert_close(out[rows], ref[rows], rtol=1e-5, atol=1e-5)


def test_int8_flash_attention_routes_count_their_launches(gen):
    """SD's 64×64 shape takes K5's one-pass route and ImageNet's 32×32 one
    (C = 384) its one-pass-wide route, both counted under
    ``int8_flash_attention``; a key length past what 8 blocks hold takes
    the sweep route, counted under ``int8_flash_sweep``."""
    from eda_dm_tpu_torch.ops._build import launch_counts
    from eda_dm_tpu_torch.ops.int8_attention import flash_plan, int8_flash_attention
    assert flash_plan(4096, 4096, 40)["route"] == "one_pass"
    assert flash_plan(1024, 1024, 384)["route"] == "one_pass_wide"
    assert flash_plan(40, 6657, 40)["route"] == "sweep"
    for (sq, skv, c), name in (((4096, 4096, 40), "int8_flash_attention"),
                               ((1024, 1024, 384), "int8_flash_attention"),
                               ((40, 6657, 40), "int8_flash_sweep")):
        Q, K, V = _codes(gen, (2, sq, c)), _codes(gen, (2, skv, c)), _codes(gen, (2, skv, c))
        launch_counts.clear()
        out = int8_flash_attention(Q, 3.0, 0.021, K, -5.0, 0.017, V, 1.0, 0.025,
                                   c ** -0.5, 1.0 / 255.0, 0.0, 256)
        torch.cuda.synchronize()
        assert dict(launch_counts) == {name: 1}
        assert out.shape == (2, sq, c) and bool(torch.isfinite(out).all())


def test_int8_flash_attention_kernel_past_the_grid_limit(gen):
    """More (b·h) elements than a grid's y/z dimension holds (65,535)."""
    from eda_dm_tpu_torch.ops.int8_attention import (
        _int8_flash_attention_cuda, int8_flash_attention_plain)
    Q, K, V, sc = _attention_case(gen, 70_000, 8, 8)
    out = _int8_flash_attention_cuda(Q, K, V, sc, 256, False)
    torch.cuda.synchronize()
    ref = int8_flash_attention_plain(Q, K, V, sc, 256)
    close = ((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all(-1)
    assert float(close.float().mean()) >= 0.999


def test_int8_attention_kernel_past_the_grid_limit(gen):
    """More (b·h) elements than a grid's y/z dimension holds (65,535)."""
    from eda_dm_tpu_torch.ops.int8_attention import (
        _int8_fused_attention_cuda, int8_fused_attention_plain)
    Q, K, V, sc = _attention_case(gen, 70_000, 8, 8)
    out = _int8_fused_attention_cuda(Q, K, V, sc, 256, False)
    torch.cuda.synchronize()
    ref = int8_fused_attention_plain(Q, K, V, sc, 256)
    close = ((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all(-1)
    assert float(close.float().mean()) >= 0.999



IMAGENET = {  # chip_smoke.py's phase-3 shapes of the ImageNet task at 100 UNet rows
    "k5_wide_32x32": (100, 1024, 1024, 384), "k4_16x16": (100, 256, 576),
    "k4_8x8": (100, 64, 960), "k2_cross_qk_n1": (100, 1024, 1, 384),
    "k2_cross_wv_k1": (100, 1024, 384, 1), "k3_rows_of_1": (100 * 1024, 1)}


@pytest.mark.parametrize("which", list(IMAGENET))
def test_imagenet_shapes(gen, which):
    """The ImageNet sites at 100 rows: K5 on its one-pass-wide route at the
    32×32 self-attention (C = 384; codes and outputs equal to the plain
    version's, bit for bit), K4 at the 16×16 (C = 576, its plan's 209,920
    bytes of shared memory) and 8×8 (C = 960, a column tail in W·V) ones:
    codes within ±1 and ≥ 99.9 % equal, the output within 1e-5 on the rows
    whose codes agree.  The cross-attention over the one class token: K2's
    q·kᵀ with N = 1 and W·V with K = 1, sums and epilogue bit-equal; K3 on
    rows of width 1, codes within ±1 and ≥ 99.9 % equal."""
    from eda_dm_tpu_torch.ops.int8_attention import (
        _int8_flash_attention_cuda, _int8_fused_attention_cuda, flash_plan,
        int8_flash_attention_plain, int8_fused_attention_plain)
    from eda_dm_tpu_torch.ops.int8_einsum import int8_bmm_nt, int8_bmm_nt_plain
    from eda_dm_tpu_torch.ops.softmax_codes import (softmax_int8_codes,
                                                    softmax_int8_codes_plain)
    shape = IMAGENET[which]
    if which.startswith(("k4", "k5")):
        n, sq = shape[:2]
        c = shape[-1]
        Q, K, V, sc = _attention_case(gen, n, sq, c)
        if which.startswith("k5"):
            assert flash_plan(sq, sq, c)["route"] == "one_pass_wide"
            out, codes = _int8_flash_attention_cuda(Q, K, V, sc, 256, True)
            torch.cuda.synchronize()
            ref, ref_codes = int8_flash_attention_plain(Q, K, V, sc, 256, True)
            assert torch.equal(codes, ref_codes) and torch.equal(out, ref)
        else:
            out, codes = _int8_fused_attention_cuda(Q, K, V, sc, 256, True)
            torch.cuda.synchronize()
            ref, ref_codes = int8_fused_attention_plain(Q, K, V, sc, 256, True)
        diff = (codes.int() - ref_codes.int()).abs()
        assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
        rows = (diff == 0).all(-1)
        torch.testing.assert_close(out[rows], ref[rows], rtol=1e-5, atol=1e-5)
    elif which.startswith("k2"):
        batch, m, n, k = shape
        A, B = _codes(gen, (batch, m, k)), _codes(gen, (batch, n, k))
        assert torch.equal(int8_bmm_nt(A, B),
                           int8_bmm_nt_plain(A, B, scale=torch.ones((), device="cuda")))
        kw = dict(row_add=torch.randn(batch, m, generator=gen, device="cuda"),
                  col_add=torch.randn(batch, n, generator=gen, device="cuda"),
                  k_add=torch.tensor(3.5, device="cuda"),
                  scale=torch.rand(n, generator=gen, device="cuda"))
        out = int8_bmm_nt(A, B, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, int8_bmm_nt_plain(A, B, **kw))
    else:
        logits = 6.0 * torch.randn(*shape, generator=gen, device="cuda")
        d, z = torch.tensor(1.0 / 255.0, device="cuda"), torch.tensor(0.0, device="cuda")
        codes, _ = softmax_int8_codes(logits, d, z, 256)
        torch.cuda.synchronize()
        _softmax_gate(codes, softmax_int8_codes_plain(logits, d, z, 256), f"{shape}")

SAME = ((1, 1), (1, 1))
GN = [  # b, h, w, c, pads (None: gn_norm), swish
    (3, 7, 9, 96, SAME, True),                    # 3 channels a group, odd h·w
    (2, 5, 6, 672, ((0, 1), (0, 1)), True),       # 21 channels: vectors across groups
    (2, 8, 8, 1280, ((0, 0), (0, 0)), False),
    (1, 32, 32, 416, SAME, True),                 # a 53 KB slice over 8 blocks
    (2, 32, 32, 384, SAME, True),                 # a 96 KB tile in bf16: 2 blocks
    (2, 16, 16, 128, None, True),
    (3, 4, 4, 64, None, False),
    # CIFAR's conv1 site at a reduced batch, each side of the plan's cluster
    # sizes 1 | 2 | 4 | 8 in bf16 (4 spans × b × R blocks reach 132)
    (40, 32, 32, 128, SAME, True), (33, 32, 32, 128, SAME, True),
    (32, 32, 32, 128, SAME, True), (17, 32, 32, 128, SAME, True),
    (16, 32, 32, 128, SAME, True), (9, 32, 32, 128, SAME, True),
    (8, 32, 32, 128, SAME, True),
    (1, 853, 16, 32, SAME, True),                 # the gate's widest slice: 13,648 a group
    (2, 16, 16, 224, SAME, True),                 # 7 channels a group
    (2, 16, 16, 672, ((0, 1), (0, 1)), False),    # 21
    (3, 16, 16, 1280, SAME, True),                # 40
    # SD's 1280 at 16×16 (32 one-group spans): each side of the plan's
    # cluster sizes 1 | 2 | 4 | 8, SD's 8 rows
    (8, 16, 16, 1280, None, True), (5, 16, 16, 1280, ((0, 1), (0, 1)), True),
    (4, 16, 16, 1280, None, False), (3, 16, 16, 1280, ((0, 0), (0, 0)), False),
    (2, 16, 16, 1280, SAME, True), (1, 16, 16, 1280, None, False),
    (1, 16, 16, 320, SAME, True),                 # batch 1
    (1, 2, 4, 16384, SAME, True),                 # 64 vectors a span: no shuffles
    (1, 2, 4, 54560, SAME, True),                 # 1,705 vectors: columns of 512 threads
]


@pytest.mark.parametrize("case", GN, ids=lambda c: "x".join(map(str, c[:4])))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gn_int8_kernel(gen, case, dtype):
    """K6 under ``gn_plan``'s plan against its plain version: the codes
    within ±1 and ≥ 99.9 % equal (equal expected), the rim the code of 0;
    ``gn_norm`` equal in bf16, within 1e-5 in f32."""
    from eda_dm_tpu_torch.ops.gn_int8 import NO_PADS, gn_norm, gn_plain, gn_swish_int8
    b, h, w, c, pads, act = case
    x = (2.1 * torch.randn(b, h, w, c, generator=gen, device="cuda") + 0.3).to(dtype)
    scale = 0.5 + torch.rand(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    if pads is None:
        out = gn_norm(x, scale, bias, swish=act)
        torch.cuda.synchronize()
        ref = gn_plain(x, scale, bias, None, None, 0, NO_PADS, act, 32, 1e-6)
        if dtype == torch.bfloat16:
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        return
    d, zp = torch.tensor(0.043, device="cuda"), torch.tensor(57.0, device="cuda")
    codes, cc = gn_swish_int8(x, scale, bias, d, zp, 256, pads, swish=act)
    torch.cuda.synchronize()
    diff = (codes.int() - gn_plain(x, scale, bias, d, zp, 256, pads, act, 32,
                                   1e-6).int()).abs()
    print(f"\n  K6 {case}: {int((diff != 0).sum())} of {diff.numel()} codes differ")
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999
    (pt, _), (pl, _) = pads
    rim = torch.ones(codes.shape[1:3], dtype=torch.bool, device="cuda")
    rim[pt:pt + h, pl:pl + w] = False
    assert (codes[:, rim] == int(-float(cc))).all()


@pytest.mark.parametrize("delta, zp, levels", [
    (0.043, 57.0, 256), (1.0 / 255.0, 0.0, 256), (0.5, 128.0, 256), (2.0 ** -20, 3.0, 256),
    (2.0 ** 11, 200.0, 256), (0.0731, 7.0, 16), (3.3e-3, 255.0, 256), (2.0 ** -24, 0.0, 256)])
def test_gn_int8_fast_arithmetic_matches_ieee(gen, delta, zp, levels):
    """K6's swish reciprocal equals ``__frcp_rn`` at every float in [1, ∞],
    and its codes equal those of ``__fdiv_rn`` → ``rintf`` →
    ``__float2int_rn`` at every y with |y| ≤ 2¹⁰·Δ (every 4,099th float
    beyond, ±∞, NaN; the clamp's reach), its fast quotients ``__fdiv_rn``'s
    bits; Δ on both sides of the fast path's range."""
    from eda_dm_tpu_torch.ops.gn_int8 import gn_check_arith
    bad = gn_check_arith(delta, zp, levels)
    torch.cuda.synchronize()
    assert bad == {"reciprocals": 0, "codes": 0, "quotients": 0}, bad


FQ = [  # m, k, n, split
    (37, 70, 45, 0), (130, 96, 64, 40), (1, 512, 256, 0), (200, 33, 7, 20)]


@pytest.mark.parametrize("case", FQ, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["out_in", "in_out"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_fakequant_matmul_kernel(gen, case, dtype, layout, with_bias):
    """K7 on the port's [out, in] weights (the transposed view) and on a
    contiguous (K, N) one, against a float64 product of the same
    fake-quantized operand."""
    from eda_dm_tpu_torch.ops.quant_matmul import fakequant_matmul
    m, k, n, split = case
    x = (1.7 * torch.randn(m, k, generator=gen, device="cuda") + 0.2).to(dtype)
    w = (0.05 * torch.randn(n, k, generator=gen, device="cuda")).to(dtype)
    w = w.t() if layout == "out_in" else w.t().contiguous()
    first = torch.arange(k, device="cuda") < (split or k)
    dk, zk = torch.where(first, 0.031, 0.017), torch.where(first, 121.0, 64.0)
    bias = 0.3 * torch.randn(n, generator=gen, device="cuda") if with_bias else None
    out = fakequant_matmul(x, w, dk, zk, 256, bias)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    _fq_gate(out, x, w, dk, zk, bias)


def _fq_gate(out, x, w, dk, zk, bias):
    """K7's output within 1e-5·(|xq|·|w| + |bias|) of the float64 product
    of the same fake-quantized operand, plus one bf16 step on a bf16
    output."""
    from eda_dm_tpu_torch.ops.quant_matmul import fq_error
    ok, e = fq_error(out, x, w, dk, zk, 256, bias)
    assert ok, e


@pytest.mark.parametrize("m,k,n,split", [(128000, 256, 256, 0), (128000, 512, 256, 256),
                                         (500, 512, 256, 0)], ids=["attn", "nin", "temb"])
@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("layout", ["out_in", "in_out"])
def test_fakequant_matmul_kernel_cifar_shapes(gen, m, k, n, split, bn, layout):
    """K7's tensor-core route at ``chip_smoke.py``'s three CIFAR shapes,
    bf16, under each of its column tiles (``fq_plan``'s and the others),
    in both weight layouts, held to the same gate."""
    from eda_dm_tpu_torch.ops.quant_matmul import _fakequant_matmul_cuda
    x = (1.7 * torch.randn(m, k, generator=gen, device="cuda") + 0.2).to(torch.bfloat16)
    w = (0.05 * torch.randn(n, k, generator=gen, device="cuda")).to(torch.bfloat16)
    w = w.t() if layout == "out_in" else w.t().contiguous()
    first = torch.arange(k, device="cuda") < (split or k)
    dk, zk = torch.where(first, 0.031, 0.017), torch.where(first, 121.0, 64.0)
    bias = 0.3 * torch.randn(n, generator=gen, device="cuda")
    out = _fakequant_matmul_cuda(x, w, dk, zk, 256, bias, bn=bn)
    torch.cuda.synchronize()
    _fq_gate(out, x, w, dk, zk, bias)


def test_fakequant_matmul_identity_is_the_fake_quant(gen):
    from eda_dm_tpu_torch.ops.quant_matmul import fakequant_matmul
    from eda_dm_tpu_torch.quant.affine import fake_quant
    x = 3.0 * torch.randn(300, 200, generator=gen, device="cuda")
    dk, zk = torch.full((200,), 0.031, device="cuda"), torch.full((200,), 121.0, device="cuda")
    out = fakequant_matmul(x, torch.eye(200, device="cuda"), dk, zk, 256)
    assert torch.equal(out, fake_quant(x, dk[0], zk[0], 256))


QM = [  # m, k, n: ragged M, N and K against the 128 x 128 x 64 tiles; the
    # resident stripe (K <= 512) and the streamed path (K > 512), each with
    # the 16-byte, 8-byte and byte-gather routes of the weights; M or N
    # under 16 and under 64
    (1000, 200, 72), (37, 130, 300), (16, 32, 64), (8, 128, 128), (5, 7, 3),
    (300, 64, 131), (300, 320, 260), (200, 40, 70), (129, 77, 130), (700, 512, 384),
    (300, 640, 200), (70, 1000, 90), (50, 2051, 33), (4096, 320, 2560)]


@pytest.mark.parametrize("case", QM, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantized_matmul_kernel(gen, case, dtype):
    """K8: int32 accumulators bit-equal to the plain version's; the
    epilogue runs the same float32 operations in the same order, so the
    output is equal too (bias and none)."""
    from eda_dm_tpu_torch.ops.quant_matmul import (
        pack_dense_weights, quantized_matmul, quantized_matmul_acc,
        quantized_matmul_acc_plain, quantized_matmul_plain)
    from eda_dm_tpu_torch.quant import calculate_qparams, weight_qparams
    m, k, n = case
    x = (1.3 * torch.randn(m, k, generator=gen, device="cuda") + 0.2).to(dtype)
    w = 0.1 * torch.randn(k, n, generator=gen, device="cuda")
    s_x, z_x = calculate_qparams(x.float().min(), x.float().max(), 256)
    d_w, z_w = weight_qparams(w, 256, symmetric=True, channel_axis=1)
    pk = pack_dense_weights(w, d_w, z_w)
    acc = quantized_matmul_acc(x, pk["w_q"], s_x, z_x)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32
    assert torch.equal(acc, quantized_matmul_acc_plain(x, pk["w_q"], s_x, z_x))
    bias = torch.randn(n, generator=gen, device="cuda")
    for b in (bias, None):
        args = (x, pk["w_q"], s_x, z_x, pk["s_w"], pk["w_colsum"], pk["w_deq_off"], b)
        out = quantized_matmul(*args)
        assert out.dtype == dtype and out.shape == (m, n)
        assert torch.equal(out, quantized_matmul_plain(*args))
    assert torch.equal(quantized_matmul(*args[:-1], w_qt=pk["w_qt"]), out)


@pytest.mark.parametrize("case", [(300, 320, 260), (300, 640, 200)],
                         ids=["resident", "streamed"])
def test_quantized_matmul_python_scalars(gen, case):
    """K8 with a bf16 x and Python-float s_x, z_x: the row term comes from
    JAX's bf16 outside pass (``jax_row_term``), passed to the kernel in
    place of its own; the output equals the plain version's."""
    from eda_dm_tpu_torch.ops.quant_matmul import (
        pack_dense_weights, quantized_matmul, quantized_matmul_plain)
    from eda_dm_tpu_torch.quant import weight_qparams
    m, k, n = case
    x = (1.9 * torch.randn(m, k, generator=gen, device="cuda") + 0.3).to(torch.bfloat16)
    w = 0.1 * torch.randn(k, n, generator=gen, device="cuda")
    pk = pack_dense_weights(w, *weight_qparams(w, 256, symmetric=True, channel_axis=1))
    args = (x, pk["w_q"], 0.0371, 117.0, pk["s_w"], pk["w_colsum"], pk["w_deq_off"])
    out = quantized_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, quantized_matmul_plain(*args))


@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("m,k", [(1024, 128), (512, 512), (300, 256), (77, 384), (65, 256),
                                 (65, 512)])
def test_mma_chain_kernel(gen, m, k, route):
    """P1 on each route: the int8 chain bit-equal to its plain version (40
    steps, ragged M included: 65 is one row past a warpgroup); the bf16
    chain within the probe's stated tolerance; one int8 step's int32 sums
    exact.  Each dtype meets the wgmma route's plan with B resident (K ≤
    256) and streamed through its ring (K = 384, 512)."""
    from eda_dm_tpu_torch.ops.int8_einsum import int8_matmul_acc_plain
    from eda_dm_tpu_torch.probes.mma_int8 import (
        BF16_REL_L2, BF16_REL_MAX, bf16_errors, chain_plan, mma_chain, mma_chain_plain, one_mm,
        probe_inputs)
    x = probe_inputs(m, k, gen)
    out = mma_chain(x["a8"], x["b8"], route=route)
    torch.cuda.synchronize()
    ref = mma_chain_plain(x["a8"], x["b8"])
    plans = {dt: chain_plan(k, dt) for dt in (torch.int8, torch.bfloat16)}
    print(f"[P1 {route} ({m}, {k})] int8 {int((out != ref).sum())} differ; plans "
          + "; ".join(f"{str(dt)[6:]} {'resident' if p['resident'] else 'streamed'} "
                      f"wgs {p['wgs']} passes {p['passes']}" for dt, p in plans.items()))
    assert torch.equal(out, ref)
    assert torch.equal(one_mm(x["a8"], x["b8"], route=route),
                       int8_matmul_acc_plain(x["a8"], x["b8"]))
    out16 = mma_chain(x["a16"], x["b16"], route=route)
    rel_l2, rel_max = bf16_errors(out16, mma_chain_plain(x["a16"], x["b16"]))
    print(f"[P1 {route} bf16 ({m}, {k})] rel L2 {rel_l2:.3g}, max {rel_max:.3g} of max|ref|")
    assert bool(torch.isfinite(out16.float()).all())
    assert rel_l2 <= BF16_REL_L2 and rel_max <= BF16_REL_MAX


TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)


def _set_quant_state(model, x, t, state, context=None):
    """Quant state ``uniform``: every act range [-3, 3], every weight Δ 0.02
    with zp 8; ``minmax``: act ranges from the min/max one FP forward
    records, weights on their symmetric per-channel range with
    round-to-nearest alphas."""
    from eda_dm_tpu_torch.nn.layers import ActQuantizer, QConv, QDense
    from eda_dm_tpu_torch.parity import tap
    from eda_dm_tpu_torch.quant import FP
    from eda_dm_tpu_torch.quant.adaround import init_alpha
    from eda_dm_tpu_torch.quant.affine import calculate_qparams
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
            return
        with tap(model, ActQuantizer) as rec:
            model(x, t, *(() if context is None else (context,)), mode=FP)
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


def _tiny_int8_model(state):
    """The tiny UNet on the host, exported by ``export_serving_int8`` with an
    f32 carrier, and a seeded input (quant states: ``_set_quant_state``)."""
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.quant import QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    qc = QuantConfig()
    model = DDPMUNet(DDPMConfig(**TINY), qc, device="cpu")
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    t = torch.full((2,), 50.0)
    _set_quant_state(model, x, t, state)
    export_serving_int8(model, qc, torch.float32)
    return model, x, t


def _card_against_host(model, x, t, tag, context=None, mode=None,
                       gn_code_flips=False):
    """``mode`` (DEPLOY_INT8 by default) of one model on the host (plain
    versions) and then on the card (kernels).  Each module on the host's
    input: the int8 convs and denses bit for bit, GroupNorm, the folded
    layers, the fused fake-quant matmuls and the ops between modules
    within rtol = atol = 2e-5; run freely, the first act code that differs
    sits on a tie.  ``gn_code_flips``: with the fused GroupNorm a code
    computed inside K6 may flip on a tie (the host's ``exp`` and sums are
    not the card's), so an int8 conv's output may then differ on ≤ 1 % of
    its elements, and the first act code to differ need not sit on a tie
    (no quantizer sees K6's codes).  Returns the whole-output |Δ|."""
    from eda_dm_tpu_torch.nn.layers import (ActQuantizer, GNorm, LayerNorm,
                                            QConv, QDense)
    from eda_dm_tpu_torch.ops.int8_einsum import tf32_off
    from eda_dm_tpu_torch.ops.serving_policy import int8_conv_serving
    from eda_dm_tpu_torch.parity import act_code_flips, tap
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    kinds = (QConv, QDense, GNorm, LayerNorm)
    mode = mode or DEPLOY_INT8
    inputs = (x, t) if context is None else (x, t, context)
    args = lambda dev: [a.to(dev) for a in inputs]
    with torch.no_grad(), tf32_off():
        with tap(model, ActQuantizer) as host_q, tap(model, kinds) as host:
            ref = model(*args("cpu"), mode=mode)
        model.to("cuda")
        with tap(model, ActQuantizer) as card_q:
            out = model(*args("cuda"), mode=mode).cpu()
        with tap(model, kinds, replace=host) as forced:
            model(*args("cuda"), mode=mode)
    mods = dict(model.named_modules())
    n_int8, worst_in, worst_out = 0, (0.0, ""), (0.0, "")
    for name, calls in forced.items():
        m = mods[name]
        int8 = isinstance(m, (QConv, QDense)) and int8_conv_serving(
            mode, m.wq, m.aq, m.disable_act_quant, getattr(m, "split", 0))
        for (x_card, o_card), (x_host, o_host) in zip(calls, host[name]):
            torch.testing.assert_close(x_card, x_host, rtol=2e-5, atol=2e-5,
                                       msg=f"input of {name}")
            worst_in = max(worst_in, (float((x_card - x_host).abs().max()), name))
            if not torch.is_tensor(o_host):     # a norm's params_only call
                continue
            if int8 and gn_code_flips:
                off = float((o_card != o_host).float().mean())
                assert off <= 1e-2, (name, off)
                n_int8 += off == 0
            elif int8:
                assert torch.equal(o_card, o_host), name
                n_int8 += 1
            else:
                torch.testing.assert_close(o_card, o_host, rtol=2e-5,
                                           atol=2e-5, msg=f"output of {name}")
                worst_out = max(worst_out,
                                (float((o_card - o_host).abs().max()), name))
    rows = act_code_flips(model, host_q, card_q)
    first = next((r for r in rows if r[2]), None)
    assert first is None or first[3] <= 2e-5 or gn_code_flips, first
    d = (out - ref).abs()
    print(f"\n[{tag}] on the host's inputs: {n_int8} int8 modules bit-equal;"
          f" worst other module output {worst_out}, worst input {worst_in}\n"
          f"[{tag}] free run: {sum(r[2] for r in rows)} act codes of "
          f"{sum(r[1] for r in rows)} differ, the first in {first}; whole "
          f"model: median {float(d.median()):.3g} max {float(d.max()):.3g} "
          f"mean {float(d.mean()):.3g} share<2e-4 "
          f"{float((d < 2e-4).float().mean()):.4f}")
    assert torch.isfinite(out).all()
    return d


@pytest.mark.parametrize("state", ["uniform", "minmax"])
def test_tiny_model_on_the_card_matches_the_host(gen, state):
    """DEPLOY_INT8 through the kernels on the card against the plain
    versions on the host, module by module (``_card_against_host``).  The
    flip then spreads through GroupNorm and attention, so the whole output
    keeps the flip-aware median / max bounds.  The ``uniform`` state puts
    activations on ties by construction (every weight Δ is 0.02 and every
    act Δ is equal, so a residual sum of int8-layer outputs is a multiple
    of Δ/50 and every 25th multiple is a .5 tie): there the median drift is
    8.5e-4 on the card, well above the 2e-4 bound, and only the max bound
    is held.  At batch 2 the attention runs K4 on the card."""
    model, x, t = _tiny_int8_model(state)
    d = _card_against_host(model, x, t, state)
    assert float(d.max()) < 0.15
    if state == "minmax":
        assert float(d.median()) < 2e-4


def test_tiny_ldm_on_the_card_matches_the_host(gen):
    """The tiny LDM UNet (attention at both levels, 8-channel heads, K4 on
    the card at batch 2) in DEPLOY_INT8, ``minmax`` state, module by module
    as above; the whole output median < 2e-4, max < 0.15."""
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet, LDMUNetConfig
    from eda_dm_tpu_torch.quant import QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    cfg = LDMUNetConfig(image_size=16, model_channels=32, channel_mult=(1, 2),
                        num_res_blocks=1, attention_resolutions=(1, 2),
                        num_head_channels=8)
    qc = QuantConfig()
    model = LDMUNet(cfg, qc, device="cpu")
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    # small t, as above: the card's and the host's sin/cos of t·freq differ
    # by more than 2e-5 at t = 600
    t = torch.tensor([50.0, 20.0])
    _set_quant_state(model, x, t, "minmax")
    export_serving_int8(model, qc, torch.float32)
    d = _card_against_host(model, x, t, "ldm")
    assert float(d.max()) < 0.15 and float(d.median()) < 2e-4


def test_tiny_sd_on_the_card_matches_the_host(gen, monkeypatch):
    """The tiny SD UNet (spatial transformer at 4×4 with 4 heads of 16,
    text context of 6 × 24, ``legacy=False``) in DEPLOY_INT8, ``minmax``
    state, 2 prompts under CFG (4 rows), module by module as above: K4
    serves the self-attention, K2 → K3 → K2 (K = 6, K2's tail) the
    cross-attention; and again with every self-attention site forced onto
    K5.  The whole output median < 2e-4, max < 0.15."""
    import eda_dm_tpu_torch.models.ldm_unet as ldm
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet, LDMUNetConfig
    from eda_dm_tpu_torch.ops._build import launch_counts
    from eda_dm_tpu_torch.quant import QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    cfg = LDMUNetConfig(image_size=8, in_channels=4, model_channels=32,
                        out_channels=4, num_res_blocks=1,
                        attention_resolutions=(2,), channel_mult=(1, 2),
                        num_heads=4, use_spatial_transformer=True,
                        transformer_depth=1, context_dim=24, legacy=False)
    qc = QuantConfig()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 4, generator=g).repeat(2, 1, 1, 1)
    ctx = torch.randn(4, 6, 24, generator=g)
    t = torch.tensor([50.0, 20.0, 50.0, 20.0])
    for impl in ("policy", "flash"):
        if impl == "flash":
            policy = ldm.attention_impl
            monkeypatch.setattr(ldm, "attention_impl", lambda b, h, sq, skv, c:
                                "flash" if sq == skv else policy(b, h, sq, skv, c))
        model = LDMUNet(cfg, qc, device="cpu")
        _set_quant_state(model, x, t, "minmax", context=ctx)
        export_serving_int8(model, qc, torch.float32)
        launch_counts.clear()
        d = _card_against_host(model, x, t, f"sd {impl}", context=ctx)
        assert launch_counts["int8_flash_attention" if impl == "flash"
                             else "int8_attention"] > 0, dict(launch_counts)
        assert launch_counts["softmax_codes"] > 0, dict(launch_counts)
        assert float(d.max()) < 0.15 and float(d.median()) < 2e-4


@pytest.mark.parametrize("path", ["fused_gn", "deploy_fused"])
def test_tiny_model_fused_paths_on_the_card_match_the_host(gen, path, monkeypatch):
    """The tiny DDPM (``minmax`` state) on the card against the host as
    above, in DEPLOY_INT8 with the fused GroupNorm (K6 at all 21 norm
    sites; ``EDM_FUSED_GN_NARROW=1`` for its 32- to 128-channel widths) and
    in DEPLOY_FUSED (K7 at all 31 1×1 convs and denses, nothing else).
    The whole output max < 0.15; with the fused GroupNorm median < 2e-4.
    In DEPLOY_FUSED the folded 3×3 convs sum in another order on the card
    (cuDNN) than on the host, a code flips on a tie and spreads (median
    2.05e-4 on the H100); as in ``tests/test_torch_ddpm.py``, the mean
    drift is then held to the host's own drift between two summation
    orders of the same function, DEPLOY_FUSED against DEPLOY_INT8."""
    from eda_dm_tpu_torch.ops._build import launch_counts
    from eda_dm_tpu_torch.quant import DEPLOY_FUSED
    model, x, t = _tiny_int8_model("minmax")
    launch_counts.clear()
    if path == "fused_gn":
        monkeypatch.setenv("EDM_FUSED_GN", "1")
        monkeypatch.setenv("EDM_FUSED_GN_NARROW", "1")
        d = _card_against_host(model, x, t, path, gn_code_flips=True)
        assert launch_counts["gn_int8"] == 2 * 21, dict(launch_counts)  # 2 card runs
        assert float(d.max()) < 0.15 and float(d.median()) < 2e-4
    else:
        from eda_dm_tpu_torch.quant import DEPLOY_INT8
        d = _card_against_host(model, x, t, path, mode=DEPLOY_FUSED)
        assert dict(launch_counts) == {"fakequant_matmul": 2 * 31}
        model.to("cpu")
        with torch.no_grad():
            own = (model(x, t, DEPLOY_FUSED) - model(x, t, DEPLOY_INT8)).abs().mean()
        print(f"[{path}] host DEPLOY_FUSED vs DEPLOY_INT8: mean {float(own):.3g}")
        assert float(d.max()) < 0.15 and float(d.mean()) <= float(own)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    """K2 takes any K now (K % 4 != 0 through the tail path, checked
    above); it refuses float operands.  K5 refuses a C that is not a
    multiple of 4 and K/V of different shapes.  K6 refuses a shape no
    plan fits."""
    from eda_dm_tpu_torch.ops.int8_attention import (
        _int8_flash_attention_cuda, attention_scalars)
    from eda_dm_tpu_torch.ops.int8_einsum import int8_bmm_nt
    A = _codes(gen, (2, 8, 6))
    with pytest.raises(ValueError, match="int8"):
        int8_bmm_nt(A.float(), A)
    sc = attention_scalars(0.0, 0.1, 0.0, 0.1, 0.0, 0.1, 1.0, 0.1, 0.0, "cuda")
    with pytest.raises(ValueError, match="multiple of 4"):
        _int8_flash_attention_cuda(A, A, A, sc, 256, False)
    Q = _codes(gen, (2, 8, 8))
    with pytest.raises(ValueError, match="Skv"):
        _int8_flash_attention_cuda(Q, Q, _codes(gen, (2, 9, 8)), sc, 256, False)
    from eda_dm_tpu_torch.ops.gn_int8 import gn_norm
    from eda_dm_tpu_torch.ops.quant_matmul import fakequant_matmul
    x = torch.zeros(1, 64, 64, 512, device="cuda")
    one = torch.ones(512, device="cuda")
    # a 4 MB span slice (65,536 pixels of one-channel groups): no cluster of
    # 8 blocks holds it, so no plan fits
    with pytest.raises(ValueError, match="no plan fits"):
        gn_norm(torch.zeros(1, 256, 256, 32, device="cuda"), one[:32], one[:32])
    with pytest.raises(ValueError, match="shape mismatch"):
        fakequant_matmul(x[0, 0], torch.ones(511, 4, device="cuda"), one, one)
    from eda_dm_tpu_torch.ops.quant_matmul import quantized_matmul
    from eda_dm_tpu_torch.probes.mma_int8 import mma_chain
    w8 = torch.zeros(511, 4, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="shape mismatch"):
        quantized_matmul(x[0, 0], w8, 0.1, 3.0, one[:4], one[:4], one[:4])
    with pytest.raises(ValueError, match="multiple of 128"):
        mma_chain(A[0], torch.zeros(6, 6, dtype=torch.int8, device="cuda"))


def test_inception_on_the_card_matches_the_host(gen):
    """The FID InceptionV3 (random weights from seed 0, float32, TF32 off)
    on the card against the same weights on the host, at 299² after
    ``preprocess``'s resize of 32×32 images: every output within 1e-4 of
    the largest |host| value plus 1e-3 relative (cuDNN and the host's
    convolutions sum in other orders)."""
    from eda_dm_tpu_torch.eval.inception import FIDInceptionV3, InceptionExtractor, preprocess
    from eda_dm_tpu_torch.ops.int8_einsum import tf32_off
    ext = InceptionExtractor(device="cuda")
    host = FIDInceptionV3()
    host.load_state_dict({k: v.cpu() for k, v in ext.model.state_dict().items()})
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), tf32_off():
        card, ref = ext.model(preprocess(x.cuda())), host(preprocess(x))
    for k in ("pool3", "logits", "feat64", "feat192", "feat768"):
        c, h = card[k].cpu().double(), ref[k].double()
        assert torch.isfinite(c).all(), k
        err = (c - h).abs()
        print(f"\n  {k}: max |card - host| {float(err.max()):.3g} of {float(h.abs().max()):.3g}")
        assert bool((err <= 1e-4 * h.abs().max() + 1e-3 * h.abs()).all()), k
    np.testing.assert_array_equal(ext(x.numpy())["pool3"], card["pool3"].cpu().numpy())


@pytest.mark.parametrize("family", ["cifar", "church"])
def test_full_width_checkpoint_loads_bit_equal(gen, tmp_path, family):
    """A full-width reference-layout checkpoint (``DDPMConfig()``;
    ``church_config()`` with its KL-f8 first stage, ``scale_factor`` and
    ``model_ema.`` shadows) written by ``reference_layout`` and loaded on
    the card through the pipeline: every weight bit-equal to its source;
    church's pipeline keeps the raw UNet weights and takes the scale
    factor, ``api.quantize_model`` the EMA ones."""
    from eda_dm_tpu_torch import api, reference_layout
    from eda_dm_tpu_torch.models.bridge import to_jax_variables
    from eda_dm_tpu_torch.quant import QuantConfig
    path = str(tmp_path / "model.ckpt")

    def equal(a, b):
        pb = dict(b.named_parameters())
        return all(torch.equal(p, pb[k]) for k, p in a.named_parameters())

    if family == "cifar":
        from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
        from eda_dm_tpu_torch.pipelines.cifar import CifarConfig, CifarPipeline
        src = DDPMUNet(DDPMConfig(), QuantConfig(), device="cuda", seed=7)
        torch.save(reference_layout.ddpm_state_dict(to_jax_variables(src)["params"]), path)
        assert equal(CifarPipeline(CifarConfig(ckpt_path=path), device="cuda").init_variables(),
                     src)
        return
    from eda_dm_tpu_torch.models.latent_diffusion import LatentDiffusion, church_config
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
    mc = church_config()
    ld = LatentDiffusion(mc, QuantConfig(), device="cuda", seed=7)
    ema = LDMUNet(mc.unet, QuantConfig(), device="cuda", seed=8)
    torch.save({"state_dict": reference_layout.latent_diffusion_state_dict(
        to_jax_variables(ld.unet)["params"], to_jax_variables(ld.first_stage)["params"],
        ema_unet=to_jax_variables(ema)["params"], scale_factor=0.8)}, path)
    pipe = LDMPipeline(task_config("church", ckpt_path=path), device="cuda")
    assert equal(pipe.ld.unet, ld.unet) and equal(pipe.ld.first_stage, ld.first_stage)
    assert pipe.mc.scale_factor == float(np.float32(0.8))
    assert equal(api.quantize_model("ldm", mc.unet, ckpt_path=path, device="cuda"), ema)


# --------------------------------------------------------------------------
# data and tensor parallelism: two gloo ranks sharing the card

def _tiny_parallel_ranks(rank, world, dev):
    """On each rank: the tiny DDPM's ``dp_calibrate_acts`` against one
    process's ``set_act_quantize_params``, each quantizer on this rank's
    rows of the single process's inputs (every act quantizer's state) and
    free-running; and its tp = 2 DEPLOY_INT8 forward (bf16 carrier,
    through K1–K3) against the unsharded one."""
    import copy
    from eda_dm_tpu_torch.calib.scale_init import (set_act_quantize_params,
                                                   set_weight_quantize_params)
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.nn.layers import ActQuantizer
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parallel import dp, mesh as pm, tp
    from eda_dm_tpu_torch.parity import tap
    from eda_dm_tpu_torch.quant import DEPLOY_INT8, QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DDPMConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                     resolution=16)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 16, 16, 3, generator=g).to(dev)
    t = torch.linspace(0.0, 90.0, 8, device=dev)
    base = DDPMUNet(cfg, QuantConfig(weight_bit=4, act_bit=8), device=dev, seed=0)
    set_weight_quantize_params(base, (x, t), device=dev)
    one = copy.deepcopy(base)
    with tap(one, ActQuantizer) as rec:
        set_act_quantize_params(one, (x, t), batch_size=4, device=dev)
    # each batch's call of each quantizer, on this rank's rows of it
    b = 4 // world
    forced = {n: [(a[rank * b:(rank + 1) * b], None) for a, _ in calls]
              for n, calls in rec.items()}
    same = copy.deepcopy(base)
    mesh = pm.make_mesh()
    with tap(same, ActQuantizer, replace=forced):
        dp.dp_calibrate_acts(same, (x, t), mesh, batch_size=4)
    free = dp.dp_calibrate_acts(copy.deepcopy(base), (x, t), mesh, batch_size=4)
    leaves = ("delta", "zero_point", "one_side", "running_min", "running_max")
    qs = lambda m: {n: q for n, q in m.named_modules() if isinstance(q, ActQuantizer)}
    differ = [n for n, q in qs(one).items()
              if not all(torch.equal(getattr(q, k), getattr(qs(same)[n], k)) for k in leaves)]
    rels = [float((q.delta - qs(free)[n].delta).abs() / q.delta.abs())
            for n, q in qs(one).items()]
    sides = all(torch.equal(q.one_side, qs(free)[n].one_side) for n, q in qs(one).items())
    serving = export_serving_int8(copy.deepcopy(one))
    sharded = tp.shard_params_tp(tp.make_mesh2d(1, world), copy.deepcopy(serving))
    with torch.no_grad():
        ref = serving(x.bfloat16(), t, DEPLOY_INT8)
        _build.launch_counts.clear()
        out = sharded(x.bfloat16(), t, DEPLOY_INT8)
    return dict(differ=differ, free_rels=rels, sides=sides, tp_equal=bool(torch.equal(out, ref)),
                launches=dict(_build.launch_counts), n_sharded=len(tp.tp_layers(sharded)))


@pytest.fixture(scope="module")
def two_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parallel.launch import spawn
    _build.build(["int8_conv", "int8_bmm", "softmax_codes", "int8_attention"])
    return spawn(_tiny_parallel_ranks, 2, "gloo", "cuda", timeout_s=300)


def test_dp_calibration_on_two_ranks_bit_equal(two_ranks):
    """On the single process's quantizer inputs, bit-equal; free-running
    (the card's convs may take another algorithm at 2 rows than at 4)
    under the gate of the free-running calibrations: ``one_side`` equal,
    every delta within rel 5 %, half within rel 1e-3."""
    for r in two_ranks:
        assert r["differ"] == [], r["differ"][:5]
        rels = r["free_rels"]
        assert r["sides"] and max(rels) <= 0.05
        assert sum(x <= 1e-3 for x in rels) >= 0.5 * len(rels)


def test_tp_int8_forward_on_two_ranks_bit_equal(two_ranks):
    for r in two_ranks:
        assert r["tp_equal"] and r["n_sharded"] == 50
        assert r["launches"].get("int8_conv", 0) > 0, r["launches"]


# --------------------------------------------------------------------------
# spatial parallelism: K1 on haloed shards, and two gloo ranks sharing the card

SHARD_GEOMETRIES = [((3, 3), (1, 1), "SAME"), ((3, 3), (2, 2), ((0, 1), (0, 1))),
                    ((3, 3), (2, 2), ((1, 1), (1, 1))), ((1, 1), (1, 1), "VALID")]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel,stride,padding", SHARD_GEOMETRIES, ids=str)
def test_int8_conv_on_shard_geometries(gen, kernel, stride, padding, n):
    from eda_dm_tpu_torch.nn.layers import QConv
    from eda_dm_tpu_torch.ops.int8_conv import border_map, int8_conv, int8_conv_plain
    from eda_dm_tpu_torch.parallel import spatial
    cin, cout, W = 40, 72, 24
    pads_fn = QConv(cin, cout, kernel, strides=stride, padding=padding).pads
    w = _codes(gen, (cout, *kernel, cin), -8, 7)
    isum = w.float().sum((1, 2, 3))
    c = torch.tensor(3.0, device="cuda")
    scale = torch.rand(cout, generator=gen, device="cuda") * 0.01
    bias = torch.randn(cout, generator=gen, device="cuda")
    border = lambda h, pads: (border_map(w, h, W, stride, pads)
                              if pads != ((0, 0), (0, 0)) else None)
    checked = 0
    for H in (8, 16, 24, 32, 64):
        x = _codes(gen, (3, H, W, cin))
        gp = pads_fn(H, W)
        full = int8_conv(x, w, isum, c, scale, bias, stride, gp, border(H, gp), torch.float32)
        plans = [spatial.halo_plan(kernel[0], stride[0], gp[0], H, r, n) for r in range(n)]
        if plans[0] is None:
            continue
        parts = []
        for r, p in enumerate(plans):
            rows = spatial.halo_rows(x, p, r, n).contiguous()
            pads = (p.pads, gp[1])
            args = (rows, w, isum, c, scale, bias, stride, pads, border(rows.shape[1], pads),
                    torch.float32)
            parts.append(int8_conv(*args))
            assert torch.equal(parts[-1], int8_conv_plain(*args)), (H, r)
        assert torch.equal(torch.cat(parts, 1), full), H
        checked += 1
    assert checked >= 3


@pytest.fixture(scope="module")
def sp_two_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import spatial_ranks
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parallel.launch import spawn
    _build.build(["int8_conv", "int8_bmm", "softmax_codes", "int8_attention"])
    return spawn(spatial_ranks.card_world, 2, "gloo", "cuda", timeout_s=300)


def test_sp_int8_forward_on_two_ranks(sp_two_ranks):
    """The tiny DDPM's DEPLOY_INT8 forward (f32 carrier) with its height
    over two ranks: bit-equal to one process that computes the norms' sums
    and the folded float convs in the ranks' blocks (``spatial.rank_blocks``:
    cuDNN and cuBLAS choose their sums by the number of rows), so the
    halos, pads and gathers are exact; against one process under the flip
    gate; K1 launched on each rank as often as in one process."""
    for r in sp_two_ranks:
        assert torch.equal(r["sp"], r["control"])
        d = (r["sp"] - r["one"]).abs()
        assert float(d.median()) < 2e-4 and float(d.max()) < 0.15, d.max()
        assert float((d < 2e-4).float().mean()) > 0.7
        assert r["launches"] == r["one_launches"] and r["launches"]["int8_conv"] > 0
