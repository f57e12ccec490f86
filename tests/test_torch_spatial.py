"""Spatial parallelism (``eda_dm_tpu_torch/parallel/spatial.py``,
``tp.shard_spatial``): the height of every activation split over gloo
ranks on the CPU, against one process and against the JAX package's
``shard_spatial``.

* ``QConv.border``'s cache is keyed by the pads: the shards of one layer
  take other pads at the same size.
* ``halo_plan`` on every conv geometry of the models (3×3 SAME, DDPM's
  stride-2 ``((0, 1), (0, 1))``, LDM's stride-2 ``((1, 1), (1, 1))``, the
  VAE encoder's stride 2 after its ``(0, 1)`` pre-pad, 1×1) at H = 4..64
  over 2, 4 and 8 shards: the shards' outputs of ``int8_conv_plain`` on
  integer codes, concatenated, equal the unsharded rows bit for bit;
  where the rule keeps the output whole, every rank computes the whole.
* One gloo spawn at world 4 (``launch.spawn``, one thread a rank) over the
  JAX test's tiny DDPM (``tests/test_tp_serving.py``: batch 8, JAX's
  CALIB_W → CALIB_A): FP within rtol = atol = 1e-5 of JAX's unsharded
  ``apply`` and of JAX's ``shard_spatial`` over ``make_mesh2d(1, 8)``; WAQ
  and DEPLOY_INT8 (the kernels' plain versions) within JAX's bound (max <
  0.15, mean < 0.01) and under the port's flip gate against its single
  process; DEPLOY_INT8 with the fused GroupNorm (``EDM_FUSED_GN=1``, K6's
  plain version on the gathered height); a tiny LDM UNet with resampling
  res blocks and spatial transformers, whose 2×2 level the rule keeps
  whole, in FP within 1e-5; a deeper tiny DDPM whose 2×2 level the rule
  keeps whole (its stride-2 conv gathers), in FP within 1e-5 and in
  DEPLOY_INT8 under the flip gate; both DEPLOY_INT8 forwards bit-equal to
  one process that computes the norms' sums and the float convs in the
  ranks' blocks (``spatial.rank_blocks``); a tiny KL first stage's decode
  and encode within 1e-5; two DDIM steps at eta 1 (each rank draws the global noise
  and keeps its rows) under the flip gate.

The rank functions live in ``tests/spatial_ranks.py`` (the ranks import
it; it imports no JAX).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_ddpm import _flip_gate        # also shares the cores among workers
import spatial_ranks as sr
from eda_dm_tpu_torch.models.vae import Conv as VAEConv
from eda_dm_tpu_torch.nn.layers import QConv
from eda_dm_tpu_torch.ops.int8_conv import border_map, int8_conv_plain
from eda_dm_tpu_torch.parallel import launch, spatial

WORLD = 4


# --------------------------------------------------------------------------
# QConv.border's cache key

def test_border_cache_keys_the_pads():
    conv = QConv(8, 4, (3, 3))
    g = torch.Generator().manual_seed(0)
    conv.w0_int = torch.randint(-8, 8, (4, 3, 3, 8), generator=g, dtype=torch.int8)
    maps = [conv.border(6, 6, pads) for pads in (((1, 0), (1, 1)), ((0, 1), (1, 1)))]
    for m, pads in zip(maps, (((1, 0), (1, 1)), ((0, 1), (1, 1)))):
        assert torch.equal(m, border_map(conv.w0_int, 6, 6, (1, 1), pads))
    assert not torch.equal(maps[0], maps[1])


# --------------------------------------------------------------------------
# halo_plan on every geometry

GEOMETRIES = {
    "3x3_same": QConv(3, 2, (3, 3)).pads,
    "ddpm_down": QConv(3, 2, (3, 3), strides=(2, 2), padding=((0, 1), (0, 1))).pads,
    "ldm_down": QConv(3, 2, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))).pads,
    "vae_down": VAEConv(3, 2, 3, stride=2)._pads,
    "1x1": QConv(3, 2, (1, 1), padding="VALID").pads,
}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_halo_plan_shards_equal_the_unsharded_rows(geometry, n):
    pads_fn = GEOMETRIES[geometry]
    k = 1 if geometry == "1x1" else 3
    s = 2 if "down" in geometry else 1
    g = torch.Generator().manual_seed(n)
    W, cin, cout = 5, 3, 2
    w = torch.randint(-8, 8, (cout, k, k, cin), generator=g, dtype=torch.int8)
    isum = w.float().sum((1, 2, 3))
    c, scale = torch.tensor(3.0), torch.rand(cout, generator=g) + 0.5
    bias = torch.randn(cout, generator=g)

    def conv(codes, pads):
        border = border_map(w, codes.shape[1], W, (s, s), pads)
        return int8_conv_plain(codes, w, isum, c, scale, bias, (s, s), pads, border,
                               torch.float32)
    whole_cases = 0
    for H in range(4, 65):
        x = torch.randint(-128, 128, (2, H, W, cin), generator=g, dtype=torch.int8)
        gp = pads_fn(H, W)
        full = conv(x, gp)
        Ho = full.shape[1]
        plans = [spatial.halo_plan(k, s, gp[0], H, r, n) for r in range(n)]
        if plans[0] is None:            # kept whole: every rank computes it all
            whole_cases += 1
            assert all(p is None for p in plans)
            assert H % n or Ho % n or Ho < n, (H, n)
            continue
        parts = [conv(spatial.halo_rows(x, p, r, n), (p.pads, gp[1]))
                 for r, p in enumerate(plans)]
        assert torch.equal(torch.cat(parts, 1), full), (geometry, H, n)
        assert all(p.above <= H // n and p.below <= H // n for p in plans)
    assert whole_cases > 0


# --------------------------------------------------------------------------
# the models at world 4

@pytest.fixture(scope="module")
def jax_side():
    """JAX's tiny DDPM (``tests/test_tp_serving.py``'s setup), its
    unsharded FP, WAQ and DEPLOY_INT8 outputs and its FP over
    ``shard_spatial`` on ``make_mesh2d(1, 8)``."""
    from eda_dm_tpu.models.ddpm_unet import DDPMConfig as JCfg, DDPMUNet as JUNet
    from eda_dm_tpu.parallel.tp import make_mesh2d, shard_spatial
    from eda_dm_tpu.quant import CALIB_A, CALIB_W, FP, WAQ, QuantConfig
    from eda_dm_tpu.quant.export import DEPLOY_INT8, export_serving_int8
    qc = QuantConfig(weight_bit=4, act_bit=8)
    model = JUNet(cfg=JCfg(**sr.TINY), qc=qc)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((8, 16, 16, 3)), jnp.float32)
    t = jnp.linspace(0.0, 90.0, 8)
    v = jax.jit(lambda k: model.init(k, x[:1], t[:1], FP))(jax.random.PRNGKey(0))
    for mode in (CALIB_W, CALIB_A):
        _, upd = jax.jit(lambda v: model.apply(v, x, t, mode, mutable=["quant"]))(v)
        v = {**v, "quant": upd["quant"]}
    apply = jax.jit(lambda v, a, mode: model.apply(v, a, t, mode), static_argnums=2)
    serving = export_serving_int8(v, qc, dtype=jnp.float32)
    return dict(tree=jax.tree.map(np.asarray, v), x=np.asarray(x), t=np.asarray(t),
                fp=np.asarray(apply(v, x, FP)),
                fp_8_shards=np.asarray(apply(v, shard_spatial(make_mesh2d(1, 8), x, dim=1), FP)),
                waq=np.asarray(apply(v, x, WAQ)),
                int8=np.asarray(apply(serving, x, DEPLOY_INT8)))


@pytest.fixture(scope="module")
def sides(jax_side):
    """(one process, rank 0's gathered outputs, every rank's results)."""
    x, t = torch.tensor(jax_side["x"]), torch.tensor(jax_side["t"])
    models, deep = sr.tiny_models(jax_side["tree"]), sr.deep_ddpm()
    single = sr.run_all(lambda f, a: f(a), *models, deep, x, t, sr.inputs())
    ranks = launch.spawn(sr.sp_world, WORLD, "gloo", "cpu", jax_side["tree"], deep, x, t,
                         threads=1, timeout_s=300)
    return single, ranks[0], ranks


def test_ranks_gather_the_same_outputs(sides):
    _, _, ranks = sides
    for r in ranks[1:]:
        for key in ("fp", "waq", "int8", "int8_fused_gn", "ldm_fp", "deep_fp", "deep_int8",
                    "decode", "encode", "ddim"):
            assert torch.equal(r[key], ranks[0][key]), key


def test_sp_fp_matches_jax(jax_side, sides):
    single, sp, _ = sides
    for ref in (jax_side["fp"], jax_side["fp_8_shards"]):
        np.testing.assert_allclose(sp["fp"].numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sp["fp"].numpy(), single["fp"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["waq", "int8"])
def test_sp_quantized_within_jax_bound(jax_side, sides, key):
    single, sp, _ = sides
    d = np.abs(sp[key].numpy() - jax_side[key])
    assert d.max() < 0.15 and d.mean() < 0.01, (d.max(), d.mean())
    _flip_gate(sp[key].numpy(), single[key].numpy(), 0.15)


def test_sp_fused_gn_gathers_for_k6(sides):
    single, sp, ranks = sides
    _flip_gate(sp["int8_fused_gn"].numpy(), single["int8_fused_gn"].numpy(), 0.15)
    # K6 ran on the gathered height (all 16 rows at the top level)
    heights = {s[1] for s in ranks[0]["k6_inputs"]}
    assert ranks[0]["k6_inputs"] and heights <= {16, 8}, heights


@pytest.mark.parametrize("key", ["ldm_fp", "deep_fp", "decode", "encode"])
def test_sp_ldm_and_first_stage_match_one_process(sides, key):
    single, sp, _ = sides
    np.testing.assert_allclose(sp[key].numpy(), single[key].numpy(), rtol=1e-5, atol=1e-5)


def test_sp_deep_ddpm_int8_kept_whole_matches_one_process(sides):
    """The 2×2 level kept whole: K1 (plain) on the gathered codes with the
    global pads, then on each rank's rows again after the upsample."""
    single, sp, _ = sides
    _flip_gate(sp["deep_int8"].numpy(), single["deep_int8"].numpy(), 0.15)


@pytest.mark.parametrize("key", ["int8", "deep_int8"])
def test_sp_int8_equals_the_rank_blocks_control(sides, key):
    """Only what a rank computes at its own number of rows (the norms'
    float sums, the float convs) separates a sharded DEPLOY_INT8 forward
    from one process: with that reproduced, the halo codes, the shards'
    pads and the gathers leave it bit-equal."""
    _, sp, ranks = sides
    for r in ranks:
        assert torch.equal(sp[key], r["control"][key])


def test_sp_ddim_eta1_matches_one_process(sides):
    single, sp, _ = sides
    _flip_gate(sp["ddim"].numpy(), single["ddim"].numpy(), 0.15)


def test_sp_counts_the_halo_exchanges(sides):
    stats = sides[2][0]["stats"]
    assert stats["halo_calls"] > 0 and stats["halo_bytes"] > 0
    assert stats["calls"] > stats["halo_calls"]      # the norms' sums and gathers
