"""Rank functions of ``tests/test_torch_spatial.py`` (and of the card test
in ``tests/test_torch_cuda.py``): spatial parallelism on gloo ranks.  This
module imports no JAX: the ranks import it to find their function."""

import os

import torch

TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)
# a tiny LDM whose 2×2 level does not shard over 4 ranks (the rule gathers
# it; the 2× upsample shards 4×4 again), with resampling res blocks and
# spatial transformers at 4×4 and in the middle block
LDM_TINY = dict(image_size=8, in_channels=3, model_channels=32, out_channels=3,
                num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2, 2),
                num_head_channels=16, use_spatial_transformer=True, context_dim=16,
                resblock_updown=True)
# a tiny DDPM whose 2×2 level does not shard over 4 ranks: its stride-2
# conv gathers, its 2× upsample shards 4×4 again
DEEP = dict(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1, attn_resolutions=(8,),
            resolution=16)
VAE_TINY = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                in_channels=3, resolution=16, z_channels=4, double_z=True, embed_dim=4)


def ddim_2steps(model, x, generator, mode, device="cpu"):
    """Two DDIM steps at eta 1 of the tiny DDPM (noise from ``generator``)."""
    from eda_dm_tpu_torch.samplers.ddim import generalized_steps
    from eda_dm_tpu_torch.samplers.schedules import get_beta_schedule, skip_sequence
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=100)
    return generalized_steps(x, skip_sequence("uniform", 2, 100),
                             lambda a, b: model(a, b, mode), betas, eta=1.0,
                             generator=generator, device=device)


def tiny_models(tree, device="cpu"):
    """The tiny DDPM from a JAX tree (its int8 export beside it), the tiny
    LDM UNet and the tiny KL first stage, from seeds."""
    import copy
    from eda_dm_tpu_torch.models.bridge import from_jax_variables
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet, LDMUNetConfig
    from eda_dm_tpu_torch.models.vae import FirstStage, VAEConfig
    from eda_dm_tpu_torch.quant import QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    qc = QuantConfig(weight_bit=4, act_bit=8)
    ddpm = from_jax_variables(tree, DDPMConfig(**TINY), qc, device=device)
    int8 = export_serving_int8(copy.deepcopy(ddpm), qc, torch.float32)
    ldm = LDMUNet(LDMUNetConfig(**LDM_TINY), device=device, seed=3)
    vae = FirstStage(VAEConfig(**VAE_TINY), device=device, seed=4)
    return ddpm, int8, ldm, vae


def deep_ddpm():
    """The deep tiny DDPM, calibrated by the port (CALIB_W, CALIB_A), and
    its int8 export."""
    import copy
    from eda_dm_tpu_torch.calib.scale_init import (set_act_quantize_params,
                                                   set_weight_quantize_params)
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.quant import QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    qc = QuantConfig(weight_bit=4, act_bit=8)
    model = DDPMUNet(DDPMConfig(**DEEP), qc, device="cpu", seed=5)
    g = torch.Generator().manual_seed(21)
    cali = (torch.randn(4, 16, 16, 3, generator=g), torch.tensor([5.0, 40.0, 70.0, 95.0]))
    set_weight_quantize_params(model, cali, device="cpu")
    set_act_quantize_params(model, cali, batch_size=4, device="cpu")
    return model, export_serving_int8(copy.deepcopy(model), qc, torch.float32)


def inputs(device="cpu"):
    g = torch.Generator().manual_seed(20)
    return dict(ldm_x=torch.randn(2, 8, 8, 3, generator=g).to(device),
                ldm_t=torch.tensor([10.0, 700.0], device=device),
                ldm_ctx=torch.randn(2, 4, 16, generator=g).to(device),
                z=torch.randn(2, 8, 8, 4, generator=g).to(device),
                img=torch.randn(2, 16, 16, 3, generator=g).to(device))


def run_all(model_fn, ddpm, int8, ldm, vae, deep, x, t, inp):
    """Every case on one side (one process, or this rank's rows under
    ``sharded_height``); ``model_fn(f, x)`` applies the side's sharding;
    ``deep``: :func:`deep_ddpm`'s pair."""
    from eda_dm_tpu_torch.quant import DEPLOY_INT8, FP, WAQ
    out = {}
    with torch.no_grad():
        out["fp"] = model_fn(lambda a: ddpm(a, t, FP), x)
        out["waq"] = model_fn(lambda a: ddpm(a, t, WAQ), x)
        out["int8"] = model_fn(lambda a: int8(a, t, DEPLOY_INT8), x)
        env = {"EDM_FUSED_GN": "1", "EDM_FUSED_GN_NARROW": "1"}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            out["int8_fused_gn"] = model_fn(lambda a: int8(a, t, DEPLOY_INT8), x)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        out["ldm_fp"] = model_fn(lambda a: ldm(a, inp["ldm_t"], inp["ldm_ctx"], mode=FP),
                                 inp["ldm_x"])
        out["deep_fp"] = model_fn(lambda a: deep[0](a, t, FP), x)
        out["deep_int8"] = model_fn(lambda a: deep[1](a, t, DEPLOY_INT8), x)
        out["decode"] = model_fn(vae.decode, inp["z"])
        out["encode"] = model_fn(vae.encode, inp["img"])
        out["ddim"] = model_fn(
            lambda a: ddim_2steps(int8, a, torch.Generator().manual_seed(9), DEPLOY_INT8), x)
    return out


def sp_world(rank, world, dev, tree, deep, x, t):
    """Every case on this rank's rows of H (gloo, ``make_mesh2d(1, world)``),
    gathered; K6's plain-version calls counted; the DEPLOY_INT8 cases also
    in this process on all of H under ``spatial.rank_blocks`` (the norms'
    sums and the float convs in the ranks' blocks, at this rank's
    threads)."""
    import eda_dm_tpu_torch.nn.layers as layers
    from eda_dm_tpu_torch.parallel import comm, spatial, tp
    from eda_dm_tpu_torch.parallel.mesh import axis_group
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    mesh = tp.make_mesh2d(1, world)
    models = tiny_models(tree)
    k6_calls = []
    gn = layers.gn_swish_int8
    layers.gn_swish_int8 = lambda a, *r, **k: k6_calls.append(a.shape) or gn(a, *r, **k)

    def sharded(f, a):
        with spatial.sharded_height(axis_group(mesh, "tp")):
            return tp.gather_spatial(mesh, f(tp.shard_spatial(mesh, a)))
    comm.reset_stats()
    out = run_all(sharded, *models, deep, x, t, inputs())
    out["stats"] = dict(comm.stats)
    out["k6_inputs"] = k6_calls
    with torch.no_grad(), spatial.rank_blocks(world):
        out["control"] = {"int8": models[1](x, t, DEPLOY_INT8),
                          "deep_int8": deep[1](x, t, DEPLOY_INT8)}
    return out


def card_world(rank, world, dev):
    """The tiny DDPM (seeded, calibrated on the card) in DEPLOY_INT8, f32
    carrier: one process's forward, the same under
    ``spatial.rank_blocks`` (the norms' sums and the float convs in the
    ranks' blocks) and the forward on this rank's rows of H, gathered; the launches of
    one process and of the sharded forward."""
    import copy
    from eda_dm_tpu_torch.calib.scale_init import (set_act_quantize_params,
                                                   set_weight_quantize_params)
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parallel import spatial, tp
    from eda_dm_tpu_torch.parallel.mesh import axis_group
    from eda_dm_tpu_torch.quant import DEPLOY_INT8, QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    qc = QuantConfig(weight_bit=4, act_bit=8)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 16, 16, 3, generator=g).to(dev)
    t = torch.linspace(0.0, 90.0, 8, device=dev)
    model = DDPMUNet(DDPMConfig(**TINY), qc, device=dev, seed=0)
    set_weight_quantize_params(model, (x, t), device=dev)
    set_act_quantize_params(model, (x, t), batch_size=8, device=dev)
    serving = export_serving_int8(copy.deepcopy(model), qc, torch.float32)
    mesh = tp.make_mesh2d(1, world)
    with torch.no_grad():
        _build.launch_counts.clear()
        one = serving(x, t, DEPLOY_INT8)
        one_launches = dict(_build.launch_counts)
        with spatial.rank_blocks(world):
            control = serving(x, t, DEPLOY_INT8)
        _build.launch_counts.clear()
        with spatial.sharded_height(axis_group(mesh, "tp")):
            mine = serving(tp.shard_spatial(mesh, x), t, DEPLOY_INT8)
        launches = dict(_build.launch_counts)
    return dict(one=one, control=control, sp=tp.gather_spatial(mesh, mine),
                one_launches=one_launches, launches=launches)
