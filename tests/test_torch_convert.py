"""The port's checkpoint converters (``eda_dm_tpu_torch/models/convert.py``,
``vae_state_dict_to_params``, ``class_embedder_state_dict_to_params``,
``bert_state_dict_to_params``) against the JAX package's, on state dicts in
the reference's layout.

Each family's JAX ``init`` tree (every leaf moved by 0.1·N(0, 1), so no
bias or norm parameter is trivial) goes through ``reference_layout`` to a
reference-layout state dict.  JAX's converter must give that tree back,
leaf for leaf and bit for bit, which shows the inverse right; the port's
converter must give a tree bit-equal to JAX's; and the port's model with
the converted tree must compute JAX's forward (full float32 on both
sides: rtol = atol = 1e-4, the summation order only; the class embedder
exactly).  Families: the DDPM ``Model``, the openaimodel UNet with the
legacy attention block (bedroom), the spatial transformer of SD
(``legacy=False``) and of ImageNet (a context), church's scale-shift,
resampling res blocks with a ``label_emb``, the VQ and KL first stages,
the class embedder and BERT.

Then the loaders: ``apply_ema_weights`` on squashed and contracted
``model_ema.`` names, ``get_ckpt_path``'s errors, and a checkpoint file
through ``CifarPipeline``, ``LDMPipeline`` (church's ``scale_factor``, the
ImageNet class embedder) and ``api.quantize_model``, each equal to its JAX
entry point's weights.  The two EMA behaviours are pinned: the API path
swaps the ``model_ema.`` shadows in, the pipeline path keeps the raw
weights, in both packages.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ddpm  # noqa: F401  (each xdist worker's share of the cores)
from eda_dm_tpu import api as japi
from eda_dm_tpu.models import convert as jconv
from eda_dm_tpu.models import encoders as jenc
from eda_dm_tpu.models import latent_diffusion as jld
from eda_dm_tpu.models import ldm_unet as jldm
from eda_dm_tpu.models import vae as jvae
from eda_dm_tpu.models.ddpm_unet import DDPMConfig as JDDPMConfig, DDPMUNet as JDDPMUNet
from eda_dm_tpu.pipelines import cifar as jcifar
from eda_dm_tpu.pipelines import latent as jlatent
from eda_dm_tpu.quant.config import FP as JFP, QuantConfig as JQC
from eda_dm_tpu_torch import api as tapi
from eda_dm_tpu_torch import reference_layout as rl
from eda_dm_tpu_torch.models import convert as tconv
from eda_dm_tpu_torch.models import encoders as tenc
from eda_dm_tpu_torch.models import latent_diffusion as tld
from eda_dm_tpu_torch.models import ldm_unet as tldm
from eda_dm_tpu_torch.models import vae as tvae
from eda_dm_tpu_torch.models.bridge import (first_stage_from_jax, load_jax_variables,
                                            to_jax_variables)
from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
from eda_dm_tpu_torch.pipelines import cifar as tcifar
from eda_dm_tpu_torch.pipelines import latent as tlatent
from eda_dm_tpu_torch.quant.config import FP, QuantConfig

DDPM_TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                 resolution=16)
BASE = dict(image_size=8, in_channels=4, out_channels=4, model_channels=32,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2))
UNET = {"bedroom": dict(BASE, num_head_channels=32),
        "sd": dict(BASE, num_heads=4, use_spatial_transformer=True, context_dim=24,
                   legacy=False),
        "imagenet": dict(BASE, num_heads=1, use_spatial_transformer=True,
                         context_dim=24),
        "church": dict(BASE, num_heads=2, use_scale_shift_norm=True,
                       resblock_updown=True, num_classes=5)}
VAE_BASE = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                attn_resolutions=(8,), in_channels=3, resolution=16)
VAE = {"vq": dict(VAE_BASE, z_channels=4, double_z=False, embed_dim=4, n_embed=16),
       "kl": dict(VAE_BASE, z_channels=4, double_z=True, embed_dim=4, n_embed=None)}
BERT = dict(n_embed=32, n_layer=2, vocab_size=50, max_seq_len=7, heads=2, dim_head=8)
FAMILIES = ["ddpm", "ldm_bedroom", "ldm_sd", "ldm_imagenet", "ldm_church", "vae_vq",
            "vae_kl", "class_embedder", "bert"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb), sorted(set(fa) ^ set(fb))[:8]
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32, k
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(
        np.shape(a))).astype(np.float32), params)


def _family(name):
    """(JAX variables with perturbed params, reference-layout state dict,
    JAX converter, port converter, JAX forward, port module factory,
    port forward)."""
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(5)
    if name == "ddpm":
        jm = JDDPMUNet(cfg=JDDPMConfig(**DDPM_TINY), qc=JQC())
        x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
        t = np.array([3.0, 71.0], np.float32)
        v = jm.init(key, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)), JFP)
        return dict(v=v, to_sd=rl.ddpm_state_dict, jconv=jconv.ddpm_state_dict_to_params,
                    tconv=tconv.ddpm_state_dict_to_params,
                    jfwd=lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(t), JFP),
                    tmod=lambda: DDPMUNet(DDPMConfig(**DDPM_TINY), QuantConfig(),
                                          device="cpu"),
                    tfwd=lambda m: m(torch.from_numpy(x), torch.from_numpy(t), FP))
    if name.startswith("ldm_"):
        cfg = UNET[name[4:]]
        jm = jldm.LDMUNet(cfg=jldm.LDMUNetConfig(**cfg), qc=JQC())
        x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        t = np.array([3.0, 71.0], np.float32)
        ctx = (rng.standard_normal((2, 3, 24)).astype(np.float32)
               if cfg.get("context_dim") else None)
        y = np.array([1, 4]) if cfg.get("num_classes") else None
        jkw = dict(context=None if ctx is None else jnp.asarray(ctx),
                   y=None if y is None else jnp.asarray(y))
        v = jm.init(key, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                    context=None if ctx is None else jnp.zeros((1, 1, 24)),
                    y=None if y is None else jnp.zeros((1,), jnp.int32), mode=JFP)
        tkw = lambda: dict(context=None if ctx is None else torch.from_numpy(ctx),
                           y=None if y is None else torch.from_numpy(y))
        return dict(v=v, to_sd=rl.ldm_unet_state_dict,
                    jconv=jconv.ldm_unet_state_dict_to_params,
                    tconv=tconv.ldm_unet_state_dict_to_params,
                    jfwd=lambda v: jm.apply(v, jnp.asarray(x), jnp.asarray(t), mode=JFP, **jkw),
                    tmod=lambda: tldm.LDMUNet(tldm.LDMUNetConfig(**cfg), QuantConfig(),
                                              device="cpu"),
                    tfwd=lambda m: m(torch.from_numpy(x), torch.from_numpy(t), mode=FP,
                                     **tkw()))
    if name.startswith("vae_"):
        kw = VAE[name[4:]]
        fs = jvae.FirstStage(cfg=jvae.VAEConfig(**kw))
        z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
        # the encoder too, as a reference checkpoint holds it
        v = fs.init(key, jnp.zeros((1, 16, 16, 3)), method=lambda m, im: (
            m.encode(im), m.decode(jnp.zeros((1, 8, 8, 4)))))
        return dict(v=v, to_sd=rl.vae_state_dict, jconv=jvae.vae_state_dict_to_params,
                    tconv=tvae.vae_state_dict_to_params,
                    jfwd=lambda v: fs.apply(v, jnp.asarray(z), method=fs.decode),
                    tmod=None,
                    tload=lambda tree: first_stage_from_jax(
                        {"params": tree}, tvae.VAEConfig(**kw), device="cpu"),
                    tfwd=lambda m: m.decode(torch.from_numpy(z)))
    if name == "class_embedder":
        ce = jenc.ClassEmbedder(embed_dim=24, n_classes=11)
        labels = np.array([0, 10, 3])
        v = ce.init(key, jnp.zeros((1,), jnp.int32))
        return dict(v=v, to_sd=rl.class_embedder_state_dict,
                    jconv=jenc.class_embedder_state_dict_to_params,
                    tconv=tenc.class_embedder_state_dict_to_params,
                    jfwd=lambda v: ce.apply(v, jnp.asarray(labels)),
                    tmod=lambda: tenc.ClassEmbedder(24, 11, device="cpu"),
                    tfwd=lambda m: m(labels))
    assert name == "bert"
    b = jenc.BERTEmbedder(**BERT)
    tokens = rng.integers(0, 50, (2, 7)).astype(np.int32)
    v = b.init(key, jnp.zeros((1, 7), jnp.int32))
    return dict(v=v, to_sd=rl.bert_state_dict, jconv=jenc.bert_state_dict_to_params,
                tconv=tenc.bert_state_dict_to_params,
                jfwd=lambda v: b.apply(v, jnp.asarray(tokens)),
                tmod=lambda: tenc.BERTEmbedder(device="cpu", **BERT),
                tfwd=lambda m: m(torch.from_numpy(tokens).long()))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    fam = _family(request.param)
    params = _perturb(fam["v"]["params"], 1)
    sd = fam["to_sd"](params)
    # entries of a reference checkpoint that the converters drop
    if request.param == "ddpm":
        sd["logvar"] = torch.zeros(1000)
    elif request.param.startswith("vae_"):
        sd["loss.logvar"] = torch.zeros(())
        sd["loss.discriminator.main.0.weight"] = torch.zeros(4, 3, 4, 4)
    fam.update(name=request.param, params=params, sd=sd)
    return fam


def test_reference_layout_inverts_the_jax_converter(family):
    """JAX's converter takes the reference-layout state dict back to the
    (perturbed) init tree, bit for bit."""
    _assert_trees_equal(family["jconv"](family["sd"]), _np(family["params"]))


def test_port_converter_is_bit_equal_to_jax(family):
    jtree = family["jconv"](family["sd"])
    _assert_trees_equal(family["tconv"](family["sd"]), jtree)
    # numpy arrays in place of tensors convert alike
    as_np = {k: v.numpy() for k, v in family["sd"].items()}
    _assert_trees_equal(family["tconv"](as_np), jtree)


def test_converted_forward_matches_jax(family):
    tree = family["tconv"](family["sd"])
    jv = {**family["v"], "params": jax.tree.map(jnp.asarray, family["jconv"](family["sd"]))}
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(family["jfwd"](jv))
    if family.get("tload"):
        model = family["tload"](tree)
    else:
        model = load_jax_variables(family["tmod"](), {"params": tree})
    with torch.no_grad():
        out = family["tfwd"](model).numpy()
    assert out.shape == ref.shape
    if family["name"] == "class_embedder":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# loaders
# --------------------------------------------------------------------------

def test_apply_ema_weights_matches_jax():
    """Squashed names, the contracted ``.model.`` fallback, keys outside
    ``model.`` and a checkpoint without shadows."""
    rng = np.random.default_rng(0)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    sd = {"model.diffusion_model.input_blocks.0.0.weight": r(4, 3, 3, 3),
          "model.diffusion_model.out.2.bias": r(3),
          "model.cond.model.proj.weight": r(2, 2),            # contracted name
          "model.diffusion_model.no_shadow.bias": r(2),
          "first_stage_model.decoder.conv_in.weight": r(2, 2, 3, 3),
          "model_ema.diffusion_modelinput_blocks00weight": r(4, 3, 3, 3),
          "model_ema.diffusion_modelout2bias": r(3),
          "model_ema.condprojweight": r(2, 2),
          "model_ema.decay": torch.tensor(0.9999),
          "model_ema.num_updates": torch.tensor(7, dtype=torch.int32)}
    tout, tn = tconv.apply_ema_weights(sd)
    jout, jn = jconv.apply_ema_weights(sd)
    assert tn == jn == 3
    assert list(tout) == list(jout)
    for k in tout:
        assert tout[k] is jout[k], k
    assert tout["model.cond.model.proj.weight"] is sd["model_ema.condprojweight"]
    plain = {k: v for k, v in sd.items() if not k.startswith("model_ema.")}
    (tp, tn), (jp, jn) = tconv.apply_ema_weights(plain), jconv.apply_ema_weights(plain)
    assert tn == jn == 0 and tp == jp == plain


def _error(fn):
    try:
        fn()
    except Exception as e:                     # noqa: BLE001 (compared below)
        return type(e), str(e)
    return None


def test_get_ckpt_path_errors_match_jax(tmp_path):
    root = str(tmp_path)
    cases = [("no_such_model", True), ("ema_cifar10", True), ("ema_lsun_church_outdoor", True)]
    for name, check in cases:
        t, j = _error(lambda: tconv.get_ckpt_path(name, root, check)), \
            _error(lambda: jconv.get_ckpt_path(name, root, check))
        assert t is not None and t == j, (name, t, j)
    path = tmp_path / jconv.DDPM_CKPT_NAMES["ema_cifar10"]
    path.parent.mkdir(parents=True)
    path.write_bytes(b"not the published file")
    t = _error(lambda: tconv.get_ckpt_path("ema_cifar10", root))
    assert t == _error(lambda: jconv.get_ckpt_path("ema_cifar10", root))
    assert t[0] is ValueError and "md5 mismatch" in t[1]
    assert tconv.get_ckpt_path("ema_cifar10", root, check=False) == \
        jconv.get_ckpt_path("ema_cifar10", root, check=False) == str(path)
    assert tconv.md5_hash(str(path)) == jconv.md5_hash(str(path))
    assert tconv.DDPM_CKPT_NAMES == jconv.DDPM_CKPT_NAMES
    assert tconv.DDPM_CKPT_MD5 == jconv.DDPM_CKPT_MD5


@pytest.fixture(scope="module")
def ddpm_ckpt(tmp_path_factory):
    """A DDPM checkpoint file of a tiny port model (seed 5), with a
    ``logvar`` entry, as a lightning ``state_dict`` wrapper."""
    src = DDPMUNet(DDPMConfig(**DDPM_TINY), QuantConfig(), device="cpu", seed=5)
    sd = rl.ddpm_state_dict(to_jax_variables(src)["params"])
    sd["logvar"] = torch.zeros(1000)
    path = str(tmp_path_factory.mktemp("ddpm") / "model.ckpt")
    torch.save({"state_dict": sd}, path)
    return path, to_jax_variables(src)["params"]


def test_ckpt_path_through_cifar_pipeline_and_api_matches_jax(ddpm_ckpt):
    path, src = ddpm_ckpt
    tiny = DDPMConfig(**DDPM_TINY)
    tcfg = tcifar.CifarConfig(arch=tiny, image_size=16, ckpt_path=path)
    tmodel = tcifar.CifarPipeline(tcfg, device="cpu").init_variables()
    jcfg = jcifar.CifarConfig(arch=JDDPMConfig(**DDPM_TINY), image_size=16, ckpt_path=path)
    jv = jcifar.CifarPipeline(jcfg).init_variables()
    _assert_trees_equal(to_jax_variables(tmodel)["params"], _np(jv["params"]))
    _assert_trees_equal(to_jax_variables(tmodel)["params"], src)
    tm = tapi.quantize_model("ddpm", tiny, ckpt_path=path, device="cpu")
    _, jv = japi.quantize_model("ddpm", JDDPMConfig(**DDPM_TINY), ckpt_path=path)
    _assert_trees_equal(to_jax_variables(tm)["params"], _np(jv["params"]))
    _assert_trees_equal(tconv.load_ddpm_checkpoint(path), jconv.load_ddpm_checkpoint(path))


LATENT = {  # task: (unet, first stage, LatentDiffusionConfig extras, scale_factor)
    "church": ("church", "kl", dict(timesteps=50), 0.734),
    "imagenet": ("imagenet", "vq", dict(timesteps=50, cond="class", n_classes=11,
                                        class_embed_dim=24), None)}


@pytest.fixture(scope="module", params=sorted(LATENT))
def latent_ckpt(request, tmp_path_factory):
    """A LatentDiffusion checkpoint of a tiny port model (raw weights seed 3,
    EMA shadows seed 4), with the first stage's encoder from a JAX init and
    ``loss.*`` entries, and church's ``scale_factor``."""
    task = request.param
    unet_kw, vae_kind, extra, scale = LATENT[task]
    unet_kw = {k: v for k, v in UNET[unet_kw].items() if k != "num_classes"}
    mk = lambda pkg_ld, pkg_unet, pkg_vae: pkg_ld.LatentDiffusionConfig(
        unet=pkg_unet.LDMUNetConfig(**unet_kw), vae=pkg_vae.VAEConfig(**VAE[vae_kind]),
        **extra)
    ld = tld.LatentDiffusion(mk(tld, tldm, tvae), QuantConfig(), device="cpu", seed=3)
    ema = tldm.LDMUNet(tldm.LDMUNetConfig(**unet_kw), QuantConfig(), device="cpu", seed=4)
    fs = jvae.FirstStage(cfg=jvae.VAEConfig(**VAE[vae_kind]))
    enc = fs.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)), method=lambda m, im: (
        m.encode(im), m.decode(jnp.zeros((1, 8, 8, 4)))))["params"]
    first = {**_np(enc), **to_jax_variables(ld.first_stage)["params"]}
    sd = rl.latent_diffusion_state_dict(
        to_jax_variables(ld.unet)["params"], first,
        to_jax_variables(ld.cond_stage)["params"] if ld.cond_stage is not None else None,
        ema_unet=to_jax_variables(ema)["params"], scale_factor=scale)
    sd["first_stage_model.loss.logvar"] = torch.zeros(())
    path = str(tmp_path_factory.mktemp(task) / "model.ckpt")
    torch.save({"state_dict": sd}, path)
    return dict(task=task, path=path, mk=mk, unet_kw=unet_kw, scale=scale,
                raw=to_jax_variables(ld.unet)["params"], ema=to_jax_variables(ema)["params"],
                first=to_jax_variables(ld.first_stage)["params"],
                cond=(to_jax_variables(ld.cond_stage)["params"]
                      if ld.cond_stage is not None else None))


def test_ldm_pipeline_checkpoint_matches_jax(latent_ckpt):
    """``LDMPipeline(ckpt_path=...)``: the raw UNet weights (no EMA swap, as
    JAX's ``LatentDiffusion.load_checkpoint``), the first stage's decode
    part, the class embedder and church's ``scale_factor``, each equal to
    JAX's."""
    c = latent_ckpt
    knobs = dict(custom_steps=5, ckpt_path=c["path"])
    tpipe = tlatent.LDMPipeline(tlatent.task_config(c["task"], **knobs),
                                c["mk"](tld, tldm, tvae), device="cpu")
    jpipe = jlatent.LDMPipeline(jlatent.task_config(c["task"], **knobs),
                                model_cfg=c["mk"](jld, jldm, jvae))
    jv = _np(jpipe.init_variables())
    tunet = to_jax_variables(tpipe.ld.unet)["params"]
    _assert_trees_equal(tunet, jv["unet"]["params"])
    _assert_trees_equal(tunet, c["raw"])
    decode = {k: v for k, v in jv["first_stage"]["params"].items()
              if k not in ("encoder", "quant_conv")}
    _assert_trees_equal(to_jax_variables(tpipe.ld.first_stage)["params"], decode)
    _assert_trees_equal(decode, c["first"])
    if c["cond"] is not None:
        _assert_trees_equal(to_jax_variables(tpipe.ld.cond_stage)["params"],
                            jv["cond_stage"]["params"])
        _assert_trees_equal(jv["cond_stage"]["params"], c["cond"])
    expect = 1.0 if c["scale"] is None else float(np.float32(c["scale"]))
    assert tpipe.mc.scale_factor == jpipe.mc.scale_factor == expect


def test_quantize_model_swaps_the_ema_weights_in_like_jax(latent_ckpt):
    """``api.quantize_model("ldm", ckpt_path=...)`` takes the ``model_ema.``
    shadows (``load_ldm_checkpoint(use_ema=True)``) in both packages;
    ``use_ema=False`` gives the raw weights."""
    c = latent_ckpt
    tm = tapi.quantize_model("ldm", tldm.LDMUNetConfig(**c["unet_kw"]),
                             ckpt_path=c["path"], device="cpu")
    _, jv = japi.quantize_model("ldm", jldm.LDMUNetConfig(**c["unet_kw"]),
                                ckpt_path=c["path"])
    _assert_trees_equal(to_jax_variables(tm)["params"], _np(jv["params"]))
    _assert_trees_equal(to_jax_variables(tm)["params"], c["ema"])
    for use_ema, want in ((True, c["ema"]), (False, c["raw"])):
        t_unet, t_first, t_cond = tconv.load_ldm_checkpoint(c["path"], use_ema)
        j_unet, j_first, j_cond = jconv.load_ldm_checkpoint(c["path"], use_ema)
        _assert_trees_equal(t_unet, j_unet)
        _assert_trees_equal(t_unet, want)
        assert list(t_first) == list(j_first) and list(t_cond) == list(j_cond)
