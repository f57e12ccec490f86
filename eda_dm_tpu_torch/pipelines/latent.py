"""Latent-diffusion PTQ pipelines (port of ``eda_dm_tpu/pipelines/latent.py``)
for the LSUN-Bedroom and LSUN-Church tasks (unconditional, DDIM), the
class-conditional ImageNet task (cin256-v2, DDIM at eta 0, guidance 3.0
over one-token class contexts: ``imagenet_labels``) and the COCO
text-to-image task (SD v1.4, PLMS, classifier-free guidance).

quantized UNet → TDAC over FP sampler trajectories (several trajectory
batches; the scores from the first batch's ``middle_block_1`` inputs) →
weight and act scale init over the calibration set → AdaRound + FBR
reconstruction over ``ldm_recon_plan`` → the serving export → batched
sampling and the float32 first-stage decode.  Conditional tasks lay their
calibration rows out as the reference does: x = [x; x], t = [t; t],
context = [uncond; cond].

One sampling batch is x_T → the task's sampler over the quantized UNet,
under classifier-free guidance where the task has a class or text
context and a scale other than 1 (``cfg_model_fn``: one UNet call on the
doubled batch) → the decode → images clipped to [0, 1], NHWC.  The UNet
is fed its carrier dtype (that of its parameters: bf16 after a serving
export); the sampler and the decode stay float32, with TF32 off.

As in ``pipelines/cifar.py``, the model holds the state: the stages update
``self.ld.unet`` in place, and the serving exports are copies.  Random
draws come from ``torch.Generator``s seeded from ``cfg.seed``; ``run``'s
``draws`` hands in another run's (TDAC's x_T, noise and permutation, each
sampling batch's x_T and noise) to reproduce it.  ``sampler="dpm"``
serves with multistep DPM-Solver++ at order 2 (``samplers/dpm_solver.py``)
over the schedule's betas, as the JAX package does; TDAC keeps the DDIM
trajectories there.  The JAX package's ``recon_clear_caches_every``
concerns compiled XLA programs and has no counterpart.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..calib.recon import ReconArgs, reconstruct
from ..calib.scale_init import set_act_quantize_params, set_weight_quantize_params
from ..calib.tdac import DENSE_R, TDACResult, select_calib_set
from ..models.latent_diffusion import (LatentDiffusion, LatentDiffusionConfig,
                                       bedroom_config, church_config,
                                       imagenet_config, sd_v1_config)
from ..models.ldm_unet import ldm_recon_plan
from ..ops.int8_einsum import tf32_off
from ..quant.config import DEPLOY_INT8, FP, WAQ, QuantConfig, QuantMode
from ..samplers.dpm_solver import NoiseScheduleVP, dpm_solver_sample
from ..samplers.latent import (cfg_model_fn, ldm_ddim_sample, ldm_plms_sample,
                               make_ldm_schedule)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LDMTaskConfig:
    """Per-task knobs, the JAX package's names and defaults."""
    task: str = "bedroom"                 # bedroom | church | imagenet | coco
    custom_steps: int = 200
    eta: float = 1.0
    sampler: str = "ddim"                 # 'ddim' | 'plms' | 'dpm'
    scale: float = 1.0                    # classifier-free guidance scale
    # quantization
    weight_bit: int = 4
    act_bit: int = 8
    sm_abit: int = 8
    a_sym: bool = False
    split: bool = True
    quant_act: bool = True
    # calibration / reconstruction
    calib_num_samples: int = 1024
    batch_samples: int = 64
    lamda: float = 100.0
    iters: int = 5000
    lr_w: float = 1e-2
    lr_a: float = 5e-3
    add_loss: float = 0.001
    input_prob: float = 0.5
    recon_batch_size: int = 32
    capture_batch_size: Optional[int] = None
    # the act scale init's streaming batch: at 32×32 latents the attention
    # weights are (B·heads, 1024, 1024)
    calib_batch_size: int = 32
    # targets of one group are captured together (calib/recon.py); 1 is
    # the reference-exact sequential order
    recon_group_size: int = 4
    recon_group_window: int = 0
    # the activation caches' dtype ('bfloat16' halves them)
    cache_dtype: Optional[str] = None
    capture_budget_bytes: int = 6_000_000_000
    recon: bool = True
    # sampling
    n_samples: int = 50000
    batch_size: int = 50
    seed: int = 1234
    ckpt_path: Optional[str] = None


# the W4A8 recipes of the reference's run scripts (the JAX package's
# TASK_DEFAULTS, which tests/test_task_recipes.py pins to them)
TASK_DEFAULTS = {
    "bedroom": dict(custom_steps=200, eta=1.0, lamda=1.0, lr_w=1e-2,
                    lr_a=5e-3, add_loss=1.0, iters=5000, batch_size=50,
                    cache_dtype="bfloat16"),
    "church": dict(custom_steps=500, eta=0.0, lamda=1.0, lr_w=5e-2,
                   lr_a=1e-4, add_loss=1.0, iters=5000, batch_size=100),
    "imagenet": dict(custom_steps=20, eta=0.0, scale=3.0, lamda=1.2,
                     lr_w=5e-1, lr_a=1e-4, add_loss=0.8, iters=1000,
                     batch_size=50, cache_dtype="bfloat16"),
    "coco": dict(custom_steps=50, eta=0.0, scale=7.5, sampler="plms",
                 lamda=5.0, lr_w=3e-2, lr_a=1e-4, add_loss=0.8, iters=1000,
                 calib_num_samples=256, batch_samples=8, batch_size=4,
                 n_samples=10000, recon_batch_size=2,
                 cache_dtype="bfloat16"),
}

MODEL_CONFIGS = {"bedroom": bedroom_config, "church": church_config,
                 "imagenet": imagenet_config, "coco": sd_v1_config}

# the trajectory samplers (TDAC's and serving's); "dpm" serves through
# DPM-Solver++ and calibrates over DDIM trajectories
SAMPLERS = {"ddim": ldm_ddim_sample, "plms": ldm_plms_sample}


def task_config(task: str, **overrides) -> LDMTaskConfig:
    kw = dict(TASK_DEFAULTS[task])
    kw.update(overrides)
    return LDMTaskConfig(task=task, **kw)


def imagenet_labels(n: int, seed: int):
    """The ImageNet task's class rows for ``n`` samples: a ``seed``ed
    permutation of the 1000 classes, each repeated ceil(n / 1000) times,
    cut to n; and n unconditional rows at label 1000.  Returns two int64
    numpy arrays (labels, unconditional labels) for
    ``LatentDiffusion.get_learned_conditioning``."""
    rng = np.random.RandomState(seed)
    labels = rng.permutation(np.repeat(np.arange(1000), -(-n // 1000)))[:n]
    return labels.astype(np.int64), np.full((n,), 1000, np.int64)


class LDMPipeline:
    """The task's model, quantized by the task's recipe, and its DDIM
    schedule on ``device`` (the card unless the caller passes ``"cpu"``),
    random weights from ``seed``, or a reference checkpoint's
    (``cfg.ckpt_path``, through ``LatentDiffusion.load_checkpoint``: the
    raw UNet weights, as the JAX pipeline loads them)."""

    def __init__(self, cfg: LDMTaskConfig,
                 model_cfg: Optional[LatentDiffusionConfig] = None,
                 device=None, seed: int = 0):
        if cfg.sampler not in ("ddim", "plms", "dpm"):
            raise ValueError(f"unknown sampler {cfg.sampler!r}")
        self.cfg = cfg
        self.qc = QuantConfig(weight_bit=cfg.weight_bit, act_bit=cfg.act_bit,
                              sm_abit=cfg.sm_abit, a_sym=cfg.a_sym,
                              quant_act=cfg.quant_act, split=cfg.split)
        self.mc = model_cfg or MODEL_CONFIGS[cfg.task]()
        self.ld = LatentDiffusion(self.mc, self.qc, device=device, seed=seed)
        if cfg.ckpt_path:
            self.ld.load_checkpoint(cfg.ckpt_path)
        self.device = next(self.ld.unet.parameters()).device
        self.sched = make_ldm_schedule(
            num_timesteps=self.mc.timesteps, linear_start=self.mc.linear_start,
            linear_end=self.mc.linear_end, ddim_steps=cfg.custom_steps,
            eta=cfg.eta)
        self.is_conditional = cfg.scale != 1.0 and self.mc.cond != "none"

    def generator(self, offset: int = 0, device=None) -> torch.Generator:
        return torch.Generator(device=device or self.device).manual_seed(
            self.cfg.seed + offset)

    def _latents(self, n: int, generator) -> torch.Tensor:
        res, ch = self.mc.unet.image_size, self.mc.unet.in_channels
        return torch.randn(n, res, res, ch, generator=generator, device=self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def tdac_calibration(self, context=None, uncond=None,
                         draws: Optional[Dict[str, Any]] = None) -> TDACResult:
        """TDAC over FP sampler trajectories.  With ``calib_num_samples``
        above ``batch_samples`` several trajectory batches run: the scores
        come from the first batch's ``middle_block_1`` inputs (read by a
        forward pre-hook in the forward that computes eps) and each batch
        gives its slice of the selected latents.  Under guidance the model
        runs the doubled batch, whose inputs are the feature, so the
        scores count 2B positions a step.  ``context`` / ``uncond`` rows
        follow the sample index (at least ``calib_num_samples`` rows, or
        ``batch_samples`` shared by every batch).  ``draws``:
        ``"tdac_x_T"`` and ``"tdac_noise"`` (one entry a batch; the noise
        a list of per-step tensors) and ``"tdac_perm"`` replace the
        generators' draws."""
        cfg, unet = self.cfg, self.ld.unet
        draws = draws or {}
        B = cfg.batch_samples
        n_batches = max(1, cfg.calib_num_samples // B)
        g_x, g_noise = self.generator(1), self.generator(2)
        # PLMS for a PLMS task, else DDIM (DPM-Solver records no trajectory)
        sampler = SAMPLERS["plms" if cfg.sampler == "plms" else "ddim"]
        feats = []

        def ctx_slice(arr, r):
            if arr is None:
                return None
            arr = arr.to(self.device)
            return arr[r * B:(r + 1) * B] if arr.shape[0] >= (r + 1) * B else arr[:B]

        def run_traj(r: int, with_feat: bool):
            ctx, unc = ctx_slice(context, r), ctx_slice(uncond, r)

            def model_fn(x, t):
                if self.is_conditional:
                    e_u, e_c = unet(torch.cat([x, x]), torch.cat([t, t]),
                                    torch.cat([unc, ctx]), mode=FP).chunk(2)
                    eps = e_u + cfg.scale * (e_c - e_u)
                else:
                    eps = unet(x, t, ctx, mode=FP)
                return (eps, feats.pop()) if with_feat else eps

            x_T = (draws["tdac_x_T"][r].to(self.device) if "tdac_x_T" in draws
                   else self._latents(B, g_x))
            noise = draws["tdac_noise"][r] if "tdac_noise" in draws else None
            hook = (unet.middle_block_1.register_forward_pre_hook(
                lambda m, args: feats.append(args[0])) if with_feat else None)
            try:
                _, traj = sampler(
                    x_T, self.sched, model_fn, generator=g_noise, noise=noise,
                    device=self.device, record_xt=True, model_returns_aux=with_feat)
            finally:
                if hook is not None:
                    hook.remove()
            return traj

        traj = run_traj(0, True)
        # step position c maps to the model time seq[len - 1 - c]: step 0
        # (x_T) takes the largest t
        sel = select_calib_set(traj["x"], traj["aux"], self.sched.ddim_timesteps,
                               cfg.lamda, cfg.calib_num_samples,
                               DENSE_R.get(cfg.task, 3.0),
                               generator=self.generator(3, "cpu"),
                               perm=draws.get("tdac_perm"))
        if n_batches == 1:
            return sel
        del traj
        pos = torch.arange(B, device=self.device)
        chunks = [sel.calib_x[:B]]
        for r in range(1, n_batches):
            codes = torch.from_numpy(sel.time_codes[r * B:(r + 1) * B]).to(self.device)
            chunks.append(run_traj(r, False)["x"][codes, pos])
        sel.calib_x = torch.cat(chunks)
        return sel

    def build_cali_data(self, sel: TDACResult, context=None, uncond=None):
        """The calibration tuple the UNet takes positionally: (x, t), or
        under guidance the doubled rows (x2, t2, [uncond; cond])."""
        if not self.is_conditional:
            return (sel.calib_x, sel.calib_t)
        n = sel.calib_x.shape[0]
        context, uncond = context.to(self.device), uncond.to(self.device)
        if context.shape[0] >= n:
            ctx, unc = context[:n], uncond[:n]
        else:
            pos = torch.arange(n, device=self.device) % context.shape[0]
            ctx, unc = context[pos], uncond[pos]
        return (torch.cat([sel.calib_x, sel.calib_x]),
                torch.cat([sel.calib_t, sel.calib_t]), torch.cat([unc, ctx]))

    # ------------------------------------------------------------------
    def calibrate(self, cali_data):
        """Weight then act scale init (the act search streams batches of
        ``calib_batch_size`` rows)."""
        unet = self.ld.unet
        set_weight_quantize_params(unet, cali_data, device=self.device)
        return set_act_quantize_params(unet, cali_data,
                                       batch_size=self.cfg.calib_batch_size,
                                       device=self.device)

    def recon_args(self) -> ReconArgs:
        cfg = self.cfg
        return ReconArgs(iters=cfg.iters, batch_size=cfg.recon_batch_size,
                         lr_w=cfg.lr_w, lr_a=cfg.lr_a, add_loss=cfg.add_loss,
                         input_prob=cfg.input_prob,
                         capture_batch_size=(cfg.capture_batch_size
                                             or cfg.calib_batch_size),
                         cache_dtype=cfg.cache_dtype,
                         capture_budget_bytes=cfg.capture_budget_bytes)

    def reconstruct(self, cali_data, progress=None,
                    checkpoint_dir: Optional[str] = None, log=None):
        """Block reconstruction over ``ldm_recon_plan``; ``checkpoint_dir``
        checkpoints after every group and resumes
        (``utils/checkpointing.py::resumable_reconstruct``)."""
        cfg = self.cfg
        plan = ldm_recon_plan(self.mc.unet, self.qc)
        if checkpoint_dir is not None:
            from ..utils.checkpointing import resumable_reconstruct
            return resumable_reconstruct(
                self.ld.unet, cali_data, plan, self.recon_args(), checkpoint_dir,
                seed=cfg.seed, progress=progress, group_size=cfg.recon_group_size,
                group_window=cfg.recon_group_window)
        return reconstruct(self.ld.unet, cali_data, plan, self.recon_args(),
                           self.generator(4), progress=progress,
                           group_size=cfg.recon_group_size,
                           group_window=cfg.recon_group_window, log=log)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample_batch(self, mode: QuantMode = DEPLOY_INT8,
                     batch_size: Optional[int] = None,
                     generator: Optional[torch.Generator] = None,
                     x_T: Optional[torch.Tensor] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None,
                     decode: bool = True,
                     context: Optional[torch.Tensor] = None,
                     uncond: Optional[torch.Tensor] = None,
                     unet=None) -> torch.Tensor:
        """One batch: images (N, H, W, 3) in [0, 1], or with ``decode=False``
        the latents, from ``unet`` (default: the pipeline's).  x_T and the
        per-step noise are drawn from ``generator`` unless given (DPM-Solver
        draws no noise).  ``context`` / ``uncond``: the rows of the
        conditions and of the unconditional one, from
        ``self.ld.get_learned_conditioning``: the prompts' and the empty
        prompt's text rows (N, 77, context_dim), or the labels' and label
        1000's class rows (N, 1, class_embed_dim)."""
        unet = self.ld.unet if unet is None else unet
        if x_T is None:
            x_T = self._latents(batch_size or self.cfg.batch_size, generator)
        ct = next(unet.parameters()).dtype
        on = lambda c: None if c is None else c.to(self.device, ct)
        apply_fn = lambda x, t, c: unet(x.to(ct), t, context=c, mode=mode).to(x.dtype)
        model_fn = cfg_model_fn(apply_fn, on(context), on(uncond),
                                self.cfg.scale if self.is_conditional else 1.0)
        with tf32_off():
            if self.cfg.sampler == "dpm":
                # multistep DPM-Solver++ at order 2 over the schedule's betas
                ns = NoiseScheduleVP("discrete", betas=self.sched.betas)
                z = dpm_solver_sample(x_T, model_fn, ns, steps=self.cfg.custom_steps,
                                      order=2, algorithm_type="dpmsolver++")
            else:
                z = SAMPLERS[self.cfg.sampler](
                    x_T, self.sched, model_fn, generator=generator, noise=noise,
                    device=self.device)
            if not decode:
                return z
            img = self.ld.decode_first_stage(z)
        return torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)

    def sample_fid(self, unet=None, out_dir: Optional[str] = None,
                   n_samples: Optional[int] = None, context_fn=None,
                   mode: QuantMode = WAQ, x_T=None, noise=None):
        """The FID set batch by batch; ``context_fn(img_id, bs)`` gives each
        batch's (context, uncond) rows; ``x_T`` and ``noise`` (one entry a
        batch) replace the draws.  Returns the images (numpy) without
        ``out_dir``, else writes PNGs and returns None."""
        total = n_samples or self.cfg.n_samples
        bs = min(self.cfg.batch_size, total)
        generator = self.generator()
        images = [] if out_dir is None else None
        img_id = 0
        for r in range(-(-total // bs)):
            ctx, unc = context_fn(img_id, bs) if context_fn else (None, None)
            t0 = time.time()
            batch = self.sample_batch(
                mode, bs, generator, None if x_T is None else x_T[r],
                None if noise is None else noise[r], context=ctx, uncond=unc,
                unet=unet).cpu().numpy()
            logger.info("batch throughput %.3f img/s", bs / max(time.time() - t0, 1e-9))
            take = min(bs, total - img_id)
            if out_dir is None:
                images.append(batch[:take])
            else:
                from ..eval.io import save_images
                save_images(batch[:take], out_dir, start_index=img_id)
            img_id += take
        return np.concatenate(images) if out_dir is None else None

    @staticmethod
    def make_context_fn(context, uncond):
        """Batch-cycling conditioning for the FID set: a batch gets rows
        ``img_id : img_id + bs`` of the conditioning (wrapping where it has
        fewer rows than the set), never the same leading slice."""
        if context is None:
            return None

        def rows(arr, start, count):
            return arr[torch.from_numpy(np.arange(start, start + count) % arr.shape[0])]

        def context_fn(img_id: int, bs: int):
            return (rows(context, img_id, bs),
                    rows(uncond, img_id, bs) if uncond is not None else None)
        return context_fn

    def serving_variables(self, unet=None, serve: str = "waq"):
        """(model, serve mode) for ``serve``: 'waq' the fake-quant model,
        'fp' the unquantized one, 'fpbf16' a copy with its float parameters
        cast to bf16 (the unquantized baseline on a bf16 carrier),
        'int8' / 'bf16' / 'fold' the exports of ``api.export_for_serving``
        (copies) with their paired modes."""
        unet = self.ld.unet if unet is None else unet
        if serve == "waq":
            return unet, WAQ
        if serve == "fp":
            return unet, FP
        if serve == "fpbf16":
            out = copy.deepcopy(unet)
            for p in out.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(torch.bfloat16)
            return out, FP
        from ..api import export_for_serving
        return export_for_serving(unet, self.qc, kind=serve)

    def run(self, out_dir: Optional[str] = None, context=None, uncond=None,
            progress=None, serve: str = "waq",
            draws: Optional[Dict[str, Any]] = None):
        """The full PTQ flow on the pipeline's model; returns (model, images
        or None).  ``draws``: TDAC's (``tdac_calibration``) and
        ``"sample_x_T"`` / ``"sample_noise"`` (one entry a sampling batch)
        in place of the generators' draws."""
        draws = draws or {}
        sel = self.tdac_calibration(context, uncond, draws)
        cali_data = self.build_cali_data(sel, context, uncond)
        self.calibrate(cali_data)
        if self.cfg.recon:
            self.reconstruct(cali_data, progress=progress)
        serving, mode = self.serving_variables(serve=serve)
        images = self.sample_fid(serving, out_dir=out_dir, mode=mode,
                                 context_fn=self.make_context_fn(context, uncond),
                                 x_T=draws.get("sample_x_T"),
                                 noise=draws.get("sample_noise"))
        return self.ld.unet, images
