"""PTQ validation: checkpoint → PTQ → paired FP and quantized samples → the
FID of one set against the other (port of ``scripts/validate_ptq.py``, the
same flags; ``--cpu`` is ``--device cpu``).

    python -m eda_dm_tpu_torch.validate_ptq --task cifar --ckpt ema_cifar10.ckpt \\
        --inception_weights pt_inception-2015-12-05-6726825d.pth --n 2048

The reference checkpoint (or random weights without one) goes through the
task's pipeline (TDAC calibration → scale init → reconstruction, or a
saved ``--quant_state``); then ``--n`` images are sampled from the FP
model and from the quantized one (``--serve``: ``waq`` fake-quant, or the
``int8`` / ``bf16`` export) with the same noise, their pool3 features are
taken by the FID InceptionV3 and ``fid_quant_vs_fp`` is the FID between the
two sets, printed beside ``split_noise_floor``, the FID between the two
halves of the FP set.  Without ``--inception_weights`` the extractor has
random weights, whose raw features all but collapse, so both numbers are
the standardized FID (``eval/metrics.py``) and read as a ratio only.
``features.npz`` and ``result.json`` go to ``--out`` (default
``result/validate_<task>``).  ``--tiny`` swaps in a small architecture.
``--device cpu`` runs on the host; without it and without a card the
script raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", required=True,
                   choices=["cifar", "bedroom", "church", "imagenet", "coco"])
    p.add_argument("--ckpt", default=None,
                   help="reference checkpoint (DDPM / LatentDiffusion); random "
                        "weights when omitted")
    p.add_argument("--inception_weights", default=None,
                   help="pt_inception-2015-12-05-*.pth for the real FID; the "
                        "random-init extractor (self-consistency) otherwise")
    p.add_argument("--n", type=int, default=1024, help="images per arm")
    p.add_argument("--serve", default="waq", choices=["waq", "int8", "bf16"],
                   help="quantized serving path of the quant arm")
    p.add_argument("--quant_state", default=None,
                   help="a saved quant state (utils/checkpointing.py) in place "
                        "of the PTQ run")
    p.add_argument("--out", default=None,
                   help="run dir for features.npz and result.json "
                        "(default result/validate_<task>)")
    p.add_argument("--text_encoder", default="tiny", choices=["clip", "bert", "tiny"])
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--calib_num_samples", type=int, default=None)
    p.add_argument("--batch_samples", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--custom_steps", type=int, default=None)
    p.add_argument("--timesteps", type=int, default=None, help="(cifar) DDIM steps")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--no_recon", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="a tiny architecture (a check of the harness without "
                        "real weights)")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs on the host (default: the card)")
    return p


def _tiny_latent_cfg(task: str):
    """Small stand-in architectures for ``--tiny`` (the JAX script's)."""
    from .models.latent_diffusion import LatentDiffusionConfig
    from .models.ldm_unet import LDMUNetConfig
    from .models.vae import VAEConfig
    transformer = task in ("imagenet", "coco")
    return LatentDiffusionConfig(
        unet=LDMUNetConfig(
            image_size=8, in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_head_channels=16, use_spatial_transformer=transformer,
            context_dim=16 if transformer else None),
        vae=VAEConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1,
                      attn_resolutions=(), in_channels=3, resolution=16,
                      z_channels=3, double_z=False, embed_dim=3, n_embed=64),
        timesteps=50,
        cond="class" if task == "imagenet" else ("text" if task == "coco" else "none"),
        n_classes=1001, class_embed_dim=16)


def _overrides(args, keys) -> Dict[str, Any]:
    return {k: getattr(args, k) for k in keys if getattr(args, k, None) is not None}


def build_cifar(args):
    from .pipelines.cifar import CifarConfig, CifarPipeline
    kw = _overrides(args, ("calib_num_samples", "batch_samples", "iters", "timesteps"))
    if args.batch_size:
        kw["sample_batch_size"] = kw["batch_samples"] = args.batch_size
    if args.no_recon:
        kw["recon"] = False
    if args.tiny:
        from .models.ddpm_unet import DDPMConfig
        kw["arch"] = DDPMConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                attn_resolutions=(16,), resolution=32)
    return CifarPipeline(CifarConfig(seed=args.seed, ckpt_path=args.ckpt, **kw),
                         device=args.device)


def build_latent(args):
    from .pipelines.latent import LDMPipeline, task_config
    kw = _overrides(args, ("calib_num_samples", "batch_samples", "iters",
                           "custom_steps", "batch_size"))
    if args.no_recon:
        kw["recon"] = False
    cfg = task_config(args.task, seed=args.seed, ckpt_path=args.ckpt, **kw)
    return LDMPipeline(cfg, model_cfg=_tiny_latent_cfg(args.task) if args.tiny else None,
                       device=args.device)


def main(argv=None) -> Dict[str, Any]:
    args = get_parser().parse_args(argv)
    from .eval.inception import InceptionExtractor
    from .eval.metrics import fid_from_features, standardized_fid
    from .quant.config import FP
    from .utils.checkpointing import load_quant_state
    from .utils.run import seed_everything

    seed_everything(args.seed)
    out_dir = args.out or f"result/validate_{args.task}"
    os.makedirs(out_dir, exist_ok=True)

    is_cifar = args.task == "cifar"
    pipe = (build_cifar if is_cifar else build_latent)(args)
    model = pipe.init_variables() if is_cifar else pipe.ld.unet
    print(f"task={args.task} ckpt={args.ckpt or 'random'}", flush=True)

    context = uncond = None
    if not is_cifar:
        n = max(pipe.cfg.batch_samples, pipe.cfg.calib_num_samples, args.n)
        if args.task == "imagenet":
            from .pipelines.latent import imagenet_labels
            labels, unc = imagenet_labels(n, args.seed)
            context = pipe.ld.get_learned_conditioning(labels)
            uncond = pipe.ld.get_learned_conditioning(unc)
        elif args.task == "coco":
            from .sample_ldm import build_coco_context
            args.prompts_file = None
            args.clip_path = "openai/clip-vit-large-patch14"
            context, uncond = build_coco_context(args, pipe, n)

    # ---- PTQ ------------------------------------------------------------
    t0 = time.perf_counter()
    if args.quant_state:
        load_quant_state(args.quant_state, model)
        print("loaded quant state; skipping calibration", flush=True)
    else:
        progress = lambda name, loss: print(f"  recon {name}: {loss:.4g}", flush=True)
        if is_cifar:
            cx, ct, _ = pipe.tdac_calibration(model)
            cali = (cx, ct)
            pipe.calibrate(model, cali)
            if pipe.cfg.recon:
                pipe.reconstruct(model, cali, progress=progress)
        else:
            sel = pipe.tdac_calibration(context, uncond)
            cali = pipe.build_cali_data(sel, context, uncond)
            pipe.calibrate(cali)
            if pipe.cfg.recon:
                pipe.reconstruct(cali, progress=progress)
        print(f"PTQ: {time.perf_counter() - t0:.0f}s", flush=True)

    # ---- paired sampling (the same noise: each arm seeds from cfg.seed) ---
    t0 = time.perf_counter()
    if is_cifar:
        imgs_fp = pipe.sample_fid(model, max_images=args.n, mode=FP)
        serving, mode = pipe.serving_variables(model, args.serve)
        imgs_q = pipe.sample_fid(serving, max_images=args.n, mode=mode)
    else:
        ctx_fn = pipe.make_context_fn(context, uncond)
        imgs_fp = pipe.sample_fid(model, n_samples=args.n, mode=FP, context_fn=ctx_fn)
        serving, mode = pipe.serving_variables(serve=args.serve)
        imgs_q = pipe.sample_fid(serving, n_samples=args.n, mode=mode, context_fn=ctx_fn)
    print(f"sampling 2x{args.n}: {time.perf_counter() - t0:.0f}s", flush=True)

    # ---- features + FID of one set against the other --------------------
    ext = InceptionExtractor(args.inception_weights, device=args.device)

    def feats(imgs, bs=64):
        return np.concatenate([ext.pool3(imgs[i:i + bs]) for i in range(0, len(imgs), bs)])
    f_fp, f_q = feats(imgs_fp), feats(imgs_q)
    np.savez(os.path.join(out_dir, "features.npz"), fp=f_fp, quant=f_q)
    half = len(f_fp) // 2
    if args.inception_weights:
        fid = fid_from_features
    else:
        pool = np.concatenate([f_fp, f_q])
        fid = lambda a, b: standardized_fid(a, b, pool)
    result = {
        "task": args.task, "serve": args.serve, "n": args.n,
        "real_weights": bool(args.ckpt),
        "real_inception": bool(args.inception_weights),
        "fid_quant_vs_fp": round(fid(f_q, f_fp), 4),
        "split_noise_floor": round(fid(f_fp[:half], f_fp[half:]), 4),
    }
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
