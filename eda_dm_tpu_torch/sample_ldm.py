"""Latent-diffusion PTQ for the bedroom, church, imagenet and coco tasks
(port of ``scripts/sample_diffusion_ldm.py``, the same flags).

    python -m eda_dm_tpu_torch.sample_ldm --task church --resume model.ckpt --serve int8

``--resume``: a reference LatentDiffusion checkpoint, grafted by
``LatentDiffusion.load_checkpoint`` (the raw UNet weights, the first
stage, the class embedder and church's ``scale_factor``); without it the
model has random weights.  ImageNet's contexts are class rows
(``imagenet_labels``, label 1000 the unconditional one); coco's come from
``--text_encoder``: ``clip`` (CLIP ViT-L/14's text tower from the local
checkout ``--clip_path``: ``config.json``, ``model.safetensors`` or
``pytorch_model.bin``, ``vocab.json``, ``merges.txt``; it raises without
one), ``bert`` or ``tiny`` (the stand-in encoder).
``--phase calib|recon|sample`` runs one phase a process with the quant
state and the calibration set handed over in ``--state_dir``; ``--dpm``
samples with DPM-Solver++.  PNGs go to ``<logdir>/samples/<timestamp>/img``
with a ``grid-0000.png`` beside them.  ``--clear_caches_every`` concerns
compiled XLA programs and is refused.  ``--device cpu`` runs on the host;
without it and without a card the script raises.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict

import numpy as np


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", type=str, required=True,
                   choices=["bedroom", "church", "imagenet", "coco"])
    p.add_argument("--resume", type=str, default=None,
                   help="LatentDiffusion torch checkpoint path")
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--custom_steps", type=int, default=None)
    p.add_argument("--eta", type=float, default=None)
    p.add_argument("--scale", type=float, default=None)
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--weight_bit", type=int, default=4)
    p.add_argument("--act_bit", type=int, default=8)
    p.add_argument("--sm_abit", type=int, default=8)
    p.add_argument("--a_sym", action="store_true", default=False)
    p.add_argument("--split", action="store_true", default=True)
    p.add_argument("--calib_num_samples", type=int, default=None)
    p.add_argument("--batch_samples", type=int, default=None)
    p.add_argument("--lamda", type=float, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--lr_w", type=float, default=None)
    p.add_argument("--lr_a", type=float, default=None)
    p.add_argument("--add_loss", type=float, default=None)
    p.add_argument("--dpm", action="store_true", default=False,
                   help="sample with multistep DPM-Solver++ instead of DDIM")
    p.add_argument("--cache_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="recon activation-cache dtype (task default: bf16 "
                        "for 64x64-latent tasks, f32 otherwise)")
    p.add_argument("--capture_budget_bytes", type=float, default=None,
                   help="cap on a recon group's summed cache bytes")
    p.add_argument("--recon_group_size", type=int, default=None,
                   help="same-shape targets captured together "
                        "(1 = reference-exact sequential order)")
    p.add_argument("--recon_group_window", type=int, default=None)
    p.add_argument("--clear_caches_every", type=int, default=None,
                   help="refused: it drops compiled XLA programs, and the "
                        "port compiles none")
    p.add_argument("--phase", default="all", choices=["all", "calib", "recon", "sample"],
                   help="run one pipeline phase per process (state handoff "
                        "in --state_dir); 'all' runs everything in-process")
    p.add_argument("--state_dir", type=str, default=None,
                   help="phase-handoff dir (default <logdir>/state)")
    p.add_argument("--serve", default="waq", choices=["waq", "int8", "bf16", "auto"],
                   help="sampling path: fake-quant / native-int8 export / "
                        "bf16 folded / auto = the export kind of "
                        "serving_policy.preferred_export_kind")
    p.add_argument("--export_bundle", type=str, default=None,
                   help="after PTQ, save the packed-int4 UNet deployment "
                        "artifact (codes 2/byte + scales) to this path")
    p.add_argument("--bundle", type=str, default=None,
                   help="(phase=sample) serve the UNet from a saved "
                        "deployment bundle instead of the quant state")
    p.add_argument("--text_encoder", default="clip", choices=["clip", "bert", "tiny"],
                   help="coco text encoder: CLIP ViT-L/14 from the local checkout "
                        "--clip_path, the BERT encoder, or the stand-in "
                        "TinyTextEncoder")
    p.add_argument("--clip_path", type=str, default="openai/clip-vit-large-patch14",
                   help="local CLIP checkout: config.json, model.safetensors or "
                        "pytorch_model.bin, vocab.json, merges.txt")
    p.add_argument("--prompts_file", type=str, default=None,
                   help="text prompts (one per line) for the coco task")
    p.add_argument("--skip_grid", action="store_true",
                   help="skip the grid-0000.png preview save")
    p.add_argument("--n_rows", type=int, default=8, help="images per grid row")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs on the host (default: the card)")
    return p


def build_coco_context(args, pipe, n: int, prompt_dir=None):
    """Prompt rows and empty-prompt rows for the coco task, from the
    encoder ``--text_encoder`` names."""
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    else:
        prompts = [f"a photo, sample {i}" for i in range(n)]
    prompts = (prompts * (-(-n // len(prompts))))[:n]
    if prompt_dir:
        from .eval.io import save_prompts
        save_prompts(prompts, prompt_dir)
    if args.text_encoder == "clip":
        from .models.encoders import FrozenCLIPTextEncoder
        enc = FrozenCLIPTextEncoder(args.clip_path, device=pipe.device)
    elif args.text_encoder == "bert":
        from .models.encoders import BERTTextEncoder
        enc = BERTTextEncoder(context_dim=pipe.mc.unet.context_dim, n_layer=4,
                              device=pipe.device)
    else:
        from .models.encoders import TinyTextEncoder
        enc = TinyTextEncoder(context_dim=pipe.mc.unet.context_dim, device=pipe.device)
    return enc.encode(prompts), enc.encode([""] * n)


def main(argv=None) -> Dict[str, Any]:
    """Run the requested phase(s); returns the run and image directories."""
    parser = get_parser()
    args = parser.parse_args(argv)
    if args.clear_caches_every is not None:
        parser.error("--clear_caches_every drops compiled XLA programs between "
                     "reconstruction groups; the port compiles none, so it has "
                     "no counterpart (calib/recon.py)")
    import torch
    from .pipelines.latent import LDMPipeline, imagenet_labels, task_config
    from .utils.run import dump_config, seed_everything, setup_run_dir

    overrides = {k: v for k, v in vars(args).items()
                 if k in ("custom_steps", "eta", "scale", "n_samples",
                          "batch_size", "calib_num_samples", "batch_samples",
                          "lamda", "iters", "lr_w", "lr_a", "add_loss",
                          "cache_dtype", "recon_group_size", "recon_group_window")
                 and v is not None}
    if args.capture_budget_bytes is not None:
        overrides["capture_budget_bytes"] = int(args.capture_budget_bytes)
    overrides.update(weight_bit=args.weight_bit, act_bit=args.act_bit,
                     sm_abit=args.sm_abit, a_sym=args.a_sym, split=args.split,
                     seed=args.seed, ckpt_path=args.resume)
    if args.dpm:
        overrides["sampler"] = "dpm"
    cfg = task_config(args.task, **overrides)

    logdir = args.logdir or f"result/{args.task}"
    run_dir = setup_run_dir(logdir)
    log = logging.getLogger(args.task)
    seed_everything(args.seed)
    dump_config(cfg, run_dir)

    pipe = LDMPipeline(cfg, device=args.device)
    if args.serve == "auto":
        from .ops.serving_policy import preferred_export_kind
        args.serve = preferred_export_kind(pipe.mc.unet.use_spatial_transformer)
        log.info("serve=auto -> %s (architecture-family policy)", args.serve)

    context = uncond = None
    n = max(cfg.batch_samples, cfg.calib_num_samples)
    if args.task == "imagenet":
        labels, unc = imagenet_labels(n, args.seed)
        context = pipe.ld.get_learned_conditioning(labels)
        uncond = pipe.ld.get_learned_conditioning(unc)
    elif args.task == "coco":
        context, uncond = build_coco_context(
            args, pipe, n, prompt_dir=os.path.join(run_dir, "image_prompts"))

    img_dir = os.path.join(run_dir, "img")
    progress = lambda name, loss: log.info("recon %s loss %.5f", name, loss)
    result = {"run_dir": run_dir, "img_dir": img_dir}

    def save_preview_grid():
        """grid-0000.png of the first saved images, watermarked for the
        imagenet and coco tasks."""
        if args.skip_grid or not os.path.isdir(img_dir):
            return
        from .data.datasets import iter_image_folder
        from .eval.io import save_grid
        first = next(iter_image_folder(img_dir, batch_size=64), None)
        if first is None:
            return
        wm = "StableDiffusionV1" if args.task in ("imagenet", "coco") else None
        save_grid(first, os.path.join(run_dir, "grid-0000.png"), nrow=args.n_rows,
                  watermark=wm)
        log.info("grid preview saved to %s/grid-0000.png", run_dir)

    def export_bundle():
        if args.export_bundle:
            from .api import save_bundle
            stats = save_bundle(pipe.ld.unet, pipe.qc, args.export_bundle)
            log.info("bundle %s: %.1f MB, %.1fx smaller than fp32",
                     args.export_bundle, stats["bundle_bytes"] / 1e6,
                     stats["compression"])

    if args.phase == "all":
        pipe.run(out_dir=img_dir, context=context, uncond=uncond,
                 progress=progress, serve=args.serve)
        export_bundle()
        save_preview_grid()
        log.info("done; images in %s", img_dir)
        return result

    # one phase a process, the state handed over in state_dir
    from .utils.checkpointing import load_quant_state, save_quant_state
    state_dir = args.state_dir or os.path.join(logdir, "state")
    os.makedirs(state_dir, exist_ok=True)
    qs_path = os.path.join(state_dir, "quant_state")
    cali_path = os.path.join(state_dir, "cali.npz")

    if args.phase == "calib":
        sel = pipe.tdac_calibration(context, uncond)
        cali = pipe.build_cali_data(sel, context, uncond)
        pipe.calibrate(cali)
        save_quant_state(qs_path, pipe.ld.unet)
        np.savez(cali_path, **{f"a{i}": a.cpu().numpy() for i, a in enumerate(cali)})
        log.info("phase=calib complete; state in %s", state_dir)
        return result

    if not (args.phase == "sample" and args.bundle):
        load_quant_state(qs_path, pipe.ld.unet)
    if args.phase == "recon":
        data = np.load(cali_path)
        cali = tuple(torch.from_numpy(data[k]).to(pipe.device)
                     for k in sorted(data.files))
        pipe.reconstruct(cali, progress=progress)
        save_quant_state(qs_path, pipe.ld.unet)
        log.info("phase=recon complete; state in %s", state_dir)
        return result

    if args.bundle:
        from .api import load_bundle
        unet, mode = load_bundle(args.bundle, device=pipe.device)
        log.info("serving UNet from bundle %s", args.bundle)
    else:
        unet, mode = pipe.serving_variables(serve=args.serve)
        export_bundle()
    pipe.sample_fid(unet, out_dir=img_dir, mode=mode,
                    context_fn=pipe.make_context_fn(context, uncond))
    save_preview_grid()
    log.info("done; images in %s", img_dir)
    return result


if __name__ == "__main__":
    main()
