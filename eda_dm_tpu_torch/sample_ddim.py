"""CIFAR-10 DDIM PTQ: quantize → TDAC calibration → scale init → AdaRound +
FBR reconstruction → the FID set as PNGs (port of
``scripts/sample_diffusion_ddim.py``, the same flags).

    python -m eda_dm_tpu_torch.sample_ddim --ckpt model-790000.ckpt --serve int8

``--ckpt``: a reference DDPM checkpoint (``ema_cifar10``), converted by
``models/convert.py``; without it the UNet has random weights from
``--seed``.  ``--serve``: the sampling path (``waq`` fake-quant, ``fp``,
or an export: ``int8`` through the card's int8 kernels, ``bf16``,
``fold``).  ``--bundle`` serves a saved deployment bundle and skips the
calibration; ``--export_bundle`` saves one after it.  PNGs go to
``<logdir>/samples/<timestamp>/img`` through ``sample_fid``.  ``--device
cpu`` runs on the host; without it and without a card the script raises.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Any, Dict


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--logdir", type=str, default="result/cifar")
    p.add_argument("--ckpt", type=str, default=None,
                   help="path to the torch ema_cifar10 checkpoint")
    p.add_argument("--sample_type", type=str, default="generalized")
    p.add_argument("--skip_type", type=str, default="quad")
    p.add_argument("--timesteps", type=int, default=100)
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--ptq", action="store_true", default=True)
    p.add_argument("--no-ptq", dest="ptq", action="store_false")
    p.add_argument("--quant_act", action="store_true", default=True)
    p.add_argument("--weight_bit", type=int, default=4)
    p.add_argument("--act_bit", type=int, default=8)
    p.add_argument("--max_images", type=int, default=50000)
    p.add_argument("--a_sym", action="store_true", default=False)
    p.add_argument("--sm_abit", type=int, default=8)
    p.add_argument("--split", action="store_true", default=True)
    p.add_argument("--calib_num_samples", type=int, default=1024)
    p.add_argument("--batch_samples", type=int, default=1024)
    p.add_argument("--recon", action="store_true", default=True)
    p.add_argument("--no-recon", dest="recon", action="store_false")
    p.add_argument("--iters", type=int, default=5000)
    p.add_argument("--add_loss", type=float, default=0.8)
    p.add_argument("--lr_w", type=float, default=5e-1)
    p.add_argument("--lr_a", type=float, default=5e-4)
    p.add_argument("--lamda", type=float, default=1.2)
    p.add_argument("--sample_batch_size", type=int, default=500)
    p.add_argument("--resume_dir", type=str, default=None,
                   help="checkpoint dir to resume block reconstruction")
    p.add_argument("--serve", default="waq",
                   choices=["waq", "fp", "bf16", "int8", "fold"],
                   help="sampling path: fake-quant, FP32 baseline, or a "
                        "deployment export (int8 = the card's int8 kernels)")
    p.add_argument("--export_bundle", type=str, default=None,
                   help="after PTQ, save the packed-int4 deployment "
                        "artifact (codes 2/byte + scales) to this path")
    p.add_argument("--bundle", type=str, default=None,
                   help="serve from a saved deployment bundle (skips "
                        "calibration/reconstruction entirely)")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs on the host (default: the card)")
    return p


def main(argv=None) -> Dict[str, Any]:
    """Run the flow; returns the run and image directories, the number of
    images and the seconds of each phase (``load``, ``calibrate``,
    ``sample``: the sampling with its PNG writes)."""
    args = get_parser().parse_args(argv)
    from .eval.io import png_writer
    from .pipelines.cifar import CifarConfig, CifarPipeline
    from .utils.run import PhaseTimer, dump_config, seed_everything, setup_run_dir

    run_dir = setup_run_dir(args.logdir)
    log = logging.getLogger("cifar")
    seed_everything(args.seed)
    cfg = CifarConfig(
        timesteps=args.timesteps, skip_type=args.skip_type, eta=args.eta,
        sample_type=args.sample_type, ptq=args.ptq,
        weight_bit=args.weight_bit, act_bit=args.act_bit,
        sm_abit=args.sm_abit, quant_act=args.quant_act, a_sym=args.a_sym,
        split=args.split, calib_num_samples=args.calib_num_samples,
        batch_samples=args.batch_samples, lamda=args.lamda, recon=args.recon,
        iters=args.iters, lr_w=args.lr_w, lr_a=args.lr_a,
        add_loss=args.add_loss, max_images=args.max_images,
        sample_batch_size=args.sample_batch_size, seed=args.seed,
        ckpt_path=args.ckpt)
    dump_config(cfg, run_dir)

    pipe = CifarPipeline(cfg, device=args.device)
    img_dir = os.path.join(run_dir, "img")
    progress = lambda name, loss: log.info("recon %s loss %.5f", name, loss)
    timer = PhaseTimer()
    if args.bundle:
        from .api import load_bundle
        with timer.phase("load"):
            serving, mode = load_bundle(args.bundle, device=pipe.device)
        log.info("serving from bundle %s (skipping PTQ)", args.bundle)
    else:
        with timer.phase("load"):
            model = pipe.init_variables()
        with timer.phase("calibrate"):
            if cfg.ptq:
                calib_x, calib_t, _ = pipe.tdac_calibration(model)
                pipe.calibrate(model, (calib_x, calib_t))
                if cfg.recon:
                    pipe.reconstruct(model, (calib_x, calib_t), progress=progress,
                                     checkpoint_dir=args.resume_dir)
        serving, mode = pipe.serving_variables(model, args.serve)
        if args.export_bundle:
            from .api import save_bundle
            stats = save_bundle(model, pipe.qc, args.export_bundle)
            log.info("bundle %s: %.1f MB, %.1fx smaller than fp32",
                     args.export_bundle, stats["bundle_bytes"] / 1e6,
                     stats["compression"])
    with timer.phase("sample"):           # each batch is read back to the host
        pipe.sample_fid(serving, out_dir=img_dir, mode=mode)
    n = min(cfg.max_images, len(os.listdir(img_dir)))
    log.info("done; %d images in %s (%s)", n, img_dir,
             ", ".join(f"{k} {v:.2f} s" for k, v in timer.summary().items()))
    return {"run_dir": run_dir, "img_dir": img_dir, "images": n,
            "writer": png_writer(), "seconds": timer.summary()}


if __name__ == "__main__":
    main()
