"""End-metric gate for the grouped-reconstruction deviations (port of
``scripts/gate_recon_deviations.py``, the same flags; ``--cpu`` is
``--device cpu``).

The shipped reconstruction defaults deviate from the reference's strictly
sequential walk in three ways: grouped targets share pre-group captures
(``group_size=4``), activation caches are stored in bf16, and captures over
the budget cap the calibration rows.  The structural gates (rounding-mask
agreement, fixed-capture exactness) cannot see their accumulated effect on
sample quality, so this entry point measures it end to end on a mid-size
random-weights DDPM (:func:`arch`, W4A8):

  A (reference-exact): ``group_size=1``, float32 caches, no row cap
  B (shipped):         ``group_size=4`` and window 1, bf16 caches, and a
                       budget that splits the groups and puts the large
                       early captures under the row cap (a multiple of the
                       capture batch, which is all rows by default, so the
                       cap keeps them all, in the JAX script as here)

Both start from the same calibrated state and sample ``--n`` images with
the same noise; the gate compares the FID InceptionV3's pool3 features on
random weights (self-consistency, not ImageNet FID): the standardized
Fréchet distances between the populations (``fid_A_vs_B``, each against
the FP samples) and the paired per-sample distances.  PASS when A against
B is a small fraction of A against FP.

    python -m eda_dm_tpu_torch.gate_recon_deviations [--iters 1000] [--n 256]

Random draws come from ``torch.Generator``s seeded as the JAX script's
keys are (0: the weights; 1: the calibration set and the sampling noise;
2: reconstruction), so the populations are the port's own, not JAX's.
The JAX script's ``clear_caches_every`` is an XLA-only knob that the
port's ``reconstruct`` does not take; it is dropped.  ``--dump`` defaults
to ``result/gate_recon_dump.npz`` beside the other run outputs.  Without
``--device cpu`` and without a card the entry point raises.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

MAIN_KEY = 2          # the A and B arms' reconstruction seed


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--n", type=int, default=256, help="images per arm")
    ap.add_argument("--calib", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' runs on the host (default: the card)")
    ap.add_argument("--dump", default="result/gate_recon_dump.npz",
                    help="save the three feature populations here so the "
                         "metric can be recomputed without re-running recon")
    ap.add_argument("--from-dump", default=None,
                    help="recompute metrics from a saved --dump npz only")
    ap.add_argument("--control-seed", type=int, default=None,
                    help="run only a reference-exact arm with this recon "
                         "seed and compare (paired) against the arms in "
                         "--dump: recon seed-noise control")
    ap.add_argument("--with-control", type=int, default=None,
                    help="after the main A/B/FP run, also run the "
                         "seed-control arm (reference-exact, this seed) in "
                         "the same process; control prints after the main "
                         "metrics")
    return ap


def arch():
    """The mid-size arch: CIFAR's levels at half width, 32² pixels."""
    from .models.ddpm_unet import DDPMConfig
    return DDPMConfig(ch=64, ch_mult=(1, 2, 2), num_res_blocks=2,
                      attn_resolutions=(16,), resolution=32)


def build(calib: int, device, cfg=None):
    """(the calibrated W4A8 model, its calibration set, the sampling noise
    generator's seed-1 stream): random weights from seed 0, random inputs
    over the timestep range from seed 1 (TDAC is orthogonal to the
    deviations under test), CALIB_W then CALIB_A in batches of 64."""
    import torch
    from .calib.scale_init import set_act_quantize_params, set_weight_quantize_params
    from .models.ddpm_unet import DDPMUNet
    from .quant import QuantConfig
    from .utils.run import hard_sync
    cfg = cfg or arch()
    model = DDPMUNet(cfg, QuantConfig(weight_bit=4, act_bit=8), device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f}M params", flush=True)
    g = torch.Generator().manual_seed(1)
    res = cfg.resolution
    cali = (torch.randn(calib, res, res, cfg.in_channels, generator=g).to(device),
            (torch.rand(calib, generator=g) * 999.0).to(device))
    t0 = time.perf_counter()
    set_weight_quantize_params(model, cali, device=device)
    set_act_quantize_params(model, cali, batch_size=64, device=device)
    hard_sync()
    print(f"scale init: {time.perf_counter() - t0:.0f}s", flush=True)
    return model, cali, g


def arm_b_budget(calib: int, cfg=None) -> int:
    """Arm B's capture budget: half a rough per-member floor, at least
    64 MB, under which the large early captures take the row cap."""
    cfg = cfg or arch()
    per_member = (calib * cfg.resolution * cfg.resolution * cfg.ch * 4) * 6
    return max(per_member // 2, 64_000_000)


def run_recon(model, cali, iters: int, tag: str, group_size: int, window: int,
              cache_dtype: Optional[str], budget: int, key: int = MAIN_KEY):
    """A reconstructed copy of ``model`` over the whole plan, and its log
    (one dict a target, with the row cap its caches took)."""
    import torch
    from .calib.recon import ReconArgs, reconstruct
    from .models.ddpm_unet import ddpm_recon_plan
    from .utils.run import hard_sync
    t0 = time.perf_counter()
    out, log = copy.deepcopy(model), []
    ra = ReconArgs(iters=iters, batch_size=32, cache_dtype=cache_dtype,
                   capture_budget_bytes=budget)
    dev = cali[0].device
    reconstruct(out, cali, ddpm_recon_plan(out.cfg, out.qc), ra,
                torch.Generator(device=dev).manual_seed(key),   # the same seed for A and B
                group_size=group_size, group_window=window, log=log)
    hard_sync()
    print(f"recon[{tag}]: {time.perf_counter() - t0:.0f}s", flush=True)
    return out, log


def sample_noise(g, n: int, cfg=None):
    """The x_T of every image, shared by the populations (index i has the
    same noise in each)."""
    import torch
    cfg = cfg or arch()
    return torch.randn(n, cfg.resolution, cfg.resolution, cfg.in_channels, generator=g)


def sample_population(model, mode, x_T, steps: int) -> np.ndarray:
    """``steps`` quad-skip DDIM steps at eta 0 from ``x_T`` in batches of
    64, images in [0, 1]."""
    import torch
    from .samplers.ddim import generalized_steps
    from .samplers.schedules import get_beta_schedule, skip_sequence
    from .utils.run import hard_sync
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=1000)
    seq = skip_sequence("quad", steps, 1000)
    dev = next(model.parameters()).device
    n = x_T.shape[0]
    bs = min(64, n)
    outs = []
    for i in range(n // bs):
        img = generalized_steps(x_T[i * bs:(i + 1) * bs], seq,
                                lambda a, b: model(a, b, mode), betas, eta=0.0, device=dev)
        hard_sync()
        outs.append(torch.clamp((img + 1.0) / 2.0, 0.0, 1.0).cpu().numpy())
    return np.concatenate(outs)


def feats(ext, imgs: np.ndarray) -> np.ndarray:
    return np.concatenate([ext.pool3(imgs[i:i + 32]) for i in range(0, len(imgs), 32)])


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Returns ``{"metrics": ..., "control": ..., "arm_b_row_caps": ...}``
    (what the run printed as JSON, and the row cap of each of arm B's
    targets over the budget)."""
    ap = get_parser()
    args = ap.parse_args(argv)
    # The main A/B arms reconstruct with seed 2; a control arm with the same
    # seed would be identical to A (d_AA' == 0) and spuriously FAIL the gate.
    for flag, val in (("--with-control", args.with_control),
                      ("--control-seed", args.control_seed)):
        if val == MAIN_KEY:
            ap.error(f"{flag}={MAIN_KEY} collides with the main A arm's recon key "
                     "(run_recon key=2); pick any other key")
    if args.from_dump:
        d = np.load(args.from_dump)
        m = _metrics(d["f_f"], d["f_a"], d["f_b"], int(d["iters"]), int(d["n"]))
        print(json.dumps(m), flush=True)
        return {"metrics": m}

    from .device import resolve_device
    from .eval.inception import InceptionExtractor
    from .quant import FP, WAQ
    device = resolve_device(args.device)
    model, cali, g = build(args.calib, device)
    x_T = sample_noise(g, args.n).to(device)
    ext = InceptionExtractor(device=device)         # random-init: self-consistency
    population = lambda m, mode: feats(ext, sample_population(m, mode, x_T, args.steps))

    if args.control_seed is not None:
        # A′: the reference-exact config with another seed: recon's own
        # stochasticity, against which the main run's paired d_AB is read
        # (needs a prior run's --dump: the same calibration and noise)
        v_c, _ = run_recon(model, cali, args.iters, f"A' seed{args.control_seed}", 1, 0,
                           None, 10 ** 18, key=args.control_seed)
        t0 = time.perf_counter()
        f_c = population(v_c, WAQ)
        print(f"sampling+feats 1x{args.n}: {time.perf_counter() - t0:.0f}s", flush=True)
        d = np.load(args.dump)
        np.savez_compressed(args.dump.replace(".npz", "_seedctl.npz"), f_c=f_c,
                            seed=args.control_seed)
        c = _control_metrics(d["f_f"], d["f_a"], d["f_b"], f_c, args.iters, args.n)
        print(json.dumps(c), flush=True)
        return {"control": c}

    # A: reference-exact semantics; B: every shipped deviation at once
    v_a, _ = run_recon(model, cali, args.iters, "A ref-exact", 1, 0, None, 10 ** 18)
    v_b, log_b = run_recon(model, cali, args.iters, "B shipped", 4, 1, "bfloat16",
                           arm_b_budget(args.calib))
    caps = [r["row_cap"] for r in log_b if r["row_cap"] is not None]
    print(f"recon[B shipped]: {len(caps)} of {len(log_b)} targets over the budget, "
          f"row cap {min(caps, default=None)} of {args.calib} rows (the cap is a "
          f"multiple of the capture batch, all rows by default)", flush=True)

    t0 = time.perf_counter()
    f_f = population(model, FP)                 # the quant state is unused in FP
    f_a = population(v_a, WAQ)
    f_b = population(v_b, WAQ)
    print(f"sampling+feats 3x{args.n}: {time.perf_counter() - t0:.0f}s", flush=True)
    if args.dump:
        os.makedirs(os.path.dirname(args.dump) or ".", exist_ok=True)
        np.savez_compressed(args.dump, f_f=f_f, f_a=f_a, f_b=f_b, iters=args.iters,
                            n=args.n)
        print(f"features dumped to {args.dump}", flush=True)
    out = {"metrics": _metrics(f_f, f_a, f_b, args.iters, args.n), "arm_b_row_caps": caps}
    print(json.dumps(out["metrics"]), flush=True)

    if args.with_control is not None:
        v_c, _ = run_recon(model, cali, args.iters, f"A' seed{args.with_control}", 1, 0,
                           None, 10 ** 18, key=args.with_control)
        f_c = population(v_c, WAQ)
        if args.dump:
            np.savez_compressed(args.dump.replace(".npz", "_seedctl.npz"), f_c=f_c,
                                seed=args.with_control)
        out["control"] = _control_metrics(f_f, f_a, f_b, f_c, args.iters, args.n)
        print(json.dumps(out["control"]), flush=True)
    return out


def _control_metrics(f_f, f_a, f_b, f_c, iters, n):
    """Compare the deviation effect (A vs B) against recon's intrinsic
    seed noise (A vs A′, same reference-exact config, different optimizer
    key), both paired per-sample (shared xT per index).  The deviations
    are benign if d_AB is comparable to d_AA′ — i.e. grouping/bf16/row-cap
    moves samples no more than re-rolling the optimizer's minibatch/QDrop
    randomness does."""
    pool = np.concatenate([f_f, f_a, f_b, f_c]).astype(np.float64)
    mu, sd = pool.mean(0), np.maximum(pool.std(0), 1e-12)
    z = lambda f: (np.asarray(f, np.float64) - mu) / sd
    zf, za, zb, zc = z(f_f), z(f_a), z(f_b), z(f_c)
    d_ab = np.linalg.norm(za - zb, axis=1)
    d_ac = np.linalg.norm(za - zc, axis=1)
    d_af = np.linalg.norm(za - zf, axis=1)
    med = lambda v: float(np.median(v))
    ratio_dev_vs_seed = med(d_ab) / max(med(d_ac), 1e-12)
    if ratio_dev_vs_seed < 1.25:
        gate = "PASS"        # deviations within ~seed-noise of recon
    elif ratio_dev_vs_seed < 2.0 and med(d_ab) < med(d_af):
        gate = "WEAK-PASS"
    else:
        gate = "FAIL"
    return {
        "paired_d_AB_median": round(med(d_ab), 2),
        "paired_d_AseedA_median": round(med(d_ac), 2),
        "paired_d_AF_median": round(med(d_af), 2),
        "ratio_deviation_over_seednoise": round(ratio_dev_vs_seed, 4),
        "gate_seed_control": gate, "iters": iters, "n": n,
    }


def _metrics(f_f, f_a, f_b, iters, n):
    """Standardized-feature Frechet distances + gate verdict.

    Random-init InceptionV3 activations wash out with depth (~2e-4 mean
    magnitude, ~2.5% relative variation across images), so raw-feature
    Frechet distances all round to 0 and the covariances are numerically
    singular.  ``standardized_fid`` z-scores against the pooled population;
    the verdict here is a *ratio* (deviation A-vs-B against quantization
    gap A-vs-FP), which standardization preserves.
    """
    from .eval.metrics import standardized_fid

    pool = np.concatenate([f_f, f_a, f_b]).astype(np.float64)
    fid_ab = standardized_fid(f_a, f_b, pool)
    fid_af = standardized_fid(f_a, f_f, pool)
    fid_bf = standardized_fid(f_b, f_f, pool)
    # population split noise floor: A vs A's own halves
    fid_noise = standardized_fid(f_a[: len(f_a) // 2],
                                 f_a[len(f_a) // 2:], pool)
    # Paired per-sample analysis: the three populations share xT noise
    # per index, so per-sample feature distances measure each
    # perturbation's effect directly, with no population-estimation noise.
    # Population-level Frechet numbers at n=256/d=2048 are bias-dominated
    # (the split noise floor exceeds the cross-arm distances); the paired
    # statistics are the load-bearing result.  Normalizing by the
    # independent-pair floor (distance between different-noise samples of
    # the same arm — full chaotic decorrelation) gives scale-free effect
    # sizes.
    mu_p, sd_p = pool.mean(0), np.maximum(pool.std(0), 1e-12)
    z = lambda f: (np.asarray(f, np.float64) - mu_p) / sd_p
    zf, za, zb = z(f_f), z(f_a), z(f_b)
    d_ab = np.linalg.norm(za - zb, axis=1)
    d_af = np.linalg.norm(za - zf, axis=1)
    rng = np.random.default_rng(0)
    i = rng.permutation(len(za))
    j = (i + 1) % len(za)           # random different-noise partner
    floor = np.linalg.norm(za[i] - za[j], axis=1)
    med = lambda v: float(np.median(v))
    ratio = med(d_ab) / max(med(d_af), 1e-12)
    frac_less = float((d_ab < d_af).mean())

    if fid_af <= 2.0 * fid_noise and ratio > 1.0:
        gate = "INCONCLUSIVE"
    elif ratio < 0.5 and frac_less > 0.9:
        gate = "PASS"               # deviations ≪ quantization, per sample
    elif ratio < 1.0 and frac_less > 0.75:
        # smaller than quantization but not ≪: whether it sits inside
        # recon's intrinsic stochasticity is decided by the same-config
        # different-seed arm (--with-control)
        gate = "WEAK-PASS"
    else:
        gate = "FAIL"
    return {
        "fid_A_vs_B": round(fid_ab, 4),
        "fid_A_vs_FP": round(fid_af, 4),
        "fid_B_vs_FP": round(fid_bf, 4),
        "split_noise_floor": round(fid_noise, 4),
        "paired_d_AB_median": round(med(d_ab), 2),
        "paired_d_AF_median": round(med(d_af), 2),
        "indep_pair_floor_median": round(med(floor), 2),
        "paired_ratio_AB_over_AF": round(ratio, 4),
        "frac_samples_AB_less_AF": round(frac_less, 4),
        "feat_scale": round(float(np.abs(pool).mean()), 8),
        "feat_rel_spread": round(float((pool.std(0) /
                                        (np.abs(pool).mean(0) + 1e-12)).mean()),
                                 6),
        "gate": gate, "iters": iters, "n": n,
    }


if __name__ == "__main__":
    main()
