"""Score a sample set: FID, and IS and sFID on request (port of
``scripts/evaluate.py``).

    python -m eda_dm_tpu_torch.evaluate --gen_dir G --ref_dir R [--isc] [--sfid]
    python -m eda_dm_tpu_torch.evaluate --ref_dir R --ref_stats stats.npz
    python -m eda_dm_tpu_torch.evaluate --gen_dir G --ref_features stats.npz

Inputs, as in the JAX script: image directories (featurized batch by
batch with the FID InceptionV3 of ``eval/inception.py`` on the card), or
``.npz`` files (``features``, or ``mu`` + ``sigma`` on the reference
side); ``--ref_stats`` saves the reference set's statistics for reuse.
``--inception_weights pt_inception-2015-12-05-6726825d.pth`` gives real
scores; without it the Inception runs on random weights (a warning says
so), and the standardized FID and sFID (``eval/metrics.py::
standardized_fid``) are printed beside the raw ones.  IS (``--isc``)
reads the generated set's logits, sFID (``--sfid``) the ``feat768``
spatial features.  ``--device
cpu`` runs the Inception on the host (the JAX script's ``--cpu``);
without it and without a card the script raises.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np

from .data.datasets import iter_image_folder
from .eval.metrics import (FeatureStats, frechet_distance, inception_score,
                           spatial_fid, standardized_fid)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gen_dir", type=str, default=None,
                   help="directory of generated images")
    p.add_argument("--ref_dir", type=str, default=None,
                   help="directory of reference images")
    p.add_argument("--gen_features", type=str, default=None,
                   help=".npz with 'features' for the generated set")
    p.add_argument("--ref_features", type=str, default=None,
                   help=".npz with 'features' (or 'mu'+'sigma')")
    p.add_argument("--ref_stats", type=str, default=None,
                   help="write the ref set's FeatureStats here and exit")
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--probs", type=str, default=None,
                   help="optional .npz with 'probs' for Inception Score")
    p.add_argument("--isc", action="store_true",
                   help="also compute Inception Score of the generated set")
    p.add_argument("--sfid", action="store_true",
                   help="also compute spatial FID (feat768 head)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--size", type=int, default=None,
                   help="resize images on read (default: native size)")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs the Inception on the host (default: the card)")
    return p


def features_from_dir(path: str, extractor, batch_size: int, size=None,
                      probs: bool = False, timing: Optional[Dict[str, float]] = None):
    """(pool3, feat768, probs or None) of every image in ``path``.
    ``timing`` accumulates ``images`` and ``seconds`` of the extractor."""
    pool, spatial, prob_rows = [], [], []
    n = 0
    for batch in iter_image_folder(path, batch_size=batch_size, size=size):
        t0 = time.perf_counter()
        out = extractor(batch)
        if timing is not None:
            timing["seconds"] = timing.get("seconds", 0.0) + time.perf_counter() - t0
            timing["images"] = timing.get("images", 0) + batch.shape[0]
        pool.append(out["pool3"])
        spatial.append(out["feat768"])
        if probs:
            logits = out["logits"]
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            prob_rows.append(e / e.sum(axis=1, keepdims=True))
        n += batch.shape[0]
        if n and n % 5000 < batch_size:
            print(f"  {path}: {n} images featurized", flush=True)
    if not pool:
        raise SystemExit(f"no images found in {path}")
    return (np.concatenate(pool), np.concatenate(spatial),
            np.concatenate(prob_rows) if probs else None)


def main(argv=None) -> Dict[str, float]:
    """Run the scoring; returns what it printed (``fid``,
    ``fid_standardized``, ``sfid``, ``sfid_standardized``, ``is_mean``,
    ``is_std``), the extractor's ``images`` and ``seconds``, and the
    statistics' ``metric_seconds``."""
    args = get_parser().parse_args(argv)
    ext = None
    timing: Dict[str, float] = {}
    if args.gen_dir or args.ref_dir:
        from .eval.inception import InceptionExtractor
        ext = InceptionExtractor(args.inception_weights, device=args.device)
        if not args.inception_weights:
            print("[warn] random-init Inception: scores are relative / "
                  "self-consistency only", flush=True)

    gen_sp = ref_sp = gen_probs = None
    gen = ref = None
    if args.gen_dir:
        gen, gen_sp, gen_probs = features_from_dir(
            args.gen_dir, ext, args.batch_size, args.size, probs=args.isc, timing=timing)
    elif args.gen_features:
        gen = np.load(args.gen_features)["features"]

    s_ref = None
    if args.ref_dir:
        ref, ref_sp, _ = features_from_dir(args.ref_dir, ext, args.batch_size,
                                           args.size, timing=timing)
        s_ref = FeatureStats.from_features(ref)
    elif args.ref_features:
        d = np.load(args.ref_features)
        s_ref = (FeatureStats(mu=d["mu"], sigma=d["sigma"]) if "mu" in d
                 else FeatureStats.from_features(d["features"]))

    result: Dict[str, float] = dict(timing)
    t_metrics = time.perf_counter()
    if args.ref_stats:
        if s_ref is None:
            raise SystemExit("--ref_stats needs --ref_dir/--ref_features")
        np.savez(args.ref_stats, mu=s_ref.mu, sigma=s_ref.sigma)
        print(f"reference stats saved to {args.ref_stats}")
        if gen is None:
            return result

    if gen is None or s_ref is None:
        raise SystemExit("need a generated set and a reference set (dirs or features)")
    result["fid"] = frechet_distance(FeatureStats.from_features(gen), s_ref)
    print(f"FID: {result['fid']:.4f}")
    if ext is not None and ext.random_init and ref is not None:
        result["fid_standardized"] = standardized_fid(gen, ref)
        print(f"FID (standardized features): {result['fid_standardized']:.4f}")

    if args.sfid and gen_sp is not None and ref_sp is not None:
        result["sfid"] = spatial_fid(gen_sp, ref_sp)
        print(f"sFID: {result['sfid']:.4f}")
        if ext.random_init:
            result["sfid_standardized"] = standardized_fid(gen_sp, ref_sp)
            print(f"sFID (standardized features): {result['sfid_standardized']:.4f}")

    probs = gen_probs
    if args.probs:
        probs = np.load(args.probs)["probs"]
    if probs is not None:
        result["is_mean"], result["is_std"] = inception_score(probs)
        print(f"IS: {result['is_mean']:.4f} ± {result['is_std']:.4f}")
    result["metric_seconds"] = time.perf_counter() - t_metrics
    return result


if __name__ == "__main__":
    main()
