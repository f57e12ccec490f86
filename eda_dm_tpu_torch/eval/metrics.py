"""Quality metrics: FID, standardized FID, sFID, Inception Score, CLIP
score (port of ``eda_dm_tpu/eval/metrics.py``).

The statistics are numpy and scipy on the host, float64, the same
operations in the same order as the JAX package's, so both give the same
numbers on the same features.  The feature extractor is
``eval/inception.py::InceptionExtractor``, or any callable images →
features.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FeatureStats:
    mu: np.ndarray
    sigma: np.ndarray

    @staticmethod
    def from_features(feats: np.ndarray) -> "FeatureStats":
        feats = np.asarray(feats, np.float64)
        return FeatureStats(mu=feats.mean(0), sigma=np.cov(feats, rowvar=False))


def frechet_distance(s1: FeatureStats, s2: FeatureStats, eps: float = 1e-6) -> float:
    """The Fréchet distance between two Gaussians (pytorch-fid's
    ``calculate_frechet_distance``: ``sqrtm`` of the product, retried with
    ``eps`` on the diagonals where it is not finite, its real part).
    ``sqrtm`` is called without ``disp``, which SciPy 1.18 removed; the
    value is the one ``disp=False`` returns beside its error estimate."""
    from scipy import linalg
    diff = s1.mu - s2.mu
    covmean = linalg.sqrtm(s1.sigma @ s2.sigma)
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.sigma.shape[0]) * eps
        covmean = linalg.sqrtm((s1.sigma + offset) @ (s2.sigma + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1.sigma) + np.trace(s2.sigma)
                 - 2.0 * np.trace(covmean))


def fid_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    return frechet_distance(FeatureStats.from_features(f1),
                            FeatureStats.from_features(f2))


def standardized_fid(f1: np.ndarray, f2: np.ndarray, pool: Optional[np.ndarray] = None,
                     eps: float = 1e-12) -> float:
    """The Fréchet distance of per-dimension z-scored features, standardized
    against ``pool`` (default: both sets).  For a random-init extractor,
    whose raw features all but collapse (tiny scale, nearly singular
    covariances): read its values as ratios only; with pretrained weights
    use :func:`fid_from_features`."""
    if pool is None:
        pool = np.concatenate([f1, f2])
    pool = np.asarray(pool, np.float64)
    mu, sd = pool.mean(0), np.maximum(pool.std(0), eps)
    return fid_from_features((np.asarray(f1, np.float64) - mu) / sd,
                             (np.asarray(f2, np.float64) - mu) / sd)


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS from class-probability rows (torch-fidelity's: exp(E_x KL(p(y|x) ||
    p(y))), mean and standard deviation over ``splits``)."""
    probs = np.asarray(probs, np.float64)
    scores = []
    for part in np.array_split(probs, splits):
        py = part.mean(0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-12) - np.log(py + 1e-12)), axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def spatial_fid(f1: np.ndarray, f2: np.ndarray) -> float:
    """sFID: the Fréchet distance of the spatial (``feat768``) features of
    both sets."""
    return fid_from_features(f1, f2)


def clip_score(image_features: np.ndarray, text_features: np.ndarray,
               scale: float = 100.0) -> float:
    """Mean scaled cosine similarity of matched image and text embeddings
    (clip-score's)."""
    im = image_features / np.linalg.norm(image_features, axis=1, keepdims=True)
    tx = text_features / np.linalg.norm(text_features, axis=1, keepdims=True)
    return float(scale * np.mean(np.sum(im * tx, axis=1)))


def load_inception_extractor(weights_path: Optional[str] = None, device=None
                             ) -> Callable[[np.ndarray], np.ndarray]:
    """The FID InceptionV3's ``pool3`` extractor on ``device`` (the card
    unless the caller passes ``"cpu"``); ``weights_path`` the local
    ``pt_inception-2015-12-05-6726825d.pth``, ``None`` random weights."""
    from .inception import InceptionExtractor
    return InceptionExtractor(weights_path, device=device).pool3


def center_resize_image(img: np.ndarray, size: int = 512) -> np.ndarray:
    """Center-crop to a square, then PIL's bicubic resize to ``size``: the
    COCO reference set's preparation."""
    h, w = img.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    img = img[top:top + s, left:left + s]
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC))
