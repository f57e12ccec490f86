"""TDAC: temporal density and diversity aware calibration-set selection
(port of ``eda_dm_tpu/calib/tdac.py``).

Run the FP sampler once, recording every step's input x_t and the
mid-block attention input, score each timestep by feature-space density
and diversity, and draw per-timestep sample counts in proportion to the
blended score.  The O(T²) pairwise scores are two Gram matrices (the
per-position cosine sum is an inner product of position-normalized
features); the count repair runs on the host in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class TDACResult:
    calib_x: torch.Tensor     # (N, ...) selected latents
    calib_t: torch.Tensor     # (N,) model-time values (seq mapped)
    time_codes: np.ndarray    # (N,) selected step positions (0 = x_T)
    t_num: np.ndarray         # (T,) per-timestep counts
    density: np.ndarray       # (T,) raw density scores
    diversity: np.ndarray     # (T,) raw diversity scores


def _pair_scores(feats: torch.Tensor):
    """Pairwise MSE matrix and per-position cosine-similarity sums of
    feats (T, B, H, W, C): MSE over whole tensors; cosine over the channel
    axis per (b, h, w) position, summed over positions."""
    T = feats.shape[0]
    flat = feats.reshape(T, -1).float()
    k = flat.shape[1]
    sq = (flat * flat).sum(1)
    gram = flat @ flat.T
    mse = (sq[:, None] + sq[None, :] - 2.0 * gram) / k
    pos = feats.reshape(T, -1, feats.shape[-1]).float()            # (T, P, C)
    norm = torch.clamp(torch.linalg.vector_norm(pos, dim=-1, keepdim=True),
                       min=1e-6)
    unit = (pos / norm).reshape(T, -1)
    return mse, unit @ unit.T


def _normalize(v: np.ndarray) -> np.ndarray:
    rng = v.max() - v.min()
    return (v - v.min()) / (rng if rng > 0 else 1.0)


def timestep_counts(mse: np.ndarray, cos_sum: np.ndarray, num_positions: int,
                    lamda: float, calib_num_samples: int,
                    dense_r: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Blend density and diversity into per-timestep sample counts:
    density = #{j≠i : mse(i,j) ≤ dense_r}; diversity = Σ_{j≠i} Σ_pos
    (1 − cos); w = D̂ + λV̂; counts = round(prob·N), repaired to sum to N
    exactly (add to the largest counts, or take from the tail)."""
    T = mse.shape[0]
    off = ~np.eye(T, dtype=bool)
    density = ((mse <= dense_r) & off).sum(1).astype(np.float64)
    diversity = np.where(off, num_positions - cos_sum, 0.0).sum(1)
    w = _normalize(density) + lamda * _normalize(diversity)
    prob = w / w.sum()
    t_num = np.round(prob * calib_num_samples).astype(np.int64)
    err = calib_num_samples - t_num.sum()
    if err >= 0:
        order = np.argsort(-t_num, kind="stable")
        t_num[order[:err]] += 1
    else:
        for i in reversed(range(T)):
            if err == 0:
                break
            if t_num[i] > 0:
                t_num[i] -= 1
                err += 1
    assert t_num.sum() == calib_num_samples
    return t_num, density, diversity


def select_calib_set(trajectory: torch.Tensor, feats: torch.Tensor, seq,
                     lamda: float, calib_num_samples: int, dense_r: float,
                     generator: Optional[torch.Generator] = None,
                     perm: Optional[np.ndarray] = None) -> TDACResult:
    """TDAC selection from a recorded trajectory (T, B, ...), index 0 =
    x_T, and the mid-block attention inputs feats (T, B, H, W, C).  Sample
    k takes position k % B of the trajectory at its drawn timestep; the
    step positions map to model times through ``seq`` reversed.  The draw
    is ``perm`` when given (a permutation of the N samples), else
    ``torch.randperm`` from ``generator`` (a CPU generator)."""
    T, B = trajectory.shape[:2]
    mse, cos_sum = _pair_scores(feats)
    num_positions = int(np.prod(feats.shape[1:-1]))          # B*H*W
    t_num, density, diversity = timestep_counts(
        mse.cpu().numpy(), cos_sum.cpu().numpy(),
        num_positions, lamda, calib_num_samples, dense_r)
    codes = np.repeat(np.arange(T), t_num)
    if perm is None:
        perm = torch.randperm(codes.shape[0], generator=generator).numpy()
    codes = codes[np.asarray(perm)]
    pos = np.arange(calib_num_samples) % B
    dev = trajectory.device
    calib_x = trajectory[torch.from_numpy(codes).to(dev), torch.from_numpy(pos).to(dev)]
    seq = np.asarray(seq)
    calib_t = torch.from_numpy(seq[(len(seq) - 1) - codes].astype(np.float32)).to(dev)
    return TDACResult(calib_x=calib_x, calib_t=calib_t, time_codes=codes,
                      t_num=t_num, density=density, diversity=diversity)


# per-task dense_r defaults
DENSE_R = {"cifar": 3.0, "bedroom": 0.3, "church": 0.3, "imagenet": 3.0,
           "coco": 0.3}


def plot_t_num(t_num: np.ndarray, path: str) -> None:
    """Diagnostic per-timestep histogram; nothing without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    f = plt.figure()
    plt.plot(range(len(t_num)), t_num)
    f.savefig(path)
    plt.close(f)
