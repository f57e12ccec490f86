"""CLIP preprocessing (port of the pure part of ``eda_dm_tpu/eval/clip.py``).

The JAX package's ``CLIPScorer`` wraps ``transformers``' Flax CLIP towers
and needs CLIP's weights and tokenizer; neither the package nor the
weights are available to the port, so only the preprocessing is ported
here, and the cosine score is ``eval/metrics.py::clip_score``.
"""

from __future__ import annotations

import numpy as np
import torch

from .inception import resize_like_jax

# openai CLIP preprocessing constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """images (N, H, W, 3) in [0, 1] → CLIP pixel values (N, 3, size, size):
    a Keys cubic resize (a = −0.5, ``jax.image``'s "cubic", with its
    antialiasing) of the square image to ``size``, then the channel
    normalisation."""
    images = torch.as_tensor(images, dtype=torch.float32)
    if tuple(images.shape[1:3]) != (size, size):
        images = resize_like_jax(images, (size, size), "cubic")
    mean = torch.from_numpy(CLIP_MEAN).to(images.device)
    std = torch.from_numpy(CLIP_STD).to(images.device)
    return ((images - mean) / std).permute(0, 3, 1, 2)
