"""CLIP score (port of ``eda_dm_tpu/eval/clip.py``): ``clip_preprocess``
and ``CLIPScorer``, image and text features from the port's own CLIP
towers (``models/clip.py``) and tokenizer (``models/clip_tokenizer.py``),
loaded from a local checkout or injected.  The cosine score is
``eval/metrics.py::clip_score``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import model_device
from .inception import resize_like_jax
from .metrics import clip_score

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


class CLIPScorer:
    """Image-tower and text-tower features and their CLIP score.

    ``model_path``: a local checkout of an openai CLIP checkpoint
    (``config.json``, ``model.safetensors`` or ``pytorch_model.bin``,
    ``vocab.json``, ``merges.txt``), loaded on ``device`` (the card unless
    the caller passes ``"cpu"``); without one it raises ``RuntimeError``.
    Or an injected ``(model, tokenizer)``: a ``models.clip.CLIPModel`` with
    both towers and a tokenizer called as ``transformers``' is, the model
    on ``device``.  Features come back as float32 numpy arrays."""

    def __init__(self, model_path: Optional[str] = None, model=None, tokenizer=None,
                 max_length: int = 77, device=None):
        if model is None:
            from ..models.clip import load_clip_checkout
            model, tokenizer = load_clip_checkout(model_path, device, who="CLIPScorer")
        self.device = model_device(model, device)
        self.model, self.tokenizer, self.max_length = model, tokenizer, max_length

    def image_features(self, images) -> np.ndarray:
        """images (N, H, W, 3) in [0, 1] → (N, projection)."""
        px = clip_preprocess(torch.as_tensor(images, dtype=torch.float32).to(self.device))
        return self.model.get_image_features(px).cpu().numpy()

    def text_features(self, prompts: Optional[Sequence[str]] = None, input_ids=None,
                      attention_mask=None) -> np.ndarray:
        """Prompts (tokenized to ``max_length``) or ``input_ids`` (with
        ``attention_mask``, all ones where absent) → (B, projection)."""
        if input_ids is None:
            batch = self.tokenizer(list(prompts), truncation=True, max_length=self.max_length,
                                   padding="max_length", return_tensors="np")
            input_ids, attention_mask = batch["input_ids"], batch["attention_mask"]
        if attention_mask is None:
            attention_mask = np.ones_like(np.asarray(input_ids))
        return self.model.get_text_features(input_ids, attention_mask).cpu().numpy()

    def score(self, images, prompts: Optional[Sequence[str]] = None, input_ids=None) -> float:
        """Mean 100·cosine(image, text) over matched pairs (clip-score's)."""
        return clip_score(self.image_features(images),
                          self.text_features(prompts, input_ids=input_ids))
