"""FID InceptionV3 (pool3 + logits), the feature extractor behind FID, sFID
and IS (port of ``eda_dm_tpu/eval/inception.py``).

The network is the TF-slim "pt_inception-2015-12-05" graph that
pytorch-fid and torch-fidelity score with: a torchvision InceptionV3 with
1008 logits and the FID variants of its pools (the 3×3 average pools inside
the A, C and E blocks exclude the padding from the divisor, and the last E
block, ``Mixed_7c``, takes a 3×3/1 max pool instead).  Inference only: the
BatchNorms are folded into the conv kernels at load (``fold_bn``), so a
layer is conv + bias + ReLU.

Outputs: ``pool3`` (N, 2048) for FID, ``logits`` (N, 1008) for IS, and the
spatial means of the pytorch-fid block boundaries ``feat64``, ``feat192``
and ``feat768`` (sFID reads ``feat768``).

The public functions keep the JAX package's NHWC layout; inside, the
network runs NCHW in float32 through ``F.conv2d``, as the JAX package
computes it through ``lax.conv`` outside any Pallas kernel.  TF32 stays off
(``InceptionExtractor`` holds ``tf32_off`` around the forward): features in
TF32 or bf16 would move the scores.  Parameters keep the flax names and
layouts (``Mixed_5b.branch1x1.conv.kernel`` HWIO, ``fc.kernel`` (2048,
1008)), so ``models/bridge.py`` loads the converted tree.

``preprocess`` resizes as ``jax.image.resize(..., "bilinear")`` does, with
its default antialiasing (``resize_like_jax``): downscaling widens the
triangle kernel by the inverse scale, drops the taps outside the image and
renormalises, which ``F.interpolate`` does not do.

Weights: the ``pt_inception-2015-12-05-6726825d.pth`` state dict from a
local path (nothing is downloaded); without it the network runs on random
weights drawn from a seeded generator, for relative comparisons only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..nn.layers import lecun_normal_
from ..ops.int8_einsum import tf32_off

BN_EPS = 1e-3                     # torchvision BasicConv2d BatchNorm eps


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: explicit (symmetric) padding and strides."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: int = 1, padding=(0, 0)):
        super().__init__()
        self.stride, self.padding = stride, tuple(padding)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class BasicConv2d(nn.Module):
    """conv (its BatchNorm folded in at load) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=(0, 0)):
        super().__init__()
        if isinstance(kernel, int):
            kernel = (kernel, kernel)
        if isinstance(padding, int):
            padding = (padding, padding)
        self.conv = Conv(cin, cout, kernel, stride, padding)

    def forward(self, x):
        return F.relu(self.conv(x))


def _avg_pool_3x3(x):
    """3×3/1 average pool, padding 1, the padding left out of the divisor:
    the FID variant of the in-block pools."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool_3x3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_3x3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    """``use_max_pool``: the ``Mixed_7c`` variant, whose branch pool is a
    3×3/1 max pool in place of the padded average pool."""

    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = F.max_pool2d(x, 3, 1, 1) if self.use_max_pool else _avg_pool_3x3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], dim=1)


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel (in, out)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class FIDInceptionV3(nn.Module):
    """The whole pt_inception-2015-12-05 graph.  ``forward`` takes the
    network input (N, 299, 299, 3) in [-1, 1] (``preprocess``) and returns
    ``pool3`` (N, 2048), ``logits`` (N, 1008), ``feat64``, ``feat192`` and
    ``feat768``."""

    def __init__(self, num_logits: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.fc = Dense(2048, num_logits)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        feat64 = x
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        feat192 = x
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        feat768 = x
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool3 = x.mean(dim=(2, 3))                       # adaptive average → 1×1
        return {"pool3": pool3, "logits": self.fc(pool3),
                "feat64": feat64.mean(dim=(2, 3)),
                "feat192": feat192.mean(dim=(2, 3)),
                "feat768": feat768.mean(dim=(2, 3))}


# --------------------------------------------------------------------------
# resizing as jax.image.resize does it
# --------------------------------------------------------------------------

def _triangle(x):
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def _keys_cubic(x):
    """Keys' cubic kernel at a = −0.5 (``jax.image``'s "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


RESIZE_KERNELS: Dict[str, Callable] = {"bilinear": _triangle, "linear": _triangle,
                                       "cubic": _keys_cubic, "bicubic": _keys_cubic}


def resize_weight_mat(input_size: int, output_size: int, method: str = "bilinear",
                      antialias: bool = True, device=None) -> torch.Tensor:
    """The (input_size, output_size) float32 weights of one axis, computed
    as ``jax.image``'s ``compute_weight_mat`` computes them (translation 0):
    the kernel widened by the inverse scale when downscaling (antialias),
    each output's weights renormalised to sum to one, and zero where the
    sample falls outside the input."""
    kernel = RESIZE_KERNELS[method]
    scale = output_size / input_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = dict(dtype=torch.float32, device=device)
    inv = torch.tensor(inv_scale, **f32)
    sample_f = (torch.arange(output_size, **f32) + 0.5) * inv - 0.5
    x = (sample_f[None, :] - torch.arange(input_size, **f32)[:, None]).abs() \
        / torch.tensor(kernel_scale, **f32)
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_like_jax(images: torch.Tensor, size: Tuple[int, int],
                    method: str = "bilinear", antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(images, (N, H', W', C), method)`` of NHWC float32
    images: the two separable weight matrices of ``resize_weight_mat``
    applied as two products (height, then width), in full float32."""
    n, h, w, c = images.shape
    out_h, out_w = size
    x = images.float()
    with tf32_off():
        if h != out_h:
            wh = resize_weight_mat(h, out_h, method, antialias, x.device)
            x = torch.einsum("nhwc,hp->npwc", x, wh)
        if w != out_w:
            ww = resize_weight_mat(w, out_w, method, antialias, x.device)
            x = torch.einsum("npwc,wq->npqc", x, ww)
    return x


def preprocess(images: torch.Tensor, resize: bool = True) -> torch.Tensor:
    """images (N, H, W, 3) in [0, 1] → the network input: resized to 299²
    as ``jax.image.resize(..., "bilinear")`` resizes, then scaled to
    [-1, 1]."""
    if resize and tuple(images.shape[1:3]) != (299, 299):
        images = resize_like_jax(images, (299, 299), "bilinear")
    return images * 2.0 - 1.0


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

def fold_bn(conv_w: np.ndarray, gamma, beta, mean, var, eps: float = BN_EPS):
    """Fold an inference BatchNorm into the conv before it.  ``conv_w`` is
    OIHW (torch layout); returns (HWIO kernel, bias), float32."""
    scale = gamma / np.sqrt(var + eps)
    w = conv_w * scale[:, None, None, None]
    b = beta - mean * scale
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32), b.astype(np.float32)


def load_fid_inception_params(path_or_state) -> Dict[str, Any]:
    """The pt_inception-2015-12-05 state dict (a file path, loaded with
    ``torch.load(weights_only=True)``, or a mapping of tensors or arrays)
    → the ``FIDInceptionV3`` params tree with the BatchNorms folded
    (``num_batches_tracked`` ignored)."""
    if isinstance(path_or_state, str):
        state = torch.load(path_or_state, map_location="cpu", weights_only=True)
    else:
        state = path_or_state
    state = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)) for k, v in state.items()}
    params: Dict[str, Any] = {}

    def insert(path, leaf, value):
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    prefixes = sorted({k[:-len(".conv.weight")] for k in state
                       if k.endswith(".conv.weight")})
    for pre in prefixes:
        w, b = fold_bn(state[f"{pre}.conv.weight"], state[f"{pre}.bn.weight"],
                       state[f"{pre}.bn.bias"], state[f"{pre}.bn.running_mean"],
                       state[f"{pre}.bn.running_var"])
        insert(pre.split(".") + ["conv"], "kernel", w)
        insert(pre.split(".") + ["conv"], "bias", b)
    insert(["fc"], "kernel", np.transpose(state["fc.weight"], (1, 0)).astype(np.float32))
    insert(["fc"], "bias", state["fc.bias"].astype(np.float32))
    return params


# --------------------------------------------------------------------------
# streaming statistics over large sample sets
# --------------------------------------------------------------------------

class StreamingStats:
    """Mean and covariance of features accumulated batch by batch in
    float64 (a 50k × 2048 set never sits in memory)."""

    def __init__(self, dim: int):
        self.n = 0
        self.s1 = np.zeros((dim,), np.float64)
        self.s2 = np.zeros((dim, dim), np.float64)

    def update(self, feats):
        feats = np.asarray(feats, np.float64)
        self.n += feats.shape[0]
        self.s1 += feats.sum(0)
        self.s2 += feats.T @ feats

    def finalize(self):
        from .metrics import FeatureStats
        mu = self.s1 / self.n
        # unbiased covariance, as np.cov(rowvar=False)
        sigma = (self.s2 - self.n * np.outer(mu, mu)) / (self.n - 1)
        return FeatureStats(mu=mu, sigma=sigma)


class InceptionExtractor:
    """Batched extractor: images in [0, 1], NHWC (numpy or tensor) →
    features as numpy, on ``device`` (the card unless the caller passes
    ``"cpu"``).  ``weights_path=None`` runs on random weights drawn from
    ``seed`` (N(0, 1/fan_in) kernels, zero biases): relative comparisons
    only; pass the local ``pt_inception-2015-12-05-6726825d.pth`` for real
    scores."""

    def __init__(self, weights_path: Optional[str] = None, device=None, seed: int = 0):
        from ..models.bridge import load_jax_variables
        self.device = resolve_device(device)
        self.random_init = weights_path is None
        with torch.device(self.device):
            self.model = FIDInceptionV3()
        if weights_path is not None:
            load_jax_variables(self.model, {"params": load_fid_inception_params(weights_path)})
        else:
            g = torch.Generator(device=self.device).manual_seed(seed)
            for m in self.model.modules():
                if isinstance(m, (Conv, Dense)):
                    lecun_normal_(m.weight, g)
        self.model.eval()

    @torch.no_grad()
    def __call__(self, images) -> Dict[str, np.ndarray]:
        x = (images if isinstance(images, torch.Tensor)
             else torch.from_numpy(np.asarray(images, np.float32)))
        x = x.to(self.device, torch.float32)
        with tf32_off():
            out = self.model(preprocess(x))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def pool3(self, images) -> np.ndarray:
        return self(images)["pool3"]

    def probs(self, images) -> np.ndarray:
        logits = self(images)["logits"]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
