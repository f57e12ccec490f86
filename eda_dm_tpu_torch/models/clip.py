"""CLIP's text and vision towers in the port's own PyTorch (the networks
behind ``eda_dm_tpu/eval/clip.py::CLIPScorer`` and
``eda_dm_tpu/models/encoders.py::FrozenCLIPTextEncoder``, which wrap
``transformers``' Flax CLIP).

* ``CLIPTextTransformer``: token and position embeddings, pre-LN encoder
  layers (causal self-attention, ``quick_gelu`` MLP), ``final_layer_norm``
  on every position; the pooled row is the end-of-text position.
* ``CLIPVisionTransformer``: a bias-free patch convolution, the class
  token and positions, ``pre_layrnorm``, the same layers without the
  causal mask, ``post_layernorm`` on the class row.
* ``CLIPModel``: either tower or both, with the bias-free
  ``text_projection`` / ``visual_projection`` and ``logit_scale``.

Module and parameter names are those of ``transformers``' PyTorch
``CLIPModel`` (``text_model.encoder.layers.0.self_attn.q_proj.weight``,
``vision_model.pre_layrnorm.bias``, ...), so a published state dict loads
by name.  Everything computes in float32 with plain ops in the Flax
model's order (query divided by √head_dim, the logits plus an additive
``finfo.min`` mask, softmax, the weighted values), with TF32 off on the
card; the JAX package runs these towers in Flax outside any Pallas kernel,
so no hand-written kernel stands behind them.

Pooling follows ``transformers``: with the legacy ``eos_token_id == 2``
(the published ViT-L/14 config carries it) the text feature is taken at
``input_ids.argmax(-1)``, otherwise at the first position holding
``eos_token_id``.

Weights: ``load_clip_checkpoint`` reads a local checkout (``config.json``
and ``model.safetensors``, through ``read_safetensors``, or
``pytorch_model.bin``, or ``flax_model.msgpack``, through
``flax_msgpack.read_flax_msgpack``), ``load_clip_checkout`` that and its tokenizer
(``vocab.json``, ``merges.txt``); ``clip_from_flax_params`` carries the JAX
package's Flax parameters over.  Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..device import resolve_device
from ..ops.int8_einsum import tf32_off

CONFIG_NAME = "config.json"
WEIGHT_NAMES = ("model.safetensors", "pytorch_model.bin", "flax_model.msgpack")
TOKENIZER_NAMES = ("vocab.json", "merges.txt")


# --------------------------------------------------------------------------
# configuration (transformers' CLIP defaults where config.json is silent)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Either tower or both.  ``projection_dim`` of a two-tower checkout is
    the top-level one (``CLIPModel``'s); a flat ``clip_text_model``
    config has no projection."""
    text: Optional[CLIPTextConfig] = None
    vision: Optional[CLIPVisionConfig] = None
    projection_dim: Optional[int] = 512
    logit_scale_init_value: float = 2.6592

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CLIPConfig":
        """A ``config.json`` as a dict: a ``CLIPConfig`` with
        ``text_config`` / ``vision_config`` (their legacy ``*_dict``
        variants take precedence, as in ``transformers``), or a flat
        ``clip_text_model`` config."""
        def tower(kind, fields):
            names = {f.name for f in dataclasses.fields(kind)}
            return kind(**{k: v for k, v in fields.items() if k in names})
        model_type = d.get("model_type", "")
        if model_type == "clip" or "text_config" in d or "vision_config" in d:
            text = {**(d.get("text_config") or {}), **(d.get("text_config_dict") or {})}
            vision = {**(d.get("vision_config") or {}), **(d.get("vision_config_dict") or {})}
            return cls(tower(CLIPTextConfig, text), tower(CLIPVisionConfig, vision),
                       d.get("projection_dim", 512), d.get("logit_scale_init_value", 2.6592))
        return cls(text=tower(CLIPTextConfig, d), projection_dim=None)

    @classmethod
    def from_json(cls, path: str) -> "CLIPConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def towers(self, which: Sequence[str]) -> "CLIPConfig":
        """The same configuration cut to the towers named in ``which``."""
        return dataclasses.replace(self, text=self.text if "text" in which else None,
                                   vision=self.vision if "vision" in which else None)


def vit_l14_config() -> CLIPConfig:
    """openai/clip-vit-large-patch14's ``config.json`` widths (with its
    legacy ``eos_token_id`` 2)."""
    return CLIPConfig(
        CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_attention_heads=12,
                       eos_token_id=2),
        CLIPVisionConfig(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                         num_attention_heads=16, patch_size=14),
        projection_dim=768)


# --------------------------------------------------------------------------
# the towers
# --------------------------------------------------------------------------

def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        if self.head_dim * heads != dim:
            raise ValueError(f"width {dim} is not a multiple of {heads} heads")
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.q_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        b, t, d = x.shape
        split = lambda y: y.reshape(b, t, self.heads, self.head_dim)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        q = q / math.sqrt(self.head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if bias is not None:
            logits = logits + bias
        w = torch.softmax(logits, dim=-1)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        if act != "quick_gelu":
            raise ValueError(f"hidden_act {act!r}: only CLIP's quick_gelu is ported")
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_attention_heads)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        h = h + self.self_attn(self.layer_norm1(h), bias)
        return h + self.mlp(self.layer_norm2(h))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, h: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            h = layer(h, bias)
        return h


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return (self.token_embedding(input_ids)
                + self.position_embedding.weight[:input_ids.shape[1]])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(last_hidden_state (B, T, width), pooled (B, width)).  The causal
        mask, and the padding mask where one is given, enter the logits as
        an additive ``finfo.min`` where a key is masked."""
        b, t = input_ids.shape
        keep = torch.ones(t, t, dtype=torch.bool, device=input_ids.device).tril()
        if attention_mask is not None:
            keep = keep & (attention_mask.to(input_ids.device)[:, None, None, :] > 0)
        bias = torch.zeros(keep.shape, dtype=torch.float32, device=input_ids.device)
        bias = bias.masked_fill(~keep, torch.finfo(torch.float32).min)
        h = self.encoder(self.embeddings(input_ids), bias)
        h = self.final_layer_norm(h)
        if self.cfg.eos_token_id == 2:       # the legacy configs: eos is the largest id
            at = input_ids.argmax(-1)
        else:
            at = (input_ids == self.cfg.eos_token_id).int().argmax(-1)
        return h, h[torch.arange(b, device=h.device), at]


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch_size = cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixel values (N, C, S, S) → (last_hidden_state (N, 1 + patches,
        width), pooled (N, width): the class row after ``post_layernorm``)."""
        h = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return h, self.post_layernorm(h[:, 0])


class CLIPModel(nn.Module):
    """The towers ``cfg`` holds, on ``device`` (the card unless the caller
    passes ``"cpu"``).  ``init``: draw the weights from ``seed`` as
    ``transformers`` initialises CLIP (normal embeddings and linears of
    its widths, zero biases, unit LayerNorms); ``init=False`` leaves them
    unset for a state dict to fill."""

    def __init__(self, cfg: CLIPConfig, device=None, seed: int = 0, init: bool = True):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        proj = cfg.projection_dim
        with torch.device("meta"):                 # no default init: set below or loaded
            if cfg.text is not None:
                self.text_model = CLIPTextTransformer(cfg.text)
                if proj is not None:
                    self.text_projection = nn.Linear(cfg.text.hidden_size, proj, bias=False)
            if cfg.vision is not None:
                self.vision_model = CLIPVisionTransformer(cfg.vision)
                if proj is not None:
                    self.visual_projection = nn.Linear(cfg.vision.hidden_size, proj, bias=False)
            if cfg.text is not None and cfg.vision is not None and proj is not None:
                self.logit_scale = nn.Parameter(torch.empty(()))
        self.to_empty(device=device)
        if init:
            self._init_weights(torch.Generator(device=device).manual_seed(seed))
        self.eval()

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        normal = lambda p, std: p.normal_(0.0, std, generator=g)
        for name, tower in (("text_model", self.cfg.text), ("vision_model", self.cfg.vision)):
            if tower is None:
                continue
            m, d = getattr(self, name), tower.hidden_size
            emb = m.embeddings
            if name == "text_model":
                normal(emb.token_embedding.weight, 0.02)
            else:
                normal(emb.class_embedding, d ** -0.5)
                normal(emb.patch_embedding.weight, 0.02)
            normal(emb.position_embedding.weight, 0.02)
            in_std = d ** -0.5 * (2 * tower.num_hidden_layers) ** -0.5
            for layer in m.encoder.layers:
                a = layer.self_attn
                for lin, std in ((a.q_proj, in_std), (a.k_proj, in_std), (a.v_proj, in_std),
                                 (a.out_proj, d ** -0.5), (layer.mlp.fc1, (2 * d) ** -0.5),
                                 (layer.mlp.fc2, in_std)):
                    normal(lin.weight, std)
                    lin.bias.zero_()
            for ln in m.modules():
                if isinstance(ln, nn.LayerNorm):
                    ln.weight.fill_(1.0)
                    ln.bias.zero_()
        for name in ("text_projection", "visual_projection"):
            if hasattr(self, name):
                lin = getattr(self, name)
                normal(lin.weight, lin.in_features ** -0.5)
        if hasattr(self, "logit_scale"):
            self.logit_scale.fill_(self.cfg.logit_scale_init_value)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def text_hidden_states(self, input_ids, attention_mask=None) -> torch.Tensor:
        """``last_hidden_state`` (B, T, width) in float32."""
        return self._text(input_ids, attention_mask)[0]

    @torch.no_grad()
    def get_text_features(self, input_ids, attention_mask=None) -> torch.Tensor:
        """The pooled text row through ``text_projection``: (B, projection)."""
        return self.text_projection(self._text(input_ids, attention_mask)[1])

    @torch.no_grad()
    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel values (N, C, S, S) → (N, projection)."""
        with tf32_off():
            pooled = self.vision_model(pixel_values.to(self.device, torch.float32))[1]
            return self.visual_projection(pooled)

    def _text(self, input_ids, attention_mask):
        on = lambda a: (a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))).to(
            self.device)
        with tf32_off():
            return self.text_model(on(input_ids).long(),
                                   None if attention_mask is None else on(attention_mask))


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

# the float types of CLIP's weights; I64 for the position_ids buffers that
# older checkouts carry
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                      "I64": torch.int64}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → {name: CPU tensor}: an 8-byte
    little-endian header length, that many bytes of JSON (each tensor's
    ``dtype``, ``shape`` and ``data_offsets`` into the data that follows,
    plus an optional ``__metadata__``), then the raw little-endian data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        size = torch.empty((), dtype=dtype).element_size()
        count = math.prod(info["shape"])
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do not hold "
                             f"{info['shape']} of {info['dtype']}")
        t = (torch.frombuffer(data, dtype=dtype, count=count, offset=begin) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def _missing(path: str, who: str, why: str) -> RuntimeError:
    return RuntimeError(
        f"{who} needs a local CLIP checkpoint at '{path}' (nothing is downloaded): it reads "
        f"{CONFIG_NAME}, one of {', '.join(WEIGHT_NAMES)} "
        f"and, for the tokenizer, {' and '.join(TOKENIZER_NAMES)}; {why}")


def _check_checkout(path: str, who: str, tokenizer: bool) -> None:
    """Raise ``_missing`` unless ``path`` holds the configuration, a weight
    file and, with ``tokenizer``, the tokenizer's files."""
    if not os.path.isdir(path):
        raise _missing(path, who, "there is no such directory")
    has = lambda n: os.path.isfile(os.path.join(path, n))
    lacks = [n for n in (CONFIG_NAME,) + (TOKENIZER_NAMES if tokenizer else ()) if not has(n)]
    if not any(map(has, WEIGHT_NAMES)):
        lacks.append(" or ".join(WEIGHT_NAMES))
    if lacks:
        raise _missing(path, who, f"it lacks {', '.join(lacks)} (the directory holds "
                                  f"{sorted(os.listdir(path))})")


def load_clip_checkpoint(path: str, device=None, towers: Sequence[str] = ("text", "vision"),
                         who: str = "load_clip_checkpoint") -> CLIPModel:
    """The towers of a local checkout at ``path`` named in ``towers``, in
    float32 on ``device`` (the card unless the caller passes ``"cpu"``).
    ``model.safetensors`` is read by ``read_safetensors``, else
    ``pytorch_model.bin`` by ``torch.load(weights_only=True)``, else
    ``flax_model.msgpack`` by ``read_flax_msgpack`` (through
    ``flax_to_state_dict``); a checkout without any of them raises
    ``RuntimeError``."""
    device = resolve_device(device)
    _check_checkout(path, who, tokenizer=False)
    found = [n for n in WEIGHT_NAMES if os.path.isfile(os.path.join(path, n))]
    cfg_path = os.path.join(path, CONFIG_NAME)
    cfg = CLIPConfig.from_json(cfg_path).towers(towers)
    if cfg.text is None and cfg.vision is None:
        raise _missing(path, who, f"its {CONFIG_NAME} has none of the towers {list(towers)}")
    weights = os.path.join(path, found[0])
    if found[0].endswith(".safetensors"):
        state = read_safetensors(weights)
    elif found[0].endswith(".msgpack"):
        from .flax_msgpack import read_flax_msgpack
        tree = read_flax_msgpack(weights)
        state = flax_to_state_dict(tree.get("params", tree))
    else:
        state = torch.load(weights, map_location="cpu", weights_only=True)
    model = CLIPModel(cfg, device=device, init=False)
    load_state(model, state, weights)
    return model


def load_clip_checkout(path: str, device=None, towers: Sequence[str] = ("text", "vision"),
                       who: str = "load_clip_checkout"):
    """``(model, tokenizer)`` of a local checkout: ``load_clip_checkpoint``'s
    towers and the ``CLIPTokenizer`` of its ``vocab.json`` and
    ``merges.txt``.  A checkout that lacks any of them raises
    ``RuntimeError`` naming ``who``, before any weight is read."""
    from .clip_tokenizer import CLIPTokenizer
    device = resolve_device(device)
    _check_checkout(path, who, tokenizer=True)
    return (load_clip_checkpoint(path, device, towers, who),
            CLIPTokenizer.from_pretrained(path))


def load_state(model: CLIPModel, state: Mapping[str, torch.Tensor], source: str = "") -> None:
    """Copy ``state`` (``transformers`` names) into ``model`` as float32.
    Every parameter of the model must be there; the other entries (the
    other tower's, ``position_ids`` buffers of older checkouts) are
    ignored."""
    own = model.state_dict()
    lacking = sorted(k for k in own if k not in state)
    if lacking:
        raise RuntimeError(f"{source}: the checkpoint lacks {len(lacking)} of the model's "
                           f"{len(own)} entries, e.g. {lacking[:3]}")
    with torch.no_grad():
        for k, p in own.items():
            v = torch.as_tensor(state[k])
            if tuple(v.shape) != tuple(p.shape):
                raise RuntimeError(f"{source}: {k} has shape {tuple(v.shape)}, the model "
                                   f"{tuple(p.shape)}")
            p.copy_(v.to(torch.float32))


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``transformers``' Flax CLIP parameters (``FlaxCLIPModel`` or
    ``FlaxCLIPTextModel``: nested dicts of numpy, JAX or torch arrays) →
    its PyTorch names:
    Dense kernels transposed to (out, in), the patch kernel HWIO → OIHW,
    LayerNorm ``scale`` → ``weight``, ``embedding`` → ``weight``."""
    out = {}

    def walk(tree, prefix):
        for key, v in tree.items():
            name = f"{prefix}{key}"
            if isinstance(v, Mapping):
                walk(v, name + ".")
                continue
            a = (v.to(torch.float32).numpy() if isinstance(v, torch.Tensor)
                 else np.array(v, dtype=np.float32))
            module, _, leaf = name.rpartition(".")
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = module + ".weight"
            elif leaf in ("scale", "embedding"):
                name = module + ".weight"
            out[name] = torch.from_numpy(a.copy())
    walk(params, "")
    return out


def clip_from_flax_params(params: Mapping[str, Any], cfg: CLIPConfig, device=None) -> CLIPModel:
    """A ``CLIPModel`` of ``cfg`` on ``device`` holding the JAX package's
    Flax CLIP parameters (``FlaxCLIPModel.params`` or
    ``FlaxCLIPTextModel.params``, as numpy or JAX arrays)."""
    params = params.get("params", params)
    towers = [t for t, k in (("text", "text_model"), ("vision", "vision_model")) if k in params]
    cfg = cfg.towers(towers)
    if "text_projection" not in params and "visual_projection" not in params:
        cfg = dataclasses.replace(cfg, projection_dim=None)
    model = CLIPModel(cfg, device=device, init=False)
    load_state(model, flax_to_state_dict(params), "Flax parameters")
    return model
