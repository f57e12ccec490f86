"""AdaRound + FBR reconstruction engine (port of ``eda_dm_tpu/calib/recon.py``).

* **Capture.**  Forward hooks on the target modules record a block's
  input and output (``block_in`` / ``block_out``), a layer's (``in`` /
  ``out``), a transformer block's context (``block_ctx``, its forward's
  second argument) and the inner layers' outputs; the hook that records the last
  tap a forward needs raises :class:`StopForward`, so the model's suffix
  after the targets never runs (the JAX package gets the same saving from
  XLA's dead-code elimination).  The quantized-input capture runs the same
  forward in the quantized mode, under the state that earlier targets
  left: each target's input depends on the reconstruction order.
* **Optimization.**  For each target, ``iters`` steps of: a minibatch
  drawn without replacement, QDrop input mixing (``input_prob``), one
  forward of the target's own submodule with its inner outputs hooked, the
  FBR loss (block output + ``add_loss`` × the inner-layer losses except
  the last), and two ``torch.optim.Adam`` groups, the AdaRound alphas at
  ``lr_w`` and the act deltas at ``lr_a``, each under optax's cosine decay
  ``0.5·(1 + cos(π·t/iters))`` as a ``LambdaLR``.  The trained tensors are
  the modules' own buffers (``requires_grad`` on while their target runs).
* **Groups.**  A group keeps the JAX package's semantics: every member's
  captures are taken before any member is reconstructed; then each member
  runs its loop.  ``group_size=1`` is the sequential, reference-exact
  path.  The cache budget is computed from the taps' shapes (a forward on
  fake tensors, nothing computed) and splits groups or caps the rows as
  in JAX.

* **Data parallel** (``mesh``, ``parallel/dp.py::dp_reconstruct``).  The
  JAX package's semantics: the same rows, the same loss, the gradients of
  the global mean.  The calibration rows and every capture are
  row-sharded, as in JAX: each rank holds a contiguous block of the rows
  (``mesh.shard_batch``), captures its block of each group's rows and
  keeps only that block of every cache.  Every rank draws the global
  minibatch indices and the input-mixing mask from the same generator
  state and takes its contiguous ``batch_size / n`` positions; the rows
  behind them that live on other ranks come from their owners
  (``parallel/rows.py::fetch``, point to point, only those rows).  QDrop
  draws its mask for the global minibatch and slices it.  A rank's data
  loss is weighted by its share of the rows, the rounding regularizer is
  counted once (on the first rank), and the gradients are summed over the
  ranks before the two Adam groups step, so the Adam state stays equal on
  every rank.

As in the JAX package, the FP inner activations are captured once and
reused (the reference recomputes them every step on the same inputs), and
the quantized forward runs once a step.  The JAX package's XLA-only knobs
(``shared_capture``, ``clear_caches_every``) have no meaning here and are
not accepted.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..nn.layers import ActQuantizer, QConv, QDense
from ..parallel import comm, rows
from ..parallel.mesh import shard_batch
from ..quant.adaround import round_regularization
from ..quant.affine import lp_loss
from ..quant.config import QuantMode
from ..utils.tree import get_submodule


def module_spec(cls: str, **fields) -> Tuple:
    """A hashable description of a standalone module: its class name and
    its configuration (the JAX package's flax-module fields).  Targets with
    equal specs share a signature in :func:`group_plan`."""
    return (cls, tuple(fields.items()))


def dense_spec(features, wq, aq):
    return module_spec("QDense", features=features, wq=wq, aq=aq,
                       disable_act_quant=False, use_bias=True)


def conv_spec(features, kernel_size, wq, aq, strides=(1, 1), padding="SAME",
              split=0, disable_act_quant=False):
    return module_spec("QConv", features=features, kernel_size=kernel_size,
                       strides=strides, padding=padding, wq=wq, aq=aq,
                       split=split, disable_act_quant=disable_act_quant,
                       use_bias=True)


@dataclasses.dataclass(frozen=True)
class ReconTarget:
    """One reconstruction unit (a quantized layer or a quant block).
    ``spec`` describes the standalone module (:func:`module_spec`);
    :meth:`module` is the model's own submodule at ``path``."""
    name: str
    path: Tuple[str, ...]
    spec: Tuple
    kind: str                   # 'block' | 'layer'
    has_temb: bool = False
    has_ctx: bool = False       # cross-attention context (transformer blocks)
    # ordered inner layer taps; the FBR loss sums all but the last
    inner_taps: Tuple[Tuple[str, ...], ...] = ()
    # layer-mode attention target: only the block-level q/k/v/w act deltas
    # train, against the block's FP output
    act_only: bool = False

    def module(self, model: nn.Module) -> nn.Module:
        return get_submodule(model, self.path)


@dataclasses.dataclass(frozen=True)
class ReconArgs:
    """The reference's hyperparameters."""
    iters: int = 5000
    batch_size: int = 32
    lr_w: float = 5e-1
    lr_a: float = 5e-4
    add_loss: float = 0.8
    input_prob: float = 0.5
    p: float = 2.0
    act_quant: bool = True
    asym: bool = True
    recon_w: bool = True
    recon_a: bool = True
    # rounding-relaxation regularizer (off in every reference pipeline)
    round_loss: str = "none"
    weight: float = 1e-4
    b_range: Tuple[int, int] = (20, 2)
    warmup: float = 0.2
    capture_batch_size: Optional[int] = None
    # dtype the activation caches are stored in ('bfloat16' halves them;
    # minibatches are upcast to float32); None = float32
    cache_dtype: Optional[str] = None
    # cap on a group's summed activation-cache bytes (groups split, or a
    # single member over it takes a subset of the rows)
    capture_budget_bytes: int = 6_000_000_000


# --------------------------------------------------------------------------
# capture
# --------------------------------------------------------------------------

FP_CAPTURE = QuantMode(capture=True)
# taps read before the forward: its first argument, or (block_ctx) its second
_INPUT_TAPS = {"in": 0, "block_in": 0, "block_ctx": 1}


class StopForward(Exception):
    """Raised by the capture hook that records a forward's last tap."""


def quant_capture_mode(act_quant: bool) -> QuantMode:
    return QuantMode(w_quant=True, a_quant=act_quant, capture=True)


def _hook_taps(model: nn.Module, keep: Sequence[Tuple[str, ...]], store: dict,
               temb: bool, stop: bool):
    """Register the hooks that put each keep path's tensor into ``store``
    (and the model's temb under ``"temb"``); with ``stop``, the hook that
    completes the set raises :class:`StopForward`.  Returns the handles."""
    wanted = len(keep) + int(temb)
    by_module: Dict[Tuple[str, ...], List[Tuple[str, Tuple[str, ...]]]] = {}
    for kp in keep:
        by_module.setdefault(kp[:-1], []).append((kp[-1], kp))
    handles = []

    def put(key, value):
        store[key] = value
        if stop and len(store) == wanted:
            raise StopForward

    def pre_hook(kps):
        def hook(mod, args):
            for kp in kps:
                put(kp, args[_INPUT_TAPS[kp[-1]]])
        return hook

    def post_hook(kps):
        def hook(mod, args, out):
            for kp in kps:
                put(kp, out)
        return hook

    for mpath, taps in by_module.items():
        mod = get_submodule(model, mpath)
        ins = [kp for tap, kp in taps if tap in _INPUT_TAPS]
        outs = [kp for tap, kp in taps if tap not in _INPUT_TAPS]
        if ins:
            handles.append(mod.register_forward_pre_hook(pre_hook(ins)))
        if outs:
            handles.append(mod.register_forward_hook(post_hook(outs)))
    if temb:
        handles.append(get_submodule(model, (model.temb_module,))
                       .register_forward_hook(post_hook(["temb"])))
    return handles


def _tap_forward(model, batch, mode, keep, temb):
    """One forward recording ``keep`` (and temb), stopped after the last."""
    store: dict = {}
    handles = _hook_taps(model, keep, store, temb, stop=True)
    try:
        model(*batch, mode=mode)
    except StopForward:
        pass
    finally:
        for h in handles:
            h.remove()
    missing = [kp for kp in keep if kp not in store]
    if missing:
        raise KeyError(f"capture: the forward never reached {missing[:3]}")
    return store


@torch.no_grad()
def capture_target(model: nn.Module, cali_data: Sequence[torch.Tensor],
                   path: Tuple[str, ...], mode: QuantMode,
                   keep: Tuple[Tuple[str, ...], ...],
                   batch_size: Optional[int] = None,
                   cache_dtype: Optional[str] = None, temb: bool = False):
    """Capture the ``keep`` taps (paths relative to ``path``, each a module
    path and a tap name) over the calibration set in chunks of
    ``batch_size`` rows (the last one ragged), stored at ``cache_dtype``.
    Returns (dict keyed by keep path, temb or None)."""
    n = cali_data[0].shape[0]
    bs = min(batch_size or n, n)
    dtype = getattr(torch, cache_dtype) if cache_dtype else None
    full = tuple(path + kp for kp in keep)
    bufs: Optional[List[torch.Tensor]] = None
    tembs = []
    for start in range(0, n, bs):
        batch = tuple(a[start:start + bs] for a in cali_data)
        store = _tap_forward(model, batch, mode, full, temb)
        kept = [store[kp] if dtype is None else store[kp].to(dtype) for kp in full]
        if temb:
            tembs.append(store["temb"] if dtype is None else store["temb"].to(dtype))
        if bs == n:
            return dict(zip(keep, kept)), (tembs[0] if temb else None)
        if bufs is None:
            bufs = [torch.empty((n,) + k.shape[1:], dtype=k.dtype, device=k.device)
                    for k in kept]
        for b, k in zip(bufs, kept):
            b[start:start + k.shape[0]] = k
    return dict(zip(keep, bufs)), (torch.cat(tembs) if temb else None)


# --------------------------------------------------------------------------
# trainable tensors
# --------------------------------------------------------------------------

def _act_quantizers(module: nn.Module):
    """The act quantizers that the module's forward calls (a layer with its
    act quantization disabled never calls its own)."""
    off = {id(m.act_quantizer) for m in module.modules()
           if isinstance(m, (QConv, QDense)) and m.disable_act_quant}
    own = [module] if isinstance(module, ActQuantizer) else []
    return own + [q for q in module.modules()
                  if isinstance(q, ActQuantizer) and id(q) not in off and q is not module]


def split_trainable(module: nn.Module, recon_w: bool, recon_a: bool):
    """(alphas, act deltas) of a target: every AdaRound alpha of its layers
    and the delta of every act quantizer it calls.  Everything else (weight
    deltas and zero-points, the EMA state) stays frozen."""
    alphas = ([getattr(m, f"{name}_alpha") for m in module.modules()
               if isinstance(m, (QConv, QDense)) for name, _, _ in m._parts]
              if recon_w else [])
    deltas = [q.delta for q in _act_quantizers(module)] if recon_a else []
    return alphas, deltas


def _trainable(target: ReconTarget, module: nn.Module, args: ReconArgs):
    if target.act_only:
        # only the attention q/k/v/w deltas train
        deltas = [q.delta for name, q in module.named_children()
                  if isinstance(q, ActQuantizer) and name.startswith("act_quantizer_")]
        return [], deltas, dataclasses.replace(args, recon_w=False)
    alphas, deltas = split_trainable(module, args.recon_w, args.recon_a)
    return alphas, deltas, args


# --------------------------------------------------------------------------
# per-target optimization
# --------------------------------------------------------------------------

def _linear_temp_decay(t: int, iters: int, warmup: float, b_range) -> float:
    """Temperature b of the rounding regularizer."""
    start = warmup * iters
    if t < start:
        return float(b_range[0])
    rel = (t - start) / (iters - start)
    return b_range[1] + (b_range[0] - b_range[1]) * max(0.0, 1.0 - rel)


def _cosine(iters: int):
    """optax's ``cosine_decay_schedule`` factor at step t (alpha = 0)."""
    return lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, iters) / iters))


def _sum_grads(tensors: List[torch.Tensor], group) -> None:
    """Every trained tensor's gradient summed over the ranks, in one
    collective."""
    grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in tensors]
    flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), "sum", group)
    for t, g in zip(tensors, flat.split([g.numel() for g in grads])):
        t.grad = g.view_as(t).clone()


def reconstruct_target(target: ReconTarget, model: nn.Module,
                       data: Dict[str, Any], args: ReconArgs,
                       generator: torch.Generator, group=None) -> torch.Tensor:
    """Optimize one target's rounding masks and act scales in place; return
    the per-iteration losses (iters,).

    ``data``: ``inp_q``, ``inp_s`` (quantized / FP target inputs),
    ``out_fp`` (FP output), ``temb_q`` for targets that take a temb,
    ``ctx_q`` for those that take a context (``has_ctx``), and
    ``inner_fp`` (FP inner-layer outputs in ``target.inner_taps`` order).
    ``generator`` (on the model's device) draws the minibatches, the input
    mixing and QDrop.  With a ``group`` (data parallel) this rank computes
    its block of each global minibatch and the gradients are summed over
    the group (see the module docstring); the losses returned are the
    global ones.
    """
    module = target.module(model)
    alphas, deltas, args = _trainable(target, module, args)
    if not (alphas or deltas):
        return torch.zeros(args.iters)
    mode = QuantMode(w_quant=True, a_quant=args.act_quant,
                     soft_targets=args.recon_w, training=True, capture=True)
    inp_q, inp_s, out_fp_all = data["inp_q"], data["inp_s"], data["out_fp"]
    temb_q = data.get("temb_q") if target.has_temb else None
    ctx_q = data.get("ctx_q") if target.has_ctx else None
    inner_fp = tuple(data.get("inner_fp", ()))
    use_inner = (target.kind == "block" and len(inner_fp) > 1
                 and args.add_loss > 0.0)
    n_rank, rank = comm.size(group), comm.rank(group)
    n = out_fp_all.shape[0] * n_rank          # the global rows
    bs = min(args.batch_size, n)
    dev = out_fp_all.device
    if bs % n_rank:
        raise ValueError(f"a minibatch of {bs} rows does not shard over "
                         f"{n_rank} ranks")
    # the caches a step reads, in one row exchange under a mesh
    cache = ([inp_q, inp_s, out_fp_all]
             + ([temb_q] if target.has_temb else [ctx_q] if target.has_ctx else [])
             + (list(inner_fp[:-1]) if use_inner else []))

    trained = alphas + deltas
    for t in trained:
        t.requires_grad_(True)
    groups = [g for g in ({"params": alphas, "lr": args.lr_w},
                          {"params": deltas, "lr": args.lr_a}) if g["params"]]
    opt = torch.optim.Adam(groups)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, _cosine(args.iters))
    quantizers = _act_quantizers(module)
    for q in quantizers:
        q.generator = generator
    store: dict = {}
    handles = (_hook_taps(module, [tp + ("out",) for tp in target.inner_taps[:-1]],
                          store, False, stop=False) if use_inner else [])
    f32 = lambda a: a.float()
    losses = []
    try:
        with rows.sharded_rows(group):
            for it in range(args.iters):
                # a minibatch of every row is every row (a rank's: its
                # own block): no draw, no gather
                got = (rows.fetch(cache, torch.randperm(n, generator=generator,
                                                        device=dev)[:bs], group)
                       if bs < n else cache)
                xq, xs, y_fp, *rest = map(f32, got)
                if args.input_prob < 1.0:
                    m = rows.draw(torch.rand, xq.shape, generator=generator,
                                  device=dev) < args.input_prob
                    x = torch.where(m, xq, xs)
                else:
                    x = xs
                cond = rest[:1] if target.has_temb or target.has_ctx else []
                store.clear()
                out = module(x, *cond, mode)
                loss = lp_loss(out, y_fp, args.p, channel_axis=-1)
                if use_inner:
                    m_loss = 0.0
                    for tap, fp_act in zip(target.inner_taps[:-1], rest[len(cond):]):
                        m_loss = m_loss + lp_loss(store[tap + ("out",)], fp_act,
                                                  2.0, channel_axis=-1)
                    loss = loss + args.add_loss * m_loss
                if n_rank > 1:
                    loss = loss / n_rank            # this rank's share of the rows
                if args.round_loss == "relaxation" and rank == 0:
                    b = _linear_temp_decay(it, args.iters, args.warmup, args.b_range)
                    loss = loss + args.weight * sum(round_regularization(a, b)
                                                    for a in alphas)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                if n_rank > 1:
                    _sum_grads(trained, group)
                opt.step()
                sched.step()
                losses.append(loss.detach())
    finally:
        for h in handles:
            h.remove()
        for q in quantizers:
            q.generator = None
        for t in trained:
            t.requires_grad_(False)
    return comm.all_reduce_(torch.stack(losses), "sum", group)


def reconstruct_group(targets: Sequence[ReconTarget], model: nn.Module,
                      datas: Sequence[Dict[str, Any]], args: ReconArgs,
                      generator: torch.Generator):
    """Reconstruct the members of a group one after another on captures
    that were all taken before the first of them ran (the JAX package's
    vmapped group: later members do not see earlier members' new rounding
    in their inputs).  Returns the members' losses."""
    return [reconstruct_target(t, model, d, args, generator)
            for t, d in zip(targets, datas)]


# --------------------------------------------------------------------------
# orchestration
# --------------------------------------------------------------------------

def _keep_paths(target: ReconTarget):
    """(in_key, out_key, fp_keep, q_keep) tap paths relative to the target."""
    if target.kind == "block":
        in_key, out_key = ("block_in",), ("block_out",)
    else:
        in_key, out_key = ("in",), ("out",)
    fp_keep = [in_key, out_key]
    if target.kind == "block":
        fp_keep += [tp + ("out",) for tp in target.inner_taps]
    q_keep = [in_key]
    if target.has_ctx:
        fp_keep.append(("block_ctx",))
        q_keep.append(("block_ctx",))
    return in_key, out_key, fp_keep, q_keep


def build_group_data(model: nn.Module, cali_data: Sequence[torch.Tensor],
                     targets: Sequence[ReconTarget], args: ReconArgs
                     ) -> List[Dict[str, Any]]:
    """FP and quantized captures for a group of targets, in two passes over
    the calibration set."""
    metas = [_keep_paths(t) for t in targets]
    fp_abs, q_abs = [], []
    for t, (_, _, fp_keep, q_keep) in zip(targets, metas):
        fp_abs += [t.path + kp for kp in fp_keep]
        q_abs += [t.path + kp for kp in q_keep]
    temb = any(t.has_temb for t in targets)
    fp_sub, fp_temb = capture_target(model, cali_data, (), FP_CAPTURE,
                                     tuple(fp_abs), args.capture_batch_size,
                                     args.cache_dtype, temb)
    q_sub, q_temb = capture_target(
        model, cali_data, (),
        quant_capture_mode(args.act_quant) if args.asym else FP_CAPTURE,
        tuple(q_abs), args.capture_batch_size, args.cache_dtype, temb)
    datas = []
    for t, (in_key, out_key, _, _) in zip(targets, metas):
        data = {"inp_s": fp_sub[t.path + in_key], "inp_q": q_sub[t.path + in_key],
                "out_fp": fp_sub[t.path + out_key]}
        if t.has_temb:
            data["temb_s"], data["temb_q"] = fp_temb, q_temb
        if t.has_ctx:
            data["ctx_s"] = fp_sub[t.path + ("block_ctx",)]
            data["ctx_q"] = q_sub[t.path + ("block_ctx",)]
        if t.kind == "block":
            data["inner_fp"] = tuple(fp_sub[t.path + tp + ("out",)]
                                     for tp in t.inner_taps)
        datas.append(data)
    return datas


def build_target_data(model, cali_data, target: ReconTarget,
                      args: ReconArgs) -> Dict[str, Any]:
    """Single-target capture (group of one)."""
    return build_group_data(model, cali_data, [target], args)[0]


def _signature(t: ReconTarget):
    return (t.spec, t.kind, t.has_temb, t.has_ctx, t.inner_taps, t.act_only)


def group_plan(plan: Sequence[ReconTarget], group_size: int,
               window: int = 0) -> List[List[ReconTarget]]:
    """Split the plan into groups of same-signature targets, capped at
    ``group_size``.  ``window=0``: only adjacent targets group; ``window=k``
    lets a group absorb a same-signature target up to ``k`` other targets
    later.  Groups run in first-member order."""
    groups: List[List[ReconTarget]] = []
    open_groups: List[list] = []     # [sig, group, last_index]
    for idx, t in enumerate(plan):
        sig = _signature(t)
        open_groups = [og for og in open_groups
                       if idx - og[2] <= window + 1 and len(og[1]) < group_size]
        for og in open_groups:
            if og[0] == sig:
                og[1].append(t)
                og[2] = idx
                break
        else:
            g = [t]
            groups.append(g)
            open_groups.append([sig, g, idx])
    return groups


def tap_row_bytes(model: nn.Module, cali_data: Sequence[torch.Tensor],
                  plan: Sequence[ReconTarget], itemsize: int) -> Dict[str, int]:
    """Bytes a calibration row adds to each target's caches, from the taps'
    shapes: one FP capture forward of a single row on fake tensors, which
    computes nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    keeps = {t.name: [t.path + kp for kp in _keep_paths(t)[2] + _keep_paths(t)[3]]
             for t in plan}
    every = tuple(dict.fromkeys(kp for ks in keeps.values() for kp in ks))
    store: dict = {}
    handles = _hook_taps(model, every, store, False, stop=False)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as fake, torch.no_grad():
            model(*(fake.from_tensor(a[:1]) for a in cali_data), mode=FP_CAPTURE)
    finally:
        for h in handles:
            h.remove()
    per = {kp: int(np.prod(store[kp].shape[1:])) * itemsize for kp in every}
    return {name: sum(per[kp] for kp in ks) for name, ks in keeps.items()}


def _split_by_budget(row_bytes: Dict[str, int], n: int,
                     grp: List[ReconTarget], args: ReconArgs):
    """Split a group so that its summed cache bytes stay under the budget.
    Returns (subgroups, row_cap): where even one member exceeds it, each
    member runs alone on ``row_cap`` of the calibration rows."""
    bs = args.capture_batch_size or n
    rows = bs * (-(-n // bs))        # ceil: a tail chunk counts in full
    pers = [row_bytes[t.name] * rows for t in grp]
    worst = max(pers)
    if worst > args.capture_budget_bytes:
        frac = args.capture_budget_bytes / worst
        return [[t] for t in grp], max(bs, int(n * frac) // bs * bs)
    subgroups: List[List[ReconTarget]] = []
    cur: List[ReconTarget] = []
    cur_bytes = 0
    for t, p in zip(grp, pers):
        if cur and cur_bytes + p > args.capture_budget_bytes:
            subgroups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(t)
        cur_bytes += p
    subgroups.append(cur)
    return subgroups, None


def cache_bytes(data: Dict[str, Any]) -> int:
    """The bytes of a target's captures (``build_group_data``'s dict)."""
    return sum(t.numel() * t.element_size() for v in data.values()
               for t in (v if isinstance(v, tuple) else (v,)))


def reconstruct(model: nn.Module, cali_data: Sequence[torch.Tensor],
                plan: Sequence[ReconTarget], args: ReconArgs,
                generator: Optional[torch.Generator] = None,
                progress: Optional[Callable[[str, float], None]] = None,
                group_size: int = 1, group_window: int = 0,
                log: Optional[list] = None, mesh=None) -> nn.Module:
    """Block/layer reconstruction over the plan, in place; returns the model.

    Each target's quantized-input capture sees the state that all earlier
    targets left.  ``group_size > 1`` captures runs of same-signature
    targets together (:func:`reconstruct_group`); ``group_size=1`` is the
    reference-exact sequential path.  ``generator`` (on the model's device;
    seed 0 if None) draws every minibatch and QDrop mask.  ``progress(name,
    last loss)`` is called after each target; ``log``, a list, gets one
    dict a target: name, kind, iterations, the row cap its caches took
    (None where its group fit the budget), the bytes of captures this
    process holds for it (``cache_bytes``), the loop's seconds and its
    first and last loss.  ``mesh`` (a 1-D ``parallel.mesh.make_mesh``)
    runs each target data-parallel over its ranks, every rank holding the
    same model (``parallel/dp.py::dp_reconstruct`` replicates it) and
    passing the whole calibration set, of which it keeps its contiguous
    block of the rows (``mesh.shard_batch``; the row count must divide
    over the ranks): each rank captures its block of each group's rows and
    keeps only that block of the caches.  The budget's splits and row caps
    are the single process's, from the global row count; a capped group
    takes the same global rows (the fixed permutation, then this rank's
    block of them, fetched from their owners).
    """
    group = None if mesh is None else mesh.get_group(0)
    if mesh is not None:
        cali_data = shard_batch(mesh, tuple(cali_data), mesh.mesh_dim_names[0])
    dev = cali_data[0].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    groups = (group_plan(plan, group_size, group_window) if group_size > 1
              else [[t] for t in plan])
    n = cali_data[0].shape[0] * comm.size(group)       # the global rows
    row_bytes = tap_row_bytes(model, cali_data, plan, 2 if args.cache_dtype else 4)
    for g in groups:
        subgroups, row_cap = _split_by_budget(row_bytes, n, g, args)
        for grp in subgroups:
            grp_cali = cali_data
            if row_cap:
                # a fixed permutation, not a prefix (CFG calib sets are laid
                # out [uncond; cond])
                perm = torch.from_numpy(np.random.RandomState(0).permutation(n)[:row_cap])
                grp_cali = tuple(rows.fetch(cali_data, perm, group))
            datas = build_group_data(model, grp_cali, grp, args)
            for i, t in enumerate(grp):
                if log is not None and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                losses = reconstruct_target(t, model, datas[i], args, generator,
                                            group)
                if log is not None:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    log.append(dict(name=t.name, kind=t.spec[0], iters=args.iters,
                                    row_cap=row_cap, cache_bytes=cache_bytes(datas[i]),
                                    seconds=time.perf_counter() - t0,
                                    first_loss=float(losses[0]),
                                    last_loss=float(losses[-1])))
                datas[i] = None              # free the caches before the next
                if progress is not None:
                    progress(t.name, float(losses[-1]))
    return model
