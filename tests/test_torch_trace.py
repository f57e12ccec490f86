"""The port's tracing: ``utils/run.py::span`` and the launch record beside
``ops/_build.py::launch_counts``.

* With no profiler session recording, a span opens no profiler range and
  the launch record stays empty.
* Under a session, a tiny DDPM DDIM batch and a tiny LDM PLMS batch under
  guidance give the span tree pipeline → sampler step → UNet forward →
  block group → op, with PLMS's look-ahead forward inside its first step;
  ``PhaseTimer`` phases are ``edm.phase.<name>`` spans.
* A second session's launch record replaces the first's.
* A torch without the C++ range raises at a span only while a session
  records.
* On the card (marker ``cuda``): the record's K1 launches equal
  ``launch_counts``' delta, and their shapes equal what forward hooks on
  K1's QConvs see.

JAX is not imported: on the card's machine this file runs as
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -q``.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eda_dm_tpu_torch.ops import _build
from eda_dm_tpu_torch.utils import run

STEPS = 3


def _cifar(device="cpu"):
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig
    from eda_dm_tpu_torch.pipelines.cifar import CifarConfig, CifarPipeline
    tiny = DDPMConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
                      resolution=8)
    pipe = CifarPipeline(CifarConfig(arch=tiny, timesteps=STEPS, sample_batch_size=2,
                                     image_size=32), device=device)
    serving, mode = pipe.serving_variables(pipe.init_variables(), "int8")
    return (lambda: pipe.sample_batch(serving, mode=mode)), serving


def _sd(device="cpu"):
    from eda_dm_tpu_torch.models.latent_diffusion import LatentDiffusionConfig
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNetConfig
    from eda_dm_tpu_torch.models.vae import VAEConfig
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
    mc = LatentDiffusionConfig(
        unet=LDMUNetConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                           num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                           num_heads=4, use_spatial_transformer=True, transformer_depth=1,
                           context_dim=32, legacy=False),
        vae=VAEConfig(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(),
                      in_channels=3, resolution=16, z_channels=4, double_z=True, embed_dim=4),
        timesteps=50, cond="text")
    pipe = LDMPipeline(task_config("coco", custom_steps=STEPS, batch_size=2), mc,
                       device=device)
    assert pipe.cfg.sampler == "plms" and pipe.is_conditional
    unet, mode = pipe.serving_variables(serve="int8")

    def batch():
        enc = pipe.ld.get_learned_conditioning
        return pipe.sample_batch(mode, context=enc(["a red bus", "two dogs"]),
                                         uncond=enc(["", ""]), unet=unet,
                                 generator=pipe.generator())
    return batch, pipe.sched.num_steps


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            fn()
    return prof


class Span:
    def __init__(self, name):
        self.name, self.children = name, []

    def find(self, prefix):
        return [c for c in self.children if c.name.startswith(prefix)]

    def walk(self):
        for c in self.children:
            yield c
            yield from c.walk()


def span_tree(prof) -> Span:
    """The ``edm.*`` spans of a session, each under its nearest ``edm.*``
    ancestor (the profiler's own nesting of host events)."""
    root, nodes = Span("root"), {}
    events = [e for e in prof.events() if e.name.startswith("edm.")]
    for e in sorted(events, key=lambda e: e.time_range.start):
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("edm."):
            parent = parent.cpu_parent
        node = nodes[id(e)] = Span(e.name)
        (nodes[id(parent)] if parent is not None else root).children.append(node)
    return root


def _check_forward(fwd, groups):
    assert [b.name for b in fwd.children if not b.name.startswith("edm.op.")] == groups
    for b in fwd.children:
        if b.name.startswith("edm.unet."):
            ops = [s for s in b.walk() if s.name.startswith("edm.op.")]
            assert ops, f"{b.name} holds no op span"
            assert all(not o.children for o in ops)


# --------------------------------------------------------------------------
def test_gate_off_makes_no_range_call(monkeypatch):
    calls = []
    real = run._RANGE
    monkeypatch.setattr(run, "_RANGE", lambda *a, **k: calls.append(a) or real(*a, **k))
    assert run.span("edm.a") is run.span("edm.b")          # the shared null context
    batch, _ = _cifar()
    _build.launch_record.append(("left", {}))
    with torch.no_grad():
        batch()
    assert calls == []
    assert not _build.recording()
    assert _build.launch_record == [("left", {})]             # nothing was added
    with run.span("edm.c"):
        pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with run.span("edm.d"):
            pass
    assert calls == [("edm.d",)]


def test_ddim_span_tree():
    batch, _ = _cifar()
    root = span_tree(_traced(batch))
    (b,) = root.children
    assert b.name == "edm.pipeline.batch"
    steps = b.find("edm.sampler.step")
    assert len(steps) == STEPS and len(b.children) == STEPS
    for s in steps:
        (fwd,) = s.children
        assert fwd.name == "edm.unet.forward"
        _check_forward(fwd, ["edm.unet.down.0", "edm.unet.down.1", "edm.unet.mid",
                             "edm.unet.up.1", "edm.unet.up.0"])
        names = collections.Counter(o.name for o in fwd.walk() if o.name.startswith("edm.op."))
        assert names["edm.op.int8_conv"] > 0


def test_plms_guided_span_tree():
    batch, n = _sd()
    root = span_tree(_traced(batch))
    assert [c.name for c in root.children] == ["edm.conditioning"] * 2 + ["edm.pipeline.batch"]
    b = root.children[-1]
    steps = b.find("edm.sampler.step")
    assert len(steps) == n > 2
    assert [c.name for c in b.children] == ["edm.sampler.step"] * n + ["edm.pipeline.decode"]
    # the first step holds the look-ahead: two forwards, the others one
    assert [len(s.find("edm.unet.forward")) for s in steps] == [2] + [1] * (n - 1)
    groups = ([f"edm.unet.input_blocks.{i}" for i in range(4)] + ["edm.unet.middle_block"]
              + [f"edm.unet.output_blocks.{i}" for i in range(4)])
    for s in steps:
        assert all(c.name == "edm.unet.forward" for c in s.children)
        for fwd in s.children:
            _check_forward(fwd, groups)
    ops = collections.Counter(o.name for o in b.walk() if o.name.startswith("edm.op."))
    assert ops["edm.op.int8_conv"] and ops["edm.op.int8_bmm"]


def test_phases_are_spans():
    timer = run.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("load"):
            with run.span("edm.inner"):
                pass
        with timer.phase("sample"):
            pass
    root = span_tree(prof)
    assert [c.name for c in root.children] == ["edm.phase.load", "edm.phase.sample"]
    assert [c.name for c in root.children[0].children] == ["edm.inner"]
    assert set(timer.summary()) == {"load", "sample"}


def _launch(tag):
    """What a launch site does after its launch."""
    _build.launch_counts["test_kernel"] += 1
    if _build.recording():
        _build.launch_record.append(("test_kernel", {"tag": tag}))


def test_a_second_session_replaces_the_record(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "launch_counts", collections.Counter())
    tags = lambda: [s["tag"] for _, s in _build.launch_record]
    for trace in (lambda d: run.profile_trace(str(tmp_path / d), label="t"),
                  lambda d: profile(activities=[ProfilerActivity.CPU])):
        _launch("off")
        with trace("a"):
            _launch(1)
            _launch(2)
        assert tags() == [1, 2]
        _launch("off")                     # a launch with no session recording
        assert tags() == [1, 2]
        with trace("b"):
            _launch(3)
        assert tags() == [3]


def test_span_without_the_fast_range_raises_while_recording(monkeypatch):
    monkeypatch.setattr(run, "_RANGE", run._no_range)
    with run.span("edm.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="_RecordFunctionFast"):
            run.span("edm.b")


def test_span_cost_probe_needs_a_card():
    """The probe of the spans' cost times the card's host path only: it
    refuses the host, CPU included, before it builds anything."""
    from eda_dm_tpu_torch.probes import span_cost
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        span_cost.main(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            span_cost.main()


# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_launch_record_on_the_card():
    """On the card, a tiny CIFAR batch under a profiler session: the record
    holds K1's launches alone, as many as ``launch_counts``' delta, and
    each equals the shapes a forward hook on its QConv saw."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from eda_dm_tpu_torch.nn.layers import QConv
    from eda_dm_tpu_torch.ops.serving_policy import int8_conv_serving
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    batch, serving = _cifar("cuda")
    with torch.no_grad():
        batch()                                           # builds and warms
    seen, hooks = [], []
    for m in serving.modules():
        if isinstance(m, QConv) and int8_conv_serving(DEPLOY_INT8, m.wq, m.aq,
                                                       m.disable_act_quant, m.split):
            hooks.append(m.register_forward_hook(lambda mod, args, out: seen.append(dict(
                n=args[0].shape[0], h=args[0].shape[1], w=args[0].shape[2],
                cin=args[0].shape[3], ho=out.shape[1], wo=out.shape[2], cout=out.shape[3],
                kh=mod.kernel_size[0], kw=mod.kernel_size[1],
                padded=mod.padding != "VALID", out_bytes=out.element_size()))))
    before = dict(_build.launch_counts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with torch.no_grad():
            batch()
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    delta = {k: v - before.get(k, 0) for k, v in _build.launch_counts.items()
             if v - before.get(k, 0)}
    assert collections.Counter(k for k, _ in _build.launch_record) == {
        "int8_conv": delta["int8_conv"]} and delta["int8_conv"] > 0
    assert [s for _, s in _build.launch_record] == seen
