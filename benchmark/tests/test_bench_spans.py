"""The program's spans in a trace (``lib/spans.py``) on synthetic events:
whole spans at the stretch's edges, self time, idle put down to the
innermost span open when a gap began, the kernel → runtime call → span
link by correlation id; and a tiny traced run on the CPU, where the three
host metrics read numbers and the device ones read nothing."""

import io
import json
import types

import pytest
import torch

from benchmark.lib import spans
from benchmark.lib.manifest import Manifest
from benchmark.lib.spans import Ev

from . import tiny
from .conftest import run_cell

NEW = ("forward_host_ms.host_paced", "op_host_ms.host_paced", "sampler_self_ms.host_paced",
       "idle_in_forward_ms.host_paced", "forward_ms", "k1_roofline")
reader = Manifest().reader


def A(name, start, end):
    return Ev("cpu_op", name, start, end)


def R(start, corr):
    return Ev("cuda_runtime", "cudaLaunchKernel", start, start + 5, corr)


def K(start, end, corr, cat="kernel", name="k"):
    return Ev(cat, name, start, end, corr)


# The stretch stops at 1000 inside a batch and a step, which stay open.
EVENTS = [
    A("edm.pipeline.batch", 0, 1000),
    A("edm.sampler.step", 10, 400),
    A("edm.unet.forward", 20, 300),
    A("edm.unet.down.0", 30, 200),
    A("edm.op.int8_conv", 40, 60), R(50, 1),
    A("edm.op.int8_conv", 100, 120), R(110, 2),
    R(250, 3),                                  # in the forward, in no op
    R(350, 4),                                  # the sampler's update
    A("edm.sampler.step", 450, 1000), R(500, 5),
    Ev("cpu_op", "aten::add", 990, 995),
    R(-50, 6),                                  # before any span
    K(-40, -30, 6),
    K(60, 115, 1),                              # idle 115-130 began in an op
    K(130, 210, 2),                             # idle 210-260 in the forward
    K(260, 280, 3),                             # idle 280-360 in the forward
    K(360, 370, 4),                             # idle 370-520 in the step
    K(520, 530, 5), K(530, 540, 5, cat="gpu_memcpy", name="Memcpy DtoH"),
    K(600, 610, 99),                            # launched before the stretch
]


@pytest.fixture
def s():
    return spans.build(EVENTS)


def test_whole_spans_at_the_edges(s):
    assert [x.name for x in s.whole] == ["edm.sampler.step", "edm.unet.forward",
                                         "edm.unet.down.0", "edm.op.int8_conv",
                                         "edm.op.int8_conv"]
    assert len(s.named(spans.STEP)) == 1 and len(s.named(spans.FORWARD)) == 1


def test_stretch_keeps_what_it_launched(s):
    assert [d.corr for d in s.device] == [6, 1, 2, 3, 4, 5, 5]
    assert s.gaps == [(-30, 60), (115, 130), (210, 260), (280, 360), (370, 520)]


def test_idle_put_down_to_the_innermost_span(s):
    idle = s.idle_by_span()
    assert dict(idle) == pytest.approx({spans.NO_SPAN: 90e-9, "edm.op.int8_conv": 15e-9,
                                        "edm.unet.forward": 130e-9, "edm.sampler.step": 150e-9})
    assert s.idle_in(s.named(spans.FORWARD)) == pytest.approx(145e-9)


def test_kernel_links_to_its_launch_span(s):
    where = s.innermost([s.launcher(d).start for d in s.device])
    assert where == [spans.NO_SPAN, "edm.op.int8_conv", "edm.op.int8_conv", "edm.unet.forward",
                     "edm.sampler.step", "edm.sampler.step", "edm.sampler.step"]
    (fwd,) = s.named(spans.FORWARD)
    assert s.device_busy_ms(fwd) == pytest.approx(155e-6)       # 60-115, 130-210, 260-280


def test_readers_on_synthetic_events(s):
    r = types.SimpleNamespace(spans=s, trace={"window_s": 580e-9, "busy_s": 195e-9})
    read = lambda name: reader(name)(r)
    assert read("forward_host_ms.host_paced") == pytest.approx(280e-6)
    assert read("op_host_ms.host_paced") == pytest.approx(40e-6)
    assert read("sampler_self_ms.host_paced") == pytest.approx(110e-6)
    assert read("idle_in_forward_ms.host_paced") == pytest.approx(145e-6)
    assert read("forward_ms") == pytest.approx(155e-6)
    out = io.StringIO()
    spans.report(s, r.trace, out)
    text = out.getvalue()
    assert "idle in whole forwards 0.000 ms" in text and "(no span)" in text
    assert ("idle by level: edm.sampler.step 0.000 ms (38.96 %), edm.unet.forward 0.000 ms "
            "(33.77 %), (no span) 0.000 ms (23.38 %), edm.op.* 0.000 ms (3.90 %)") in text


class Kineto:
    """A Kineto event as a torch without ``activity_type`` gives it."""

    def __init__(self, name, device="DeviceType.CPU", user=False):
        self._name, self._device, self._user = name, device, user

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._user

    def activity_type(self):
        return None


@pytest.mark.parametrize("event, cat", [
    (Kineto("edm.unet.forward", user=True), "user_annotation"),
    (Kineto("edm.unet.forward", "DeviceType.CUDA", user=True), "user_annotation"),
    (Kineto("cudaLaunchKernelExC"), "cuda_runtime"),
    (Kineto("cuLaunchKernel"), "cuda_driver"),
    (Kineto("aten::cumsum"), "cpu_op"),
    (Kineto("Runtime Triggered Module Loading"), "cpu_op"),
    (Kineto("Memcpy DtoD (Device -> Device)", "DeviceType.CUDA"), "gpu_memcpy"),
    (Kineto("Memset (Device)", "DeviceType.CUDA"), "gpu_memset"),
    (Kineto("void int8_conv_kernel<128>", "DeviceType.CUDA"), "kernel"),
])
def test_categories_without_activity_type(event, cat):
    assert spans._category(event) == cat


def test_annotations_are_neither_spans_nor_device_activity():
    """A ``record_function`` range (the caller's) is no program span, and
    its copy on the card, which carries a correlation id, is no kernel."""
    s = spans.build([A("edm.unet.forward", 0, 100), Ev("user_annotation", "edm.x", 10, 50),
                     R(20, 1), Ev("user_annotation", "edm.x", 25, 90, 1), K(30, 40, 1),
                     Ev("cpu_op", "aten::add", 200, 205)])
    assert [x.name for x in s.spans] == ["edm.unet.forward"]
    assert [(d.cat, d.start) for d in s.device] == [("kernel", 30)]


def test_no_program_spans_reads_nothing():
    assert spans.build([Ev("cpu_op", "aten::add", 0, 5), R(1, 1), K(10, 20, 1)]) is None
    r = types.SimpleNamespace(window=types.SimpleNamespace(prof=None), trace=None)
    assert spans.read(r) is None
    for name in NEW:
        assert reader(name)(r) is None


def test_tiny_traced_run_reads_host_metrics(tiny_root, monkeypatch):
    """A traced run of the tiny latent cell on the CPU: the host metrics
    read the program's spans; no device activity, so the device ones and
    K1's record (no card, no launch) read nothing."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] = [tiny.LATENT]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)   # no card to wait for
    # a window long enough that the stretch (forwards 2 and 3) closes in it
    rc, res = run_cell(tiny_root, tiny.LATENT, seconds=10.0, trace=1)
    assert rc == 0
    got = res["metrics"]
    for name in ("forward_host_ms.host_paced", "op_host_ms.host_paced",
                 "sampler_self_ms.host_paced"):
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
    for name in ("idle_in_forward_ms.host_paced", "forward_ms", "k1_roofline"):
        assert name not in got
