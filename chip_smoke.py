#!/usr/bin/env python3
"""Drive the PyTorch port (``eda_dm_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing its results; any failed check raises and the run
exits non-zero before the last line:

1. device: ``nvidia-smi`` name and power limit, ``torch.cuda`` name;
2. build: the CUDA kernels from ``eda_dm_tpu_torch/csrc`` (cold), seconds;
3. each hand-written kernel against its plain PyTorch version on the card
   at the batch-500 CIFAR shapes: int32 accumulators bit-equal (K1, K2),
   outputs within the stated tolerance (K1's bf16 output, the serving
   carrier, equal), softmax codes within ±1 and
   ≥ 99.9 % equal (K3); median times of kernel, plain version, one
   library call where one computes the same function, and the bound;
4. the full CIFAR-10 ``DDPMConfig()`` UNet with seeded random weights and a
   smoke quant state (below), exported by the port's
   ``export_serving_int8``, in DEPLOY_INT8 through the kernels and through
   the plain versions (batch 8, f32 carrier): flip-aware gate;
5. serving, the main path: ``generalized_steps``, eta=0, 10 quad-skip
   steps at batch 500, bf16 carrier, DEPLOY_INT8 — launch counts are set
   to 0 just before and read just after; steps/s beside the bf16-FP and
   fp32-FP forwards in the same loop.

The smoke quant state stands in for calibration (a later slice): weight
scales from the per-output-channel symmetric range ``[-max|w|, max|w|]``
with round-to-nearest AdaRound alphas, activation scales from the min/max
that one FP forward (batch 8, t = 500) records at every act quantizer.

TF32 is off for the whole run: the plain versions and the fp32-FP forward
compute in full float32.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

BATCH, STEPS = 500, 10
INT8_PEAK, F32_PEAK, HBM = 1979e12, 67e12, 3.35e12     # H100 SXM data sheet


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}")


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(nbytes, ops, peak):
    tb, to = nbytes / HBM * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def codes(g, shape, lo=-128, hi=127):
    return torch.randint(lo, hi + 1, shape, generator=g, device="cuda",
                         dtype=torch.int32).to(torch.int8)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def check_conv(g):
    from eda_dm_tpu_torch.ops.int8_conv import (border_map, int8_conv,
                                                int8_conv_acc_plain,
                                                int8_conv_plain, out_size,
                                                same_pads)
    cases = [("32x32x128->128 3x3 same", 32, 128, 128, 3, 1, None),
             ("32x32x128 3x3 s2 downsample", 32, 128, 128, 3, 2, ((0, 1), (0, 1))),
             ("16x16x256->256 1x1", 16, 256, 256, 1, 1, ((0, 0), (0, 0))),
             ("conv_in 32x32x3->128 3x3", 32, 3, 128, 3, 1, None)]
    err, timing = 0.0, None
    for name, hw, cin, cout, k, s, pads in cases:
        pads = pads or same_pads(hw, hw, k, k, s, s)
        x = codes(g, (BATCH, hw, hw, cin))
        w = codes(g, (cout, k, k, cin), -8, 7)
        isum = w.float().sum((1, 2, 3))
        border = (border_map(w, hw, hw, (s, s), pads)
                  if pads != ((0, 0), (0, 0)) else None)
        c = torch.tensor(37.0, device="cuda")
        scale = torch.rand(cout, generator=g, device="cuda") * 1e-3
        bias = torch.randn(cout, generator=g, device="cuda")
        # accumulators: c = 0, scale = 1, no bias -> the f32 output is acc
        acc_k = int8_conv(x, w, isum, torch.zeros((), device="cuda"),
                          torch.ones(cout, device="cuda"), None, (s, s), pads,
                          border, torch.float32)
        acc_p = int8_conv_acc_plain(x, w, (s, s), pads)
        bad = acc_k.to(torch.int32) != acc_p
        check(not bool(bad.any()), f"K1 {name}: int32 accumulators bit-equal "
              f"({int(bad.sum())} differ, max |d| "
              f"{float((acc_k - acc_p.float()).abs().max()):.6g})")
        args = (x, w, isum, c, scale, bias, (s, s), pads, border)
        out_k = int8_conv(*args, torch.float32)
        out_p = int8_conv_plain(*args, torch.float32)
        e = float((out_k - out_p).abs().max())
        check(torch.allclose(out_k, out_p, rtol=1e-5, atol=1e-5),
              f"K1 {name}: f32 output within 1e-5 (max |d| {e:.3g})")
        err = max(err, e)
        # the serving carrier: both round one f32 value to bf16 (RN)
        check(torch.equal(int8_conv(*args, torch.bfloat16),
                          int8_conv_plain(*args, torch.bfloat16)),
              f"K1 {name}: bf16 output equal")
        if timing is None:                 # the most frequent conv shape
            ho, wo = out_size(hw, hw, k, k, (s, s), pads)
            nbytes = (x.numel() + w.numel() + BATCH * ho * wo * cout * 2
                      + 3 * cout * 4 + border.numel() * 4)
            ops = 2 * BATCH * ho * wo * cout * k * k * cin
            xf = x.permute(0, 3, 1, 2).float()
            wf = w.permute(0, 3, 1, 2).float()
            timing = dict(
                shape=f"batch {BATCH} {name}, bf16 out",
                ms=cuda_ms(lambda: int8_conv(*args, torch.bfloat16)),
                plain_ms=cuda_ms(lambda: int8_conv_plain(*args, torch.bfloat16)),
                library_ms=cuda_ms(lambda: torch.nn.functional.conv2d(
                    xf, wf, padding=1)),
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops, INT8_PEAK))))
    return dict(name="int8_conv", route="cuda",
                source="eda_dm_tpu_torch/csrc/int8_conv.cu",
                replaces="eda_dm_tpu/nn/layers.py:471", max_abs_err=err, **timing)


def check_bmm(g):
    from eda_dm_tpu_torch.ops.int8_einsum import (int8_bmm_acc_plain,
                                                  int8_bmm_nt, int8_bmm_nt_plain,
                                                  int8_code_einsum)
    import eda_dm_tpu_torch.ops.int8_einsum as ein
    cases = [("q.k (500,256,256)x(500,256,256)^T", (BATCH, 256, 256), (BATCH, 256, 256), "nic,njc->nij"),
             ("W.V (500,256,256)x(500,256,256)", (BATCH, 256, 256), (BATCH, 256, 256), "nij,njc->nic"),
             ("mid q.k (500,16,256)x(500,16,256)^T", (BATCH, 16, 256), (BATCH, 16, 256), "nic,njc->nij"),
             ("mid W.V (500,16,16)x(500,16,256)", (BATCH, 16, 16), (BATCH, 16, 256), "nij,njc->nic"),
             ("dense (500,512)x(512,512)", (1, BATCH, 512), (1, 512, 512), None)]
    err, timing = 0.0, None
    for name, sa, sb, eq in cases:
        A = codes(g, sa)
        B = codes(g, sb, *((-8, 7) if eq is None else (-128, 127)))
        Bt = B.transpose(1, 2).contiguous() if eq == "nij,njc->nic" else B
        acc_k = int8_bmm_nt(A, Bt)
        bad = acc_k.to(torch.int32) != int8_bmm_acc_plain(A, Bt)
        check(not bool(bad.any()), f"K2 {name}: int32 accumulators bit-equal "
              f"({int(bad.sum())} differ)")
        ca, cb = torch.tensor(11.0, device="cuda"), torch.tensor(-3.0, device="cuda")
        da, db = torch.tensor(0.013, device="cuda"), torch.tensor(0.0071, device="cuda")
        if eq is None:
            n = Bt.shape[1]
            kw = dict(col_add=torch.randn(n, generator=g, device="cuda"),
                      scale=torch.rand(n, generator=g, device="cuda") * 1e-3,
                      bias=torch.randn(n, generator=g, device="cuda"))
            out_k, out_p = int8_bmm_nt(A, Bt, **kw), int8_bmm_nt_plain(A, Bt, **kw)
        else:
            out_k = int8_code_einsum(eq, A, ca, da, B, cb, db)
            with swapped(ein, "int8_bmm_nt", _plain_bmm):
                out_p = int8_code_einsum(eq, A, ca, da, B, cb, db)
        e = float((out_k - out_p).abs().max())
        check(torch.allclose(out_k, out_p, rtol=1e-5, atol=1e-5),
              f"K2 {name}: f32 epilogue within 1e-5 (max |d| {e:.3g})")
        err = max(err, e)
        if timing is None:
            m, k = A.shape[1:]
            n = Bt.shape[1]
            nbytes = A.numel() + Bt.numel() + BATCH * m * n * 4 + BATCH * (m + n) * 4
            ops = 2 * BATCH * m * n * k
            Af, Bf = A.float(), Bt.float().transpose(1, 2)
            timing = dict(
                shape=f"{name}, f32 out",
                ms=cuda_ms(lambda: int8_code_einsum(eq, A, ca, da, B, cb, db)),
                plain_ms=cuda_ms(lambda: int8_bmm_nt_plain(
                    A, Bt, cb * A.sum(-1, dtype=torch.int32).float(),
                    ca * B.sum(-1, dtype=torch.int32).float(), ca * cb * 256.0, da * db)),
                library_ms=cuda_ms(lambda: torch.bmm(Af, Bf)),
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops, INT8_PEAK))))
    return dict(name="int8_bmm", route="cuda",
                source="eda_dm_tpu_torch/csrc/int8_bmm.cu",
                replaces="eda_dm_tpu/ops/int8_einsum.py:79", max_abs_err=err, **timing)


def _plain_bmm(A, B, row_add=None, col_add=None, k_add=None, scale=None,
               bias=None):
    from eda_dm_tpu_torch.ops.int8_einsum import int8_bmm_nt_plain
    if scale is None:
        scale = torch.ones((), device=A.device)
    return int8_bmm_nt_plain(A, B, row_add, col_add, k_add, scale, bias)


def check_softmax(g):
    from eda_dm_tpu_torch.ops.softmax_codes import (softmax_int8_codes,
                                                    softmax_int8_codes_plain)
    d, z = torch.tensor(1.0 / 255.0, device="cuda"), torch.tensor(0.0, device="cuda")
    timing = None
    for s in (256, 16):
        logits = 6.0 * torch.randn(BATCH * s, s, generator=g, device="cuda")
        ck, _ = softmax_int8_codes(logits, d, z, 256)
        cp = softmax_int8_codes_plain(logits, d, z, 256)
        diff = (ck.int() - cp.int()).abs()
        same = float((diff == 0).float().mean())
        check(int(diff.max()) <= 1 and same >= 0.999,
              f"K3 ({BATCH}*{s}, {s}): codes within ±1, {same:.6f} identical")
        if timing is None:
            n = logits.numel()
            timing = dict(
                shape=f"({BATCH}*{s}, {s}) f32 -> int8",
                max_abs_err=float(diff.max()),
                ms=cuda_ms(lambda: softmax_int8_codes(logits, d, z, 256)),
                plain_ms=cuda_ms(lambda: softmax_int8_codes_plain(logits, d, z, 256)),
                library_ms=None,
                **dict(zip(("bound_ms", "bound_by"),
                           bound(5 * n, 10 * n, F32_PEAK))))
    return dict(name="softmax_codes", route="triton",
                source="eda_dm_tpu_torch/ops/softmax_codes.py",
                replaces="eda_dm_tpu/ops/pallas_softmax.py:50", **timing)


# --------------------------------------------------------------------------
# phase 4/5 helpers


@contextlib.contextmanager
def swapped(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def plain_versions():
    """Route the model's three kernel call sites to the plain versions, on
    the card, for the comparison only."""
    import eda_dm_tpu_torch.models.ddpm_unet as unet
    import eda_dm_tpu_torch.nn.layers as layers
    import eda_dm_tpu_torch.ops.int8_einsum as ein
    from eda_dm_tpu_torch.ops.int8_conv import int8_conv_plain
    from eda_dm_tpu_torch.ops.softmax_codes import softmax_int8_codes_plain

    def softmax_plain(logits, delta, zp, n_levels):
        return (softmax_int8_codes_plain(logits, delta, zp, n_levels),
                n_levels / 2 - zp)

    with swapped(layers, "int8_conv", int8_conv_plain), \
            swapped(ein, "int8_bmm_nt", _plain_bmm), \
            swapped(unet, "softmax_int8_codes", softmax_plain):
        yield


@torch.no_grad()
def smoke_quant_state(model, x, t):
    """Stand-in for calibration: symmetric per-channel weight ranges with
    round-to-nearest alphas; act ranges from one FP forward."""
    from eda_dm_tpu_torch.nn.layers import ActQuantizer, QConv, QDense
    from eda_dm_tpu_torch.quant import FP
    from eda_dm_tpu_torch.quant.adaround import init_alpha
    from eda_dm_tpu_torch.quant.affine import calculate_qparams
    for m in model.modules():
        if isinstance(m, (QConv, QDense)):
            for name, s, e in m._parts:
                w = m.weight[:, s:e]
                amax = w.abs().reshape(w.shape[0], -1).amax(1)
                d, zp = calculate_qparams(-amax, amax, m.wq.n_levels)
                setattr(m, f"{name}_delta", d)
                setattr(m, f"{name}_zp", zp)
                setattr(m, f"{name}_alpha", init_alpha(w, m._per_channel(d)))
    ranges, hooks = {}, []
    for m in model.modules():
        if isinstance(m, ActQuantizer):
            def hook(mod, inputs, _out):
                v = inputs[0].float()
                lo, hi = ranges.get(mod, (v.min(), v.max()))
                ranges[mod] = (torch.minimum(lo, v.min()), torch.maximum(hi, v.max()))
            hooks.append(m.register_forward_hook(hook))
    model(x, t, FP)
    for h in hooks:
        h.remove()
    for m, (lo, hi) in ranges.items():
        m.delta, m.zero_point = calculate_qparams(lo, hi, m.spec.n_levels,
                                                  m.spec.always_zero)
    return len(ranges)


def profile_forward(fn, top=12):
    """One forward under torch.profiler: device busy share of the wall time
    and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3
    busy = sum(dev_ms(e) for e in kern)
    if busy == 0:
        print("    profiler saw no device time")
        return
    print(f"    one forward: wall {wall_ms:.2f} ms, kernels {busy:.2f} ms "
          f"(device busy {busy / wall_ms:.1%}, idle {1 - busy / wall_ms:.1%})")
    for e in sorted(kern, key=dev_ms, reverse=True)[:top]:
        print(f"      {dev_ms(e):8.3f} ms {dev_ms(e) / busy:6.1%} x{e.count:<4d} "
              f"{e.key[:90]}")


def steps_per_s(model_fn, x, seq, betas):
    """Steps/s of one synchronised DDIM run after a 2-step warm-up.  The
    launch counts are set to 0 just before the timed run."""
    from eda_dm_tpu_torch.ops._build import launch_counts
    from eda_dm_tpu_torch.samplers.ddim import generalized_steps
    generalized_steps(x, seq[:2], model_fn, betas, eta=0.0)      # warm up
    torch.cuda.synchronize()
    launch_counts.clear()
    t0 = time.perf_counter()
    out = generalized_steps(x, seq, model_fn, betas, eta=0.0)
    torch.cuda.synchronize()
    return len(seq) / (time.perf_counter() - t0), out


# --------------------------------------------------------------------------


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port first: without it (this file alone) nothing is printed
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.quant import DEPLOY_INT8, FP, QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    from eda_dm_tpu_torch.samplers.schedules import get_beta_schedule, skip_sequence

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {kind} x{torch.cuda.device_count()}")

    secs = _build.build()
    print(f"[2] build: {secs:.1f} s for {', '.join(_build.CUDA_SOURCES)}")
    for name in _build.CUDA_SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    print(f"[3] kernels vs plain versions, batch {BATCH}")
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    kernels = [check_conv(g), check_bmm(g), check_softmax(g)]
    for k in kernels:
        print(f"    {k['name']}: {k['shape']}: {k['ms']:.4f} ms (plain "
              f"{k['plain_ms']:.4f}, library {k['library_ms']}, bound "
              f"{k['bound_ms']:.4f} by {k['bound_by']})")
    print(f"    phase 3: {time.perf_counter() - t0:.1f} s")

    print("[4] DDPMConfig() DEPLOY_INT8, kernels vs plain versions (batch 8, f32)")
    cfg, qc = DDPMConfig(), QuantConfig(weight_bit=4, act_bit=8)
    model = DDPMUNet(cfg, qc, device="cuda", seed=0)
    gx = torch.Generator(device="cuda").manual_seed(1)
    x8 = torch.randn(8, 32, 32, 3, generator=gx, device="cuda")
    t8 = torch.full((8,), 500.0, device="cuda")
    n_aq = smoke_quant_state(model, x8, t8)
    export_serving_int8(model, qc, torch.float32)
    with torch.no_grad():
        fp_ref = DDPMUNet(cfg, qc, device="cuda", seed=0)(x8, t8, FP)
        out_k = model(x8, t8, DEPLOY_INT8)
        with plain_versions():
            out_p = model(x8, t8, DEPLOY_INT8)
    d = (out_k - out_p).abs()
    check(bool(torch.isfinite(out_k).all()) and out_k.shape == (8, 32, 32, 3),
          f"int8 output finite, shape {tuple(out_k.shape)} ({n_aq} act quantizers set)")
    med, mx, share = float(d.median()), float(d.max()), float((d < 2e-4).float().mean())
    check(med < 2e-4 and mx < 0.15 and share > 0.7,
          f"flip gate: median {med:.3g} < 2e-4, max {mx:.3g} < 0.15, "
          f"share {share:.4f} > 0.7")
    print(f"    quantization error mean |int8 - FP| = "
          f"{float((out_k - fp_ref).abs().mean()):.4f}")

    print(f"[5] serving: DDIM eta=0, {STEPS} quad steps, batch {BATCH}, "
          f"bf16 carrier DEPLOY_INT8")
    for p in model.parameters():                 # the export's carrier cast
        p.data = p.data.to(torch.bfloat16)
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=1000)
    seq = skip_sequence("quad", STEPS, 1000)
    xb = torch.randn(BATCH, 32, 32, 3, generator=gx, device="cuda")
    int8_fn = lambda x, t: model(x.to(torch.bfloat16), t, DEPLOY_INT8)
    int8_sps, out = steps_per_s(int8_fn, xb, seq, betas)         # the main path
    launches = dict(_build.launch_counts)
    check(bool(torch.isfinite(out).all()) and out.shape == (BATCH, 32, 32, 3),
          f"samples finite, shape {tuple(out.shape)}")
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        check(k["launches"] > 0, f"{k['name']} launched {k['launches']} times "
              f"({k['launches'] / STEPS:g} per forward) on the main path")
    print(f"    profile, DEPLOY_INT8 forward at batch {BATCH}, bf16 carrier:")
    t500 = torch.full((BATCH,), 500.0, device="cuda")
    with torch.no_grad():
        profile_forward(lambda: int8_fn(xb, t500))
    del model
    fp32 = DDPMUNet(cfg, qc, device="cuda", seed=0)
    fp32_sps, _ = steps_per_s(lambda x, t: fp32(x, t, FP), xb, seq, betas)
    bf16 = DDPMUNet(cfg, qc, device="cuda", seed=0).to(torch.bfloat16)
    bf16_sps, _ = steps_per_s(lambda x, t: bf16(x.to(torch.bfloat16), t, FP),
                              xb, seq, betas)
    print(f"    profile, bf16-FP forward at batch {BATCH}:")
    with torch.no_grad():
        profile_forward(lambda: bf16(xb.to(torch.bfloat16), t500, FP), top=6)
    print(f"    steps/s at batch {BATCH} on {smi}: int8 W4A8 {int8_sps:.4f} | "
          f"bf16-FP {bf16_sps:.4f} | fp32-FP {fp32_sps:.4f}")
    print(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{**{k: kern[k] for k in keys}, "check": "pass"}
                                  for kern in kernels]}))
    print(json.dumps({"serving_steps_per_s": {"int8": int8_sps, "bf16_fp": bf16_sps,
                                              "fp32_fp": fp32_sps, "batch": BATCH}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
