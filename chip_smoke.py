#!/usr/bin/env python3
"""Drive the PyTorch port (``eda_dm_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing its results; any failed check raises and the run
exits non-zero before the last line:

1. device: ``nvidia-smi`` name, power limit and max SM clock, ``torch.cuda``
   name and SM count;
2. build: the CUDA kernels from ``eda_dm_tpu_torch/csrc`` (cold, one
   ``nvcc`` each, all started together), seconds;
3. each hand-written kernel against its plain PyTorch version on the card:
   int32 accumulators bit-equal (K1, K2; the CIFAR batch-500 shapes and the
   LSUN-Bedroom ones: the symmetric-pad stride-2 conv of ``DownsampleL``, a
   concatenated input, the heads-layout einsums), outputs within the stated
   tolerance (K1's bf16 output, the serving carrier, equal); softmax codes
   within ±1 and ≥ 99.9 % equal, the rows that differ counted (K3 at the
   CIFAR shapes, bf16 logits too, the bedroom 8x8 site's and SD's
   cross-attention, each with its ``softmax_plan`` and its device time by
   the profiler beside the CUDA events; K4 at its bedroom, CIFAR and SD
   shapes and K5 at SD's 64×64 shapes, a query length other than the key
   length and a 16-level softmax quantizer (each on its plan's one-pass
   route), past the one pass (the sweep route) and at ImageNet's 32×32
   site (100, 1024, 1024, 384) on the one-pass-wide route (codes and
   outputs equal to the plain version's), timed beside its bound and the
   sweep route's kernel on the same inputs; K4 at
   ImageNet's (100, 256, 576) and (100, 64, 960), K2 at its
   cross-attention's N = 1 and K = 1 products and K3 on its rows of
   width 1), whose outputs agree within rtol = atol = 1e-5 on the rows
   whose codes agree); K2's int32 sums and
   f32 epilogue bit-equal at both tiles and each load route (SD's K = 40
   and K = 77, operands off a 16-byte boundary), K2 alone timed beside its
   einsum, ``torch.bmm`` in f32 on the codes and ``torch._int_mm`` at the
   dense shapes, with the bound, at every shape; K1 also at SD's 1×1
   ``proj_in``, bedroom's 224 channels, SD's ``conv_in`` (Cin = 4, the
   byte gather), CIFAR's ``conv_out`` (Cout = 3, the 128×64 tile),
   ImageNet's widest level at 100 rows (with its bound) and VALID over
   K6's padded codes, each with its ``conv_plan`` (tile and
   route) and time, ``ptxas``'s registers and spills of each K1 instance,
   CIFAR's 3×3 and SD's 1×1 beside ``F.conv2d`` in f32 and in bf16
   channels-last on the same codes (and ``torch._int_mm`` at the 1×1); K6
   (fused GroupNorm) at the CIFAR, bedroom and SD norm sites, codes within
   ±1 and ≥ 99.9 % equal (bit-equal expected), ``gn_norm`` equal in bf16
   and within 1e-5 in f32; K7 (fake-quant matmul) equal to ``fake_quant``
   through an identity weight, else within 1e-5·(|xq|·|w| + |bias|) of a
   float64 product (bf16: plus one bf16 step) at the DEPLOY_FUSED CIFAR
   shapes, in both weight layouts, the bf16 tensor-core route also by
   device time with its ``fq_plan``; median times of kernel, plain
   version, one library call where one computes the same function (for K3
   the chain softmax → ``quantize_act_int8`` instead, for K4 and K5 the
   port's own einsum chain K2 → K3 → K2, for K6 the unfused GNorm → swish
   → quantize chain, for K7 the DEPLOY chain fake_quant → matmul → bias),
   and the bound;
3b. K8 (int8 quantized matmul) against its plain version: int32
   accumulators and outputs bit-equal at the JAX test's shapes, ragged
   ones, the resident stripe and the streamed path with each load route,
   SD's GEGLU dense and K7's CIFAR shape, float32 and bf16 x, and bf16 x
   with Python-number s_x, z_x; timed beside the call that transposes the
   weights itself, the bound, the plain version, ``torch._int_mm`` on the
   same codes and the chain quantize → ``_int_mm`` → epilogue; then K8's path as its
   test drives it (``weight_qparams`` → ``pack_dense_weights`` →
   ``quantized_matmul`` at SD's GEGLU width, launch counts set to 0 just
   before and read just after, the output within 1e-4 of the fake-quant
   product).  P1 (the tensor-core rate probe) on both its routes, the
   ``wgmma`` kernel and the ``mma.sync`` one: int8 chains bit-equal to the
   plain chains after 40 steps, bf16 chains within the probe's stated
   tolerance, one_mm exact, at the probe's three shapes, the wgmma build
   free of spills; then the probe's own ``main()`` as its path (counts set
   to 0 just before, read just after, both routes' counters and nothing
   else): each route's int8 and bf16 rates beside the bound and the data
   sheet, the SM clock after each shape's timed chains, the library
   chains, one library product and the library's own rate at 8192³;
4. the full CIFAR-10 ``DDPMConfig()`` UNet with seeded random weights and a
   smoke quant state (below), exported by the port's
   ``export_serving_int8``, in DEPLOY_INT8 through the kernels and through
   the plain versions (batch 8, f32 carrier): flip-aware gate; then the
   same with the fused GroupNorm (``EDM_FUSED_GN=1``: K6 at all 51 norm
   sites, and each recorded K6 call held as in phase 3) and in
   DEPLOY_FUSED (K7 at all 61 1×1 convs and denses);
5. CIFAR serving: ``generalized_steps``, eta=0, 10 quad-skip steps at batch
   500, bf16 carrier, DEPLOY_INT8 — launch counts are set to 0 just before
   and read just after; again with the fused GroupNorm (K6's main path),
   then the folded W4A8 export in DEPLOY and in DEPLOY_FUSED (K7's main
   path); steps/s of each beside the bf16-FP and fp32-FP forwards, and a
   profile of one forward of each int8 arm and of DEPLOY_FUSED;
6. the full LSUN-Bedroom LDM-4 UNet (``bedroom_config()``), smoke quant
   state, DEPLOY_INT8 through the kernels and the plain versions (batch 5,
   f32 carrier; its attention sites take the branches of batch 50): the
   same flip-aware gate, then K3 and K4 on each call's input from the
   plain run, held as in phase 3; again with the fused GroupNorm and its
   narrow widths (``EDM_FUSED_GN=1 EDM_FUSED_GN_NARROW=1``), printing the
   K6 launches;
7. bedroom serving: ``LDMPipeline.sample_batch``
   at batch 50, 10 DDIM steps at eta 1.0 (the task's eta; the cost of a
   step does not depend on their number), bf16 carrier, DEPLOY_INT8, then
   the VQ-f4 decode to (50, 256, 256, 3) images in [0, 1] — launch counts
   set to 0 just before and read just after, and printed per forward;
   ms per denoise step of int8 W4A8, int8 with the fused GroupNorm
   (``EDM_FUSED_GN=1 EDM_FUSED_GN_NARROW=1``), bf16-FP and fp32-FP (each
   warmed up at batch 50 and timed twice, fp32-FP once), the decode ms, img/s, peak
   memory and one profiled forward of each int8 arm;
8. the full Stable Diffusion v1.4 UNet (``sd_v1_config()``), smoke quant
   state, DEPLOY_INT8 through the kernels and the plain versions (one
   prompt under CFG, 2 rows, f32 carrier; its attention sites take the
   branches of the 8 rows of 4 prompts: K5 at the five 64×64 sites, K4 at
   the eleven others, K2 → K3 → K2 for every cross-attention): the
   flip-aware gate, then K3, K4 and K5 on each call's input from the
   plain run; again with the fused GroupNorm (``EDM_FUSED_GN=1``), printing
   the K6 launches;
9. SD serving, this slice's main path: ``LDMPipeline.sample_batch`` for
   the coco task, 4 prompts through the stand-in text encoder, CFG 7.5
   (8 UNet rows), 10 PLMS steps (11 UNet forwards: the first step looks
   ahead), bf16 carrier, DEPLOY_INT8, then the KL-f8 decode to
   (4, 512, 512, 3) images in [0, 1] — launch counts set to 0 just before
   and read just after; ms per UNet forward at 8 rows of int8 W4A8, int8
   with the fused GroupNorm (``EDM_FUSED_GN=1``), folded W4A8 (DEPLOY on
   the bf16 export: what the JAX package serves this family with),
   bf16-FP and fp32-FP (each warmed up at 8 rows and timed twice), the
   decode ms, img/s, peak memory and one profiled forward of each int8
   arm;
10. the CIFAR calibration path at ``DDPMConfig()`` (``calibration``'s
    docstring lists its cuts), served from its export;
11. the latent family's calibration, this slice's main path
    (``latent_calibration``'s docstring lists every cut): LSUN-Bedroom at
    ``bedroom_config()`` width through ``LDMPipeline`` — TDAC, scale init,
    AdaRound/FBR over the whole ``ldm_recon_plan``, the int8 export, its
    bundle, kernels vs plain versions at batch 5, ``sample_batch`` at
    batch 50 beside phase 7's smoke-state ms a step — with card-vs-host
    checks on the first res block's and the first attention block's
    quantizers; COCO (``sd_v1_config()``): TDAC under guidance, scale init
    and the plan through its first transformer block (the first capture
    with a text context), served at 8 rows through K5; LSUN-Church
    (``church_config()``, smoke state): DEPLOY_INT8 kernels vs plain
    versions at batch 5 on the attention branches of batch 100 (K4 at
    24-channel heads), then ``sample_batch`` at batch 100, 10 DDIM steps,
    KL-f8 decode;
12. the class-conditional ImageNet task, this slice's main path
    (``imagenet``'s docstring lists every cut): ``imagenet_config()``
    (one head at 384/576/960 channels, one-token class contexts from the
    1001-row embedder, VQ-f4), smoke state, DEPLOY_INT8 kernels vs plain
    versions at 2 rows on the branches of 100 (K5's one-pass-wide route
    at the five 32×32 sites, K4 at the eleven others, K2 → K3 → K2 over the one
    class token at the 16 cross-attentions) and DPM-Solver++ held step by
    step on the plain run's x_t; ``sample_batch`` with 50 labels under
    CFG 3.0 (100 UNet rows), 10 DDIM steps, the VQ-f4 decode, ms per
    denoise step of int8, folded W4A8, bf16-FP and fp32-FP, decode ms,
    img/s, peak memory, one profiled int8 forward; ``sampler="dpm"``
    (DPM-Solver++ order 2, 10 steps) at 100 rows; TDAC under guidance
    with class contexts, scale init and the plan through its first
    transformer block, the export served at 100 rows;
13. the scoring path, this slice's main path (``scoring``'s docstring
    lists every cut): a full-width CIFAR checkpoint and an ImageNet
    cin256-v2 one (UNet, VQ-f4, class embedder, EMA shadows) written in
    the reference's layout and loaded back bit-equal through
    ``CifarPipeline``, ``LDMPipeline`` (raw weights) and
    ``api.quantize_model`` (EMA weights); ``python -m
    eda_dm_tpu_torch.sample_ddim``'s ``main`` on the CIFAR checkpoint
    (int8 through K1–K3, and fp), 1,000 PNGs a set at batch 500;
    ``python -m eda_dm_tpu_torch.evaluate``'s ``main`` on the two sets
    (FID raw and standardized, IS, sFID at batch 200 on the card), one
    profiled Inception forward, the Inception card against host and the
    PNG round trip's features held exactly;
14. data and tensor parallelism, this slice's main path (``parallel``'s
    docstring lists every step): phase 5's smoke-state export of
    ``DDPMConfig()`` (DEPLOY_INT8, bf16 carrier, 10 quad DDIM steps at
    batch 500) through ``dp_sample`` on a one-rank NCCL mesh (bit-equal to
    one process) and on two gloo ranks sharing the card (250 rows a rank,
    each rank's K1–K3 launches per forward those of one process and each
    call held against its plain version), a tp = 2 DEPLOY_INT8 forward
    bit-equal to the unsharded one, ``dp_calibrate_acts`` bit-equal to
    ``set_act_quantize_params`` on the same quantizer inputs (free-running
    within its tolerance) and ``dp_reconstruct`` within JAX's dp tolerance
    of ``reconstruct``, then ``python -m
    eda_dm_tpu_torch.validate_ptq --task cifar``'s ``main`` at full width;
15. spatial parallelism, this slice's main path (``spatial_phase``'s
    docstring lists every step): K1 on every shard geometry of
    ``DDPMConfig()`` and bedroom's UNet (each shard's rows, halo and pads)
    bit-equal to its plain version and, concatenated, to the unsharded
    output; then the activations' height over two gloo ranks sharing the
    card: CIFAR's 10 DDIM steps at batch 500 (launch counts set to 0 just
    before and read just after: K1 76, K2 35, K3 6 a forward a rank),
    bedroom's DEPLOY_INT8 forward at batch 50 (K4 on the gathered
    sites) and SD's KL-f8 decode of 4 latents to 512×512, each against
    one process, with img/s or ms, the halo's calls, bytes and seconds
    and each rank's peak memory beside one process's;
16. ``python -m eda_dm_tpu_torch.gate_recon_deviations``'s ``main`` at
    ``--iters 20 --n 64 --calib 64 --steps 10``: every metric finite, the
    verdict printed, arm B's row cap taken;
17. CLIP ViT-L/14 at its published widths on random weights, this
    slice's main path (``clip_phase``'s docstring lists every step): a
    text checkout with a synthetic 49,408-entry vocabulary,
    ``FrozenCLIPTextEncoder`` card against host, ``python -m
    eda_dm_tpu_torch.sample_ldm --task coco --text_encoder clip --serve
    int8``'s ``main`` (launch counts set to 0 just before and read just
    after: ``DEFAULT_LAUNCHES["sd"]`` a forward under the CLIP context),
    then ``CLIPScorer`` on its images, card against host, with the
    towers' images/s and prompts/s at batch 64.

The serving switches (``EDM_FUSED_ATTN`` and the others that
``eda_dm_tpu_torch/ops/serving_policy.py`` reads) are unset for the run,
outside the blocks that set one; each serving path's launches per forward
are held to those of the default branches (``DEFAULT_LAUNCHES``).

The smoke quant state stands in for calibration in the serving phases
(phases 10 and 11 calibrate with the port's own path): weight scales from the per-output-channel symmetric range ``[-max|w|, max|w|]``
with round-to-nearest AdaRound alphas, activation scales from the min/max
that one FP forward records at every act quantizer.

TF32 is off for the whole run: the plain versions, the fp32-FP forwards
and the first-stage decode compute in full float32.
"""

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

BATCH, STEPS = 500, 10
LDM_BATCH = 50                         # the bedroom task's batch
CHURCH_BATCH = 100                     # the church task's batch
SD_ROWS = 8                            # 4 prompts under classifier-free guidance
IMAGENET_ROWS = 100                    # 50 labels under classifier-free guidance
INT8_PEAK, BF16_PEAK, F32_PEAK, HBM = 1979e12, 989e12, 67e12, 3.35e12  # H100 SXM
SFU_PER_CLOCK = 16                     # exponentials per SM per clock, sm_90
# launches per UNet forward of each serving path with every serving switch
# unset (the policy's default branches): a change of branch shows here
DEFAULT_LAUNCHES = {
    "cifar": {"int8_bmm": 35, "int8_conv": 76, "softmax_codes": 6},
    "bedroom": {"int8_attention": 10, "int8_bmm": 67, "int8_conv": 54, "softmax_codes": 6},
    "sd": {"int8_attention": 11, "int8_bmm": 215, "int8_conv": 85,
           "int8_flash_attention": 5, "softmax_codes": 16},
    "church": {"int8_attention": 5, "int8_bmm": 110, "int8_conv": 73, "softmax_codes": 16},
    "imagenet": {"int8_attention": 11, "int8_bmm": 215, "int8_conv": 86,
                 "int8_flash_attention": 5, "softmax_codes": 16}}
SERVING_SWITCHES = ("EDM_FUSED_ATTN", "EDM_FUSED_ATTN_NARROW", "EDM_FUSED_SOFTMAX",
                    "EDM_INT8_CONV", "EDM_INT8_ATTN", "EDM_FUSED_GN", "EDM_FUSED_GN_NARROW",
                    "EDM_SERVE_KIND")


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


def bound(nbytes, ops, peak, other_ms=0.0):
    """The larger of bytes over the memory rate and operations over their
    peak (``other_ms``: a further operation time, e.g. the exponentials)."""
    tb, to = nbytes / HBM * 1e3, max(ops / peak * 1e3, other_ms)
    return (tb, "bytes") if tb >= to else (to, "operations")


def codes(g, shape, lo=-128, hi=127):
    return torch.randint(lo, hi + 1, shape, generator=g, device="cuda",
                         dtype=torch.int32).to(torch.int8)


def codes_gate(ck, cp, what):
    """Softmax codes of a kernel and its plain version: within ±1 and
    ≥ 99.9 % identical.  Returns |Δ|."""
    diff = (ck.int() - cp.int()).abs()
    same = float((diff == 0).float().mean())
    check(int(diff.max()) <= 1 and same >= 0.999,
          f"{what}: codes within ±1, {same:.6f} identical")
    return diff


def attention_gate(out_k, W_k, out_p, W_p, what):
    """K4 against its plain version: the codes by ``codes_gate``, the
    output within rtol = atol = 1e-5 on the rows whose codes agree.
    Returns the largest |Δ| there."""
    rows = (codes_gate(W_k, W_p, what) == 0).all(-1)
    e = float((out_k[rows] - out_p[rows]).abs().max())
    check(torch.allclose(out_k[rows], out_p[rows], rtol=1e-5, atol=1e-5),
          f"{what}: output within 1e-5 on the {float(rows.float().mean()):.4%}"
          f" of rows whose codes agree (max |d| {e:.3g})")
    return e


def _times(t):
    """One shape's numbers as text: every ``*_ms`` time, then the bound."""
    parts = [f"{k[:-3]} {v:.4f}" for k, v in t.items()
             if k.endswith("_ms") and k not in ("ms", "bound_ms")
             and isinstance(v, (int, float))]
    parts += [f"{k} {v}" for k, v in t.items() if k in ("tile", "route", "plan")]
    if "bound_ms" in t:
        parts.append(f"bound {t['bound_ms']:.4f} by {t['bound_by']}")
    return f"{t['ms']:.4f} ms ({', '.join(parts)})"


def print_kernel(k):
    print(f"    {k['name']}: {k['shape']}: {_times(k)}")
    for shape, t in {**k["sd_ms"], **k.get("shapes_ms", {}), **k.get("imagenet_ms", {})}.items():
        print(f"      {shape}: {_times(t) if isinstance(t, dict) else f'{t:.4f} ms'}")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def ptxas_report(lib):
    """``[(kernel, registers, spill stores, spill loads)]`` of one library's
    build, from ``ptxas -v``'s lines in ``_build/<lib>.log`` (names
    demangled by ``c++filt`` where the machine has it)."""
    import re
    import shutil
    from eda_dm_tpu_torch.ops import _build
    log = _build.BUILD_DIR / f"{lib}.log"
    rows, entry, spills = [], None, (0, 0)
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append([entry, int(m.group(1)), *spills])
            entry, spills = None, (0, 0)
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        for r, n in zip(rows, names):
            r[0] = n or r[0]
    return [tuple(r) for r in rows]


def check_conv(g):
    from eda_dm_tpu_torch.ops.int8_conv import (border_map, conv_plan, int8_conv,
                                                int8_conv_acc_plain,
                                                int8_conv_plain, out_size,
                                                same_pads)
    F = torch.nn.functional
    import re
    for name, regs, st, ld in ptxas_report("int8_conv"):
        m = re.search(r"int8_conv_kernel<[^()]*>", name)
        print(f"    K1 instance {m.group(0) if m else name} (tile N, kstep, stages, route, "
              f"out): {regs} registers, spill stores {st} B, loads {ld} B")

    def bf16_conv_ms(x, w, padding):
        """``F.conv2d`` in bf16, channels-last, on the same codes: the conv
        that bf16-FP serving pays for."""
        cl = torch.channels_last
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=cl)
        wb = w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=cl)
        return cuda_ms(lambda: F.conv2d(xb, wb, padding=padding))

    cases = [(BATCH, "32x32x128->128 3x3 same", 32, 128, 128, 3, 1, None),
             (BATCH, "32x32x128 3x3 s2 downsample", 32, 128, 128, 3, 2, ((0, 1), (0, 1))),
             (BATCH, "16x16x256->256 1x1", 16, 256, 256, 1, 1, ((0, 0), (0, 0))),
             (BATCH, "conv_in 32x32x3->128 3x3", 32, 3, 128, 3, 1, None),
             (BATCH, "conv_out 32x32x128->3 3x3", 32, 128, 3, 3, 1, None),
             (LDM_BATCH, "bedroom DownsampleL 64x64x224 3x3 s2 pad ((1,1),(1,1))",
              64, 224, 224, 3, 2, ((1, 1), (1, 1))),
             (LDM_BATCH, "bedroom concat 32x32x(448+224)->448 3x3", 32, 672, 448,
              3, 1, None),
             (LDM_BATCH, "bedroom 64x64x224->224 3x3", 64, 224, 224, 3, 1, None),
             (SD_ROWS, "SD conv_in 64x64x4->320 3x3", 64, 4, 320, 3, 1, None),
             (IMAGENET_ROWS, "ImageNet 64x64x192->192 3x3", 64, 192, 192, 3, 1, None),
             (SD_ROWS, "SD proj_in 64x64x320->320 1x1", 64, 320, 320, 1, 1,
              ((0, 0), (0, 0))),
             # after K6, which writes the codes already padded: VALID over 34x34
             (BATCH, "3x3 VALID over K6's padded 34x34x128 codes", 34, 128, 128, 3, 1,
              ((0, 0), (0, 0)))]
    err, timing, sd, plans, shapes = 0.0, None, {}, {}, {}
    for batch, name, hw, cin, cout, k, s, pads in cases:
        pads = pads or same_pads(hw, hw, k, k, s, s)
        x = codes(g, (batch, hw, hw, cin))
        w = codes(g, (cout, k, k, cin), -8, 7)
        plans[f"batch {batch} {name}"] = "/".join(
            map(str, conv_plan(cin, cout, x.data_ptr(), w.data_ptr())))
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
        name = f"batch {batch} {name}"
        check(not bool(bad.any()), f"K1 {name} (plan {plans[name]}): int32 accumulators "
              f"bit-equal ({int(bad.sum())} differ, max |d| "
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
        if timing is not None and not name.startswith(f"batch {SD_ROWS} SD proj_in"):
            shapes[name] = dict(ms=cuda_ms(lambda: int8_conv(*args, torch.bfloat16)),
                                plan=plans[name])
            if batch == IMAGENET_ROWS:     # ImageNet's widest level, with its bound
                ho, wo = out_size(hw, hw, k, k, (s, s), pads)
                shapes[name].update(zip(("bound_ms", "bound_by"), bound(
                    x.numel() + w.numel() + batch * ho * wo * cout * 2 + 3 * cout * 4
                    + border.numel() * 4, 2 * batch * ho * wo * cout * k * k * cin,
                    INT8_PEAK)))
        if name.startswith(f"batch {SD_ROWS} SD proj_in"):
            # a 1x1 conv is a matmul over channels: (8*64*64, 320)x(320, 320)
            xf = x.permute(0, 3, 1, 2).float()
            wf = w.permute(0, 3, 1, 2).float()
            x2, w2 = x.reshape(-1, cin), w.reshape(cout, cin).t().contiguous()
            sd[name] = dict(
                ms=cuda_ms(lambda: int8_conv(*args, torch.bfloat16)),
                library_ms=cuda_ms(lambda: F.conv2d(xf, wf)),
                int_mm_ms=cuda_ms(lambda: torch._int_mm(x2, w2)),
                bf16_conv_ms=bf16_conv_ms(x, w, 0), plan=plans[name],
                **dict(zip(("bound_ms", "bound_by"), bound(
                    x.numel() + w.numel() + x.numel() // cin * cout * 2 + 3 * cout * 4,
                    2 * x.numel() * cout, INT8_PEAK))))
            del xf, wf
        if timing is None:                 # the most frequent conv shape
            ho, wo = out_size(hw, hw, k, k, (s, s), pads)
            nbytes = (x.numel() + w.numel() + BATCH * ho * wo * cout * 2
                      + 3 * cout * 4 + border.numel() * 4)
            ops = 2 * BATCH * ho * wo * cout * k * k * cin
            xf = x.permute(0, 3, 1, 2).float()
            wf = w.permute(0, 3, 1, 2).float()
            timing = dict(
                shape=f"{name}, bf16 out",
                ms=cuda_ms(lambda: int8_conv(*args, torch.bfloat16)),
                plain_ms=cuda_ms(lambda: int8_conv_plain(*args, torch.bfloat16)),
                library_ms=cuda_ms(lambda: F.conv2d(xf, wf, padding=1)),
                bf16_conv_ms=bf16_conv_ms(x, w, 1), plan=plans[name],
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops, INT8_PEAK))))
            del xf, wf
    for name, plan in plans.items():
        print(f"    K1 plan at {name}: {plan} (tile 0 = 128x128, 1 = 128x64 / route 16, "
              "8 bytes, or 1: the gather)")
    return dict(name="int8_conv", route="cuda",
                source="eda_dm_tpu_torch/csrc/int8_conv.cu",
                replaces="eda_dm_tpu/nn/layers.py:471", max_abs_err=err, sd_ms=sd,
                plans=plans, shapes_ms=shapes, **timing)


def _offset_codes(g, shape, offset):
    """Contiguous int8 codes whose first byte sits ``offset`` bytes past a
    256-byte boundary (to reach K2's narrower load routes)."""
    n = 1
    for d in shape:
        n *= d
    return codes(g, (n + offset,))[offset:].view(shape)


def check_bmm(g):
    """K2 against its plain version: int32 sums and the f32 epilogue
    bit-equal at the CIFAR, bedroom and SD shapes (both tiles; the 16-byte,
    8-byte and byte-gather routes, the last two also by operands 8 and 4
    bytes off a 16-byte boundary); K2 alone (``int8_bmm_nt`` with the
    einsum's epilogue terms) timed beside ``int8_code_einsum`` (K2 plus
    the code sums), ``torch.bmm`` in f32 on the codes, ``torch._int_mm``
    at the 2-D dense shapes, and the bound, at every shape."""
    from eda_dm_tpu_torch.ops.int8_einsum import (bmm_plan, int8_bmm_acc_plain,
                                                  int8_bmm_nt, int8_bmm_nt_plain,
                                                  int8_code_einsum)
    import eda_dm_tpu_torch.ops.int8_einsum as ein
    cases = [("q.k (500,256,256)x(500,256,256)^T", (BATCH, 256, 256), (BATCH, 256, 256), "nic,njc->nij", 0),
             ("W.V (500,256,256)x(500,256,256)", (BATCH, 256, 256), (BATCH, 256, 256), "nij,njc->nic", 0),
             ("mid q.k (500,16,256)x(500,16,256)^T", (BATCH, 16, 256), (BATCH, 16, 256), "nic,njc->nij", 0),
             ("mid W.V (500,16,16)x(500,16,256)", (BATCH, 16, 16), (BATCH, 16, 256), "nij,njc->nic", 0),
             ("dense (500,512)x(512,512)", (1, BATCH, 512), (1, 512, 512), None, 0),
             ("SD cross q.k (64,4096,40)x(64,77,40)^T", (64, 4096, 40), (64, 77, 40),
              "nic,njc->nij", 0),
             ("SD cross W.V, K = 77: (64,4096,77)x(64,77,40)", (64, 4096, 77),
              (64, 77, 40), "nij,njc->nic", 0),
             ("SD GEGLU dense (32768,320)x(320,2560)", (1, SD_ROWS * 4096, 320),
              (1, 2560, 320), None, 0),
             ("ImageNet cross q.k, N = 1: (100,1024,384)x(100,1,384)^T",
              (IMAGENET_ROWS, 1024, 384), (IMAGENET_ROWS, 1, 384), "nic,njc->nij", 0),
             ("ImageNet cross W.V, K = 1: (100,1024,1)x(100,1,384)",
              (IMAGENET_ROWS, 1024, 1), (IMAGENET_ROWS, 1, 384), "nij,njc->nic", 0),
             ("q.k, operands 8 bytes off 16", (BATCH, 256, 256), (BATCH, 256, 256),
              "nic,njc->nij", 8),
             ("q.k, operands 4 bytes off 8", (BATCH, 256, 256), (BATCH, 256, 256),
              "nic,njc->nij", 4)]
    err, shapes = 0.0, {}
    for name, sa, sb, eq, offset in cases:
        A = _offset_codes(g, sa, offset) if offset else codes(g, sa)
        B = codes(g, sb, *((-8, 7) if eq is None else (-128, 127)))
        Bt = B.transpose(1, 2).contiguous() if eq == "nij,njc->nic" else B
        if offset:
            Bt = _offset_codes(g, Bt.shape, offset).copy_(Bt)
        m, k = A.shape[1:]
        n = Bt.shape[1]
        tile, route = bmm_plan(n, k, A.data_ptr(), Bt.data_ptr())
        tag = f"K2 {name} (tile {'64x64' if tile else '128x128'}, route {route})"
        acc_k = int8_bmm_nt(A, Bt)
        bad = acc_k.to(torch.int32) != int8_bmm_acc_plain(A, Bt)
        check(not bool(bad.any()), f"{tag}: int32 accumulators bit-equal "
              f"({int(bad.sum())} differ)")
        ca, cb = torch.tensor(11.0, device="cuda"), torch.tensor(-3.0, device="cuda")
        da, db = torch.tensor(0.013, device="cuda"), torch.tensor(0.0071, device="cuda")
        if eq is None:
            kw = dict(col_add=torch.randn(n, generator=g, device="cuda"),
                      scale=torch.rand(n, generator=g, device="cuda") * 1e-3,
                      bias=torch.randn(n, generator=g, device="cuda"))
            out_k, out_p = int8_bmm_nt(A, Bt, **kw), int8_bmm_nt_plain(A, Bt, **kw)
            einsum = lambda: int8_bmm_nt(A, Bt, **kw)
            B_kn = Bt[0].t().contiguous()
        else:
            out_k = int8_code_einsum(eq, A, ca, da, B, cb, db)
            with swapped(ein, "int8_bmm_nt", _plain_bmm):
                out_p = int8_code_einsum(eq, A, ca, da, B, cb, db)
            sum_a = A.sum(-1, dtype=torch.int32).float()
            sum_b = (B.sum(-1) if eq == "nic,njc->nij" else B.sum(1)).to(torch.int32).float()
            kw = dict(row_add=cb * sum_a, col_add=ca * sum_b, k_add=ca * cb * float(k),
                      scale=da * db)
            einsum = lambda: int8_code_einsum(eq, A, ca, da, B, cb, db)
        e = float((out_k - out_p).abs().max())
        check(torch.equal(out_k, out_p), f"{tag}: f32 epilogue bit-equal (max |d| {e:.3g})")
        err = max(err, e)
        if offset:
            continue
        batch = A.shape[0]
        Af, Bf = A.float(), Bt.float().transpose(1, 2)
        nbytes = A.numel() + Bt.numel() + batch * m * n * 4 + sum(
            v.numel() * 4 for v in kw.values() if isinstance(v, torch.Tensor))
        shapes[name] = dict(
            ms=cuda_ms(lambda: int8_bmm_nt(A, Bt, **kw)),
            einsum_ms=cuda_ms(einsum),
            plain_ms=cuda_ms(lambda: int8_bmm_nt_plain(A, Bt, **kw), reps=5),
            bmm_f32_ms=cuda_ms(lambda: torch.bmm(Af, Bf)),
            int_mm_ms=(cuda_ms(lambda: torch._int_mm(A[0], B_kn))
                       if eq is None else None),
            tile="64x64" if tile else "128x128", route=route,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(nbytes, 2 * batch * m * n * k, INT8_PEAK))))
        shapes[name]["library_ms"] = (shapes[name]["int_mm_ms"] if eq is None
                                      else shapes[name]["bmm_f32_ms"])
        # the other tile at the same shape, held and timed beside
        with swapped(ein, "bmm_plan", lambda *a: (1 - tile, route)):
            check(torch.equal(int8_bmm_nt(A, Bt, **kw), int8_bmm_nt_plain(A, Bt, **kw)),
                  f"{tag}: the other tile gives the same output")
            shapes[name]["other_tile_ms"] = cuda_ms(lambda: int8_bmm_nt(A, Bt, **kw))
        del Af, Bf
    # the LDM heads layout at the bedroom 8x8 site: (50, 64, 28 heads, 32)
    b, s, h, c = LDM_BATCH, 64, 28, 32
    for eq, sa in (("bthc,bshc->bhts", (b, s, h, c)), ("bhts,bshc->bthc", (b, h, s, s))):
        A, B = codes(g, sa), codes(g, (b, s, h, c))
        Bh = B.permute(0, 2, 1, 3).reshape(b * h, s, c)
        Ah = (A.permute(0, 2, 1, 3).reshape(b * h, s, c) if eq.startswith("bthc")
              else A.reshape(b * h, s, s))
        Bt = Bh if eq.startswith("bthc") else Bh.transpose(1, 2).contiguous()
        bad = int8_bmm_nt(Ah.contiguous(), Bt).to(torch.int32) != int8_bmm_acc_plain(
            Ah.contiguous(), Bt)
        check(not bool(bad.any()), f"K2 heads {eq} ({b * h}, {s}, {sa[-1]}): int32 "
              f"accumulators bit-equal ({int(bad.sum())} differ)")
        ca, cb = torch.tensor(5.0, device="cuda"), torch.tensor(-2.0, device="cuda")
        da, db = torch.tensor(0.011, device="cuda"), torch.tensor(0.0093, device="cuda")
        out_k = int8_code_einsum(eq, A, ca, da, B, cb, db)
        with swapped(ein, "int8_bmm_nt", _plain_bmm):
            out_p = int8_code_einsum(eq, A, ca, da, B, cb, db)
        e = float((out_k - out_p).abs().max())
        check(torch.equal(out_k, out_p), f"K2 heads {eq}: f32 epilogue bit-equal "
              f"(max |d| {e:.3g})")
        err = max(err, e)
    main = cases[0][0]
    return dict(name="int8_bmm", route="cuda",
                source="eda_dm_tpu_torch/csrc/int8_bmm.cu",
                replaces="eda_dm_tpu/ops/int8_einsum.py:79", max_abs_err=err, sd_ms={},
                shape=f"{main}, f32 out, K2 alone", shapes_ms=shapes,
                **{k: v for k, v in shapes[main].items() if k not in ("tile", "route")})


def _plain_bmm(A, B, row_add=None, col_add=None, k_add=None, scale=None,
               bias=None):
    from eda_dm_tpu_torch.ops.int8_einsum import int8_bmm_nt_plain
    if scale is None:
        scale = torch.ones((), device=A.device)
    return int8_bmm_nt_plain(A, B, row_add, col_add, k_add, scale, bias)


def rows_differ(ck, cp):
    """Rows of two code matrices (last axis a row) that differ anywhere."""
    return int((ck != cp).reshape(-1, ck.shape[-1]).any(-1).sum())


def check_softmax(g):
    """K3 against its plain version at its four main-path shapes, float32
    logits (what the einsum attention hands it), and bf16 logits at
    CIFAR's: codes within ±1 and ≥ 99.9 % equal, the rows that differ
    counted (0 expected, apart from f64 sums that straddle an f32 rounding
    boundary); timed by CUDA events and by the profiler's device time,
    beside the bound, the plain version and the chain softmax →
    ``quantize_act_int8``."""
    from eda_dm_tpu_torch.ops.int8_einsum import quantize_act_int8
    from eda_dm_tpu_torch.ops.softmax_codes import (K3_PLAN_ARGS, softmax_int8_codes,
                                                    softmax_int8_codes_plain, softmax_plan)
    from eda_dm_tpu_torch.probes.mma_int8 import device_ms
    d, z = torch.tensor(1.0 / 255.0, device="cuda"), torch.tensor(0.0, device="cuda")
    err, shapes = 0.0, {}
    # CIFAR at batch 500 (256 and 16 tokens); the bedroom 8x8 site at batch
    # 50 (28 heads of 64 tokens); SD's cross-attention at 8 rows (8 heads of
    # 4096 queries over the 77 text tokens)
    cases = [("CIFAR 16x16 site", BATCH, 256, 256), ("CIFAR 4x4 site", BATCH, 16, 16),
             ("bedroom 8x8 site", LDM_BATCH * 28, 64, 64),
             ("SD cross-attention", SD_ROWS * 8, 77, 4096),
             ("ImageNet cross-attention, rows of 1", IMAGENET_ROWS, 1, 1024)]
    for what, n, s, q in cases:
        logits = 6.0 * torch.randn(n * q, s, generator=g, device="cuda")
        for x in ((logits, logits.to(torch.bfloat16)) if s == 256 else (logits,)):
            ck, _ = softmax_int8_codes(x, d, z, 256)
            cp = softmax_int8_codes_plain(x, d, z, 256)
            name = f"K3 {what} ({n}*{q}, {s}) {str(x.dtype)[6:]}"
            diff = codes_gate(ck, cp, name)
            print(f"    {name}: {rows_differ(ck, cp)} of {x.shape[0]} rows differ")
            err = max(err, float(diff.max()))
        nel = logits.numel()
        plan = softmax_plan(n * q, s, logits.dtype)
        kern = lambda: softmax_int8_codes(logits, d, z, 256)
        shapes[f"{what} ({n}*{q}, {s}) f32 -> int8"] = dict(
            ms=cuda_ms(kern), device_ms=device_ms(kern, "softmax_codes_kernel"),
            plain_ms=cuda_ms(lambda: softmax_int8_codes_plain(logits, d, z, 256), reps=5),
            chain_ms=cuda_ms(lambda: quantize_act_int8(torch.softmax(logits, -1), d, z, 256),
                             reps=5),
            plan=" ".join(f"{k} {plan[k]}" for k in K3_PLAN_ARGS),
            **dict(zip(("bound_ms", "bound_by"), bound(5 * nel, 10 * nel, F32_PEAK))))
        del logits, ck, cp
    main = next(iter(shapes))
    return dict(name="softmax_codes", route="cuda",
                source="eda_dm_tpu_torch/csrc/softmax_codes.cu",
                replaces="eda_dm_tpu/ops/pallas_softmax.py:50", max_abs_err=err,
                shape=main, library_ms=None, sd_ms={}, shapes_ms=shapes, **shapes[main])


def check_attention(g, sms, clock_hz):
    """K4 against its plain version at its main-path shapes: the two
    fused LSUN-Bedroom sites at batch 50 (32x32 and 16x16, 32-channel
    heads), the two CIFAR sites at batch 8, SD's three fused sites at
    8 rows (32x32, 16x16, 8x8) and LSUN-Church's 32x32 site at batch 100
    (24-channel heads)."""
    from eda_dm_tpu_torch.ops.int8_attention import (
        K4_PLAN_ARGS, _int8_fused_attention_cuda, attention_plan, attention_scalars,
        int8_fused_attention_plain)
    from eda_dm_tpu_torch.ops.int8_einsum import int8_code_einsum
    from eda_dm_tpu_torch.ops.softmax_codes import softmax_int8_codes
    err, timing, sd, shapes = 0.0, None, {}, {}
    for n, s, c in ((700, 1024, 32), (1050, 256, 32), (8, 256, 256), (8, 16, 256),
                    (64, 1024, 80), (64, 256, 160), (64, 64, 160),
                    (CHURCH_BATCH * 8, 1024, 24), (IMAGENET_ROWS, 256, 576),
                    (IMAGENET_ROWS, 64, 960)):
        Q, K, V = (codes(g, (n, s, c)) for _ in range(3))
        cq, ck, cv = 3.0, -5.0, 1.0
        dq, dk, dv, dw, zw = 0.021, 0.017, 0.025, 1.0 / 255.0, 0.0
        sc = attention_scalars(cq, dq, ck, dk, cv, dv, c ** -0.5, dw, zw, "cuda")
        out_k, W_k = _int8_fused_attention_cuda(Q, K, V, sc, 256, True)
        torch.cuda.synchronize()
        out_p, W_p = int8_fused_attention_plain(Q, K, V, sc, 256, True)
        err = max(err, attention_gate(out_k, W_k, out_p, W_p, f"K4 ({n}, {s}, {c})"))
        del W_k, W_p, out_p
        if n in (CHURCH_BATCH * 8, IMAGENET_ROWS):  # church's C = 24, ImageNet's wide heads
            exp_ch = n * s * s / (sms * SFU_PER_CLOCK * clock_hz) * 1e3
            what = "church" if n == CHURCH_BATCH * 8 else "ImageNet"
            shapes[f"{what} ({n}, {s}, {c})"] = dict(
                ms=cuda_ms(lambda: _int8_fused_attention_cuda(Q, K, V, sc, 256, False)),
                plan=" ".join(f"{k} {attention_plan(s, c)[k]}" for k in K4_PLAN_ARGS),
                **dict(zip(("bound_ms", "bound_by"),
                           bound(n * 7 * s * c, 4 * n * s * s * c, INT8_PEAK, exp_ch))))
        if n == SD_ROWS * 8:
            exp_sd = n * s * s / (sms * SFU_PER_CLOCK * clock_hz) * 1e3
            sd[f"SD ({n}, {s}, {c})"] = dict(
                ms=cuda_ms(lambda: _int8_fused_attention_cuda(Q, K, V, sc, 256, False)),
                **dict(zip(("bound_ms", "bound_by"),
                           bound(n * 7 * s * c, 4 * n * s * s * c, INT8_PEAK, exp_sd))))
        if timing is None:                 # the bedroom 32x32 site
            tq, tk, tv, tdq, tdk, tdv, tdw, tzw = (
                torch.tensor(v, device="cuda") for v in (cq, ck, cv, dq, dk, dv, dw, zw))

            def chain():
                w = int8_code_einsum("nic,njc->nij", Q, tq, tdq, K, tk, tdk) * (c ** -0.5)
                W, cw = softmax_int8_codes(w, tdw, tzw, 256)
                return int8_code_einsum("nij,njc->nic", W, cw, tdw, V, tv, tdv)
            exp_ms = n * s * s / (sms * SFU_PER_CLOCK * clock_hz) * 1e3
            timing = dict(
                shape=f"({n}, {s}, {c}) int8 -> f32 (bedroom 32x32, batch {LDM_BATCH})",
                ms=cuda_ms(lambda: _int8_fused_attention_cuda(Q, K, V, sc, 256, False)),
                plain_ms=cuda_ms(lambda: int8_fused_attention_plain(Q, K, V, sc, 256),
                                 reps=5),
                library_ms=None, chain_ms=cuda_ms(chain, reps=5),
                plan=" ".join(f"{k} {attention_plan(s, c)[k]}" for k in K4_PLAN_ARGS),
                **dict(zip(("bound_ms", "bound_by"),
                           bound(n * 7 * s * c, 4 * n * s * s * c, INT8_PEAK, exp_ms))))
            print(f"    K4 bound parts: bytes {n * 7 * s * c / HBM * 1e3:.4f} ms, int8 "
                  f"ops {4 * n * s * s * c / INT8_PEAK * 1e3:.4f} ms, exponentials "
                  f"{exp_ms:.4f} ms ({sms} SMs at {clock_hz / 1e6:.0f} MHz)")
    return dict(name="int8_attention", route="cuda",
                source="eda_dm_tpu_torch/csrc/int8_attention.cu",
                replaces="eda_dm_tpu/ops/pallas_attention.py:115",
                max_abs_err=err, sd_ms=sd, shapes_ms=shapes, **timing)


def check_flash(g, sms, clock_hz):
    """K5 against its plain version: SD's 64x64 self-attention at 8 rows
    (64 batch-heads) and at 2 (16), a query length other than the key
    length, and a 16-level softmax quantizer, each on the route of its
    ``flash_plan`` (one pass, the keys over a cluster of blocks), a key
    length past what 8 blocks hold and a head past its resident 1024
    columns (the sweep route, C in chunks), and ImageNet's 32x32 site at
    100 rows (the one-pass-wide route, one W·V buffer: codes and outputs
    equal to the plain version's); timed at SD's 8-row shape beside the
    bound and the port's einsum chain K2 -> K3 -> K2, and at ImageNet's
    beside the bound and the sweep route's kernel on the same inputs."""
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.ops.int8_attention import (
        _SWEEP_SIG, K5_PLAN_ARGS, _int8_flash_attention_cuda, attention_scalars, flash_plan,
        int8_flash_attention_plain)
    from eda_dm_tpu_torch.ops.int8_einsum import int8_code_einsum
    from eda_dm_tpu_torch.ops.softmax_codes import softmax_int8_codes
    err, timing = 0.0, None
    for n, sq, skv, c, levels in ((SD_ROWS * 8, 4096, 4096, 40, 256),
                                  (16, 4096, 4096, 40, 256), (8, 256, 512, 32, 256),
                                  (16, 4096, 4096, 40, 16), (2, 40, 6657, 40, 256),
                                  (1, 256, 512, 1280, 256),
                                  (IMAGENET_ROWS, 1024, 1024, 384, 256)):
        Q, K, V = codes(g, (n, sq, c)), codes(g, (n, skv, c)), codes(g, (n, skv, c))
        cq, ck, cv = 3.0, -5.0, 1.0
        dq, dk, dv, dw, zw = 0.021, 0.017, 0.025, 1.0 / (levels - 1), 0.0
        sc = attention_scalars(cq, dq, ck, dk, cv, dv, c ** -0.5, dw, zw, "cuda")
        out_k, W_k = _int8_flash_attention_cuda(Q, K, V, sc, levels, True)
        torch.cuda.synchronize()
        out_p, W_p = int8_flash_attention_plain(Q, K, V, sc, levels, True)
        plan = flash_plan(sq, skv, c)
        what = f"K5 ({n}, {sq}, {skv}, {c}), {levels} levels, {plan['route']} route"
        err = max(err, attention_gate(out_k, W_k, out_p, W_p, what))
        if n == IMAGENET_ROWS:             # ImageNet's 32x32 site, the one-pass-wide route
            check(plan["route"] == "one_pass_wide" and torch.equal(W_k, W_p)
                  and torch.equal(out_k, out_p),
                  f"{what}: every code and output equal to the plain version's")
        del W_k, W_p, out_p
        if n == IMAGENET_ROWS:
            logits = n * sq * skv
            exp_ms = logits / (sms * SFU_PER_CLOCK * clock_hz) * 1e3
            nbytes = n * (sq * c + 2 * skv * c + 4 * sq * c)
            sweep = _build.cuda_lib("int8_flash_sweep", _SWEEP_SIG)
            out_s = torch.empty_like(out_k)

            def sweep_call():              # the sweep route's kernel on the same inputs
                _build.check_launch(sweep, sweep.edm_int8_flash_sweep(
                    *(_build.ptr(x) for x in (Q, K, V, sc, out_s, None)), n, sq, skv, c,
                    levels, _build.stream_ptr(Q.device)), "int8_flash_sweep")
            imagenet_ms = {f"ImageNet ({n}, {sq}, {skv}, {c})": dict(
                ms=cuda_ms(lambda: _int8_flash_attention_cuda(Q, K, V, sc, levels, False)),
                sweep_ms=cuda_ms(sweep_call, reps=5),
                plain_ms=cuda_ms(lambda: int8_flash_attention_plain(Q, K, V, sc, levels),
                                 reps=3, warmup=1),
                plan=" ".join(f"{k} {plan[k]}" for k in ("route",) + K5_PLAN_ARGS
                              if k in plan),
                **dict(zip(("bound_ms", "bound_by"),
                           bound(nbytes, 4 * logits * c, INT8_PEAK, exp_ms))))}
            print(f"    K5 ImageNet ({n}, {sq}, {skv}, {c}): the sweep route's output equal "
                  f"to the one-pass-wide route's: {torch.equal(out_s, out_k)}")
            del out_s
        if timing is None:                 # SD 64x64, 4 prompts under CFG
            tq, tk, tv, tdq, tdk, tdv, tdw, tzw = (
                torch.tensor(v, device="cuda") for v in (cq, ck, cv, dq, dk, dv, dw, zw))

            def chain():
                w = int8_code_einsum("nic,njc->nij", Q, tq, tdq, K, tk, tdk) * (c ** -0.5)
                W, cw = softmax_int8_codes(w, tdw, tzw, levels)
                return int8_code_einsum("nij,njc->nic", W, cw, tdw, V, tv, tdv)
            logits = n * sq * skv
            exp_ms = logits / (sms * SFU_PER_CLOCK * clock_hz) * 1e3
            nbytes = n * (sq * c + 2 * skv * c + 4 * sq * c)
            timing = dict(
                shape=f"({n}, {sq}, {skv}, {c}) int8 -> f32 (SD 64x64, {SD_ROWS} rows)",
                ms=cuda_ms(lambda: _int8_flash_attention_cuda(Q, K, V, sc, levels, False)),
                plain_ms=cuda_ms(lambda: int8_flash_attention_plain(Q, K, V, sc, levels),
                                 reps=5, warmup=1),
                library_ms=None, chain_ms=cuda_ms(chain, reps=5, warmup=1),
                plan=" ".join(f"{k} {plan[k]}" for k in ("route",) + K5_PLAN_ARGS),
                **dict(zip(("bound_ms", "bound_by"),
                           bound(nbytes, 4 * logits * c, INT8_PEAK, exp_ms))))
            print(f"    K5 bound parts: bytes {nbytes / HBM * 1e3:.4f} ms, int8 ops "
                  f"{4 * logits * c / INT8_PEAK * 1e3:.4f} ms, exponentials "
                  f"{exp_ms:.4f} ms ({sms} SMs at {clock_hz / 1e6:.0f} MHz)")
    return dict(name="int8_flash_attention", route="cuda",
                source="eda_dm_tpu_torch/csrc/int8_flash_attention.cu",
                replaces="eda_dm_tpu/ops/pallas_attention.py:260",
                max_abs_err=err, sd_ms={}, imagenet_ms=imagenet_ms, **timing)


def check_gn(g):
    """K6 against its plain version at the fused-GroupNorm paths' shapes:
    codes within ±1 and ≥ 99.9 % equal (bit-equal expected: both add the
    statistics in float64 and run the same float32 steps), ``gn_norm``
    equal in bf16 and within 1e-5 in float32; timed beside the bound, the
    plain version and the port's unfused chain GNorm → swish →
    quantize_act_int8 (the norm alone for ``gn_norm``)."""
    from eda_dm_tpu_torch.nn.layers import GNorm, swish
    from eda_dm_tpu_torch.ops.gn_int8 import (K6_PLAN_ARGS, NO_PADS, gn_norm, gn_plain,
                                              gn_plan, gn_swish_int8)
    from eda_dm_tpu_torch.ops.int8_einsum import quantize_act_int8
    same = ((1, 1), (1, 1))
    cases = [("CIFAR conv1 (500, 32, 32, 128), SAME pad", BATCH, 32, 128, same, True),
             ("CIFAR up concat (500, 32, 32, 384), SAME pad", BATCH, 32, 384, same, True),
             ("CIFAR attention (500, 16, 16, 256), gn_norm", BATCH, 16, 256, None, False),
             ("bedroom (50, 16, 16, 672), SAME pad, 21 channels a group", LDM_BATCH,
              16, 672, same, True),
             ("SD proj_in (8, 16, 16, 1280), no pad, no swish", SD_ROWS, 16, 1280,
              NO_PADS, False)]
    d, zp = torch.tensor(0.043, device="cuda"), torch.tensor(57.0, device="cuda")
    err, shapes = 0.0, {}
    for name, b, hw, c, pads, act in cases:
        x = (2.1 * torch.randn(b, hw, hw, c, generator=g, device="cuda") + 0.3)
        scale = 0.5 + torch.rand(c, generator=g, device="cuda")
        bias = 0.1 * torch.randn(c, generator=g, device="cuda")
        gn = GNorm(c).cuda()
        gn.scale.data, gn.bias.data = scale, bias
        for xx in (x, x.to(torch.bfloat16)):
            tag = f"K6 {name}, {str(xx.dtype)[6:]}"
            if pads is None:
                yk = gn_norm(xx, scale, bias, swish=act)
                yp = gn_plain(xx, scale, bias, None, None, 0, NO_PADS, act, 32, 1e-6)
                e = float((yk.float() - yp.float()).abs().max())
                if xx.dtype == torch.bfloat16:
                    check(torch.equal(yk, yp), f"{tag}: equal to the plain version")
                else:
                    check(torch.allclose(yk, yp, rtol=1e-5, atol=1e-5),
                          f"{tag}: within 1e-5 of the plain version (max |d| {e:.3g})")
                err = max(err, e)
                kern = lambda: gn_norm(xx, scale, bias, swish=act)
                plain = lambda: gn_plain(xx, scale, bias, None, None, 0, NO_PADS, act,
                                         32, 1e-6)
                chain = lambda: swish(gn(xx)) if act else gn(xx)
                out_bytes = xx.numel() * xx.element_size()
            else:
                ck = gn_swish_int8(xx, scale, bias, d, zp, 256, pads, swish=act)[0]
                cp = gn_plain(xx, scale, bias, d, zp, 256, pads, act, 32, 1e-6)
                diff = codes_gate(ck, cp, tag)
                print(f"    {tag}: {int((diff != 0).sum())} of {diff.numel()} codes "
                      f"differ (bit-equal expected)")
                err = max(err, float(diff.max()))
                kern = lambda: gn_swish_int8(xx, scale, bias, d, zp, 256, pads, swish=act)
                plain = lambda: gn_plain(xx, scale, bias, d, zp, 256, pads, act, 32, 1e-6)
                chain = lambda: quantize_act_int8(swish(gn(xx)) if act else gn(xx),
                                                  d, zp, 256)
                out_bytes = ck.numel()
            if xx.dtype == torch.bfloat16:      # the serving carrier: timed
                nbytes = xx.numel() * 2 + out_bytes + 2 * c * 4
                plan = gn_plan(b, hw, hw, c, xx.dtype)
                shapes[name] = dict(
                    ms=cuda_ms(kern), plain_ms=cuda_ms(plain, reps=5),
                    chain_ms=cuda_ms(chain, reps=5),
                    plan=" ".join(f"{k} {plan[k]}" for k in K6_PLAN_ARGS),
                    **dict(zip(("bound_ms", "bound_by"),
                               bound(nbytes, 12 * xx.numel(), F32_PEAK))))
        del x, xx, gn
    main = cases[0][0]
    return dict(name="gn_int8", route="cuda", source="eda_dm_tpu_torch/csrc/gn_int8.cu",
                replaces="eda_dm_tpu/ops/pallas_gn.py:172", max_abs_err=err,
                shape=f"{main}, bf16 -> int8 codes", library_ms=None, sd_ms={},
                shapes_ms=shapes, **shapes[main])


def check_fq(g):
    """K7 against a float64 product of the same fake-quantized operand:
    with an identity weight in float32 the output is ``fake_quant(x)`` bit
    for bit (the float32 route); otherwise |Δ| ≤ 1e-5·(|xq|·|w| + |bias|)
    in float32 and within one bf16 step (plus that) in bf16 (the
    tensor-core route), at the DEPLOY_FUSED CIFAR shapes, with the port's
    [out, in] weights and a contiguous (K, N); the bf16 route timed by CUDA
    events and by the profiler's device time, with its ``fq_plan``, beside
    the bound, the plain version and the DEPLOY chain fake_quant → cuBLAS
    matmul → bias."""
    from eda_dm_tpu_torch.ops.quant_matmul import (fakequant_matmul, fakequant_matmul_plain,
                                                   fq_error, fq_plan)
    from eda_dm_tpu_torch.probes.mma_int8 import device_ms
    from eda_dm_tpu_torch.quant.affine import fake_quant
    x = 3.0 * torch.randn(4096, 256, generator=g, device="cuda")
    dk, zk = torch.full((256,), 0.031, device="cuda"), torch.full((256,), 121.0, device="cuda")
    check(torch.equal(fakequant_matmul(x, torch.eye(256, device="cuda"), dk, zk, 256),
                      fake_quant(x, dk[0], zk[0], 256)),
          "K7 identity weight, float32 (4096, 256): output == fake_quant(x) bit for bit")
    cases = [("CIFAR attention 1x1 (128000, 256) x (256, 256)", BATCH * 256, 256, 256, 0),
             ("CIFAR split nin_shortcut (128000, 512) x (512, 256), split at 256",
              BATCH * 256, 512, 256, 256),
             ("CIFAR temb_proj dense (500, 512) x (512, 256)", BATCH, 512, 256, 0)]
    err, shapes = 0.0, {}
    for name, m, k, n, split in cases:
        x = 1.7 * torch.randn(m, k, generator=g, device="cuda") + 0.2
        w = 0.05 * torch.randn(n, k, generator=g, device="cuda")     # [out, in]
        first = torch.arange(k, device="cuda") < (split or k)
        dk = torch.where(first, 0.031, 0.017)
        zk = torch.where(first, 121.0, 64.0)
        bias = 0.3 * torch.randn(n, generator=g, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            for layout in ("[out, in] weights", "(K, N) weights"):
                xx, ww = x.to(dt), w.to(dt).t()
                if layout == "(K, N) weights":
                    ww = ww.contiguous()
                ok, e = fq_error(fakequant_matmul(xx, ww, dk, zk, 256, bias), xx, ww, dk,
                                 zk, 256, bias)
                check(ok, f"K7 {name}, {str(dt)[6:]}, {layout}: within "
                      f"{'one bf16 step + ' if dt == torch.bfloat16 else ''}"
                      f"1e-5·(|xq|·|w| + |bias|) of the float64 product (max |d| {e:.3g})")
                err = max(err, e)
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16).t()
        rows = [(dk[0], zk[0], split or k)] + ([(dk[-1], zk[-1], k - split)] if split else [])

        def chain():
            parts, s0 = [], 0
            for dd, zz, kk in rows:
                parts.append(fake_quant(xb[:, s0:s0 + kk], dd, zz, 256))
                s0 += kk
            return (torch.cat(parts, -1) if split else parts[0]) @ wb + bias
        nbytes = 2 * (m * k + k * n + m * n) + 2 * k * 4 + n * 4
        kern = lambda: fakequant_matmul(xb, wb, dk, zk, 256, bias)
        shapes[name] = dict(
            ms=cuda_ms(kern), device_ms=device_ms(kern, "fakequant_matmul"),
            plan=f"bn {fq_plan(m, n)}",
            plain_ms=cuda_ms(lambda: fakequant_matmul_plain(xb, wb, dk, zk, 256, bias),
                             reps=5),
            chain_ms=cuda_ms(chain, reps=5),
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 2 * m * n * k, BF16_PEAK))))
        del x, xb
    main = cases[0][0]
    return dict(name="fakequant_matmul", route="cuda",
                source="eda_dm_tpu_torch/csrc/fakequant_matmul.cu",
                replaces="eda_dm_tpu/ops/pallas_quant.py:143", max_abs_err=err,
                shape=f"{main}, bf16", library_ms=None, sd_ms={}, shapes_ms=shapes,
                **shapes[main])


# --------------------------------------------------------------------------
# phase 3b: K8 and P1, each against its plain version, then its own path


def check_quantized_matmul(g):
    """K8 against its plain version: int32 accumulators bit-equal and
    outputs equal (the epilogue runs the plain version's float32 operations
    in its order) at the JAX test's shapes, ragged shapes, the resident
    stripe and the streamed path with each load route of the weights, and
    the two timed shapes, in float32 and bf16, and with a bf16 x and
    Python-number s_x, z_x (the row term from JAX's bf16 outside pass);
    timed (bf16 x, the pack's K-major copy) beside the call that
    transposes w_q itself, the streamed plan at the same shape, the int32
    sums alone (the same products, int32 stores in place of the epilogue),
    the bound, the plain version, ``torch._int_mm`` on the same codes
    (library) and the chain quantize → ``_int_mm`` → epilogue."""
    import eda_dm_tpu_torch.ops.quant_matmul as qm
    from eda_dm_tpu_torch.ops.quant_matmul import (
        pack_dense_weights, qm_plan, quantize_x_int8, quantized_matmul,
        quantized_matmul_acc, quantized_matmul_acc_plain, quantized_matmul_epilogue,
        quantized_matmul_plain)
    from eda_dm_tpu_torch.quant import calculate_qparams, weight_qparams
    timed_shapes = {(SD_ROWS * 4096, 320, 2560): "SD GEGLU dense (32768, 320)x(320, 2560)",
                    (BATCH * 256, 256, 256): "CIFAR attention 1x1 (128000, 256)x(256, 256)"}
    shapes = {}
    for m, k, n in [(16, 32, 64), (8, 128, 128), (1000, 200, 72), (37, 130, 300),
                    (200, 40, 70), (129, 77, 130), (700, 512, 384), (300, 640, 200),
                    (70, 1000, 90), (50, 2051, 33), *timed_shapes]:
        x = 1.3 * torch.randn(m, k, generator=g, device="cuda") + 0.2
        w = 0.1 * torch.randn(k, n, generator=g, device="cuda")
        bias = torch.randn(n, generator=g, device="cuda")
        pk = pack_dense_weights(w, *weight_qparams(w, 256, symmetric=True, channel_axis=1))
        streamed, route = qm_plan(k, pk["w_qt"].data_ptr())
        plan = f"{'streamed' if streamed else 'resident'}, route {route}"
        for xx in (x, x.to(torch.bfloat16)):
            s_x, z_x = calculate_qparams(xx.float().min(), xx.float().max(), 256)
            tag = f"K8 ({m}, {k})x({k}, {n}), {str(xx.dtype)[6:]}, {plan}"
            acc_k = quantized_matmul_acc(xx, pk["w_q"], s_x, z_x)
            bad = acc_k != quantized_matmul_acc_plain(xx, pk["w_q"], s_x, z_x)
            check(not bool(bad.any()), f"{tag}: int32 accumulators bit-equal "
                  f"({int(bad.sum())} differ)")
            args = (xx, pk["w_q"], s_x, z_x, pk["s_w"], pk["w_colsum"], pk["w_deq_off"], bias)
            out_k, out_p = quantized_matmul(*args, w_qt=pk["w_qt"]), quantized_matmul_plain(*args)
            check(torch.equal(out_k, out_p), f"{tag}: output equal to the plain version "
                  f"(max |d| {float((out_k.float() - out_p.float()).abs().max()):.3g})")
            if xx.dtype == torch.bfloat16 and (m, k, n) in ((700, 512, 384), (300, 640, 200)):
                py = (xx, pk["w_q"], float(s_x), float(z_x), *args[4:])
                check(torch.equal(quantized_matmul(*py, w_qt=pk["w_qt"]),
                                  quantized_matmul_plain(*py)),
                      f"{tag}, Python-number s_x and z_x (JAX's bf16 row term): output "
                      f"equal to the plain version")
            if (m, k, n) not in timed_shapes or xx.dtype != torch.bfloat16:
                continue
            codes = quantize_x_int8(xx, s_x, z_x).to(torch.int8)

            def chain():
                xq = quantize_x_int8(xx, s_x, z_x)
                return quantized_matmul_epilogue(
                    torch._int_mm(xq.to(torch.int8), pk["w_q"]), xq, z_x, s_x, pk["s_w"],
                    pk["w_colsum"], pk["w_deq_off"], bias, xx.dtype)
            check(torch.equal(chain(), out_k), f"{tag}: the chain through torch._int_mm "
                  f"gives the same output")
            nbytes = 2 * m * k + k * n + 4 * 4 * n + 2 * m * n
            # the other plan at the same shape: x quantized once into device
            # memory, both operands streamed (K2's grid)
            with swapped(qm, "qm_plan", lambda kk, p: (1, qm.load_route(kk, p))):
                check(torch.equal(quantized_matmul(*args, w_qt=pk["w_qt"]), out_k),
                      f"{tag}: the streamed plan gives the same output")
                streamed_ms = cuda_ms(lambda: quantized_matmul(*args, w_qt=pk["w_qt"]))
            shapes[timed_shapes[(m, k, n)]] = dict(
                ms=cuda_ms(lambda: quantized_matmul(*args, w_qt=pk["w_qt"])),
                streamed_ms=streamed_ms,
                transposing_ms=cuda_ms(lambda: quantized_matmul(*args)),
                acc_ms=cuda_ms(lambda: quantized_matmul_acc(xx, pk["w_q"], s_x, z_x,
                                                            w_qt=pk["w_qt"])),
                plain_ms=cuda_ms(lambda: quantized_matmul_plain(*args), reps=5),
                library_ms=cuda_ms(lambda: torch._int_mm(codes, pk["w_q"])),
                chain_ms=cuda_ms(chain, reps=5), plan=plan,
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 2 * m * n * k, INT8_PEAK))))
        del x, w
    main = next(iter(timed_shapes.values()))
    return dict(name="quantized_matmul", route="cuda",
                source="eda_dm_tpu_torch/csrc/quantized_matmul.cu",
                replaces="eda_dm_tpu/ops/pallas_quant.py:57", max_abs_err=0.0,
                shape=f"{main}, bf16 x", sd_ms={}, shapes_ms=shapes,
                **{k: v for k, v in shapes[main].items() if k != "plan"})


def check_mma_chain(g):
    """P1 against its plain version at the probe's three shapes, on both
    routes (``wgmma``, the probe's default, and ``mma_sync``): the int8
    chain bit-equal after 40 steps, the bf16 chain within the probe's
    stated tolerance; one_mm exact on each; the plain chains timed; the
    wgmma build's ``ptxas`` report free of spills."""
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.ops.int8_einsum import int8_matmul_acc_plain
    from eda_dm_tpu_torch.probes import mma_int8 as probe
    err, plain = 0.0, {}
    for m, k in probe.PROBE_SHAPES:
        x = probe.probe_inputs(m, k, g)
        ref8 = probe.mma_chain_plain(x["a8"], x["b8"])
        ref16 = probe.mma_chain_plain(x["a16"], x["b16"])
        for route in probe.ROUTES:
            plan = probe.chain_plan(k, torch.int8) if route == "wgmma" else None
            how = (f"{route}, {'resident' if plan['resident'] else 'streamed'} B, "
                   f"{plan['wgs']} warpgroups" if plan else route)
            out = probe.mma_chain(x["a8"], x["b8"], route=route)
            check(torch.equal(out, ref8), f"P1 int8 chain ({m}, {k})x({k}, {k}), {probe.CHAIN} "
                  f"steps, {how}: bit-equal to the plain chain ({int((out != ref8).sum())} differ)")
            out = probe.mma_chain(x["a16"], x["b16"], route=route)
            rel_l2, rel_max = probe.bf16_errors(out, ref16)
            check(bool(torch.isfinite(out.float()).all()) and rel_l2 <= probe.BF16_REL_L2
                  and rel_max <= probe.BF16_REL_MAX,
                  f"P1 bf16 chain ({m}, {k}), {route}: finite, relative L2 {rel_l2:.3g} <= "
                  f"{probe.BF16_REL_L2}, max |d| {rel_max:.3g} of max|ref| <= "
                  f"{probe.BF16_REL_MAX}")
            err = max(err, float((out.float() - ref16.float()).abs().max()))
        plain[(m, k)] = cuda_ms(lambda: probe.mma_chain_plain(x["a8"], x["b8"]), reps=5)
    x = probe.probe_inputs(512, 128, g)
    want = int8_matmul_acc_plain(x["a8"], x["b8"])
    for route in probe.ROUTES:
        check(torch.equal(probe.one_mm(x["a8"], x["b8"], route=route), want),
              f"P1 one_mm (512, 128)x(128, 128), {route}: int32 product exact")
    regs = ptxas_report("wgmma_chain")
    chains = [r for name, r, _, _ in regs if "wgmma_chain_kernel" in name]
    check(len(chains) == 8 and all(st == 0 and ld == 0 for _, _, st, ld in regs),
          f"P1 wgmma build: 8 chain instances and their B packs, no spills (chain registers "
          f"{chains})")
    log = _build.BUILD_DIR / "wgmma_chain.log"
    notes = [line for line in log.read_text().splitlines() if "C75" in line]
    check(not any("serialized" in line for line in notes),
          f"P1 wgmma build: ptxas serializes no wgmma ({len(notes)} notes of fences it added)")
    return dict(name="mma_chain", route="cuda", source="eda_dm_tpu_torch/csrc/wgmma_chain.cu",
                mma_sync_source="eda_dm_tpu_torch/csrc/mma_chain.cu",
                replaces="scripts/probes/mosaic_int8.py:60", max_abs_err=err, sd_ms={},
                plain_by_shape=plain)


def k8_path(kernel):
    """K8's path, as its test drives it: a weight quantizer from the MSE
    search (``weight_qparams``, per output channel, symmetric),
    ``pack_dense_weights``, an activation quantizer from the input's
    range, then ``quantized_matmul`` — at SD's GEGLU dense width, float32
    x.  Launch counts set to 0 just before and read just after; the output
    held to the test's reference (both operands fake-quantized, a float32
    product, rtol = atol = 1e-4)."""
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.ops.quant_matmul import pack_dense_weights, quantized_matmul
    from eda_dm_tpu_torch.quant import calculate_qparams, fake_quant_nograd, weight_qparams
    gp = torch.Generator(device="cuda").manual_seed(5)
    m, k, n = SD_ROWS * 4096, 320, 2560
    x = torch.randn(m, k, generator=gp, device="cuda")
    w = 0.1 * torch.randn(k, n, generator=gp, device="cuda")
    bias = torch.randn(n, generator=gp, device="cuda")
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    d_w, z_w = weight_qparams(w, 256, symmetric=True, channel_axis=1)
    s_x, z_x = calculate_qparams(x.min(), x.max(), 256)
    pk = pack_dense_weights(w, d_w, z_w)
    out = quantized_matmul(x, pk["w_q"], s_x, z_x, pk["s_w"], pk["w_colsum"],
                           pk["w_deq_off"], bias, w_qt=pk["w_qt"])
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    ref = fake_quant_nograd(x, s_x, z_x, 256) @ fake_quant_nograd(w, d_w, z_w, 256) + bias
    e = float((out - ref).abs().max())
    check(out.shape == (m, n) and bool(torch.isfinite(out).all())
          and torch.allclose(out, ref, rtol=1e-4, atol=1e-4),
          f"K8 path ({m}, {k})x({k}, {n}): within rtol = atol = 1e-4 of the fake-quant "
          f"float32 product (max |d| {e:.3g})")
    kernel["launches"] = launches.get("quantized_matmul", 0)
    check(launches == {"quantized_matmul": 1}, f"K8 launched once on its path, nothing "
          f"else (launches {launches})")


def p1_path(kernel, smi):
    """P1's path: the probe's own ``main()`` at its three shapes on both
    routes, launch counts set to 0 just before and read just after; its
    results held (int8 chains bit-equal, bf16 within tolerance, one_mm
    exact, on each route); each route's time, rate, bound and share of
    the data sheet, and the SM clock read right after each shape's timed
    chains."""
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.probes import mma_int8 as probe
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    results = probe.main()
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    shapes = [r for r in results if "k" in r]
    check(all(r["int8_equal"] and r["bf16_ok"] for r in shapes) and results[-1]["one_mm_exact"],
          "the probe's own checks on both routes: int8 chains bit-equal, bf16 chains within "
          "tolerance, one_mm exact")
    counters = set(probe.LAUNCH_COUNTER.values())
    kernel["launches"] = launches.get(probe.LAUNCH_COUNTER["wgmma"], 0)
    kernel["mma_sync_launches"] = launches.get(probe.LAUNCH_COUNTER["mma_sync"], 0)
    check(set(launches) == counters and all(launches[c] > 0 for c in counters),
          f"P1 launched on both routes by the probe, nothing else (launches {launches})")
    peaks = {r["library_peak"]: r for r in results if "library_peak" in r}
    check(set(peaks) == {"int8", "bf16"}, "the library's own rates measured")
    rates = {}
    name = lambda arm, m, k: f"{arm} ({m}, {k})x({k}, {k}) x{probe.CHAIN}"
    for r in shapes:
        for arm in ("int8", "bf16"):
            t = r[arm]
            rates[name(arm, r["m"], r["k"])] = dict(
                ms=t["ms"], tops=t["rate"] / 1e12, peak_share=t["rate"] / t["peak"],
                event_ms=t["event_ms"], mma_sync_event_ms=t["mma_sync_event_ms"],
                mma_sync_ms=t["mma_sync_ms"], mma_sync_tops=t["mma_sync_rate"] / 1e12,
                mma_sync_peak_share=t["mma_sync_rate"] / t["peak"],
                library_ms=t["library_ms"], library_tops=t["library_rate"] / 1e12,
                library_mm_ms=t["library_mm_ms"],
                library_mm_tops=t["library_mm_rate"] / 1e12,
                library_peak_share=t["rate"] / peaks[arm]["rate"], sm_clock=r["sm_clock"],
                **dict(zip(("bound_ms", "bound_by"),
                           bound(0, r["ops"], INT8_PEAK if arm == "int8" else BF16_PEAK))))
    m, k = probe.PROBE_SHAPES[1]           # K = 256, as K1's 16x16x256 convs
    main_shape = name("int8", m, k)
    main = rates[main_shape]
    kernel.update(shape=f"{main_shape}, on {smi}", ms=main["ms"], mma_sync_ms=main["mma_sync_ms"],
                  plain_ms=kernel["plain_by_shape"][(m, k)], library_ms=main["library_ms"],
                  bound_ms=main["bound_ms"], bound_by=main["bound_by"], rates=rates)
    kernel["plain_by_shape"] = {f"{m}x{k}": v for (m, k), v in kernel["plain_by_shape"].items()}
    kernel["library_peak"] = {arm: dict(n=p["n"], ms=p["ms"], tops=p["rate"] / 1e12,
                                        peak_share=p["rate"] / p["peak"])
                              for arm, p in peaks.items()}
    for name, r in rates.items():
        print(f"    P1 {name}, kernel device time: wgmma {r['ms']:.4f} ms = {r['tops']:.1f} T/s "
              f"({r['peak_share']:.1%} of the data sheet; the call by events "
              f"{r['event_ms']:.4f}); mma.sync {r['mma_sync_ms']:.4f} ms = "
              f"{r['mma_sync_tops']:.1f} T/s ({r['mma_sync_peak_share']:.1%}; events "
              f"{r['mma_sync_event_ms']:.4f}); bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}; library chain {r['library_ms']:.4f} "
              f"ms = {r['library_tops']:.1f} T/s; one library product {r['library_mm_ms']:.4f} "
              f"ms = {r['library_mm_tops']:.1f} T/s; wgmma at {r['library_peak_share']:.1%} of "
              f"the library's own rate; SM clock after the timed chains {r['sm_clock']}")
    for arm, p in kernel["library_peak"].items():
        print(f"    library {arm} product {p['n']}^3: {p['ms']:.4f} ms = {p['tops']:.1f} T/s "
              f"({p['peak_share']:.1%} of the data sheet)")


# --------------------------------------------------------------------------
# phase 4-7 helpers


@contextlib.contextmanager
def swapped(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def environ(**values):
    """The environment variables set to ``values`` inside the block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def plain_versions(record=None):
    """Route the models' seven kernel call sites to the plain versions, on
    the card, for the comparison only.  With ``record`` (a dict), the
    inputs of every softmax-codes, fused- and flash-attention, fused
    GroupNorm and fake-quant matmul call are kept there under the kernel's
    name."""
    import eda_dm_tpu_torch.nn.layers as layers
    import eda_dm_tpu_torch.ops.gn_int8 as gn
    import eda_dm_tpu_torch.ops.softmax_codes as sm
    import eda_dm_tpu_torch.ops.int8_attention as attn
    import eda_dm_tpu_torch.ops.int8_einsum as ein
    import eda_dm_tpu_torch.ops.quant_matmul as fq
    from eda_dm_tpu_torch.ops.int8_conv import int8_conv_plain
    from eda_dm_tpu_torch.ops.softmax_codes import softmax_int8_codes_plain

    def keep(name, *args):
        if record is not None:
            record.setdefault(name, []).append(args)

    def softmax_plain(logits, delta, zp, n_levels):
        keep("softmax_codes", logits, delta, zp, n_levels)
        return (softmax_int8_codes_plain(logits, delta, zp, n_levels),
                n_levels / 2 - zp)

    def attention_plain(Q, K, V, sc, n_levels_w, return_codes):
        keep("int8_attention", Q, K, V, sc, n_levels_w)
        return attn.int8_fused_attention_plain(Q, K, V, sc, n_levels_w, return_codes)

    def flash_plain(Q, K, V, sc, n_levels_w, return_codes):
        keep("int8_flash_attention", Q, K, V, sc, n_levels_w)
        return attn.int8_flash_attention_plain(Q, K, V, sc, n_levels_w, return_codes)

    def gn_plain(*args):
        keep("gn_int8", *args)
        return gn.gn_plain(*args)

    def fq_plain(*args):
        keep("fakequant_matmul", *args)
        return fq.fakequant_matmul_plain(*args)

    with swapped(layers, "int8_conv", int8_conv_plain), \
            swapped(ein, "int8_bmm_nt", _plain_bmm), \
            swapped(sm, "softmax_int8_codes", softmax_plain), \
            swapped(attn, "_int8_fused_attention_cuda", attention_plain), \
            swapped(attn, "_int8_flash_attention_cuda", flash_plain), \
            swapped(gn, "_gn_cuda", gn_plain), \
            swapped(fq, "_fakequant_matmul_cuda", fq_plain):
        yield


@torch.no_grad()
def check_recorded(record):
    """K3 to K7 on the inputs that one run of the plain versions gave each
    of their calls, against the plain versions on the same inputs (K7
    against a float64 product, as in phase 3): a code that flips on a
    rounding tie shows here as a ±1 code, apart from what it does
    downstream."""
    from eda_dm_tpu_torch.ops.gn_int8 import _gn_cuda, gn_plain
    from eda_dm_tpu_torch.ops.quant_matmul import _fakequant_matmul_cuda, fq_error
    from eda_dm_tpu_torch.ops.int8_attention import (
        _int8_flash_attention_cuda, _int8_fused_attention_cuda,
        int8_flash_attention_plain, int8_fused_attention_plain)
    from eda_dm_tpu_torch.ops.softmax_codes import (softmax_int8_codes,
                                                    softmax_int8_codes_plain)
    calls = record.get("softmax_codes", [])
    n_rows = n_differ = 0
    for i, (logits, d, z, n_levels) in enumerate(calls):
        ck = softmax_int8_codes(logits, d, z, n_levels)[0]
        cp = softmax_int8_codes_plain(logits, d, z, n_levels)
        codes_gate(ck, cp, f"K3 call {i} {tuple(logits.shape)}")
        n_rows, n_differ = n_rows + cp.numel() // cp.shape[-1], n_differ + rows_differ(ck, cp)
    if calls:
        print(f"    K3 on the {len(calls)} recorded calls: {n_differ} of {n_rows} rows differ")
    for i, (Q, K, V, sc, n_levels) in enumerate(record.get("int8_attention", [])):
        out_k, W_k = _int8_fused_attention_cuda(Q, K, V, sc, n_levels, True)
        out_p, W_p = int8_fused_attention_plain(Q, K, V, sc, n_levels, True)
        attention_gate(out_k, W_k, out_p, W_p, f"K4 call {i} {tuple(Q.shape)}")
    for i, (Q, K, V, sc, n_levels) in enumerate(record.get("int8_flash_attention", [])):
        out_k, W_k = _int8_flash_attention_cuda(Q, K, V, sc, n_levels, True)
        out_p, W_p = int8_flash_attention_plain(Q, K, V, sc, n_levels, True)
        attention_gate(out_k, W_k, out_p, W_p, f"K5 call {i} {tuple(Q.shape)}")
    calls = record.get("gn_int8", [])
    if calls:                                   # one line for all K6 calls
        worst_share, worst_code, n_diff, n_codes, worst_norm = 1.0, 0, 0, 0, 0.0
        for args in calls:
            out_k, out_p = _gn_cuda(*args), gn_plain(*args)
            if args[3] is None:                 # gn_norm
                worst_norm = max(worst_norm, float((out_k.float() - out_p.float()).abs().max()))
                continue
            diff = (out_k.int() - out_p.int()).abs()
            worst_code = max(worst_code, int(diff.max()))
            n_diff, n_codes = n_diff + int((diff != 0).sum()), n_codes + diff.numel()
            worst_share = min(worst_share, float((diff == 0).float().mean()))
        check(worst_code <= 1 and worst_share >= 0.999 and worst_norm <= 1e-5,
              f"K6 on the {len(calls)} recorded calls: codes within ±1, the least share "
              f"identical {worst_share:.6f} ({n_diff} of {n_codes} differ), gn_norm max "
              f"|d| {worst_norm:.3g} <= 1e-5")
    calls = record.get("fakequant_matmul", [])
    if calls:
        results = [fq_error(_fakequant_matmul_cuda(*args), *args) for args in calls]
        check(all(ok for ok, _ in results),
              f"K7 on the {len(calls)} recorded calls: within 1e-5·(|xq|·|w| + |bias|) "
              f"of the float64 product (max |d| {max(e for _, e in results):.3g})")


@torch.no_grad()
def smoke_quant_state(model, x, t, *context):
    """Stand-in for calibration: symmetric per-channel weight ranges with
    round-to-nearest alphas; act ranges from one FP forward (on ``x``,
    ``t`` and, for a text-conditioned UNet, its context)."""
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
    model(x, t, *context, mode=FP)
    for h in hooks:
        h.remove()
    for m, (lo, hi) in ranges.items():
        m.delta, m.zero_point = calculate_qparams(lo, hi, m.spec.n_levels,
                                                  m.spec.always_zero)
    return len(ranges)


def profile_forward(fn, top=12, what="one forward"):
    """One call of ``fn`` (a forward, unless ``what`` says otherwise) under
    torch.profiler: device busy share of the wall time and the kernels with
    the most device time, printed; returns the wall and kernel ms and the
    busy share."""
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
        return dict(wall_ms=wall_ms, kernel_ms=None, busy=None)
    print(f"    {what}: wall {wall_ms:.2f} ms, kernels {busy:.2f} ms "
          f"(device busy {busy / wall_ms:.1%}, idle {1 - busy / wall_ms:.1%})")
    for e in sorted(kern, key=dev_ms, reverse=True)[:top]:
        print(f"      {dev_ms(e):8.3f} ms {dev_ms(e) / busy:6.1%} x{e.count:<4d} "
              f"{e.key[:90]}")
    # the hand-written kernels, each summed over its template instances (a
    # name matches where it starts a word: cuBLAS's "..._align..._kernel" is
    # no "gn_kernel")
    mine = {}
    for e in kern:
        for name in ("int8_conv_kernel", "int8_bmm_nt_kernel", "softmax_codes_kernel",
                     "int8_attention_kernel", "int8_flash_attention_kernel",
                     "int8_flash_sweep_kernel", "gn_kernel", "fakequant_matmul"):
            if re.search(rf"(?<!\w){name}", e.key):
                t, c = mine.get(name, (0.0, 0))
                mine[name] = (t + dev_ms(e), c + e.count)
    print("      hand-written kernels: " + "; ".join(
        f"{n} {t:.3f} ms ({t / busy:.1%}, x{c})" for n, (t, c) in
        sorted(mine.items(), key=lambda kv: -kv[1][0])))
    return dict(wall_ms=wall_ms, kernel_ms=busy, busy=busy / wall_ms)


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


def kernels_vs_plain(run, what, same_function=None):
    """``run()`` through the kernels, then through the plain versions on the
    card, recording the K3-K7 calls: the flip gate, then each recorded
    call (``check_recorded``).  Returns the kernels' launch counts.

    ``same_function``: another run of the same function whose float sums
    go in another order.  Where the kernels sum floats in another order
    than the plain versions (K7), a code on a tie flips and the random-
    weight model spreads it until the drift saturates at the level any
    reordering reaches (DEPLOY_FUSED against DEPLOY_INT8: mean 0.016 on
    the H100, the kernels 0.0153).  So the output is held instead to
    max < 0.15 and a mean drift at most 1.5× that run's from the plain one
    (the margin covers the spread between two such saturated drifts); each
    K7 call is held exactly by ``check_recorded``."""
    from eda_dm_tpu_torch.ops import _build
    record = {}
    with torch.no_grad():
        _build.launch_counts.clear()
        out_k = run()
        launches = dict(_build.launch_counts)
        with plain_versions(record):
            out_p = run()
            other = same_function() if same_function else None
    check(bool(torch.isfinite(out_k).all()), f"{what}: output finite")
    if other is None:
        flip_gate(out_k, out_p, what)
    else:
        d, own = (out_k - out_p).abs(), (other - out_p).abs()
        check(float(d.max()) < 0.15 and float(d.mean()) <= 1.5 * float(own.mean()),
              f"{what}: max {float(d.max()):.3g} < 0.15, mean {float(d.mean()):.3g} <= "
              f"1.5 x {float(own.mean()):.3g}, the same function's drift with its sums "
              f"in another order (median {float(d.median()):.3g}, share < 2e-4 "
              f"{float((d < 2e-4).float().mean()):.4f})")
    check_recorded(record)
    return launches


def flip_gate(out_k, out_p, what):
    d = (out_k - out_p).abs()
    med, mx, share = float(d.median()), float(d.max()), float((d < 2e-4).float().mean())
    check(med < 2e-4 and mx < 0.15 and share > 0.7,
          f"{what} flip gate: median {med:.3g} < 2e-4, max {mx:.3g} < 0.15, "
          f"share {share:.4f} > 0.7")


def free_memory(when):
    """Collect what the last part left and print the card's memory."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"    memory {when}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")


def timed(fn):
    """(result, wall seconds) of one call, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bedroom(kernels, smi):
    """Phases 6 and 7: the LSUN-Bedroom LDM-4 at full width and depth.
    Returns phase 7's numbers and its DEPLOY_INT8 export on the host."""
    from eda_dm_tpu_torch.models.latent_diffusion import bedroom_config
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
    from eda_dm_tpu_torch.quant import DEPLOY_INT8, FP
    from eda_dm_tpu_torch.quant.export import export_serving_int8

    print("[6] bedroom LDM-4 UNet DEPLOY_INT8, kernels vs plain versions (batch 5, f32)")
    pipe = LDMPipeline(task_config("bedroom", custom_steps=STEPS), device="cuda", seed=0)
    unet, cfg, qc = pipe.ld.unet, pipe.mc.unet, pipe.qc
    print(f"    UNet {sum(p.numel() for p in unet.parameters()):,} params; schedule "
          f"{pipe.sched.num_steps} DDIM steps, eta {pipe.cfg.eta}")
    g = torch.Generator(device="cuda").manual_seed(2)
    # batch 5 splits the sites as batch 50 does: K4 at 32x32 (70 batch-heads)
    # and 16x16 (105), the einsum chain at 8x8 (140 >= 128)
    x5 = torch.randn(5, 64, 64, 3, generator=g, device="cuda")
    t5 = torch.tensor([900.0, 500.0, 200.0, 50.0, 20.0], device="cuda")
    n_aq = smoke_quant_state(unet, x5, t5)
    export_serving_int8(unet, qc, torch.float32)
    record = {}
    with torch.no_grad():
        _build.launch_counts.clear()
        out_k = unet(x5, t5, mode=DEPLOY_INT8)
        launches = dict(_build.launch_counts)
        with plain_versions(record):
            out_p = unet(x5, t5, mode=DEPLOY_INT8)
    check(bool(torch.isfinite(out_k).all()) and out_k.shape == (5, 64, 64, 3),
          f"int8 output finite, shape {tuple(out_k.shape)} ({n_aq} act quantizers set)")
    check(launches.get("int8_attention") == 10 and launches.get("softmax_codes") == 6,
          f"batch 5 serves 10 attention blocks with K4 and 6 with K2 -> K3 -> K2, "
          f"as batch {LDM_BATCH} does (launches {launches})")
    flip_gate(out_k, out_p, "bedroom")
    check_recorded(record)
    del record, out_k, out_p
    print("    the same with the fused GroupNorm (EDM_FUSED_GN=1 EDM_FUSED_GN_NARROW=1)")
    with environ(EDM_FUSED_GN="1", EDM_FUSED_GN_NARROW="1"):
        launches = kernels_vs_plain(lambda: unet(x5, t5, mode=DEPLOY_INT8),
                                    "bedroom fused GN")
    kernels[5]["per_forward"]["bedroom"] = launches.get("gn_int8", 0)
    check(launches.get("gn_int8", 0) > 0,
          f"K6 serves {launches.get('gn_int8', 0)} GroupNorm sites of a bedroom forward "
          f"(launches {launches})")

    print(f"[7] bedroom serving: sample_batch, batch {LDM_BATCH}, {STEPS} DDIM steps at "
          f"eta {pipe.cfg.eta}, bf16 carrier DEPLOY_INT8, VQ-f4 decode")
    for p in unet.parameters():                  # the export's carrier cast
        p.data = p.data.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    x50 = torch.randn(LDM_BATCH, 64, 64, 3, generator=g, device="cuda")
    t50 = torch.full((LDM_BATCH,), 500.0, device="cuda")
    int8_fwd = lambda: unet(x50.to(torch.bfloat16), t50, mode=DEPLOY_INT8)
    with torch.no_grad():
        int8_fwd()                                # warm up (K3's first compile)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    imgs, wall = timed(lambda: pipe.sample_batch(DEPLOY_INT8, generator=g))  # the main path
    launches = dict(_build.launch_counts)
    check(bool(torch.isfinite(imgs).all()) and imgs.shape == (LDM_BATCH, 256, 256, 3)
          and float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0,
          f"images finite, shape {tuple(imgs.shape)}, in [0, 1] "
          f"(mean {float(imgs.mean()):.4f}, std {float(imgs.std()):.4f})")
    print(f"    launches per UNet forward: "
          + ", ".join(f"{k} {v / STEPS:g}" for k, v in sorted(launches.items())))
    check({k: v / STEPS for k, v in launches.items()} == DEFAULT_LAUNCHES["bedroom"],
          f"the default branches: {DEFAULT_LAUNCHES['bedroom']} per forward")
    for k in kernels[:4]:                        # K1-K4; K5 serves SD only
        k["bedroom_launches"] = launches.get(k["name"], 0)
        check(k["bedroom_launches"] > 0, f"{k['name']} launched "
              f"{k['bedroom_launches']} times ({k['bedroom_launches'] / STEPS:g} per "
              f"forward) on the bedroom path")
    z, int8_s = timed(lambda: pipe.sample_batch(DEPLOY_INT8, generator=g, decode=False))
    _, decode_s = timed(lambda: pipe.ld.decode_first_stage(z))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def step_ms(mode):
        _, secs = timed(lambda: pipe.sample_batch(mode, generator=g, decode=False))
        return secs / STEPS * 1e3
    # each arm timed twice in a row (fp32-FP once), after a warm-up at the
    # timed batch
    ms = {"int8": [int8_s / STEPS * 1e3, step_ms(DEPLOY_INT8)]}
    print(f"    profile, DEPLOY_INT8 forward at batch {LDM_BATCH}, bf16 carrier:")
    with torch.no_grad():
        profile_forward(int8_fwd)
    with environ(EDM_FUSED_GN="1", EDM_FUSED_GN_NARROW="1"):   # K6 at its serving batch
        with torch.no_grad():
            int8_fwd()
        ms["int8_fused_gn"] = [step_ms(DEPLOY_INT8), step_ms(DEPLOY_INT8)]
        print(f"    profile, DEPLOY_INT8 with the fused GroupNorm (EDM_FUSED_GN=1 "
              f"EDM_FUSED_GN_NARROW=1) forward at batch {LDM_BATCH}, bf16 carrier:")
        with torch.no_grad():
            profile_forward(int8_fwd)
    export = copy.deepcopy(unet).cpu()          # phase 15 serves it
    del pipe.ld.unet, unet
    for arm, dtype, runs in (("bf16_fp", torch.bfloat16, 2), ("fp32_fp", torch.float32, 1)):
        pipe.ld.unet = LDMUNet(cfg, qc, device="cuda", seed=0).to(dtype)
        with torch.no_grad():
            pipe.ld.unet(x50.to(dtype), t50, mode=FP)        # warm up
        ms[arm] = [step_ms(FP) for _ in range(runs)]
        del pipe.ld.unet
    both = lambda arm: " / ".join(f"{v:.3f}" for v in ms[arm])
    print(f"    on {smi}: ms per denoise step at batch {LDM_BATCH} (two runs each, "
          f"fp32-FP one): "
          f"int8 W4A8 {both('int8')} | int8 W4A8 fused GN {both('int8_fused_gn')} | "
          f"bf16-FP {both('bf16_fp')} | fp32-FP "
          f"{both('fp32_fp')}; decode {decode_s * 1e3:.1f} ms; sample_batch {wall:.3f} s = "
          f"{LDM_BATCH / wall:.4f} img/s ({STEPS} steps + decode); peak memory "
          f"{peak:.2f} GiB")
    return dict(ms_per_step=ms, decode_ms=decode_s * 1e3, img_per_s=LDM_BATCH / wall,
                steps=STEPS, batch=LDM_BATCH, peak_gib=peak), export


def sd(kernels, smi):
    """Phases 8 and 9: Stable Diffusion v1.4 at full width and depth."""
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
    from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_INT8, FP
    from eda_dm_tpu_torch.quant.export import export_serving_int8

    print("[8] SD v1.4 UNet DEPLOY_INT8, kernels vs plain versions (1 prompt under "
          "CFG: 2 rows, f32)")
    pipe = LDMPipeline(task_config("coco", custom_steps=STEPS), device="cuda", seed=0)
    unet, cfg, qc = pipe.ld.unet, pipe.mc.unet, pipe.qc
    print(f"    UNet {sum(p.numel() for p in unet.parameters()):,} params; text encoder "
          f"{sum(p.numel() for p in pipe.ld.cond_stage.parameters()):,}; schedule "
          f"{pipe.sched.num_steps} {pipe.cfg.sampler.upper()} steps, eta {pipe.cfg.eta}, "
          f"guidance scale {pipe.cfg.scale}")
    g = torch.Generator(device="cuda").manual_seed(3)
    prompts = ["a photograph of an astronaut riding a horse", "a red bus in the snow",
               "two dogs playing on a beach at sunset", "an oil painting of a lighthouse"]
    ctx = pipe.ld.get_learned_conditioning(prompts)
    unc = pipe.ld.get_learned_conditioning([""] * len(prompts))
    check(tuple(ctx.shape) == (4, 77, 768) and bool(torch.isfinite(ctx).all()),
          f"text contexts {tuple(ctx.shape)}, finite")
    # one prompt under CFG: rows [x; x], [t; t], [uncond; cond]
    x2 = torch.randn(1, 64, 64, 4, generator=g, device="cuda").repeat(2, 1, 1, 1)
    t2 = torch.full((2,), 500.0, device="cuda")
    c2 = torch.cat([unc[:1], ctx[:1]])
    n_aq = smoke_quant_state(unet, x2, t2, c2)
    export_serving_int8(unet, qc, torch.float32)
    record = {}
    with torch.no_grad():
        _build.launch_counts.clear()
        out_k = unet(x2, t2, c2, mode=DEPLOY_INT8)
        launches = dict(_build.launch_counts)
        with plain_versions(record):
            out_p = unet(x2, t2, c2, mode=DEPLOY_INT8)
    check(bool(torch.isfinite(out_k).all()) and out_k.shape == (2, 64, 64, 4),
          f"int8 output finite, shape {tuple(out_k.shape)} ({n_aq} act quantizers set)")
    check(launches.get("int8_flash_attention") == 5 and launches.get("int8_attention") == 11
          and launches.get("softmax_codes") == 16,
          f"2 rows serve the five 64x64 self-attention sites with K5, the other "
          f"eleven with K4 and all 16 cross-attention sites with K2 -> K3 -> K2, as "
          f"{SD_ROWS} rows do (launches {launches})")
    flip_gate(out_k, out_p, "SD")
    check_recorded(record)
    del record, out_k, out_p
    print("    the same with the fused GroupNorm (EDM_FUSED_GN=1)")
    with environ(EDM_FUSED_GN="1"):
        launches = kernels_vs_plain(lambda: unet(x2, t2, c2, mode=DEPLOY_INT8),
                                    "SD fused GN")
    kernels[5]["per_forward"]["sd"] = launches.get("gn_int8", 0)
    check(launches.get("gn_int8", 0) > 0,
          f"K6 serves {launches.get('gn_int8', 0)} GroupNorm sites of an SD forward "
          f"(launches {launches})")
    torch.cuda.empty_cache()

    n_fwd = STEPS + 1                            # PLMS: the first step looks ahead
    print(f"[9] SD serving: sample_batch, coco, {len(prompts)} prompts, CFG "
          f"{pipe.cfg.scale} ({SD_ROWS} UNet rows), {STEPS} PLMS steps ({n_fwd} "
          f"forwards), bf16 carrier DEPLOY_INT8, KL-f8 decode")
    for p in unet.parameters():                  # the export's carrier cast
        p.data = p.data.to(torch.bfloat16)
    x8 = torch.randn(SD_ROWS, 64, 64, 4, generator=g, device="cuda")
    t8 = torch.full((SD_ROWS,), 500.0, device="cuda")
    c8 = torch.cat([unc, ctx])

    def fwd_ms(model, mode, dtype):
        """Two synchronised forwards at the serving rows, after a warm-up."""
        f = lambda: model(x8.to(dtype), t8, c8.to(dtype), mode=mode)
        with torch.no_grad():
            f()
            return [timed(f)[1] * 1e3 for _ in range(2)]
    ms = {"int8": fwd_ms(unet, DEPLOY_INT8, torch.bfloat16)}
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    imgs, wall = timed(lambda: pipe.sample_batch(DEPLOY_INT8, generator=g, context=ctx,
                                                 uncond=unc))       # the main path
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(torch.isfinite(imgs).all()) and imgs.shape == (len(prompts), 512, 512, 3)
          and float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0,
          f"images finite, shape {tuple(imgs.shape)}, in [0, 1] "
          f"(mean {float(imgs.mean()):.4f}, std {float(imgs.std()):.4f})")
    per_fwd = {k: v / n_fwd for k, v in sorted(launches.items())}
    print("    launches per UNet forward: " + ", ".join(f"{k} {v:g}" for k, v in per_fwd.items()))
    for k in kernels[:5]:                        # K6 and K7 serve CIFAR's fused paths
        k["launches"] = launches.get(k["name"], 0)
        check(k["launches"] > 0, f"{k['name']} launched {k['launches']} times "
              f"({k['launches'] / n_fwd:g} per forward) on the SD path")
    check(per_fwd.get("int8_flash_attention") == 5,
          "K5 serves the five 64x64 self-attention sites of every forward")
    check(per_fwd == DEFAULT_LAUNCHES["sd"], f"the default branches: "
          f"{DEFAULT_LAUNCHES['sd']} per forward")
    z, _ = timed(lambda: pipe.sample_batch(DEPLOY_INT8, generator=g, context=ctx,
                                           uncond=unc, decode=False))
    _, decode_s = timed(lambda: pipe.ld.decode_first_stage(z))
    ms["folded"] = fwd_ms(unet, DEPLOY, torch.bfloat16)
    print(f"    profile, DEPLOY_INT8 forward at {SD_ROWS} rows, bf16 carrier:")
    with torch.no_grad():
        profile_forward(lambda: unet(x8.to(torch.bfloat16), t8,
                                     c8.to(torch.bfloat16), mode=DEPLOY_INT8))
    with environ(EDM_FUSED_GN="1"):               # K6 at the serving rows
        ms["int8_fused_gn"] = fwd_ms(unet, DEPLOY_INT8, torch.bfloat16)
        print(f"    profile, DEPLOY_INT8 with the fused GroupNorm (EDM_FUSED_GN=1) forward "
              f"at {SD_ROWS} rows, bf16 carrier:")
        with torch.no_grad():
            profile_forward(lambda: unet(x8.to(torch.bfloat16), t8,
                                         c8.to(torch.bfloat16), mode=DEPLOY_INT8))
    del pipe.ld.unet, unet
    for arm, dtype in (("bf16_fp", torch.bfloat16), ("fp32_fp", torch.float32)):
        model = LDMUNet(cfg, qc, device="cuda", seed=0).to(dtype)
        ms[arm] = fwd_ms(model, FP, dtype)
        del model
    both = lambda arm: " / ".join(f"{v:.3f}" for v in ms[arm])
    print(f"    on {smi}: ms per UNet forward at {SD_ROWS} rows (two runs each): int8 "
          f"W4A8 {both('int8')} | int8 W4A8 fused GN {both('int8_fused_gn')} | folded "
          f"W4A8 {both('folded')} | bf16-FP "
          f"{both('bf16_fp')} | fp32-FP {both('fp32_fp')}; decode "
          f"{decode_s * 1e3:.1f} ms; sample_batch {wall:.3f} s = "
          f"{len(prompts) / wall:.4f} img/s ({STEPS} steps + decode); peak memory "
          f"{peak:.2f} GiB")
    return dict(ms_per_forward=ms, decode_ms=decode_s * 1e3,
                img_per_s=len(prompts) / wall, steps=STEPS, forwards=n_fwd,
                prompts=len(prompts), rows=SD_ROWS, peak_gib=peak,
                launches_per_forward=per_fwd)




CAL_TRAJ, CAL_ROWS, CAL_ITERS, CAL_ACT_BATCH = 128, 256, 20, 128
CAL_HOST_ROWS, CAL_TARGET_ROWS = 16, 32


def calibration(kernels, smi, smoke_int8_sps):
    """Phase 10: the CIFAR calibration path at full width (``DDPMConfig()``,
    seed 0 weights) on the card, through ``CifarPipeline`` and the ``api``
    verbs, then serving its export.  Cuts against the task, to keep the
    run near twice its length before the phase: TDAC's trajectory batch
    (``batch_samples``) 128 and its ``calib_num_samples`` 256 (the task's
    1024 each; sample k takes position k % 128, as the reference reuses
    its batch), 20 reconstruction iterations a target (the task's 5000);
    the card-vs-host comparisons take the first 16 rows (CALIB_A) and the
    first 32 (one reconstruction target), since the host runs them on the
    CPU."""
    import copy
    import dataclasses
    from eda_dm_tpu_torch import api
    from eda_dm_tpu_torch.calib import recon, scale_init
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMUNet, ddpm_recon_plan
    from eda_dm_tpu_torch.nn.layers import ActQuantizer, QConv, QDense
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parity import tap
    from eda_dm_tpu_torch.pipelines.cifar import CifarConfig, CifarPipeline
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    from eda_dm_tpu_torch.samplers.schedules import get_beta_schedule, skip_sequence

    print(f"[10] CIFAR calibration on the card: TDAC -> scale init -> AdaRound/FBR "
          f"reconstruction -> export and bundle ({smi})")
    cfg = CifarConfig(batch_samples=CAL_TRAJ, calib_num_samples=CAL_ROWS, iters=CAL_ITERS)
    pipe = CifarPipeline(cfg, device="cuda")
    model = DDPMUNet(cfg.arch, pipe.qc, device="cuda", seed=0)
    host = copy.deepcopy(model).cpu()              # the same weights on the host
    secs = {}

    (cx, ct, sel), secs["tdac"] = timed(lambda: pipe.tdac_calibration(model))
    check(tuple(cx.shape) == (CAL_ROWS, 32, 32, 3) and bool(torch.isfinite(cx).all())
          and int(sel.t_num.sum()) == CAL_ROWS,
          f"TDAC over {cfg.timesteps} quad DDIM steps at eta {cfg.eta}, batch "
          f"{CAL_TRAJ}: {CAL_ROWS} rows, finite, in {secs['tdac']:.2f} s on {smi}")
    print(f"    t_num {sel.t_num.tolist()}")
    print(f"    density [{sel.density.min():.0f}, {sel.density.max():.0f}], diversity "
          f"[{sel.diversity.min():.6g}, {sel.diversity.max():.6g}]")
    cali = (cx, ct)

    _, secs["calib_w"] = timed(lambda: scale_init.set_weight_quantize_params(
        model, cali, device="cuda"))
    card_w = copy.deepcopy(model)                  # CALIB_W state, before CALIB_A
    _, secs["calib_a"] = timed(lambda: scale_init.set_act_quantize_params(
        model, cali, batch_size=CAL_ACT_BATCH, device="cuda"))
    used = recon._act_quantizers(model)
    check(all(bool(q.inited) and bool(torch.isfinite(q.delta)) and float(q.delta) > 0
              for q in used),
          f"CALIB_W in {secs['calib_w']:.2f} s, CALIB_A ({CAL_ROWS} rows in batches of "
          f"{CAL_ACT_BATCH}) in {secs['calib_a']:.2f} s on {smi}: all {len(used)} act "
          f"quantizers inited, delta finite and > 0")

    # card against host on the same inputs
    _, secs["host_calib_w"] = timed(lambda: scale_init.set_weight_quantize_params(
        host, tuple(a.cpu() for a in cali), device="cpu"))
    layers = [(n, m) for n, m in card_w.named_modules() if isinstance(m, (QConv, QDense))]
    hosts = dict(host.named_modules())
    n_el = diff_alpha = diff_mask = 0
    max_alpha = 0.0
    unequal = []
    for n, m in layers:
        for part, _, _ in m._parts:
            unequal += [f"{n}.{part}_{leaf}" for leaf in ("delta", "zp") if not torch.equal(
                getattr(m, f"{part}_{leaf}").cpu(), getattr(hosts[n], f"{part}_{leaf}"))]
            a, b = getattr(m, f"{part}_alpha").cpu(), getattr(hosts[n], f"{part}_alpha")
            n_el += a.numel()
            diff_alpha += int((a != b).sum())
            diff_mask += int(((a >= 0) != (b >= 0)).sum())
            max_alpha = max(max_alpha, float((a - b).abs().max()))
    print(f"    CALIB_W host in {secs['host_calib_w']:.2f} s; alphas: {diff_alpha} of {n_el} "
          f"differ from the card's (max |d| {max_alpha:.3g}), {diff_mask} hard masks")
    # alpha = -log(1.2/(rest + 0.1) - 1): the card's logf and division round
    # the last bit otherwise than the host's on some elements
    check(not unequal and diff_mask == 0 and max_alpha <= 1e-6,
          f"CALIB_W card vs host: delta and zp of all {len(layers)} layers bit-equal "
          f"(unequal: {unequal[:5]}); alphas' hard masks equal, the alphas within 1e-6 "
          f"({diff_alpha} of {n_el} not bit-equal, max |d| {max_alpha:.3g})")
    # CALIB_A on the same inputs: the card's quantizers each on the host's
    # input (parity.tap), so that the card's own float sums upstream (its
    # convs sum in another order, a code on a tie flips, the prefix
    # drifts) move no search; the free run is printed beside
    rows = tuple(a[:CAL_HOST_ROWS] for a in cali)
    with tap(host, ActQuantizer) as rec:
        _, secs["host_calib_a_32"] = timed(lambda: scale_init.set_act_quantize_params(
            host, tuple(a.cpu() for a in rows), batch_size=CAL_HOST_ROWS, device="cpu"))
    card_free, card_a = card_w, copy.deepcopy(card_w)
    scale_init.set_act_quantize_params(card_free, rows, batch_size=CAL_HOST_ROWS,
                                       device="cuda")
    with tap(card_a, ActQuantizer, replace=rec):
        scale_init.set_act_quantize_params(card_a, rows, batch_size=CAL_HOST_ROWS,
                                           device="cuda")
    del rec
    qh = recon._act_quantizers(host)
    names = {q: n for n, q in card_a.named_modules()}

    def differing(card):
        return [(names.get(a, "?"), float(a.delta), float(b.delta))
                for a, b in zip(recon._act_quantizers(card), qh)
                if int(a.one_side) != int(b.one_side)
                or abs(float(a.delta) - float(b.delta)) > 1e-5 * abs(float(b.delta))]
    free, off = differing(card_free), differing(card_a)
    for n, d_card, d_host in off:
        print(f"      differs: {n} delta card {d_card:.9g} host {d_host:.9g}")
    print(f"    the free run (each on its own prefix): {len(qh) - len(free)} of {len(qh)} "
          f"within rel 1e-5")
    check(len(off) <= 0.01 * len(qh),
          f"CALIB_A on the first {CAL_HOST_ROWS} rows, card vs host on the same inputs "
          f"({secs['host_calib_a_32']:.1f} s on the host): one_side equal and delta within "
          f"rel 1e-5 at {len(qh) - len(off)} of {len(qh)} act quantizers (>= 99 %)")
    del card_a, card_free, card_w

    # the whole plan
    plan = ddpm_recon_plan(cfg.arch, pipe.qc)
    pre = copy.deepcopy(model)
    log = []
    _, secs["recon"] = timed(lambda: pipe.reconstruct(model, cali, log=log))
    check(len(log) == len(plan) and all(math.isfinite(r["last_loss"]) and
                                        math.isfinite(r["first_loss"]) for r in log),
          f"reconstruct: {len(plan)} targets of ddpm_recon_plan, {CAL_ITERS} iterations "
          f"each, batch {cfg.recon_batch_size}, groups of {cfg.recon_group_size}, every "
          f"loss finite, in {secs['recon']:.2f} s on {smi}")
    loops = sum(r["seconds"] for r in log)
    per_kind = {}
    for r in log:
        per_kind.setdefault(r["kind"], []).append(r)
    for kind, rs in per_kind.items():
        ms = 1e3 * sum(r["seconds"] for r in rs) / sum(r["iters"] for r in rs)
        print(f"    {kind}: {len(rs)} targets, {ms:.3f} ms an iteration, first/last loss "
              f"(mean) {statistics.mean(r['first_loss'] for r in rs):.5g} / "
              f"{statistics.mean(r['last_loss'] for r in rs):.5g} on {smi}")
    full_loops = loops * 5000 / CAL_ITERS
    full_rest = (secs["recon"] - loops) * 1024 / CAL_ROWS
    print(f"    loops {loops:.2f} s, captures and the rest {secs['recon'] - loops:.2f} s; "
          f"EXTRAPOLATED to the task (5000 iterations, 1024 rows): loops {full_loops:.0f} s "
          f"+ captures {full_rest:.0f} s = {full_loops + full_rest:.0f} s on {smi}")

    # one target on the card and the host, nothing drawn
    target = next(t for t in plan if t.name == "down_0.block_0")
    args = dataclasses.replace(pipe.recon_args(), batch_size=CAL_TARGET_ROWS, input_prob=1.0)
    sub = tuple(a[:CAL_TARGET_ROWS] for a in cali)
    data = recon.build_target_data(pre, sub, target, args)
    hpre = copy.deepcopy(pre).cpu()
    for m in (pre, hpre):
        for q in recon._act_quantizers(target.module(m)):
            q.spec = dataclasses.replace(q.spec, prob=1.0)          # no QDrop draw
    gen = lambda d: torch.Generator(device=d).manual_seed(0)
    lc, secs["target_card"] = timed(lambda: recon.reconstruct_target(
        target, pre, data, args, gen("cuda")))
    hdata = {k: (tuple(a.cpu() for a in v) if isinstance(v, tuple) else v.cpu())
             for k, v in data.items()}
    lh, secs["target_host"] = timed(lambda: recon.reconstruct_target(
        target, hpre, hdata, args, gen("cpu")))
    same = total = 0
    for (n, a), (_, b) in zip(target.module(pre).named_buffers(),
                              target.module(hpre).named_buffers()):
        if n.endswith("_alpha"):
            same += int(((a.cpu() >= 0) == (b >= 0)).sum())
            total += a.numel()
    check(same > 0.98 * total and bool(torch.isfinite(lc).all()),
          f"down_0.block_0, {CAL_ITERS} iterations on {CAL_TARGET_ROWS} rows (batch = rows, "
          f"input_prob 1, QDrop 1): hard masks card vs host agree on {same / total:.5f} of "
          f"{total} (> 0.98); last loss card {float(lc[-1]):.6g} host {float(lh[-1]):.6g}; "
          f"{secs['target_card']:.2f} s on the card, {secs['target_host']:.2f} s on the host")
    print(f"    profile of 5 reconstruction iterations of {target.name} at batch "
          f"{CAL_TARGET_ROWS} (the rows; no QDrop draw) on {smi}:")
    args5 = dataclasses.replace(args, iters=5)
    profile_forward(lambda: recon.reconstruct_target(target, pre, data, args5,
                                                     gen("cuda")), top=6,
                    what="5 iterations")
    del pre, hpre, host, data, hdata
    torch.cuda.empty_cache()

    # serve the calibrated state
    ex, mode = api.export_for_serving(model, pipe.qc, kind="int8")
    check(mode == DEPLOY_INT8, "export_for_serving(kind='int8') serves DEPLOY_INT8")
    path = str(_build.BUILD_DIR / "calib_bundle.pt")          # ignored by git
    os.makedirs(os.path.dirname(path), exist_ok=True)
    stats = api.save_bundle(model, pipe.qc, path)
    loaded, lmode = api.load_bundle(path, device="cuda")
    os.remove(path)
    os.remove(path + ".meta.json")
    print(f"    bundle {stats['bundle_bytes']:,} bytes, fp32 {stats['fp32_bytes']:,}, "
          f"compression {stats['compression']:.3f}")
    gx = torch.Generator(device="cuda").manual_seed(5)
    x8 = torch.randn(8, 32, 32, 3, generator=gx, device="cuda")
    t8 = torch.full((8,), 500.0, device="cuda")
    with torch.no_grad():
        a, b = ex(x8.bfloat16(), t8, DEPLOY_INT8), loaded(x8.bfloat16(), t8, lmode)
    check(torch.equal(a, b), "the loaded bundle's DEPLOY_INT8 output bit-equal to the "
          "in-memory export's (batch 8, bf16 carrier)")
    f32 = export_serving_int8(copy.deepcopy(model), pipe.qc, torch.float32)
    kernels_vs_plain(lambda: f32(x8, t8, DEPLOY_INT8), "calibrated CIFAR, batch 8, f32")
    del f32, loaded
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=1000)
    seq = skip_sequence("quad", STEPS, 1000)
    xb = torch.randn(BATCH, 32, 32, 3, generator=gx, device="cuda")
    sps, out = steps_per_s(lambda x, t: ex(x.to(torch.bfloat16), t, DEPLOY_INT8),
                           xb, seq, betas)
    launches = dict(_build.launch_counts)
    check(bool(torch.isfinite(out).all()) and out.shape == (BATCH, 32, 32, 3),
          f"calibrated samples finite, shape {tuple(out.shape)}")
    check({k: v / STEPS for k, v in launches.items()} == DEFAULT_LAUNCHES["cifar"],
          f"the calibrated export on the default branches: {launches} = "
          f"{DEFAULT_LAUNCHES['cifar']} per forward")
    for k in kernels[:3]:
        k["calibrated_launches"] = launches.get(k["name"], 0)
    print(f"    steps/s at batch {BATCH} on {smi}: calibrated int8 W4A8 {sps:.4f} | the "
          f"smoke state's int8 W4A8 (phase 5) {smoke_int8_sps:.4f}")
    return dict(seconds=secs, targets=len(plan), iters=CAL_ITERS, rows=CAL_ROWS,
                loops_s=loops, extrapolated_task_s=full_loops + full_rest,
                ms_per_iter={k: 1e3 * sum(r["seconds"] for r in rs) /
                             sum(r["iters"] for r in rs) for k, rs in per_kind.items()},
                bundle=stats, int8_steps_per_s=sps, smoke_int8_steps_per_s=smoke_int8_sps)


# --------------------------------------------------------------------------
# phase 11: the latent family's calibration
LCAL_TRAJ, LCAL_STEPS, LCAL_ITERS, LCAL_HOST_ROWS = 32, 20, 4, 8
COCO_PROMPTS = ("a red bus on a bridge", "two dogs on a beach", "a bowl of fruit",
                "a lighthouse at night")


def _card_vs_host_weights(unet, prefixes):
    """CALIB_W of the layers under ``prefixes``, the card's state against
    the host's CALIB_W of a copy: (layers, delta/zp leaves unequal, alphas
    not bit-equal, hard masks that differ, max |Δalpha|)."""
    from eda_dm_tpu_torch.nn.layers import QConv, QDense
    layers = [(n, m) for n, m in unet.named_modules()
              if n.startswith(prefixes) and isinstance(m, (QConv, QDense))]
    unequal, n_el, diff, masks, worst = [], 0, 0, 0, 0.0
    for n, m in layers:
        host = copy.deepcopy(m).cpu()
        host.calibrate_weights()
        for part, _, _ in m._parts:
            unequal += [f"{n}.{part}_{leaf}" for leaf in ("delta", "zp") if not torch.equal(
                getattr(m, f"{part}_{leaf}").cpu(), getattr(host, f"{part}_{leaf}"))]
            a, b = getattr(m, f"{part}_alpha").cpu(), getattr(host, f"{part}_alpha")
            n_el, diff = n_el + a.numel(), diff + int((a != b).sum())
            masks += int(((a >= 0) != (b >= 0)).sum())
            worst = max(worst, float((a - b).abs().max()))
    return len(layers), unequal, n_el, diff, masks, worst


def latent_calibration(kernels, smi, bedroom_serving):
    """Phase 11: the latent family's calibration on the card, through
    ``LDMPipeline``, and church's serving.

    Bedroom (``bedroom_config()``, seed 0 weights), with these cuts against
    the task (so that the phase runs in a few minutes): TDAC runs one
    trajectory batch of ``LCAL_TRAJ`` = 32 over ``LCAL_STEPS`` = 20 DDIM
    steps (the task: 1024 samples in batches of 64 over 200 steps); the
    reconstruction runs ``LCAL_ITERS`` = 4 iterations a target (the task:
    5000) over the whole ``ldm_recon_plan``; its int8 export's ms a step
    is held within 3 % of the smoke state's export (seven rounds of 10
    pairs of forwards, each pair back to back in an order that alternates
    by round: the median of the rounds' median ratios); the recipe's own
    ``calib_batch_size`` 32, recon batch 32, groups of 4 and bf16 caches
    stay.  The card-vs-host checks take the first res block's and the
    first attention block's quantizers: CALIB_W of their layers, CALIB_A
    of their act quantizers on the first ``LCAL_HOST_ROWS`` = 8 rows of
    each one's input in the card's run (the same input on both sides), and
    one target (the first res block) for 4 iterations on 8 rows, nothing
    drawn.  The task's time is extrapolated (marked so): TDAC by its
    forward rows, CALIB_A and the captures by the rows, the loops by the
    iterations.

    COCO (``sd_v1_config()``): 4 prompts through the stand-in text encoder
    (8 rows under guidance), TDAC over 10 PLMS steps, scale init, and the
    plan through its first transformer-block target (the recipe's recon
    batch 2; 4 iterations a target); the export served at 8 rows.

    Church (``church_config()``): the smoke quant state, DEPLOY_INT8
    through the kernels and the plain versions at batch 5 with every
    attention site on the branch batch 100 takes (``attention_impl`` sees
    20× the batch), then ``sample_batch`` at batch 100, 10 DDIM steps at
    the task's eta 0, bf16 carrier, the KL-f8 decode."""
    import dataclasses
    from eda_dm_tpu_torch import api
    from eda_dm_tpu_torch.calib import recon, scale_init
    import eda_dm_tpu_torch.models.ldm_unet as ldm_unet
    from eda_dm_tpu_torch.models.ldm_unet import ldm_recon_plan
    from eda_dm_tpu_torch.nn.layers import ActQuantizer
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
    from eda_dm_tpu_torch.quant import CALIB_A, DEPLOY_INT8
    from eda_dm_tpu_torch.quant.export import export_serving_int8, serving_bundle
    from eda_dm_tpu_torch.samplers.latent import make_ldm_schedule

    print(f"[11] latent calibration on the card: bedroom TDAC -> scale init -> "
          f"AdaRound/FBR over ldm_recon_plan -> export, bundle, serving; COCO under "
          f"guidance through its first transformer block; church serving ({smi})")
    secs = {}
    pipe = LDMPipeline(task_config("bedroom", custom_steps=LCAL_STEPS,
                                   calib_num_samples=LCAL_TRAJ, batch_samples=LCAL_TRAJ,
                                   iters=LCAL_ITERS), device="cuda", seed=0)
    unet, cfg = pipe.ld.unet, pipe.cfg
    shape = lambda p, n: (n, p.mc.unet.image_size, p.mc.unet.image_size,
                          p.mc.unet.in_channels)
    img_shape = lambda p, n: (n, p.mc.vae.resolution, p.mc.vae.resolution, 3)
    sel, secs["tdac"] = timed(lambda: pipe.tdac_calibration())
    cali = pipe.build_cali_data(sel)
    check(tuple(cali[0].shape) == shape(pipe, LCAL_TRAJ)
          and bool(torch.isfinite(cali[0]).all()) and int(sel.t_num.sum()) == LCAL_TRAJ,
          f"bedroom TDAC over {LCAL_STEPS} DDIM steps at eta {cfg.eta}, batch "
          f"{LCAL_TRAJ}: {LCAL_TRAJ} rows, finite, in {secs['tdac']:.2f} s on {smi}")
    print(f"    t_num {sel.t_num.tolist()}")

    items = unet.layout.input_blocks
    res = f"input_blocks_{next(it.key for it in items if it.kind == 'res')}"
    attn = f"input_blocks_{next(it.key for it in items if it.kind == 'attn')}"
    _, secs["calib_w"] = timed(lambda: scale_init.set_weight_quantize_params(
        unet, cali, device="cuda"))
    (n_layers, unequal, n_el, n_diff, n_masks, worst), secs["host_calib_w"] = timed(
        lambda: _card_vs_host_weights(unet, (res + ".", attn + ".")))
    check(not unequal and n_masks == 0 and worst <= 1e-6,
          f"CALIB_W card vs host at the {n_layers} layers of {res} and {attn}: delta and "
          f"zp bit-equal (unequal: {unequal[:4]}), hard masks equal, alphas within 1e-6 "
          f"({n_diff} of {n_el} not bit-equal, max |d| {worst:.3g}; host "
          f"{secs['host_calib_w']:.1f} s)")
    names = {q: n for n, q in unet.named_modules() if isinstance(q, ActQuantizer)
             and n.startswith((res + ".", attn + "."))}
    inputs = {}

    def keep(mod, args):                         # each quantizer's first input
        if names[mod] not in inputs:
            inputs[names[mod]] = args[0][:LCAL_HOST_ROWS].clone()
    hooks = [q.register_forward_pre_hook(keep) for q in names]
    _, secs["calib_a"] = timed(lambda: scale_init.set_act_quantize_params(
        unet, cali, batch_size=cfg.calib_batch_size, device="cuda"))
    for h in hooks:
        h.remove()
    used = recon._act_quantizers(unet)
    check(all(bool(q.inited) and float(q.delta) > 0 and math.isfinite(float(q.delta))
              for q in used),
          f"CALIB_W in {secs['calib_w']:.2f} s, CALIB_A ({LCAL_TRAJ} rows in batches of "
          f"{cfg.calib_batch_size}) in {secs['calib_a']:.2f} s on {smi}: all {len(used)} "
          f"act quantizers inited, delta finite and > 0")
    off = []
    for q, n in names.items():
        x = inputs[n]
        card, host = ActQuantizer(q.spec).cuda(), ActQuantizer(q.spec)
        card(x, CALIB_A)
        host(x.cpu(), CALIB_A)
        if (int(card.one_side) != int(host.one_side) or abs(float(card.delta) - float(
                host.delta)) > 1e-5 * abs(float(host.delta))
                or float(card.zero_point) != float(host.zero_point)):
            off.append((n, float(card.delta), float(host.delta)))
    check(not off, f"CALIB_A card vs host on the same input ({LCAL_HOST_ROWS} rows of each "
          f"one's input in the card's run): one_side, zero_point and delta (rel 1e-5) equal "
          f"at all {len(names)} act quantizers of {res} and {attn} (differ: {off})")
    del inputs

    plan = ldm_recon_plan(pipe.mc.unet, pipe.qc)
    pre = copy.deepcopy(unet)
    log = []
    _, secs["recon"] = timed(lambda: pipe.reconstruct(cali, log=log))
    check(len(log) == len(plan) and all(math.isfinite(r["last_loss"]) and
                                        math.isfinite(r["first_loss"]) for r in log),
          f"reconstruct: the {len(plan)} targets of ldm_recon_plan, {LCAL_ITERS} iterations "
          f"each, batch {cfg.recon_batch_size}, groups of {cfg.recon_group_size}, "
          f"{cfg.cache_dtype} caches, every loss finite, in {secs['recon']:.2f} s on {smi}")
    loops = sum(r["seconds"] for r in log)
    per_kind = {}
    for r in log:
        per_kind.setdefault(r["kind"], []).append(r)
    ms_iter = {k: 1e3 * sum(r["seconds"] for r in rs) / sum(r["iters"] for r in rs)
               for k, rs in per_kind.items()}
    for kind, rs in per_kind.items():
        print(f"    {kind}: {len(rs)} targets, {ms_iter[kind]:.3f} ms an iteration, "
              f"first/last loss (mean) {statistics.mean(r['first_loss'] for r in rs):.5g} / "
              f"{statistics.mean(r['last_loss'] for r in rs):.5g} on {smi}")
    rows = 1024 / LCAL_TRAJ
    task_s = {"tdac": secs["tdac"] * (1024 * 200) / (LCAL_TRAJ * LCAL_STEPS),
              "calib_w": secs["calib_w"], "calib_a": secs["calib_a"] * rows,
              "loops": loops * 5000 / LCAL_ITERS, "captures": (secs["recon"] - loops) * rows}
    print(f"    loops {loops:.2f} s, captures and the rest {secs['recon'] - loops:.2f} s; "
          f"EXTRAPOLATED to the task (1024 rows, 200 steps, 5000 iterations): "
          + ", ".join(f"{k} {v:.0f} s" for k, v in task_s.items())
          + f" = {sum(task_s.values()) / 3600:.2f} h on {smi}")

    # one target on the card and the host, nothing drawn
    target = next(t for t in plan if t.path == (res,))
    args = dataclasses.replace(pipe.recon_args(), batch_size=LCAL_HOST_ROWS,
                               input_prob=1.0, iters=LCAL_ITERS)
    data = recon.build_target_data(pre, tuple(a[:LCAL_HOST_ROWS] for a in cali),
                                   target, args)
    holder = torch.nn.Module()
    setattr(holder, res, copy.deepcopy(target.module(pre)).cpu())
    for m in (pre, holder):
        for q in recon._act_quantizers(target.module(m)):
            q.spec = dataclasses.replace(q.spec, prob=1.0)          # no QDrop draw
    gen = lambda d: torch.Generator(device=d).manual_seed(0)
    lc, secs["target_card"] = timed(lambda: recon.reconstruct_target(
        target, pre, data, args, gen("cuda")))
    hdata = {k: (tuple(a.cpu() for a in v) if isinstance(v, tuple) else v.cpu())
             for k, v in data.items()}
    lh, secs["target_host"] = timed(lambda: recon.reconstruct_target(
        target, holder, hdata, args, gen("cpu")))
    same = total = 0
    for (n, a), (_, b) in zip(target.module(pre).named_buffers(),
                              target.module(holder).named_buffers()):
        if n.endswith("_alpha"):
            same += int(((a.cpu() >= 0) == (b >= 0)).sum())
            total += a.numel()
    check(same > 0.98 * total and bool(torch.isfinite(lc).all()),
          f"{target.name}, {LCAL_ITERS} iterations on {LCAL_HOST_ROWS} rows (batch = rows, "
          f"input_prob 1, QDrop 1): hard masks card vs host agree on {same / total:.5f} of "
          f"{total} (> 0.98); last loss card {float(lc[-1]):.6g} host {float(lh[-1]):.6g}")
    data32 = recon.build_target_data(pre, cali, target, pipe.recon_args())
    for q in recon._act_quantizers(target.module(pre)):
        q.spec = dataclasses.replace(q.spec, prob=1.0)
    print(f"    profile of 3 reconstruction iterations of {target.name} at batch "
          f"{cfg.recon_batch_size} (no QDrop draw) on {smi}:")
    args3 = dataclasses.replace(pipe.recon_args(), iters=3)
    profile_forward(lambda: recon.reconstruct_target(target, pre, data32, args3,
                                                     gen("cuda")), top=6,
                    what="3 iterations")
    del pre, holder, data, hdata, data32
    torch.cuda.empty_cache()

    # serve the calibrated state
    ex, mode = pipe.serving_variables(serve="int8")
    check(mode == DEPLOY_INT8, "serving_variables(serve='int8') serves DEPLOY_INT8")
    path = str(_build.BUILD_DIR / "latent_bundle.pt")          # ignored by git
    os.makedirs(os.path.dirname(path), exist_ok=True)
    stats = api.save_bundle(unet, pipe.qc, path)
    loaded, lmode = api.load_bundle(path, device="cuda")
    os.remove(path)
    os.remove(path + ".meta.json")
    gx = torch.Generator(device="cuda").manual_seed(7)
    x5 = torch.randn(shape(pipe, 5), generator=gx, device="cuda")
    t5 = torch.tensor([900.0, 500.0, 200.0, 50.0, 20.0], device="cuda")
    with torch.no_grad():
        a, b = ex(x5.bfloat16(), t5, mode=DEPLOY_INT8), loaded(x5.bfloat16(), t5, mode=lmode)
    check(torch.equal(a, b), f"the loaded bundle ({stats['bundle_bytes']:,} bytes, "
          f"{stats['compression']:.3f}x smaller than fp32) serves DEPLOY_INT8 bit-equal to "
          f"the in-memory export (batch 5, bf16 carrier)")
    del loaded
    f32 = export_serving_int8(copy.deepcopy(unet), pipe.qc, torch.float32)
    launches = kernels_vs_plain(lambda: f32(x5, t5, mode=DEPLOY_INT8),
                                "calibrated bedroom, batch 5, f32")
    check(launches == DEFAULT_LAUNCHES["bedroom"],
          f"batch 5 takes batch {LDM_BATCH}'s branches: {launches}")
    del f32
    torch.cuda.empty_cache()
    # serve on phase 7's schedule (TDAC ran the pipeline's 20 steps)
    pipe.sched = make_ldm_schedule(
        num_timesteps=pipe.mc.timesteps, linear_start=pipe.mc.linear_start,
        linear_end=pipe.mc.linear_end, ddim_steps=STEPS, eta=cfg.eta)
    g = torch.Generator(device="cuda").manual_seed(8)
    x50 = torch.randn(shape(pipe, LDM_BATCH), generator=g, device="cuda")
    with torch.no_grad():
        ex(x50.bfloat16(), torch.full((LDM_BATCH,), 500.0, device="cuda"), mode=mode)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    imgs, wall = timed(lambda: pipe.sample_batch(mode, generator=g, unet=ex))  # the main path
    launches = dict(_build.launch_counts)
    check(bool(torch.isfinite(imgs).all()) and imgs.shape == img_shape(pipe, LDM_BATCH)
          and float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0,
          f"calibrated bedroom images finite, shape {tuple(imgs.shape)}, in [0, 1] "
          f"(mean {float(imgs.mean()):.4f}, std {float(imgs.std()):.4f})")
    check({k: v / STEPS for k, v in launches.items()} == DEFAULT_LAUNCHES["bedroom"],
          f"the calibrated export on the default branches over {STEPS} steps: {launches}"
          f" = {DEFAULT_LAUNCHES['bedroom']} per forward")
    for k in kernels[:4]:
        k["latent_calibrated_launches"] = launches.get(k["name"], 0)
    # the smoke state's export (phase 7's) timed in turns with the calibrated
    # one: seven rounds of STEPS pairs of UNet forwards at batch 50, each
    # pair the two back to back (the card synchronised around each; the
    # order alternates by round, so that neither export always runs
    # second).  A round reads the median of its pairs' ratios, and the gate
    # holds the median of the seven rounds'.  The shared host's and the
    # card's speed move by several per cent over a second or two: whole
    # 10-step runs of the two, and even their fastest forwards, read from
    # -15 to +11 % apart on one card, while a pair 0.2 s apart sees one
    # state
    smoke_ex = ldm_unet.LDMUNet(pipe.mc.unet, pipe.qc, device="cuda", seed=0)
    smoke_quant_state(smoke_ex, x5, t5)
    export_serving_int8(smoke_ex, pipe.qc)
    xb, t50 = x50.bfloat16(), torch.full((LDM_BATCH,), 500.0, device="cuda")
    with torch.no_grad():
        smoke_ex(xb, t50, mode=mode)

    def forward_ms(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            m(xb, t50, mode=mode)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rounds = []
    for r in range(7):
        order = (("smoke", smoke_ex), ("calibrated", ex))[::1 if r % 2 == 0 else -1]
        pairs = [{name: forward_ms(m) for name, m in order} for _ in range(STEPS)]
        each = [q["calibrated"] / q["smoke"] - 1.0 for q in pairs]
        rounds.append(dict(ratio=statistics.median(each), pairs=pairs))
        print(f"    round {r + 1} ({'smoke first' if r % 2 == 0 else 'calibrated first'}, "
              f"{STEPS} pairs): median ratio {rounds[-1]['ratio']:+.2%} (pairs "
              f"{min(each):+.2%} to {max(each):+.2%}); median forward calibrated "
              f"{statistics.median(q['calibrated'] for q in pairs):.3f} ms, smoke "
              f"{statistics.median(q['smoke'] for q in pairs):.3f}")
    rel = statistics.median(q["ratio"] for q in rounds)
    listed = ", ".join(f"{q['ratio']:+.2%}" for q in rounds)
    med = {k: statistics.median(q[k] for rd in rounds for q in rd["pairs"])
           for k in ("calibrated", "smoke")}
    check(abs(rel) <= 0.03,
          f"calibrated bedroom against the smoke state's export at batch {LDM_BATCH}, "
          f"seven rounds of {STEPS} back-to-back pairs of forwards in alternating order: "
          f"median of the rounds' ratios {rel:+.2%} (each {listed}), within 3 %; all "
          f"forwards' medians {med['calibrated']:.3f} and {med['smoke']:.3f} ms "
          f"({med['calibrated'] / med['smoke'] - 1.0:+.2%}; phase 7's ms a step: "
          f"{statistics.mean(bedroom_serving['ms_per_step']['int8']):.3f}) on {smi}")
    del ex, smoke_ex, unet, pipe, cali, imgs, names, used
    free_memory("after the bedroom calibration")

    # COCO: guidance, a text context in the reconstruction, K5 on the path
    pipe = LDMPipeline(task_config("coco", custom_steps=STEPS, calib_num_samples=len(
        COCO_PROMPTS), batch_samples=len(COCO_PROMPTS), iters=LCAL_ITERS),
        device="cuda", seed=0)
    ctx = pipe.ld.get_learned_conditioning(list(COCO_PROMPTS))
    unc = pipe.ld.get_learned_conditioning([""] * len(COCO_PROMPTS))
    sel, secs["coco_tdac"] = timed(lambda: pipe.tdac_calibration(ctx, unc))
    cali = pipe.build_cali_data(sel, ctx, unc)
    n = len(COCO_PROMPTS)
    check(tuple(cali[0].shape) == shape(pipe, 2 * n) and torch.equal(cali[2][n:], ctx)
          and torch.equal(cali[2][:n], unc) and bool(torch.isfinite(cali[0]).all()),
          f"COCO TDAC under guidance {pipe.cfg.scale} over {STEPS} PLMS steps: {2 * n} "
          f"rows [x; x] with [uncond; cond], finite, in {secs['coco_tdac']:.2f} s")
    _, secs["coco_calibrate"] = timed(lambda: pipe.calibrate(cali))
    cplan = ldm_recon_plan(pipe.mc.unet, pipe.qc)
    first_tx = next(i for i, t in enumerate(cplan) if t.has_ctx)
    log = []
    _, secs["coco_recon"] = timed(lambda: recon.reconstruct(
        pipe.ld.unet, cali, cplan[:first_tx + 1], pipe.recon_args(), pipe.generator(4),
        group_size=pipe.cfg.recon_group_size, log=log))
    tx = log[-1]
    check(len(log) == first_tx + 1 and cplan[first_tx].name == tx["name"]
          and all(math.isfinite(r["last_loss"]) for r in log),
          f"COCO scale init in {secs['coco_calibrate']:.2f} s; reconstruct through "
          f"{tx['name']} (a text-context capture, {tx['kind']}): {len(log)} targets, "
          f"batch {pipe.cfg.recon_batch_size}, every loss finite, {secs['coco_recon']:.2f} s "
          f"({1e3 * tx['seconds'] / tx['iters']:.1f} ms an iteration of the transformer "
          f"block)")
    ex, mode = pipe.serving_variables(serve="int8")
    xs = torch.randn(shape(pipe, n), generator=g, device="cuda")
    ts = torch.full((2 * n,), 500.0, device="cuda")
    args = (torch.cat([xs, xs]).bfloat16(), ts, torch.cat([unc, ctx]).bfloat16())
    with torch.no_grad():
        ex(*args, mode=mode)
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        out = ex(*args, mode=mode)
        launches = dict(_build.launch_counts)
    check(bool(torch.isfinite(out).all()) and launches == DEFAULT_LAUNCHES["sd"],
          f"the COCO export at {2 * n} rows: output finite, launches {launches} = "
          f"{DEFAULT_LAUNCHES['sd']}")
    kernels[4]["latent_calibrated_launches"] = launches.get("int8_flash_attention", 0)
    del ex, pipe, cali, out
    free_memory("after COCO")

    # church: the smoke state served at its batch
    pipe = LDMPipeline(task_config("church", custom_steps=STEPS), device="cuda", seed=0)
    unet = pipe.ld.unet
    x5 = torch.randn(shape(pipe, 5), generator=g, device="cuda")
    n_aq = smoke_quant_state(unet, x5, t5)
    _, church_bundle = serving_bundle(unet, pipe.qc)
    print(f"    church UNet {sum(p.numel() for p in unet.parameters()):,} params: bundle "
          f"{church_bundle['bundle_bytes']:,} bytes, fp32 {church_bundle['fp32_bytes']:,}, "
          f"compression {church_bundle['compression']:.3f}")
    export_serving_int8(unet, pipe.qc, torch.float32)
    impl = ldm_unet.attention_impl
    with swapped(ldm_unet, "attention_impl",
                 lambda b, *a: impl(b * CHURCH_BATCH // 5, *a)):
        launches = kernels_vs_plain(lambda: unet(x5, t5, mode=DEPLOY_INT8),
                                    f"church batch 5 on batch {CHURCH_BATCH}'s branches")
    check(launches == DEFAULT_LAUNCHES["church"],
          f"church ({n_aq} act quantizers set): K4 at the 32x32 sites, K2 -> K3 -> K2 at "
          f"the others: {launches}")
    for p in unet.parameters():                  # the export's carrier cast
        p.data = p.data.to(torch.bfloat16)
    x100 = torch.randn(shape(pipe, CHURCH_BATCH), generator=g, device="cuda")
    with torch.no_grad():
        unet(x100.bfloat16(), torch.full((CHURCH_BATCH,), 500.0, device="cuda"),
             mode=DEPLOY_INT8)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    z, church_s = timed(lambda: pipe.sample_batch(DEPLOY_INT8, generator=g,
                                                  decode=False))
    launches = dict(_build.launch_counts)
    imgs, decode_s = timed(lambda: torch.clamp(
        (pipe.ld.decode_first_stage(z) + 1.0) / 2.0, 0.0, 1.0))
    check(bool(torch.isfinite(imgs).all()) and imgs.shape == img_shape(pipe, CHURCH_BATCH)
          and {k: v / STEPS for k, v in launches.items()} == DEFAULT_LAUNCHES["church"],
          f"church sample_batch at batch {CHURCH_BATCH}, {STEPS} DDIM steps at eta "
          f"{pipe.cfg.eta}: images finite, shape {tuple(imgs.shape)}; launches per forward "
          f"{ {k: v / STEPS for k, v in launches.items()} }")
    for k in kernels[:4]:
        k["church_launches"] = launches.get(k["name"], 0)
    church_ms = [church_s / STEPS * 1e3, timed(lambda: pipe.sample_batch(
        DEPLOY_INT8, generator=g, decode=False))[1] / STEPS * 1e3]
    print(f"    church on {smi}: {church_ms[0]:.3f} / {church_ms[1]:.3f} ms a step at batch "
          f"{CHURCH_BATCH} (int8 W4A8, smoke state), decode {decode_s * 1e3:.1f} ms; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del pipe, unet, z, imgs
    torch.cuda.empty_cache()
    return dict(seconds=secs, targets=len(plan), iters=LCAL_ITERS, rows=LCAL_TRAJ,
                loops_s=loops, ms_per_iter=ms_iter, extrapolated_task_s=task_s,
                bundle=stats, int8_forward_ms=med["calibrated"],
                smoke_int8_forward_ms=med["smoke"], round_ratios=[q["ratio"] for q in rounds],
                church_ms_per_step=church_ms, church_decode_ms=decode_s * 1e3,
                church_bundle=church_bundle)


# --------------------------------------------------------------------------
# phase 12: the class-conditional ImageNet task and DPM-Solver++

IMAGENET_LABELS = IMAGENET_ROWS // 2   # the task's batch
IMAGENET_CAL = 4                       # phase 12's calibration labels (8 rows)


def imagenet(kernels, smi):
    """Phase 12: ImageNet cin256-v2 (``imagenet_config()``: 400,920,579 UNet
    params, one head at 384/576/960 channels, a one-token class context
    of 512 from the 1001-row embedder, VQ-f4) at full width and depth,
    seed-0 weights, labels from ``imagenet_labels`` (seed 0), and
    DPM-Solver++.

    (a) The smoke quant state's int8 export in DEPLOY_INT8 through the
    kernels and the plain versions at batch 2 (one label under CFG), f32
    carrier, each attention site on the branch of 100 rows
    (``attention_impl`` sees 50× the batch): the flip gate, then K3, K4
    and K5 on each call's input from the plain run; the launches of one
    forward (K5 on its one-pass-wide route at the five 32×32 sites, K4 at the
    eleven 16×16 and 8×8 ones, K2 → K3 → K2 at the 16 cross-attentions
    over the one class token).  DPM-Solver++ (order 2, 10 steps) at the
    same 2 rows through the plain versions, recording each model call's
    x_t; the kernels' UNet output on each of those x_t held to the plain
    versions' by the same flip gate.

    (b) Serving, this slice's main path: ``sample_batch`` for the
    imagenet task, 50 labels under CFG 3.0 (100 UNet rows), 10 of the
    task's 20 DDIM steps at eta 0, bf16 carrier, DEPLOY_INT8, the VQ-f4
    decode to (50, 256, 256, 3) images in [0, 1]; launch counts set to 0
    just before and read just after.  ms per denoise step of int8, folded
    W4A8 (DEPLOY on the same bf16 export: what ``preferred_export_kind``
    names for this family), bf16-FP and fp32-FP, each warmed up, int8 timed
    twice and the others once; decode ms, img/s, peak memory, one profiled
    int8 forward.

    (c) The same export through ``sampler="dpm"`` (multistep DPM-Solver++
    at order 2), 10 steps at 100 rows: ms per step, images finite in
    [0, 1], the launches of 10 forwards.

    (d) Calibration, cut as phase 11 cuts COCO: ``IMAGENET_CAL`` = 4
    labels (8 rows under guidance), TDAC over 10 DDIM steps (the task:
    1024 samples over 20), scale init, and the plan through its first
    transformer-block target (the first capture with a one-token context;
    ``LCAL_ITERS`` = 4 iterations a target, the task 1000; the recipe's
    recon batch 32 cut to the 8 rows, bf16 caches); the int8 export
    served at 100 rows on (b)'s launches."""
    import dataclasses
    import eda_dm_tpu_torch.models.ldm_unet as ldm_unet
    from eda_dm_tpu_torch.calib import recon
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet, ldm_recon_plan
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.ops.int8_attention import flash_plan
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, imagenet_labels, task_config
    from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_INT8, FP
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    from eda_dm_tpu_torch.samplers.dpm_solver import NoiseScheduleVP, dpm_solver_sample

    rows = 2 * IMAGENET_LABELS
    print(f"[12] ImageNet cin256-v2 DEPLOY_INT8, kernels vs plain versions (1 label under "
          f"CFG: 2 rows, f32, on {rows} rows' branches); DPM-Solver++ step by step")
    pipe = LDMPipeline(task_config("imagenet", custom_steps=STEPS), device="cuda", seed=0)
    unet, cfg, qc = pipe.ld.unet, pipe.mc.unet, pipe.qc
    print(f"    UNet {sum(p.numel() for p in unet.parameters()):,} params; class embedder "
          f"{sum(p.numel() for p in pipe.ld.cond_stage.parameters()):,}; schedule "
          f"{pipe.sched.num_steps} DDIM steps, eta {pipe.cfg.eta}, guidance scale "
          f"{pipe.cfg.scale}")
    labels, uncond = imagenet_labels(IMAGENET_LABELS, 0)
    ctx = pipe.ld.get_learned_conditioning(labels)
    unc = pipe.ld.get_learned_conditioning(uncond)
    check(tuple(ctx.shape) == (IMAGENET_LABELS, 1, 512) and ctx.dtype == torch.float32
          and bool(torch.isfinite(ctx).all()) and torch.equal(unc[0], unc[-1]),
          f"class contexts {tuple(ctx.shape)} float32 of labels {labels[:6].tolist()}..., "
          f"the unconditional rows label 1000")
    g = torch.Generator(device="cuda").manual_seed(12)
    x2 = torch.randn(1, 64, 64, 3, generator=g, device="cuda").repeat(2, 1, 1, 1)
    t2 = torch.full((2,), 500.0, device="cuda")
    c2 = torch.cat([unc[:1], ctx[:1]])
    n_aq = smoke_quant_state(unet, x2, t2, c2)
    export_serving_int8(unet, qc, torch.float32)
    impl = ldm_unet.attention_impl
    wide = lambda b, *a: impl(b * IMAGENET_LABELS, *a)
    with swapped(ldm_unet, "attention_impl", wide):
        launches = kernels_vs_plain(lambda: unet(x2, t2, c2, mode=DEPLOY_INT8),
                                    f"ImageNet 2 rows on {rows} rows' branches")
    check(launches == DEFAULT_LAUNCHES["imagenet"]
          and flash_plan(1024, 1024, 384)["route"] == "one_pass_wide",
          f"ImageNet ({n_aq} act quantizers set): K5 (one-pass-wide route) at the five "
          f"32x32 sites, K4 at the eleven others, K2 -> K3 -> K2 at the 16 "
          f"cross-attentions: {launches}")
    ns = NoiseScheduleVP("discrete", betas=pipe.sched.betas)
    x1 = torch.randn(1, 64, 64, 3, generator=g, device="cuda")
    seen = []

    def guided(rec):
        def fn(x, t):
            if rec:
                seen.append((x.clone(), t.clone()))
            e_u, e_c = unet(torch.cat([x, x]), torch.cat([t, t]), c2,
                            mode=DEPLOY_INT8).chunk(2)
            return e_u + pipe.cfg.scale * (e_c - e_u)
        return fn
    with torch.no_grad(), swapped(ldm_unet, "attention_impl", wide):
        with plain_versions():
            z_p = dpm_solver_sample(x1, guided(True), ns, steps=STEPS, order=2,
                                    algorithm_type="dpmsolver++")
        z_k = dpm_solver_sample(x1, guided(False), ns, steps=STEPS, order=2,
                                algorithm_type="dpmsolver++")
        for i, (x, t) in enumerate(seen):
            xx, tt = torch.cat([x, x]), torch.cat([t, t])
            out_k = unet(xx, tt, c2, mode=DEPLOY_INT8)
            with plain_versions():
                out_p = unet(xx, tt, c2, mode=DEPLOY_INT8)
            flip_gate(out_k, out_p, f"DPM-Solver++ call {i} (t {float(t[0]):.1f}), "
                      f"kernels vs plain on the plain run's x_t")
    dz = (z_k - z_p).abs()
    check(len(seen) == STEPS and bool(torch.isfinite(z_k).all()),
          f"DPM-Solver++ order 2: {len(seen)} model calls over {STEPS} steps; the free "
          f"runs' latents finite, kernels vs plain mean |d| {float(dz.mean()):.3g}, max "
          f"{float(dz.max()):.3g}")
    del seen, z_k, z_p
    torch.cuda.empty_cache()

    print(f"    serving: sample_batch, imagenet, {IMAGENET_LABELS} labels, CFG "
          f"{pipe.cfg.scale} ({rows} UNet rows), {STEPS} DDIM steps at eta "
          f"{pipe.cfg.eta}, bf16 carrier DEPLOY_INT8, VQ-f4 decode")
    for p in unet.parameters():                  # the export's carrier cast
        p.data = p.data.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    xr = torch.randn(rows, 64, 64, 3, generator=g, device="cuda")
    tr = torch.full((rows,), 500.0, device="cuda")
    cr = torch.cat([unc, ctx])
    fwd = lambda model, mode, dtype: model(xr.to(dtype), tr, cr.to(dtype), mode=mode)
    with torch.no_grad():
        fwd(unet, DEPLOY_INT8, torch.bfloat16)    # warm up at the serving rows
    torch.cuda.synchronize()
    sample = lambda mode, **kw: pipe.sample_batch(mode, IMAGENET_LABELS, generator=g,
                                                  context=ctx, uncond=unc, **kw)
    _build.launch_counts.clear()
    imgs, wall = timed(lambda: sample(DEPLOY_INT8))                  # the main path
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(torch.isfinite(imgs).all()) and imgs.shape == (IMAGENET_LABELS, 256, 256, 3)
          and float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0,
          f"images finite, shape {tuple(imgs.shape)}, in [0, 1] "
          f"(mean {float(imgs.mean()):.4f}, std {float(imgs.std()):.4f})")
    per_fwd = {k: v / STEPS for k, v in sorted(launches.items())}
    print("    launches per UNet forward: " + ", ".join(f"{k} {v:g}" for k, v in per_fwd.items()))
    check(per_fwd == DEFAULT_LAUNCHES["imagenet"],
          f"the default branches: {DEFAULT_LAUNCHES['imagenet']} per forward")
    for k in kernels[:5]:                        # K1-K5
        k["imagenet_launches"] = launches.get(k["name"], 0)
        check(k["imagenet_launches"] > 0, f"{k['name']} launched {k['imagenet_launches']} "
              f"times ({k['imagenet_launches'] / STEPS:g} per forward) on the ImageNet path")
    z, int8_s = timed(lambda: sample(DEPLOY_INT8, decode=False))
    _, decode_s = timed(lambda: pipe.ld.decode_first_stage(z))

    def step_ms(mode):
        return timed(lambda: sample(mode, decode=False))[1] / STEPS * 1e3
    # int8 timed twice in a row, the other arms once, each after a warm-up
    # at the serving rows
    ms = {"int8": [int8_s / STEPS * 1e3, step_ms(DEPLOY_INT8)]}
    with torch.no_grad():
        fwd(unet, DEPLOY, torch.bfloat16)         # warm up the folded arm
    ms["folded"] = [step_ms(DEPLOY)]
    print(f"    profile, DEPLOY_INT8 forward at {rows} rows, bf16 carrier:")
    with torch.no_grad():
        profile_forward(lambda: fwd(unet, DEPLOY_INT8, torch.bfloat16))

    print(f"    DPM-Solver++ (sampler='dpm', order 2), {STEPS} steps at {rows} rows, "
          f"DEPLOY_INT8")
    pipe.cfg = dataclasses.replace(pipe.cfg, sampler="dpm")
    _build.launch_counts.clear()
    zd, dpm_s = timed(lambda: sample(DEPLOY_INT8, decode=False))
    dpm_launches = dict(_build.launch_counts)
    dimgs = torch.clamp((pipe.ld.decode_first_stage(zd) + 1.0) / 2.0, 0.0, 1.0)
    check(bool(torch.isfinite(dimgs).all()) and dimgs.shape == imgs.shape
          and {k: v / STEPS for k, v in dpm_launches.items()} == DEFAULT_LAUNCHES["imagenet"],
          f"DPM-Solver++ images finite, shape {tuple(dimgs.shape)}, in [0, 1] (mean "
          f"{float(dimgs.mean()):.4f}); {STEPS} forwards on the default branches")
    dpm_ms = [dpm_s / STEPS * 1e3]
    pipe.cfg = dataclasses.replace(pipe.cfg, sampler="ddim")
    del z, zd, imgs, dimgs, pipe.ld.unet, unet
    torch.cuda.empty_cache()
    for arm, dtype in (("bf16_fp", torch.bfloat16), ("fp32_fp", torch.float32)):
        pipe.ld.unet = LDMUNet(cfg, qc, device="cuda", seed=0).to(dtype)
        with torch.no_grad():
            fwd(pipe.ld.unet, FP, dtype)          # warm up
        ms[arm] = [step_ms(FP)]
        del pipe.ld.unet
        torch.cuda.empty_cache()
    both = lambda v: " / ".join(f"{x:.3f}" for x in v)
    print(f"    on {smi}: ms per denoise step at {rows} rows (int8 two runs, the other "
          f"arms one): int8 W4A8 "
          f"{both(ms['int8'])} | folded W4A8 {both(ms['folded'])} | bf16-FP "
          f"{both(ms['bf16_fp'])} | fp32-FP {both(ms['fp32_fp'])}; DPM-Solver++ int8 "
          f"{both(dpm_ms)}; decode {decode_s * 1e3:.1f} ms; sample_batch {wall:.3f} s = "
          f"{IMAGENET_LABELS / wall:.4f} img/s ({STEPS} steps + decode); peak memory "
          f"{peak:.2f} GiB")
    del pipe
    free_memory("after ImageNet serving")

    # (d) calibration through the first transformer block
    n = IMAGENET_CAL
    pipe = LDMPipeline(task_config("imagenet", custom_steps=STEPS, calib_num_samples=n,
                                   batch_samples=n, iters=LCAL_ITERS,
                                   recon_batch_size=2 * n), device="cuda", seed=0)
    cl, cu = imagenet_labels(n, 1)
    cctx = pipe.ld.get_learned_conditioning(cl)
    cunc = pipe.ld.get_learned_conditioning(cu)
    secs = {}
    sel, secs["tdac"] = timed(lambda: pipe.tdac_calibration(cctx, cunc))
    cali = pipe.build_cali_data(sel, cctx, cunc)
    check(tuple(cali[0].shape) == (2 * n, 64, 64, 3) and torch.equal(cali[2][n:], cctx)
          and torch.equal(cali[2][:n], cunc) and bool(torch.isfinite(cali[0]).all()),
          f"ImageNet TDAC under guidance {pipe.cfg.scale} over {STEPS} DDIM steps: {2 * n} "
          f"rows [x; x] with [uncond; cond] class contexts, finite, in {secs['tdac']:.2f} s")
    _, secs["calibrate"] = timed(lambda: pipe.calibrate(cali))
    plan = ldm_recon_plan(pipe.mc.unet, pipe.qc)
    first_tx = next(i for i, t in enumerate(plan) if t.has_ctx)
    log = []
    _, secs["recon"] = timed(lambda: recon.reconstruct(
        pipe.ld.unet, cali, plan[:first_tx + 1], pipe.recon_args(), pipe.generator(4),
        group_size=pipe.cfg.recon_group_size, log=log))
    tx = log[-1]
    check(len(log) == first_tx + 1 and plan[first_tx].name == tx["name"]
          and all(math.isfinite(r["last_loss"]) for r in log),
          f"ImageNet scale init in {secs['calibrate']:.2f} s; reconstruct through "
          f"{tx['name']} (a one-token class-context capture, {tx['kind']}): {len(log)} "
          f"targets, batch {pipe.cfg.recon_batch_size}, {pipe.cfg.cache_dtype} caches, every "
          f"loss finite, {secs['recon']:.2f} s ({1e3 * tx['seconds'] / tx['iters']:.1f} ms an "
          f"iteration of the transformer block)")
    ex, mode = pipe.serving_variables(serve="int8")
    with torch.no_grad():
        ex(xr.bfloat16(), tr, cr.bfloat16(), mode=mode)
        torch.cuda.synchronize()
        _build.launch_counts.clear()
        out = ex(xr.bfloat16(), tr, cr.bfloat16(), mode=mode)
        cal_launches = dict(_build.launch_counts)
    check(bool(torch.isfinite(out).all()) and cal_launches == DEFAULT_LAUNCHES["imagenet"],
          f"the calibrated ImageNet export at {rows} rows: output finite, launches "
          f"{cal_launches}")
    for k in kernels[:5]:
        k["imagenet_calibrated_launches"] = cal_launches.get(k["name"], 0)
    del ex, pipe, cali, out
    free_memory("after the ImageNet calibration")
    return dict(ms_per_step=ms, dpm_ms_per_step=dpm_ms, decode_ms=decode_s * 1e3,
                img_per_s=IMAGENET_LABELS / wall, steps=STEPS, rows=rows, peak_gib=peak,
                launches_per_forward=per_fwd, calibration_seconds=secs,
                dpm_launches=dpm_launches)


# --------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 13: the scoring path

SCORE_IMAGES = 1000                    # images a set (the task: 50,000)
SCORE_BATCH = 500                      # CIFAR's sampling batch
INCEPTION_BATCH = 200                  # the Inception's batch
HELD_IMAGES = 16                       # the card-vs-host comparison's images


def _params_equal(a, b, what):
    """Every parameter of module ``a`` bit-equal to ``b``'s of that name."""
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    same = sorted(pa) == sorted(pb) and all(
        pa[k].shape == pb[k].shape and torch.equal(pa[k], pb[k].to(pa[k].device))
        for k in pa)
    n = sum(p.numel() for p in pa.values())
    check(same, f"{what}: all {len(pa)} parameters ({n:,} values) bit-equal")


def _any_differs(a, b):
    pb = dict(b.named_parameters())
    return any(not torch.equal(p, pb[k].to(p.device)) for k, p in a.named_parameters())


def scoring(smi):
    """Phase 13: the scoring path, reference checkpoint → convert →
    calibrate → ``sample_fid`` → PNGs → Inception features → FID, IS and
    sFID, through the port's entry points on the card.

    (a) Checkpoints in: ``DDPMConfig()`` (35,746,307 params, seed 7) as a
    reference-layout DDPM state dict (``reference_layout``, ``torch.save``
    into a temporary directory of the checkout's ignored ``_build/``),
    loaded back through ``CifarPipeline(CifarConfig(ckpt_path=...))``;
    ImageNet cin256-v2 (400,920,579 UNet params, seed 7) as a
    LatentDiffusion checkpoint with all three prefixes (UNet, VQ-f4 first
    stage, class embedder) and ``model_ema.`` shadows (a seed-8 UNet),
    loaded through ``LDMPipeline`` (the raw UNet weights) and
    ``api.quantize_model("ldm")`` (the EMA weights), as the JAX package's
    two entry points load it; every weight bit-equal to its source; the
    file deleted after.

    (b) Sampling, this slice's main path: ``sample_ddim``'s ``main`` in
    process on the CIFAR checkpoint, ``--serve int8`` after TDAC (256
    samples over the 10 steps) and CALIB_W / CALIB_A without the
    reconstruction, 10 quad DDIM steps at batch 500, 1,000 PNGs (launch
    counts set to 0 just before and read just after: 20 forwards of
    ``DEFAULT_LAUNCHES["cifar"]``); the same ``main`` with ``--serve fp
    --no-ptq`` writes the reference set (the fp32 UNet of the same
    checkpoint).  img/s counts the PNG writes.

    (c) Scoring: ``evaluate``'s ``main`` in process on the two directories
    with ``--isc --sfid`` at batch 200 (``FIDInceptionV3`` at 299², float32,
    TF32 off, random weights from seed 0): FID and sFID raw and
    standardized, and IS, all finite; the extractor's images/s and the
    statistics' seconds; one profiled forward at batch 200.

    (d) Held: the Inception on the card against the same weights on the
    host on 16 of the images (``pool3`` and ``logits`` within 1e-4 of the
    largest |host| value plus 1e-3 relative: cuDNN and the host's
    convolutions sum in other orders); and 200 of the images read from
    their PNGs, written again and read back, equal pixel for pixel, their
    features from that directory bit-equal to the features of the same
    images in memory."""
    import shutil
    import tempfile
    import numpy as np
    from eda_dm_tpu_torch import api, evaluate, reference_layout, sample_ddim
    from eda_dm_tpu_torch.data.datasets import iter_image_folder
    from eda_dm_tpu_torch.eval.inception import FIDInceptionV3, InceptionExtractor, preprocess
    from eda_dm_tpu_torch.eval.io import png_writer, save_images
    from eda_dm_tpu_torch.models.bridge import to_jax_variables
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.models.latent_diffusion import LatentDiffusion, imagenet_config
    from eda_dm_tpu_torch.models.ldm_unet import LDMUNet
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.ops.int8_einsum import tf32_off
    from eda_dm_tpu_torch.pipelines.cifar import CifarConfig, CifarPipeline
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline, task_config
    from eda_dm_tpu_torch.quant import QuantConfig

    t_phase = time.perf_counter()
    out = {"card": smi}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="scoring-", dir=_build.BUILD_DIR)
    try:
        qc = QuantConfig(weight_bit=4, act_bit=8)
        print("    (a) checkpoints in, through the converters")
        src = DDPMUNet(DDPMConfig(), qc, device="cuda", seed=7)
        n = sum(p.numel() for p in src.parameters())
        check(n == 35_746_307, f"DDPMConfig() has {n:,} params")
        cifar_ckpt = os.path.join(tmp, "cifar.ckpt")
        _, save_s = timed(lambda: torch.save(
            reference_layout.ddpm_state_dict(to_jax_variables(src)["params"]), cifar_ckpt))
        model, load_s = timed(lambda: CifarPipeline(
            CifarConfig(ckpt_path=cifar_ckpt), device="cuda").init_variables())
        _params_equal(model, src, "CIFAR checkpoint through CifarPipeline")
        print(f"    CIFAR: {os.path.getsize(cifar_ckpt) / 1e6:.1f} MB written in {save_s:.2f} s, "
              f"loaded through CifarPipeline in {load_s:.2f} s on {smi}")
        out["cifar_ckpt"] = dict(bytes=os.path.getsize(cifar_ckpt), save_s=save_s,
                                 load_s=load_s)
        del model, src

        mc = imagenet_config()
        ld = LatentDiffusion(mc, qc, device="cuda", seed=7)
        ema = LDMUNet(mc.unet, qc, device="cuda", seed=8)
        n = sum(p.numel() for p in ld.unet.parameters())
        check(n == 400_920_579, f"imagenet_config() UNet has {n:,} params")
        latent_ckpt = os.path.join(tmp, "imagenet.ckpt")

        def write():
            sd = reference_layout.latent_diffusion_state_dict(
                to_jax_variables(ld.unet)["params"], to_jax_variables(ld.first_stage)["params"],
                to_jax_variables(ld.cond_stage)["params"],
                ema_unet=to_jax_variables(ema)["params"])
            prefixes = sorted({k.split(".")[0] for k in sd})
            torch.save({"state_dict": sd}, latent_ckpt)
            return prefixes
        prefixes, save_s = timed(write)
        check(prefixes == ["cond_stage_model", "first_stage_model", "model", "model_ema"],
              f"the checkpoint's prefixes {prefixes}")
        pipe, pipe_s = timed(lambda: LDMPipeline(
            task_config("imagenet", ckpt_path=latent_ckpt), device="cuda"))
        _params_equal(pipe.ld.unet, ld.unet, "ImageNet UNet through LDMPipeline: the raw weights")
        _params_equal(pipe.ld.first_stage, ld.first_stage, "the VQ-f4 first stage's decode part")
        _params_equal(pipe.ld.cond_stage, ld.cond_stage, "the class embedder")
        del pipe
        free_memory("after the pipeline's load")
        unet, api_s = timed(lambda: api.quantize_model("ldm", mc.unet, qc,
                                                       ckpt_path=latent_ckpt, device="cuda"))
        _params_equal(unet, ema, "ImageNet UNet through api.quantize_model: the EMA weights")
        check(_any_differs(unet, ld.unet), "the API path's UNet is not the raw one")
        size = os.path.getsize(latent_ckpt)
        os.remove(latent_ckpt)
        print(f"    ImageNet: {size / 1e9:.3f} GB written in {save_s:.2f} s, loaded through "
              f"LDMPipeline in {pipe_s:.2f} s (raw weights) and api.quantize_model in "
              f"{api_s:.2f} s (EMA weights) on {smi}; the file deleted")
        out["imagenet_ckpt"] = dict(bytes=size, save_s=save_s, pipeline_load_s=pipe_s,
                                    api_load_s=api_s)
        del unet, ld, ema
        free_memory("after the checkpoints")

        print(f"    (b) sample_ddim: {SCORE_IMAGES} images at batch {SCORE_BATCH}, "
              f"{STEPS} quad DDIM steps, --serve int8 (CALIB_W / CALIB_A, no reconstruction) "
              f"and --serve fp")
        common = ["--ckpt", cifar_ckpt, "--timesteps", str(STEPS), "--sample_batch_size",
                  str(SCORE_BATCH), "--max_images", str(SCORE_IMAGES)]
        _build.launch_counts.clear()
        run8 = sample_ddim.main(common + ["--serve", "int8", "--no-recon", "--calib_num_samples",
                                          "256", "--batch_samples", "256", "--logdir",
                                          os.path.join(tmp, "int8")])
        launches = dict(_build.launch_counts)
        forwards = STEPS * -(-SCORE_IMAGES // SCORE_BATCH)
        check({k: v / forwards for k, v in launches.items()} == DEFAULT_LAUNCHES["cifar"],
              f"the int8 set ran K1-K3 through the card: {launches} over {forwards} forwards, "
              f"{DEFAULT_LAUNCHES['cifar']} each")
        runfp = sample_ddim.main(common + ["--serve", "fp", "--no-ptq", "--logdir",
                                           os.path.join(tmp, "fp")])
        for what, run in (("int8", run8), ("fp", runfp)):
            check(run["images"] == SCORE_IMAGES and len(os.listdir(run["img_dir"])) == SCORE_IMAGES,
                  f"{what}: {run['images']} PNGs written ({run['writer']} writer)")
            sec = run["seconds"]
            print(f"    {what}: load {sec['load']:.2f} s, calibration {sec['calibrate']:.2f} s, "
                  f"sampling with the writes {sec['sample']:.2f} s = "
                  f"{SCORE_IMAGES / sec['sample']:.2f} img/s ({run['writer']} PNG writer) on {smi}")
        out.update(writer=png_writer(), int8_seconds=run8["seconds"],
                   fp_seconds=runfp["seconds"],
                   int8_img_per_s=SCORE_IMAGES / run8["seconds"]["sample"],
                   fp_img_per_s=SCORE_IMAGES / runfp["seconds"]["sample"],
                   int8_launches=launches)

        import scipy
        print(f"    (c) evaluate --isc --sfid at batch {INCEPTION_BATCH} (FIDInceptionV3 at "
              f"299², float32, random weights; scipy {scipy.__version__})")
        res, eval_s = timed(lambda: evaluate.main([
            "--gen_dir", run8["img_dir"], "--ref_dir", runfp["img_dir"], "--isc", "--sfid",
            "--batch_size", str(INCEPTION_BATCH)]))
        scores = ("fid", "fid_standardized", "sfid", "sfid_standardized", "is_mean", "is_std")
        for k in scores:
            check(math.isfinite(res[k]), f"{k} = {res[k]!r} finite")
        ips = res["images"] / res["seconds"]
        print(f"    FID {res['fid']!r} (raw features), {res['fid_standardized']!r} "
              f"(standardized), IS {res['is_mean']!r} ± {res['is_std']!r}, sFID {res['sfid']!r} "
              f"(raw), {res['sfid_standardized']!r} (standardized); the extractor {ips:.1f} "
              f"images/s ({res['images']} images in {res['seconds']:.2f} s), the statistics "
              f"{res['metric_seconds']:.2f} s (scipy's sqrtm on the host), evaluate "
              f"{eval_s:.2f} s in all on {smi}")
        out.update({k: res[k] for k in scores}, inception_images_per_s=ips, evaluate_s=eval_s,
                   metric_s=res["metric_seconds"])

        ext = InceptionExtractor(device="cuda")
        first = next(iter_image_folder(run8["img_dir"], batch_size=INCEPTION_BATCH))
        xb = torch.from_numpy(first).cuda()
        with torch.no_grad(), tf32_off():
            prof = profile_forward(lambda: ext.model(preprocess(xb)),
                                   what=f"one Inception forward at batch {INCEPTION_BATCH}")
        out["inception_forward"] = prof

        print(f"    (d) the Inception on the card against the host, {HELD_IMAGES} images")
        host = FIDInceptionV3()
        host.load_state_dict({k: v.cpu() for k, v in ext.model.state_dict().items()})
        x16 = torch.from_numpy(first[:HELD_IMAGES])
        with torch.no_grad(), tf32_off():
            card = ext.model(preprocess(x16.cuda()))
            ref = host(preprocess(x16))
        for k in ("pool3", "logits"):
            c, h = card[k].cpu().double(), ref[k].double()
            err = float((c - h).abs().max())
            tol = 1e-4 * float(h.abs().max())
            check(bool(((c - h).abs() <= tol + 1e-3 * h.abs()).all()),
                  f"{k}: card vs host max |d| {err:.3g} (largest |host| "
                  f"{float(h.abs().max()):.3g}) within 1e-4 of it plus 1e-3 relative")
            out[f"card_vs_host_{k}_max_abs"] = err
        again = os.path.join(tmp, "again")
        save_images(first, again)
        # a folder reads in name order: 0, 1, 10, 100, ...
        order = sorted(range(len(first)), key=lambda i: f"{i}.png")
        back = next(iter_image_folder(again, batch_size=INCEPTION_BATCH))
        check(np.array_equal(back, first[order]), f"{len(first)} images: PNG → read → PNG → "
              f"read equal pixel for pixel")
        feats_dir, _, _ = evaluate.features_from_dir(again, ext, INCEPTION_BATCH)
        feats_mem = ext.pool3(first[order])
        check(np.array_equal(feats_dir, feats_mem),
              "pool3 of the directory bit-equal to pool3 of the same images in memory")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"    phase 13 on {smi}: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 14: data and tensor parallelism

P14_CAL_ROWS = 256                     # the calibration set of steps (d)-(f)
P14_RECON_ITERS, P14_LR = 20, 1e-4     # JAX's dp tolerance: rtol 1e-3, atol 6·lr


def _p14_setup(dev):
    """A rank's start: TF32 off (as in the parent) and the CIFAR sampler
    of phase 5 (``sample(model, x, generator)``)."""
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    from eda_dm_tpu_torch.samplers.ddim import generalized_steps
    from eda_dm_tpu_torch.samplers.schedules import get_beta_schedule, skip_sequence
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=1000)
    seq = skip_sequence("quad", STEPS, 1000)

    def sample(model, x, generator, steps=seq):
        fn = lambda a, t: model(a.to(torch.bfloat16), t, DEPLOY_INT8)
        return generalized_steps(x, steps, fn, betas, eta=0.0, device=dev)
    return sample, seq


def _p14_timed_sample(run):
    """(samples, seconds, launches, collective stats) of one synchronised
    run after a 2-step warm-up; the launch counts and the collective
    statistics are set to 0 just before the timed run."""
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parallel import comm
    run(True)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    comm.reset_stats()
    out, secs = timed(lambda: run(False))
    return out, secs, dict(_build.launch_counts), dict(comm.stats)


def p14_world1(rank, world, dev, path, x_T):
    """World 1 on NCCL: one process's DDIM run, then ``dp_sample`` on the
    one-rank mesh, on the same x_T."""
    from eda_dm_tpu_torch.parallel import dp, mesh as pm
    sample, seq = _p14_setup(dev)
    model = torch.load(path, weights_only=False).to(dev)
    x = x_T.to(dev)
    single, s_single, l_single, _ = _p14_timed_sample(
        lambda warm: sample(model, x, None, seq[:2] if warm else seq))
    mesh = pm.make_mesh()
    out, s_dp, l_dp, stats = _p14_timed_sample(lambda warm: dp.dp_sample(
        lambda m, xx, g: sample(m, xx, g, seq[:2] if warm else seq), model, x, None, mesh))
    return dict(single=single, dp=out, single_s=s_single, dp_s=s_dp,
                single_launches=l_single, dp_launches=l_dp, comm=stats,
                backend=torch.distributed.get_backend())


@contextlib.contextmanager
def recording_k1_k2(record):
    """Keep the inputs of every K1 and K2 call (the kernels still run)."""
    import eda_dm_tpu_torch.nn.layers as layers
    import eda_dm_tpu_torch.ops.int8_einsum as ein

    def keeping(name, fn):
        def call(*args, **kw):
            record.setdefault(name, []).append((args, kw))
            return fn(*args, **kw)
        return call
    with swapped(layers, "int8_conv", keeping("int8_conv", layers.int8_conv)), \
            swapped(ein, "int8_bmm_nt", keeping("int8_bmm", ein.int8_bmm_nt)):
        yield


@torch.no_grad()
def check_k1_k2(record, what):
    """Each recorded K1 and K2 call against its plain version on the same
    inputs: outputs bit-equal (int32 sums, the same float32 epilogue)."""
    from eda_dm_tpu_torch.ops.int8_conv import int8_conv, int8_conv_plain
    from eda_dm_tpu_torch.ops.int8_einsum import int8_bmm_nt, int8_bmm_nt_plain
    for name, kern, plain in (("int8_conv", int8_conv, int8_conv_plain),
                              ("int8_bmm", int8_bmm_nt, int8_bmm_nt_plain)):
        calls = record.get(name, [])
        bad = sum(not torch.equal(kern(*a, **k), plain(*a, **k)) for a, k in calls)
        check(calls and bad == 0, f"{what}: {name} on its {len(calls)} calls bit-equal "
              f"to the plain version on this rank's inputs")


@torch.no_grad()
def _first_difference(model, x, t, rows_slice, group):
    """The first module (in call order) whose output on this rank's rows
    differs from the same rows of the one-process forward on ``x``."""
    from eda_dm_tpu_torch.parallel import rows
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    names = {m: n for n, m in model.named_modules()}
    runs = []
    for local in (False, True):
        outs, hooks = [], []
        for m in model.modules():
            if m is not model and len(list(m.children())) == 0:
                hooks.append(m.register_forward_hook(
                    lambda mod, a, o: outs.append((names[mod], o))
                    if torch.is_tensor(o) and o.dim() > 1 else None))
        with rows.sharded_rows(group if local else None):
            model((x[rows_slice] if local else x).to(torch.bfloat16),
                  t[rows_slice] if local else t, DEPLOY_INT8)
        for h in hooks:
            h.remove()
        runs.append(outs)
    for (name, full), (_, mine) in zip(*runs):
        if not torch.equal(full[rows_slice], mine):
            return name
    return None


@contextlib.contextmanager
def quantizer_inputs(model, rows=None, replace=None):
    """Keep every act quantizer's input (its ``rows`` of each call, on the
    card) in the dict yielded; with ``replace`` (such a dict), each call
    computes on the kept input instead of its own (teacher forcing)."""
    from eda_dm_tpu_torch.nn.layers import ActQuantizer
    kept, used, hooks = {}, {}, []

    def pre(mod, args):
        if not torch.is_tensor(args[0]):
            return None
        if replace is not None:
            i = used[mod] = used.get(mod, -1) + 1
            return (replace[mod_names[mod]][i],) + tuple(args[1:])
        kept.setdefault(mod_names[mod], []).append(args[0][rows].clone())
        return None
    mod_names = {m: n for n, m in model.named_modules()}
    for m in model.modules():
        if isinstance(m, ActQuantizer):
            hooks.append(m.register_forward_pre_hook(pre))
    try:
        yield kept
    finally:
        for h in hooks:
            h.remove()


def p14_world2(rank, world, dev, path, x_T, single):
    """Two gloo ranks sharing the card: dp sampling, the kernels on this
    rank's rows, tp = 2, dp calibration and dp reconstruction."""
    import copy as _copy
    from eda_dm_tpu_torch.calib.scale_init import (set_act_quantize_params,
                                                   set_weight_quantize_params)
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.nn.layers import ActQuantizer
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parallel import comm, dp, mesh as pm, rows, tp
    from eda_dm_tpu_torch.quant import DEPLOY_INT8, QuantConfig
    sample, seq = _p14_setup(dev)
    out = {"rank": rank, "backend": torch.distributed.get_backend()}
    secs = out["seconds"] = {}
    model = torch.load(path, weights_only=False).to(dev)
    x = x_T.to(dev)
    mesh = pm.make_mesh()
    group = pm.axis_group(mesh, "dp")
    mine = slice(rank * (x.shape[0] // world), (rank + 1) * (x.shape[0] // world))
    t0 = time.perf_counter()

    # (a) dp_sample, 250 rows a rank
    samples, s, launches, stats = _p14_timed_sample(lambda warm: dp.dp_sample(
        lambda m, xx, g: sample(m, xx, g, seq[:2] if warm else seq), model, x, None, mesh))
    out.update(samples=samples, sample_s=s, comm=stats,
               launches={k: v / STEPS for k, v in launches.items()})
    check(out["launches"] == DEFAULT_LAUNCHES["cifar"], f"rank {rank}: launches per "
          f"forward {out['launches']} = one process's {DEFAULT_LAUNCHES['cifar']}")
    single = single.to(dev)
    out["bit_equal"] = torch.equal(samples, single)
    if not out["bit_equal"]:
        t500 = torch.full((x.shape[0],), 500.0, device=dev)
        out["first_difference"] = _first_difference(model, x, t500, mine, group)
    secs["dp_sample"] = time.perf_counter() - t0

    # (b) the kernels on this rank's rows against their plain versions
    t0 = time.perf_counter()
    xl = x[mine].to(torch.bfloat16)
    tl = torch.full((xl.shape[0],), 500.0, device=dev)
    record = {}
    with rows.sharded_rows(group), recording_k1_k2(record):
        held = kernels_vs_plain(lambda: model(xl, tl, DEPLOY_INT8),
                                f"rank {rank} ({xl.shape[0]} rows)")
    check_k1_k2(record, f"rank {rank}")
    out["held_launches"] = held
    secs["kernels_vs_plain"] = time.perf_counter() - t0

    # (c) tp = 2: a DEPLOY_INT8 forward at t = 500 on all rows
    t0 = time.perf_counter()
    mesh2 = tp.make_mesh2d(1, world)
    sharded = tp.shard_params_tp(mesh2, _copy.deepcopy(model))
    nbytes = lambda m: sum(v.numel() * v.element_size() for v in m.state_dict().values()
                           if torch.is_tensor(v))
    t_all = torch.full((x.shape[0],), 500.0, device=dev)
    with torch.no_grad():
        ref = model(x.to(torch.bfloat16), t_all, DEPLOY_INT8)
        _build.launch_counts.clear()
        comm.reset_stats()
        got = sharded(x.to(torch.bfloat16), t_all, DEPLOY_INT8)
        out["tp_launches"] = dict(_build.launch_counts)
        out["tp_comm"] = dict(comm.stats)
    check(torch.equal(got, ref), f"rank {rank}: tp = 2 DEPLOY_INT8 forward bit-equal to "
          f"the unsharded one ({len(tp.tp_layers(sharded))} layers sharded)")
    out["tp_weight_bytes"], out["weight_bytes"] = nbytes(sharded), nbytes(model)
    del sharded, ref, got
    secs["tp"] = time.perf_counter() - t0

    # (d) dp_calibrate_acts over 256 rows against set_act_quantize_params: on
    # the single process's quantizer inputs (this rank's rows of them) the
    # state is bit-equal; free-running, the card's convs take another
    # algorithm at 128 rows than at 256, so the inputs differ in their
    # last bits and the state is held to the free-running gate
    t0 = time.perf_counter()
    cfg, qc = DDPMConfig(), QuantConfig(weight_bit=4, act_bit=8)
    gc_ = torch.Generator().manual_seed(14)
    cali = (torch.randn(P14_CAL_ROWS, 32, 32, 3, generator=gc_).to(dev),
            torch.randint(0, 1000, (P14_CAL_ROWS,), generator=gc_).float().to(dev))
    base = DDPMUNet(cfg, qc, device=dev, seed=0)
    set_weight_quantize_params(base, cali, device=dev)
    one = _copy.deepcopy(base)
    b = P14_CAL_ROWS // world
    with quantizer_inputs(one, slice(rank * b, (rank + 1) * b)) as inputs:
        set_act_quantize_params(one, cali, batch_size=P14_CAL_ROWS, device=dev)
    forced = _copy.deepcopy(base)
    with quantizer_inputs(forced, replace=inputs):
        dp.dp_calibrate_acts(forced, cali, mesh, batch_size=P14_CAL_ROWS)
    del inputs
    free = dp.dp_calibrate_acts(_copy.deepcopy(base), cali, mesh, batch_size=P14_CAL_ROWS)
    qs = lambda m: {n: q for n, q in m.named_modules() if isinstance(q, ActQuantizer)}
    leaves = ("delta", "zero_point", "one_side", "running_min", "running_max")
    bits = lambda m: [n for n, q in qs(one).items()
                      if not all(torch.equal(getattr(q, k), getattr(qs(m)[n], k))
                                 for k in leaves)]
    differ, drift = bits(forced), bits(free)
    rels = [float((q.delta - qs(free)[n].delta).abs() / q.delta.abs()) for n, q in qs(one).items()]
    sides = all(torch.equal(q.one_side, qs(free)[n].one_side) for n, q in qs(one).items())
    check(not differ, f"rank {rank}: dp_calibrate_acts over {P14_CAL_ROWS} rows on the "
          f"single process's quantizer inputs bit-equal to set_act_quantize_params at all "
          f"{len(qs(one))} act quantizers (differ: {differ[:3]})")
    close = sum(r <= 1e-3 for r in rels)
    check(sides and max(rels) <= 0.05,
          f"rank {rank}: free-running, {len(qs(one)) - len(drift)} of {len(qs(one))} act "
          f"quantizers bit-equal (the first that is not: {drift[:1]}); one_side equal, "
          f"every delta within rel 5 % (the farthest {max(rels):.3g}), {close} within 1e-3")
    rel = max(rels)
    out["calib_quantizers"], out["calib_free_bit_equal"] = len(qs(one)), len(qs(one)) - len(drift)
    out["calib_free_rel"] = rel
    del forced, free, base
    secs["dp_calibrate_acts"] = time.perf_counter() - t0

    out.update(p14_reconstruct(rank, one, cali, cfg, qc, mesh, dev, secs))
    return out


def p14_reconstruct(rank, one, cali, cfg, qc, mesh, dev, secs):
    """Step (e) of ``p14_world2``: ``reconstruct`` and ``dp_reconstruct``
    on row-sharded captures from the calibrated ``one``, the first 3 block
    targets, 20 iterations (each rank holds half the rows of every capture
    and fetches the minibatch rows it lacks from the other rank); their
    states held by JAX's dp tolerance, the captures' bytes, peak memory,
    the row exchange and the seconds returned."""
    import copy as _copy
    from eda_dm_tpu_torch.calib.recon import ReconArgs, reconstruct
    from eda_dm_tpu_torch.models.ddpm_unet import ddpm_recon_plan
    from eda_dm_tpu_torch.nn.layers import ActQuantizer, QConv, QDense
    from eda_dm_tpu_torch.parallel import comm, dp
    out = {}
    plan = [tg for tg in ddpm_recon_plan(cfg, qc) if tg.kind == "block"][:3]
    args = ReconArgs(iters=P14_RECON_ITERS, batch_size=32, lr_w=P14_LR, lr_a=P14_LR)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)
    logs, peaks = {}, {}
    for name, run in (("reconstruct", lambda log: reconstruct(
                          _copy.deepcopy(one), cali, plan, args, gen(), log=log)),
                      ("dp_reconstruct", lambda log: dp.dp_reconstruct(
                          _copy.deepcopy(one), cali, plan, args, gen(), mesh, log=log))):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base_bytes = torch.cuda.memory_allocated(dev)
        comm.reset_stats()
        logs[name] = []
        t0 = time.perf_counter()
        result = run(logs[name])
        torch.cuda.synchronize(dev)
        secs[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base_bytes
        if name == "reconstruct":
            a = result
        else:
            b = result
            out["recon_exchange"] = {k: comm.stats[k] for k in
                                     ("rows_calls", "rows_bytes", "rows_seconds")}
    out["recon_cache_bytes"] = {e["name"]: (e["cache_bytes"], f["cache_bytes"])
                                for e, f in zip(logs["reconstruct"], logs["dp_reconstruct"])}
    out["recon_peak_bytes"] = peaks
    halves = [n for n, (u, v) in out["recon_cache_bytes"].items() if 2 * v != u]
    ex = out["recon_exchange"]
    sizes = ", ".join(f"{d / 2**20:.1f} / {s / 2**20:.1f}"
                      for s, d in out["recon_cache_bytes"].values())
    check(not halves and len(out["recon_cache_bytes"]) == len(plan),
          f"rank {rank}: dp_reconstruct's captures a target, this rank / one process: "
          f"{sizes} MiB, half at every target; peak memory above the start "
          f"{peaks['dp_reconstruct'] / 2**20:.1f} MiB against {peaks['reconstruct'] / 2**20:.1f}; "
          f"the row exchange {ex['rows_calls']} calls, {ex['rows_bytes'] / 2**20:.1f} MiB "
          f"received, {ex['rows_seconds']:.3f} s; {secs['dp_reconstruct']:.2f} s against "
          f"{secs['reconstruct']:.2f} s")
    atol = 6 * P14_LR
    close = lambda u, v: torch.allclose(u, v, rtol=1e-3, atol=atol)
    worst, masks, n_alpha, far, loose = 0.0, 0, 0, [], 0
    for (n, ma), mb in zip(a.named_modules(), b.modules()):
        if isinstance(ma, (QConv, QDense)):
            for part, _, _ in ma._parts:
                pa, pb = getattr(ma, f"{part}_alpha"), getattr(mb, f"{part}_alpha")
                far += [] if close(pa, pb) else [f"{n}.{part}_alpha"]
                worst = max(worst, float((pa - pb).abs().max()))
                flip = (pa >= 0) != (pb >= 0)
                masks += int(flip.sum())
                # a mask may flip only where both alphas lie within the
                # tolerance of 0 (a near-zero gradient's sign, an Adam step)
                loose += int((flip & ((pa.abs() > atol) | (pb.abs() > atol))).sum())
                n_alpha += pa.numel()
        elif isinstance(ma, ActQuantizer) and not close(ma.delta, mb.delta):
            far.append(f"{n}.delta")
    check(not far and loose == 0, f"rank {rank}: dp_reconstruct ({P14_RECON_ITERS} "
          f"iterations, lr {P14_LR:g}) alphas and act deltas within JAX's dp tolerance "
          f"(rtol 1e-3, atol 6·lr; max |d| alpha {worst:.3g}; outside: {far[:3]}); "
          f"{masks} of {n_alpha} rounding masks differ, each where both alphas lie "
          f"within 6·lr of 0")
    out["recon_masks_differ"] = masks
    out["recon_max_alpha_d"] = worst
    return out


def parallel(kernels, smi, model):
    """Phase 14: data and tensor parallelism (``eda_dm_tpu_torch.parallel``)
    on phase 5's smoke-state export of ``DDPMConfig()`` (DEPLOY_INT8, bf16
    carrier), the ranks started by ``parallel.launch.spawn`` (a ``FileStore``
    in a temporary directory, the kernels loaded from phase 2's build):

    (1) world 1 on NCCL: ``dp_sample`` of 10 quad DDIM steps at batch 500
        on a one-rank mesh, bit-equal to one process's run on the same x_T;
    (2) world 2 on gloo, both ranks on the card (NCCL refuses two ranks on
        one device; gloo stages the card tensors through the host):
        ``dp_sample`` at 250 rows a rank against (1)'s one-process samples
        (bit-equal, else the whole-model flip gate and the first module
        that differs), each rank's launches per forward those of one
        process (K1 76, K2 35, K3 6), and one forward on each rank's rows
        through the kernels and the plain versions (every K1 and K2 call
        bit-equal, K3 by ``check_recorded``, the output by the flip gate);
    (3) tp = 2 on the same two ranks: a DEPLOY_INT8 forward at t = 500,
        bit-equal to the unsharded forward, each rank's weight bytes beside
        the unsharded model's;
    (4) ``dp_calibrate_acts`` at world 2 over 256 rows (``DDPMConfig()``
        seed 0, CALIB_W first), each quantizer on this rank's rows of the
        single process's inputs: every act quantizer's Δ, zp, ``one_side``
        and running range bit-equal to ``set_act_quantize_params``'s (the
        statistics are exact over the ranks); free-running (the card's
        convs pick their algorithm by batch size, so the inputs differ in
        their last bits and a flat search score may move a candidate):
        ``one_side`` equal and every Δ within rel 5 %, the bit-equal ones
        and those within rel 1e-3 counted (as phase 10 prints its free run
        beside its exact check);
    (5) ``dp_reconstruct`` at world 2 over the same rows, row-sharded
        (each rank captures and keeps its 128 rows, and fetches the
        minibatch rows it lacks from the other rank): the first 3 block
        targets of ``ddpm_recon_plan``, 20 iterations, lr 1e-4, batch 32:
        alphas and act Δ within JAX's dp tolerance (rtol 1e-3, atol 6·lr)
        of ``reconstruct``; a rounding mask may differ only where both
        alphas lie within 6·lr of 0 (the differing ones counted); each
        target's captures on a rank exactly half the single process's,
        with each run's peak memory, the row exchange's calls, bytes and
        seconds, and both runs' seconds printed;
    (6) ``validate_ptq --task cifar`` at full width, one process: ``--n
        500 --no_recon --serve int8``, the calibration cut to 256 rows
        and 10 DDIM steps (the task: 100); its numbers finite.

    No speedup is expected from two ranks that share one card."""
    import shutil
    import tempfile
    from eda_dm_tpu_torch.parallel.launch import spawn
    from eda_dm_tpu_torch.validate_ptq import main as validate_ptq
    print("[14] data and tensor parallelism: dp_sample on NCCL (world 1) and gloo "
          "(world 2, one card), tp = 2, dp_calibrate_acts, dp_reconstruct, validate_ptq")
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_p14_")
    res = {"card": smi}
    try:
        path = os.path.join(work, "cifar_int8.pt")
        torch.save(model, path)
        x_T = torch.randn(BATCH, 32, 32, 3, generator=torch.Generator().manual_seed(140))

        t0 = time.perf_counter()
        (w1,) = spawn(p14_world1, 1, "nccl", "cuda", path, x_T, timeout_s=300)
        res["world1_s"] = time.perf_counter() - t0
        check(w1["backend"] == "nccl" and torch.equal(w1["dp"], w1["single"]),
              f"world 1 on NCCL: dp_sample bit-equal to one process ({BATCH} rows)")
        check(w1["dp_launches"] == w1["single_launches"],
              f"world 1: the same launches as one process ({w1['dp_launches']})")
        res["world1"] = {"img_s_single": BATCH / w1["single_s"], "img_s_dp": BATCH / w1["dp_s"],
                         "collective_s": w1["comm"]["seconds"],
                         "collectives": w1["comm"]["calls"]}

        t0 = time.perf_counter()
        ranks = spawn(p14_world2, 2, "gloo", "cuda", path, x_T, w1["single"], timeout_s=300)
        res["world2_s"] = time.perf_counter() - t0
        r0 = ranks[0]
        check(all(r["backend"] == "gloo" for r in ranks), "world 2 on gloo")
        equal = all(r["bit_equal"] for r in ranks)
        if equal:
            check(True, f"world 2: gathered dp_sample bit-equal to one process")
        else:
            print(f"    world 2 samples differ from one process's; first module that "
                  f"differs: {[r.get('first_difference') for r in ranks]}")
            flip_gate(r0["samples"].float(), w1["single"].float(), "world 2 dp_sample")
        res["world2"] = {
            "bit_equal": equal, "img_s": BATCH / max(r["sample_s"] for r in ranks),
            "collective_s": [r["comm"]["seconds"] for r in ranks],
            "collectives": [r["comm"]["calls"] for r in ranks],
            "launches_per_forward": [r["launches"] for r in ranks],
            "held_launches": [r["held_launches"] for r in ranks],
            "tp_launches": [r["tp_launches"] for r in ranks],
            "tp_collective_s": [r["tp_comm"]["seconds"] for r in ranks],
            "tp_weight_bytes": [r["tp_weight_bytes"] for r in ranks],
            "weight_bytes": r0["weight_bytes"],
            "calib_quantizers": r0["calib_quantizers"],
            "calib_free_bit_equal": [r["calib_free_bit_equal"] for r in ranks],
            "calib_free_rel": [r["calib_free_rel"] for r in ranks],
            "recon_max_alpha_d": [r["recon_max_alpha_d"] for r in ranks],
            "recon_masks_differ": [r["recon_masks_differ"] for r in ranks],
            "recon_cache_bytes": [r["recon_cache_bytes"] for r in ranks],
            "recon_peak_bytes": [r["recon_peak_bytes"] for r in ranks],
            "recon_exchange": [r["recon_exchange"] for r in ranks],
            "seconds": [r["seconds"] for r in ranks]}
        for k in kernels[:3]:
            k["parallel_launches"] = [r["launches"].get(k["name"], 0) for r in ranks]
        w2 = res["world2"]
        print(f"    tp = 2 weight bytes a rank {w2['tp_weight_bytes']} beside the unsharded "
              f"model's {w2['weight_bytes']}")

        t0 = time.perf_counter()
        out_dir = os.path.join(work, "validate")
        v = validate_ptq(["--task", "cifar", "--n", str(BATCH), "--no_recon", "--serve", "int8",
                          "--calib_num_samples", str(P14_CAL_ROWS), "--batch_samples",
                          str(P14_CAL_ROWS), "--timesteps", str(STEPS), "--out", out_dir])
        res["validate_s"] = time.perf_counter() - t0
        check(all(math.isfinite(v[k]) for k in ("fid_quant_vs_fp", "split_noise_floor"))
              and os.path.exists(os.path.join(out_dir, "features.npz")),
              f"validate_ptq --task cifar: fid_quant_vs_fp {v['fid_quant_vs_fp']} "
              f"(split noise floor {v['split_noise_floor']}) finite, features written")
        res["validate"] = v
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"    on {smi}: world 1 (NCCL) {res['world1']['img_s_single']:.1f} img/s one "
          f"process, {res['world1']['img_s_dp']:.1f} img/s dp_sample "
          f"({res['world1']['collectives']} collectives, "
          f"{res['world1']['collective_s']:.4f} s); world 2 (gloo, one card) "
          f"{w2['img_s']:.1f} img/s, collectives {w2['collective_s']} s")
    caches = {n: (u, [r["recon_cache_bytes"][n][1] for r in ranks])
              for n, (u, _) in r0["recon_cache_bytes"].items()}
    print(f"    dp_reconstruct (world 2, gloo, one card): capture bytes a target (single "
          f"process, [rank 0, rank 1]) {caches}; peak bytes above the start "
          f"{w2['recon_peak_bytes']}; row exchange {w2['recon_exchange']}; seconds (dp, "
          f"single process) "
          f"{[(r['seconds']['dp_reconstruct'], r['seconds']['reconstruct']) for r in ranks]}")
    print(f"    seconds: world 1 {res['world1_s']:.1f}, world 2 {res['world2_s']:.1f} "
          f"(rank 0's steps {r0['seconds']}), validate_ptq {res['validate_s']:.1f}, "
          f"phase 14 {res['phase_s']:.1f}")
    return res


# --------------------------------------------------------------------------
# phase 15: spatial parallelism (the height over ranks)

P15_CODE_ROWS = 50                     # the rows of (b)'s act-code and K1/K2 checks
P15_SD_LATENTS = 4                     # the COCO task's 4 prompts


def _sp(mesh, fn, x, dim=1):
    """``fn`` on this rank's rows of ``x``'s height (``tp.shard_spatial``
    over the mesh's ``tp`` axis, inside ``sharded_height``), gathered."""
    from eda_dm_tpu_torch.parallel import spatial, tp
    from eda_dm_tpu_torch.parallel.mesh import axis_group
    with spatial.sharded_height(axis_group(mesh, "tp")):
        out = fn(tp.shard_spatial(mesh, x, dim=dim))
    return tp.gather_spatial(mesh, out, dim=dim)


def _codes_differ(full_calls, sp_calls, rank, world):
    """Act codes of every K1 call of a sharded forward (this rank's rows
    and their halo) that differ from the same rows of a one-process
    forward's (``full_calls``): (codes that differ, codes compared)."""
    from eda_dm_tpu_torch.parallel import spatial
    check(len(full_calls) == len(sp_calls), f"rank {rank}: {len(sp_calls)} K1 calls "
          f"sharded, {len(full_calls)} in one process")
    differ = total = 0
    for (fa, _), (sa, _) in zip(full_calls, sp_calls):
        full, mine, w, stride, gp = fa[0], sa[0], fa[1], fa[6], fa[7]
        if mine.shape != full.shape:
            halo = spatial.halo_plan(w.shape[1], stride[0], gp[0], full.shape[1], rank, world)
            full = spatial.halo_rows(full, halo, rank, world)
        differ += int((full != mine).sum())
        total += mine.numel()
    return differ, total


def flip_reading(out, ref):
    """The flip gate's numbers of ``out`` against ``ref``, as a reading."""
    d = (out - ref).abs()
    return (f"median {float(d.median()):.3g}, max {float(d.max()):.3g}, mean "
            f"{float(d.mean()):.3g}, share < 2e-4 {float((d < 2e-4).float().mean()):.4f}")


def p15_rank(rank, world, dev, paths, inp):
    """Two gloo ranks sharing the card, each on its rows of H: CIFAR's DDIM
    run, the K1 and K2 calls of one forward (and the act codes of one
    process's, and of its rank-order control's, K1 calls), a bedroom
    forward and SD's KL-f8 decode."""
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parallel import comm, spatial, tp
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    sample, seq = _p14_setup(dev)
    mesh = tp.make_mesh2d(1, world)
    out = {"rank": rank}

    def measured(run):
        """(output, seconds, launches, collective stats, peak bytes above
        what was allocated before: the weights and inputs) of a
        synchronised run after a warm-up, everything set to 0 just before."""
        run(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _build.launch_counts.clear()
        comm.reset_stats()
        res, secs = timed(lambda: run(False))
        return (res, secs, dict(_build.launch_counts), dict(comm.stats),
                torch.cuda.max_memory_allocated() - base)

    # (b) CIFAR: DDIM, 10 quad steps at batch 500, bf16 carrier DEPLOY_INT8
    model = torch.load(paths["cifar"], weights_only=False).to(dev)
    x = inp["x_T"].to(dev)
    samples, secs, launches, stats, peak = measured(lambda warm: _sp(
        mesh, lambda xs: sample(model, xs, None, seq[:2] if warm else seq), x))
    out["cifar"] = dict(samples=samples, s=secs, comm=stats, peak=peak,
                        launches={k: v / STEPS for k, v in launches.items()})
    x50 = x[:P15_CODE_ROWS].to(torch.bfloat16)
    t50 = torch.full((P15_CODE_ROWS,), 500.0, device=dev)
    full, control, mine = {}, {}, {}
    with torch.no_grad():
        with recording_k1_k2(full):
            model(x50, t50, DEPLOY_INT8)
        with recording_k1_k2(control), spatial.rank_blocks(world):
            model(x50, t50, DEPLOY_INT8)
        with recording_k1_k2(mine):
            _sp(mesh, lambda xs: model(xs, t50, DEPLOY_INT8), x50)
    out["cifar"]["codes_differ"] = _codes_differ(full["int8_conv"], mine["int8_conv"],
                                                 rank, world)
    out["cifar"]["codes_differ_control"] = _codes_differ(
        control["int8_conv"], mine["int8_conv"], rank, world)
    del full, control
    check_k1_k2(mine, f"rank {rank} on its rows of H")
    del mine, model
    torch.cuda.empty_cache()

    # (c) bedroom: one DEPLOY_INT8 forward at batch 50, bf16 carrier
    unet = torch.load(paths["bedroom"], weights_only=False).to(dev)
    xb, tb = inp["bed_x"].to(dev), inp["bed_t"].to(dev)
    with torch.no_grad():
        y, secs, launches, stats, peak = measured(
            lambda warm: _sp(mesh, lambda xs: unet(xs, tb, mode=DEPLOY_INT8), xb))
    out["bedroom"] = dict(out=y, s=secs, launches=launches, comm=stats, peak=peak)
    del unet
    torch.cuda.empty_cache()

    # (d) SD's KL-f8 decode of four 64x64x4 latents to 512x512, float32
    fs = torch.load(paths["vae"], weights_only=False).to(dev)
    z = inp["z"].to(dev)
    with torch.no_grad():
        img, secs, _, stats, peak = measured(lambda warm: _sp(mesh, fs.decode, z))
    out["decode"] = dict(out=img, s=secs, comm=stats, peak=peak)
    return out


@torch.no_grad()
def check_shard_geometries(models):
    """(a) K1 on every conv geometry of ``models`` (name → DEPLOY_INT8
    export, ``(x, t)``) at world 2: each shard's K1 output (its rows, halo
    and pads) bit-equal to the plain version on the same inputs, and the
    shards' outputs, concatenated, bit-equal to the rows of the unsharded
    K1 output.  Returns the geometries checked."""
    from eda_dm_tpu_torch.nn.layers import QConv
    from eda_dm_tpu_torch.ops.int8_conv import border_map, int8_conv, int8_conv_plain
    from eda_dm_tpu_torch.ops.serving_policy import int8_conv_serving
    from eda_dm_tpu_torch.parallel import spatial
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    world, n_rows = 2, 4
    g = torch.Generator(device="cuda").manual_seed(15)
    seen, checked, whole, bad = set(), [], 0, []
    for name, (model, x, t) in models.items():
        sites = []
        hooks = [m.register_forward_pre_hook(lambda m, a: sites.append((m, a[0].shape)))
                 for m in model.modules()
                 if isinstance(m, QConv) and int8_conv_serving(
                     DEPLOY_INT8, m.wq, m.aq, m.disable_act_quant, m.split)]
        try:
            model(x, t, mode=DEPLOY_INT8)
        finally:
            for h in hooks:
                h.remove()
        for m, shape in sites:
            _, H, W, cin = shape
            key = (m.kernel_size, m.strides, m.padding, H, W, cin, m.features)
            if key in seen:
                continue
            seen.add(key)
            codes = torch.randint(-128, 128, (n_rows, H, W, cin), generator=g, device="cuda",
                                  dtype=torch.int8)
            c = torch.tensor(3.0, device="cuda")
            scale = m.w0_delta.float() * 0.01
            args = (m.w0_int, m.w0_isum, c, scale, m.bias.float(), m.strides)
            gp = m.pads(H, W)
            border = lambda h, pads: (border_map(m.w0_int, h, W, m.strides, pads)
                                      if pads != ((0, 0), (0, 0)) else None)
            full = int8_conv(codes, *args, gp, border(H, gp), torch.float32)
            plans = [spatial.halo_plan(m.kernel_size[0], m.strides[0], gp[0], H, r, world)
                     for r in range(world)]
            if plans[0] is None:
                whole += 1
                continue
            parts = []
            for r, p in enumerate(plans):
                rows = spatial.halo_rows(codes, p, r, world).contiguous()
                pads = (p.pads, gp[1])
                mine = int8_conv(rows, *args, pads, border(rows.shape[1], pads), torch.float32)
                plain = int8_conv_plain(rows, *args, pads, border(rows.shape[1], pads),
                                        torch.float32)
                if not torch.equal(mine, plain):
                    bad.append((name, key, f"rank {r}"))
                parts.append(mine)
            if not torch.equal(torch.cat(parts, 1), full):
                bad.append((name, key, "concatenated"))
            checked.append(key)
    check(checked and not bad, f"(a) K1 on {len(checked)} shard geometries at world {world} "
          f"({whole} kept whole by the rule): each shard's output bit-equal to the plain "
          f"version on its rows, halo and pads, the shards concatenated bit-equal to the "
          f"unsharded output (failing: {bad[:3]})")
    print("    geometries (kernel, stride, H x W x Cin -> Cout): "
          + "; ".join(f"{k[0][0]}x{k[0][1]} s{k[1][0]} {k[3]}x{k[4]}x{k[5]}->{k[6]}"
                      for k in checked))
    return checked


def spatial_phase(kernels, smi, cifar_model, bedroom_unet):
    """Phase 15: spatial parallelism (``parallel/spatial.py``,
    ``tp.shard_spatial``), the activations' height split over two gloo
    ranks sharing the card (NCCL refuses two ranks on one device; every
    halo is staged through the host and its seconds counted apart):

    (a) K1 on every conv geometry of ``DDPMConfig()`` and of bedroom's UNet
        (3×3 SAME, DDPM's stride-2 ``((0, 1), (0, 1))``, LDM's stride-2
        ``((1, 1), (1, 1))``, 1×1) with each shard's rows, halo and pads:
        bit-equal to the plain version, and the shards concatenated
        bit-equal to the unsharded output;
    (b) CIFAR ``DDPMConfig()``, phase 5's smoke-state export in DEPLOY_INT8
        (bf16 carrier), 10 quad DDIM steps at batch 500, each rank on 16 of
        the 32 rows: the samples bit-equal to one process's under
        ``spatial.rank_blocks(2)`` (the control: what a rank computes at
        its own number of rows, the norms' sums and the folded float
        convs, done in the ranks' blocks, so the halos, pads and gathers
        are exact where it holds), and the act codes of one forward's K1
        calls equal to that control's; against the plain one process the
        flip gate's numbers and the act codes that differ are printed (a
        float sum in another order flips a bf16 rounding or an act code,
        and the norms spread it); each rank's K1, K2 and K3 launches per
        forward one process's, each K1 and K2 call of that forward
        bit-equal to its plain version; img/s, halo calls, bytes and
        seconds and each rank's peak memory beside one process's;
    (c) bedroom's UNet (phase 7's export), one DEPLOY_INT8 forward at batch
        50 (K4 on the gathered 32×32 and 16×16 sites, ``DownsampleL``'s
        halo), timed after a warm-up: the flip gate against one process
        and bit-equal to its rank-order control, the launches one
        process's;
    (d) SD v1.4's KL-f8 decode of four 64×64×4 latents to 512×512 in
        float32: max |Δ| / max |ref| within 1e-4 of one process (cuDNN picks
        its algorithm by shape, so not bit for bit), ms and each rank's
        peak memory beside one process's, the halo bytes."""
    import shutil
    import tempfile
    from eda_dm_tpu_torch.models.latent_diffusion import sd_v1_config
    from eda_dm_tpu_torch.models.vae import FirstStage
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.parallel import spatial
    from eda_dm_tpu_torch.parallel.launch import spawn
    from eda_dm_tpu_torch.quant import DEPLOY_INT8
    print("[15] spatial parallelism: the height over 2 gloo ranks on one card (K1 on "
          "haloed shards, CIFAR DDIM, a bedroom forward, SD's 512x512 decode)")
    t_phase = time.perf_counter()
    res = {"card": smi}
    work = tempfile.mkdtemp(prefix="chip_smoke_p15_")
    try:
        g = torch.Generator().manual_seed(150)
        inp = {"x_T": torch.randn(BATCH, 32, 32, 3, generator=g),
               "bed_x": torch.randn(LDM_BATCH, 64, 64, 3, generator=g).to(torch.bfloat16),
               "bed_t": torch.full((LDM_BATCH,), 500.0),
               "z": torch.randn(P15_SD_LATENTS, 64, 64, 4, generator=g)}
        cifar, unet = cifar_model.cuda(), bedroom_unet.cuda()
        t0 = time.perf_counter()
        with torch.no_grad():
            x8 = torch.randn(2, 32, 32, 3, device="cuda").to(torch.bfloat16)
            xb = inp["bed_x"][:2].cuda()
            res["geometries"] = len(check_shard_geometries({
                "CIFAR": (cifar, x8, torch.full((2,), 500.0, device="cuda")),
                "bedroom": (unet, xb, torch.full((2,), 500.0, device="cuda"))}))
        res["geometries_s"] = time.perf_counter() - t0

        # one process: the references, their times and peak memory
        sample, seq = _p14_setup("cuda")
        single = {}
        x = inp["x_T"].cuda()
        sample(cifar, x, None, seq[:2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _build.launch_counts.clear()
        s_out, s_secs = timed(lambda: sample(cifar, x, None, seq))
        with spatial.rank_blocks(2):
            control = sample(cifar, x, None, seq).cpu()
        single["cifar"] = dict(out=s_out.cpu(), s=s_secs,
                               peak=torch.cuda.max_memory_allocated() - base,
                               control=control)
        with torch.no_grad():
            xb, tb = inp["bed_x"].cuda(), inp["bed_t"].cuda()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _build.launch_counts.clear()
            y, secs = timed(lambda: unet(xb, tb, mode=DEPLOY_INT8))
            single["bedroom"] = dict(out=y.cpu(), s=secs, launches=dict(_build.launch_counts),
                                     peak=torch.cuda.max_memory_allocated() - base)
            with spatial.rank_blocks(2):
                single["bedroom"]["control"] = unet(xb, tb, mode=DEPLOY_INT8).cpu()
        torch.save(cifar.cpu(), os.path.join(work, "cifar.pt"))
        torch.save(unet.cpu(), os.path.join(work, "bedroom.pt"))
        del cifar, unet, x, xb, y, s_out
        torch.cuda.empty_cache()
        fs = FirstStage(sd_v1_config().vae, device="cuda", seed=0, encoder=False)
        with torch.no_grad():
            z = inp["z"].cuda()
            fs.decode(z)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            img, secs = timed(lambda: fs.decode(z))
            single["decode"] = dict(out=img.cpu(), s=secs,
                                    peak=torch.cuda.max_memory_allocated() - base)
        torch.save(fs.cpu(), os.path.join(work, "vae.pt"))
        del fs, img, z
        torch.cuda.empty_cache()

        paths = {k: os.path.join(work, f"{k}.pt") for k in ("cifar", "bedroom", "vae")}
        t0 = time.perf_counter()
        ranks = spawn(p15_rank, 2, "gloo", "cuda", paths, inp, timeout_s=300)
        res["ranks_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)

    gib = lambda b: b / 2 ** 30
    halo = lambda r, part: (r[part]["comm"]["halo_calls"], r[part]["comm"]["halo_bytes"],
                            r[part]["comm"]["halo_seconds"])
    # (b)
    r0 = ranks[0]
    sp_samples = r0["cifar"]["samples"].cpu()
    check(torch.equal(sp_samples, single["cifar"]["control"]),
          f"sp CIFAR DDIM (world 2) bit-equal to one process under rank_blocks(2) "
          f"(max |d| {float((sp_samples - single['cifar']['control']).abs().max()):.3g})")
    for r in ranks:
        d, n = r["cifar"]["codes_differ_control"]
        check(d == 0, f"rank {r['rank']}: act codes of one forward's K1 calls "
              f"({P15_CODE_ROWS} rows) equal to the rank_blocks control's: {d} of {n} differ")
    for r in ranks:
        check(r["cifar"]["launches"] == DEFAULT_LAUNCHES["cifar"],
              f"rank {r['rank']}: launches per forward {r['cifar']['launches']} = one "
              f"process's {DEFAULT_LAUNCHES['cifar']}")
    for k in kernels[:4]:                       # a forward a rank
        k["spatial_launches"] = {part: [r[part]["launches"].get(k["name"], 0) for r in ranks]
                                 for part in ("cifar", "bedroom")}
    differ = [r["cifar"]["codes_differ"] for r in ranks]
    res["cifar"] = {
        "img_s_single": BATCH / single["cifar"]["s"],
        "img_s_sp": BATCH / max(r["cifar"]["s"] for r in ranks),
        "halo": [halo(r, "cifar") for r in ranks],
        "collective_s": [r["cifar"]["comm"]["seconds"] for r in ranks],
        "peak_gib_single": gib(single["cifar"]["peak"]),
        "peak_gib_ranks": [gib(r["cifar"]["peak"]) for r in ranks],
        "codes_differ": differ,
        "flip_reading": flip_reading(sp_samples.float(), single["cifar"]["out"].float())}
    c = res["cifar"]
    print(f"    (b) on {smi}: CIFAR DDIM {STEPS} steps at batch {BATCH}: one process "
          f"{c['img_s_single']:.1f} img/s, sp world 2 {c['img_s_sp']:.1f} img/s; halo "
          f"(calls, bytes, s) a rank {c['halo']}, all collectives {c['collective_s']} s; "
          f"peak memory one process {c['peak_gib_single']:.3f} GiB, ranks "
          f"{[round(p, 3) for p in c['peak_gib_ranks']]} GiB; act codes of one forward's K1 "
          f"calls ({P15_CODE_ROWS} rows) that differ from the plain one process's "
          f"(a reading): {[d for d, _ in differ]} of {[n for _, n in differ]}; the samples "
          f"against the plain one process (a reading): {c['flip_reading']}")
    # (c)
    flip_gate(r0["bedroom"]["out"].float().cpu(), single["bedroom"]["out"].float(),
              "sp bedroom DEPLOY_INT8 forward (world 2) against one process")
    check(torch.equal(r0["bedroom"]["out"].cpu(), single["bedroom"]["control"]),
          "sp bedroom DEPLOY_INT8 forward bit-equal to one process under rank_blocks(2)")
    for r in ranks:
        check(r["bedroom"]["launches"] == single["bedroom"]["launches"]
              and r["bedroom"]["launches"] == DEFAULT_LAUNCHES["bedroom"],
              f"rank {r['rank']}: bedroom launches {r['bedroom']['launches']} = one "
              f"process's (K4 on the gathered 32x32 and 16x16 sites)")
    res["bedroom"] = {"ms_single": single["bedroom"]["s"] * 1e3,
                      "ms_sp": max(r["bedroom"]["s"] for r in ranks) * 1e3,
                      "halo": [halo(r, "bedroom") for r in ranks],
                      "peak_gib_single": gib(single["bedroom"]["peak"]),
                      "peak_gib_ranks": [gib(r["bedroom"]["peak"]) for r in ranks]}
    b = res["bedroom"]
    print(f"    (c) bedroom forward at batch {LDM_BATCH}: one process {b['ms_single']:.1f} ms, "
          f"sp {b['ms_sp']:.1f} ms; halo {b['halo']}; peak one process "
          f"{b['peak_gib_single']:.3f} GiB, ranks {[round(p, 3) for p in b['peak_gib_ranks']]}")
    # (d)
    ref = single["decode"]["out"]
    rel = float((r0["decode"]["out"].cpu() - ref).abs().max() / ref.abs().max())
    check(rel <= 1e-4 and r0["decode"]["out"].shape == (P15_SD_LATENTS, 512, 512, 3),
          f"sp KL-f8 decode (world 2): max |d| / max |ref| {rel:.3g} <= 1e-4, shape "
          f"{tuple(r0['decode']['out'].shape)}")
    res["decode"] = {"rel_err": rel, "ms_single": single["decode"]["s"] * 1e3,
                     "ms_sp": max(r["decode"]["s"] for r in ranks) * 1e3,
                     "halo": [halo(r, "decode") for r in ranks],
                     "collective_s": [r["decode"]["comm"]["seconds"] for r in ranks],
                     "peak_gib_single": gib(single["decode"]["peak"]),
                     "peak_gib_ranks": [gib(r["decode"]["peak"]) for r in ranks]}
    d = res["decode"]
    print(f"    (d) on {smi}: SD KL-f8 decode of {P15_SD_LATENTS} latents to 512x512, f32: "
          f"one process {d['ms_single']:.1f} ms, sp {d['ms_sp']:.1f} ms; peak memory one "
          f"process {d['peak_gib_single']:.3f} GiB, ranks "
          f"{[round(p, 3) for p in d['peak_gib_ranks']]} GiB (ratio "
          f"{max(d['peak_gib_ranks']) / max(d['peak_gib_single'], 1e-9):.3f}); halo "
          f"(calls, bytes, s) "
          f"{d['halo']}, all collectives {d['collective_s']} s")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"    seconds: geometries {res['geometries_s']:.1f}, ranks {res['ranks_s']:.1f}, "
          f"phase 15 {res['phase_s']:.1f}")
    return res


# --------------------------------------------------------------------------
# phase 16: the gate on the grouped-reconstruction deviations

def gate_phase(smi):
    """Phase 16: ``python -m eda_dm_tpu_torch.gate_recon_deviations``'s
    ``main`` at ``--iters 20 --n 64 --calib 64 --steps 10`` on the card
    (the mid-size W4A8 DDPM, arms A and B over the whole plan, FP, A and B
    populations through the random-init FID InceptionV3): every metric
    finite, the verdict one of the four, and arm B's row cap taken.  At 20
    iterations on random weights a FAIL or INCONCLUSIVE is a finding, not a
    fault."""
    import shutil
    import tempfile
    from eda_dm_tpu_torch.gate_recon_deviations import main as gate_main
    print("[16] gate_recon_deviations: --iters 20 --n 64 --calib 64 --steps 10")
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_p16_")
    try:
        out = gate_main(["--iters", "20", "--n", "64", "--calib", "64", "--steps", "10",
                         "--dump", os.path.join(work, "dump.npz")])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    m, caps = out["metrics"], out["arm_b_row_caps"]
    check(all(math.isfinite(v) for v in m.values() if isinstance(v, float))
          and m["gate"] in ("PASS", "WEAK-PASS", "INCONCLUSIVE", "FAIL"),
          f"gate {m['gate']}: every metric finite")
    check(len(caps) > 0, f"arm B: {len(caps)} targets over the budget under the row cap "
          f"{min(caps, default=None)} of 64 rows")
    out["seconds"] = time.perf_counter() - t0
    print(f"    on {smi}: {json.dumps(m)}; arm B row caps {caps}; {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 17: CLIP ViT-L/14, SD v1.4's text conditioner and the CLIP scorer

CLIP_SEED = 17
CLIP_BATCH = 64                        # the towers' timed batch
CLIP_HELD = 4                          # the card-vs-host comparison's images


def host_gate(card, host, what):
    """Card against host: within 1e-4 of the largest |host| value plus 1e-3
    relative (cuBLAS and the host's products sum in other orders).
    Returns the largest |Δ|."""
    c = torch.as_tensor(card).detach().cpu().double()
    h = torch.as_tensor(host).detach().cpu().double()
    err, top = float((c - h).abs().max()), float(h.abs().max())
    check(c.shape == h.shape and bool(((c - h).abs() <= 1e-4 * top + 1e-3 * h.abs()).all()),
          f"{what}: card vs host max |d| {err:.3g} (largest |host| {top:.3g}) within 1e-4 "
          f"of it plus 1e-3 relative")
    return err


def clip_phase(kernels, smi, dev="cuda"):
    """Phase 17: CLIP ViT-L/14 in the port (``models/clip.py``,
    ``models/clip_tokenizer.py``) as SD v1.4's text conditioner and as the
    CLIP scorer, at openai/clip-vit-large-patch14's published widths on
    random weights (seed 17).

    (a) A text checkout written into a temporary directory of the
    checkout's ignored ``_build/`` and deleted after: ``config.json`` in
    the published two-tower layout (``eos_token_id`` 2), the text tower
    (123,060,480 parameters, and ``text_projection``) as
    ``pytorch_model.bin``, and a synthetic ``vocab.json`` / ``merges.txt``
    of the published 49,408 entries (the 512 byte symbols, merges learned
    from SD's four prompts, filler merges, the specials at 49,406 and
    49,407).

    (b) ``FrozenCLIPTextEncoder`` on it, on the card and on the host: SD's
    four prompts and "" → (4, 77, 768) and (1, 77, 768), finite, the card
    against the host in phase 13's gate; the ms of an encode at 8 rows.

    (c) ``python -m eda_dm_tpu_torch.sample_ldm``'s ``main`` in process:
    ``--task coco --text_encoder clip --clip_path <checkout> --serve int8``
    at ``sd_v1_config()`` on random weights, cut to the smallest
    calibration its flags take (4 prompts: ``--calib_num_samples 4
    --batch_samples 4``, ``--iters 1`` over the whole reconstruction plan)
    and phase 11's 10 PLMS steps, 4 images at batch 4 (CFG 7.5, 8 UNet
    rows).  Launch counts set to 0 just before and read just after: 11
    forwards of ``DEFAULT_LAUNCHES["sd"]``, so K1-K5 serve a UNet
    conditioned by the CLIP tower.  Images finite in [0, 1]; img/s (the
    PNG writes counted) and the encode's share of ``main``'s wall time.

    (d) ``CLIPScorer`` at both published widths (text 123,060,480 and
    vision 303,179,776 parameters) with the injected model and the
    checkout's tokenizer: (c)'s images scored against their prompts,
    finite, in [-100, 100]; 4 images' and prompts' features card against
    host in the same gate; the vision tower's images/s and the text
    tower's prompts/s at batch 64 (float32, TF32 off)."""
    import shutil
    import tempfile
    import numpy as np
    from eda_dm_tpu_torch import sample_ldm
    from eda_dm_tpu_torch.eval.clip import CLIPScorer, clip_preprocess
    from eda_dm_tpu_torch.models import clip
    from eda_dm_tpu_torch.models.clip_tokenizer import CLIPTokenizer, write_synthetic_vocab
    from eda_dm_tpu_torch.models.encoders import FrozenCLIPTextEncoder
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.pipelines.latent import LDMPipeline

    print(f"[17] CLIP ViT-L/14: the text conditioner of SD v1.4's int8 serving "
          f"(sample_ldm --text_encoder clip) and CLIPScorer, random weights ({smi})")
    t_phase = time.perf_counter()
    out = {"card": smi}
    prompts = list(COCO_PROMPTS)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="clip-", dir=_build.BUILD_DIR)
    try:
        print("    (a) a random text checkout at the published widths")
        cfg = clip.vit_l14_config()
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"model_type": "clip", "projection_dim": cfg.projection_dim,
                       "text_config": dataclasses.asdict(cfg.text),
                       "vision_config": dataclasses.asdict(cfg.vision)}, f)
        src = clip.CLIPModel(cfg.towers(("text",)), device=dev, seed=CLIP_SEED)
        n_text = sum(p.numel() for p in src.text_model.parameters())
        check(n_text == 123_060_480, f"text tower {n_text:,} parameters")
        _, save_s = timed(lambda: torch.save(
            {k: v.cpu() for k, v in src.state_dict().items()},
            os.path.join(tmp, "pytorch_model.bin")))
        vocab = write_synthetic_vocab(tmp, prompts)
        check(len(vocab) == 49_408 and vocab["<|startoftext|>"] == 49_406
              and vocab["<|endoftext|>"] == 49_407,
              f"synthetic vocab of {len(vocab):,} entries, specials at 49,406 and 49,407")
        del src

        print("    (b) FrozenCLIPTextEncoder on the card and on the host")
        enc, load_s = timed(lambda: FrozenCLIPTextEncoder(tmp, device=dev))
        host = FrozenCLIPTextEncoder(tmp, device="cpu")
        card_ctx, card_unc = enc.encode(prompts), enc.encode([""])
        check(tuple(card_ctx.shape) == (4, 77, 768) and tuple(card_unc.shape) == (1, 77, 768)
              and bool(torch.isfinite(card_ctx).all() and torch.isfinite(card_unc).all()),
              f"contexts {tuple(card_ctx.shape)} and {tuple(card_unc.shape)}, finite")
        out["encode_card_vs_host_max_abs"] = max(
            host_gate(card_ctx, host.encode(prompts), "4 prompts' hidden states"),
            host_gate(card_unc, host.encode([""]), "the empty prompt's"))
        rows8 = prompts + [""] * 4
        encode_ms = cuda_ms(lambda: enc.encode(rows8), reps=10)
        ids8 = torch.from_numpy(enc.tokenize(rows8)).to(dev)
        tower_ms = cuda_ms(lambda: enc.model.text_hidden_states(ids8), reps=10)
        print(f"    checkout written in {save_s:.2f} s; loaded on the card in {load_s:.2f} s; "
              f"an encode at 8 rows {encode_ms:.3f} ms (the tower alone {tower_ms:.3f} ms) "
              f"on {smi}")
        out.update(save_s=save_s, load_s=load_s, encode_8_ms=encode_ms,
                   text_tower_8_ms=tower_ms)
        del enc, host
        free_memory("after the encoder")

        print(f"    (c) sample_ldm --task coco --text_encoder clip --serve int8: "
              f"{len(prompts)} prompts, {STEPS} PLMS steps, CFG 7.5, 4 calibration prompts, "
              f"--iters 1")
        with open(os.path.join(tmp, "prompts.txt"), "w") as f:
            f.write("\n".join(prompts) + "\n")
        spent, images = [0.0, 0.0], []            # encode, sample_batch seconds
        encode, sample_batch = FrozenCLIPTextEncoder.encode, LDMPipeline.sample_batch

        def timed_encode(self, rows):
            res, sec = timed(lambda: encode(self, rows))
            spent[0] += sec
            return res

        def kept_batch(self, *a, **kw):
            img, sec = timed(lambda: sample_batch(self, *a, **kw))
            spent[1] += sec
            images.append(img.float().cpu())
            return img
        flags = ["--task", "coco", "--text_encoder", "clip", "--clip_path", tmp,
                 "--prompts_file", os.path.join(tmp, "prompts.txt"), "--serve", "int8",
                 "--custom_steps", str(STEPS), "--calib_num_samples", "4", "--batch_samples",
                 "4", "--iters", "1", "--n_samples", "4", "--batch_size", "4",
                 "--logdir", os.path.join(tmp, "run"), "--skip_grid"]
        if dev != "cuda":
            flags += ["--device", dev]
        with swapped(FrozenCLIPTextEncoder, "encode", timed_encode), \
                swapped(LDMPipeline, "sample_batch", kept_batch):
            _build.launch_counts.clear()
            run, main_s = timed(lambda: sample_ldm.main(flags))
            launches = dict(_build.launch_counts)
        forwards = STEPS + 1
        check({k: v / forwards for k, v in launches.items()} == DEFAULT_LAUNCHES["sd"],
              f"the int8 UNet under the CLIP context: {launches} over {forwards} forwards, "
              f"{DEFAULT_LAUNCHES['sd']} each")
        for k in kernels:
            if k["name"] in DEFAULT_LAUNCHES["sd"]:
                k["clip_launches"] = launches.get(k["name"], 0)
        imgs = torch.cat(images)
        check(tuple(imgs.shape) == (4, 512, 512, 3) and bool(torch.isfinite(imgs).all())
              and float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0
              and len(os.listdir(run["img_dir"])) == 4,
              f"images {tuple(imgs.shape)} finite in [0, 1], 4 PNGs written")
        print(f"    main {main_s:.2f} s (calibration and reconstruction included), 4 images: "
              f"{4 / main_s:.4f} img/s end to end, {4 / spent[1]:.4f} img/s in sample_batch "
              f"({spent[1]:.3f} s: {STEPS} PLMS steps and the decode); the CLIP encodes "
              f"{spent[0]:.4f} s = {spent[0] / main_s:.4%} of main's wall time, "
              f"{spent[0] / spent[1]:.3%} of sample_batch's on {smi}")
        out.update(main_s=main_s, main_img_per_s=4 / main_s, sample_s=spent[1],
                   sample_img_per_s=4 / spent[1], encode_s=spent[0],
                   encode_share=spent[0] / main_s, launches=launches)
        free_memory("after sample_ldm")

        print("    (d) CLIPScorer at both published widths, (c)'s images against their prompts")
        model = clip.CLIPModel(cfg, device=dev, seed=CLIP_SEED)
        n_vision = sum(p.numel() for p in model.vision_model.parameters())
        check(n_vision == 303_179_776, f"vision tower {n_vision:,} parameters")
        tok = CLIPTokenizer.from_pretrained(tmp)
        scorer = CLIPScorer(model=model, tokenizer=tok, device=dev)
        score = scorer.score(imgs.numpy(), prompts)
        check(math.isfinite(score) and -100.0 <= score <= 100.0,
              f"CLIP score of the 4 images against their prompts {score!r}")
        ref = clip.CLIPModel(cfg, device="cpu", init=False)
        clip.load_state(ref, model.state_dict())
        host_scorer = CLIPScorer(model=ref, tokenizer=tok, device="cpu")
        held = imgs[:CLIP_HELD].numpy()
        out["image_card_vs_host_max_abs"] = host_gate(
            scorer.image_features(held), host_scorer.image_features(held),
            f"{CLIP_HELD} images' features")
        out["text_card_vs_host_max_abs"] = host_gate(
            scorer.text_features(prompts), host_scorer.text_features(prompts),
            f"{len(prompts)} prompts' features")
        del ref, host_scorer
        g = torch.Generator(device=dev).manual_seed(CLIP_SEED)
        px = clip_preprocess(torch.rand(CLIP_BATCH, 512, 512, 3, generator=g, device=dev))
        vision_ms = cuda_ms(lambda: model.get_image_features(px), reps=5, warmup=1)
        ids = torch.from_numpy(tok(prompts * (CLIP_BATCH // len(prompts)))["input_ids"]).to(dev)
        text_ms = cuda_ms(lambda: model.get_text_features(ids), reps=5, warmup=1)
        print(f"    score {score!r}; at batch {CLIP_BATCH} (float32, TF32 off): vision tower "
              f"{vision_ms:.3f} ms = {CLIP_BATCH / vision_ms * 1e3:.1f} images/s, text tower "
              f"{text_ms:.3f} ms = {CLIP_BATCH / text_ms * 1e3:.1f} prompts/s on {smi}")
        out.update(score=score, vision_64_ms=vision_ms,
                   vision_images_per_s=CLIP_BATCH / vision_ms * 1e3, text_64_ms=text_ms,
                   text_prompts_per_s=CLIP_BATCH / text_ms * 1e3)
        del model, scorer, px
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"    phase 17 on {smi}: {out['phase_s']:.1f} s")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port first: without it (this file alone) nothing is printed
    from eda_dm_tpu_torch.ops import _build
    from eda_dm_tpu_torch.models.ddpm_unet import DDPMConfig, DDPMUNet
    from eda_dm_tpu_torch.quant import DEPLOY, DEPLOY_FUSED, DEPLOY_INT8, FP, QuantConfig
    from eda_dm_tpu_torch.quant.export import export_serving_int8
    from eda_dm_tpu_torch.samplers.schedules import get_beta_schedule, skip_sequence

    t_start = time.perf_counter()
    dropped = [name for name in SERVING_SWITCHES if os.environ.pop(name, None) is not None]
    if dropped:                     # the checks below hold the default branches
        print(f"chip_smoke: serving switches unset for this run: {', '.join(dropped)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    query = lambda q: subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    smi = query("name,power.limit")
    clock_mhz = float(query("clocks.max.sm").split()[0])
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[1] device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {kind} x{torch.cuda.device_count()}, {sms} SMs, max SM clock "
          f"{clock_mhz:.0f} MHz")

    secs = _build.build()
    print(f"[2] build: {secs:.1f} s for {', '.join(_build.CUDA_SOURCES)}")
    for name in _build.CUDA_SOURCES:
        if name == "int8_conv":      # by instance in phase 3
            continue
        log = (_build.BUILD_DIR / f"{name}.log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    print(f"[3] kernels vs plain versions")
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    kernels = [check_conv(g), check_bmm(g), check_softmax(g),
               check_attention(g, sms, clock_mhz * 1e6),
               check_flash(g, sms, clock_mhz * 1e6), check_gn(g), check_fq(g)]
    kernels[5]["per_forward"] = {}
    for k in kernels:
        print_kernel(k)
    print(f"    phase 3: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    print("[3b] K8 (int8 quantized matmul) and P1 (tensor-core rate probe) vs plain "
          "versions, then each one's own path")
    t0 = time.perf_counter()
    kernels.append(check_quantized_matmul(g))
    k8 = kernels[-1]
    print_kernel(k8)
    k8_path(k8)
    torch.cuda.empty_cache()
    kernels.append(check_mma_chain(g))
    p1_path(kernels[-1], smi)
    print(f"    phase 3b: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

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
        _build.launch_counts.clear()
        out_k = model(x8, t8, DEPLOY_INT8)
        batch8 = dict(_build.launch_counts)
        with plain_versions():
            out_p = model(x8, t8, DEPLOY_INT8)
    check(bool(torch.isfinite(out_k).all()) and out_k.shape == (8, 32, 32, 3),
          f"int8 output finite, shape {tuple(out_k.shape)} ({n_aq} act quantizers set)")
    check(batch8.get("int8_attention", 0) == 6 and "softmax_codes" not in batch8,
          f"batch 8 serves all 6 attention blocks with K4 (launches {batch8})")
    flip_gate(out_k, out_p, "CIFAR")
    print(f"    quantization error mean |int8 - FP| = "
          f"{float((out_k - fp_ref).abs().mean()):.4f}")
    print("    the same with the fused GroupNorm (EDM_FUSED_GN=1), and in DEPLOY_FUSED")
    with environ(EDM_FUSED_GN="1"):
        launches = kernels_vs_plain(lambda: model(x8, t8, DEPLOY_INT8), "CIFAR fused GN")
    kernels[5]["per_forward"]["cifar"] = launches.get("gn_int8", 0)
    check(launches.get("gn_int8") == 51, f"K6 at all 51 GroupNorm sites: conv1 and conv2 "
          f"of 22 ResnetBlocks, 6 attention blocks, norm_out (launches {launches})")
    launches = kernels_vs_plain(lambda: model(x8, t8, DEPLOY_FUSED), "CIFAR DEPLOY_FUSED",
                                same_function=lambda: model(x8, t8, DEPLOY_INT8))
    check(launches == {"fakequant_matmul": 61}, f"K7 at all 61 1x1 convs and denses: 24 "
          f"attention 1x1s, 13 nin_shortcuts, 24 denses; nothing else (launches {launches})")

    print(f"[5] CIFAR serving: DDIM eta=0, {STEPS} quad steps, batch {BATCH}, "
          f"bf16 carrier DEPLOY_INT8")
    for p in model.parameters():                 # the export's carrier cast
        p.data = p.data.to(torch.bfloat16)
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                              num_diffusion_timesteps=1000)
    seq = skip_sequence("quad", STEPS, 1000)
    xb = torch.randn(BATCH, 32, 32, 3, generator=gx, device="cuda")
    int8_fn = lambda x, t: model(x.to(torch.bfloat16), t, DEPLOY_INT8)
    int8_sps, out = steps_per_s(int8_fn, xb, seq, betas)         # CIFAR's main path
    cifar = dict(_build.launch_counts)
    check(bool(torch.isfinite(out).all()) and out.shape == (BATCH, 32, 32, 3),
          f"samples finite, shape {tuple(out.shape)}")
    check({k: v / STEPS for k, v in cifar.items()} == DEFAULT_LAUNCHES["cifar"],
          f"the default branches: {DEFAULT_LAUNCHES['cifar']} per forward")
    for k in kernels[:3]:
        k["cifar_launches"] = cifar.get(k["name"], 0)
        check(k["cifar_launches"] > 0, f"{k['name']} launched {k['cifar_launches']} "
              f"times ({k['cifar_launches'] / STEPS:g} per forward) on the CIFAR path")
    print(f"    the fused-GroupNorm path (EDM_FUSED_GN=1), DEPLOY_INT8")
    with environ(EDM_FUSED_GN="1"):
        gn_sps, out = steps_per_s(int8_fn, xb, seq, betas)       # K6's main path
    launches = dict(_build.launch_counts)
    check(bool(torch.isfinite(out).all()) and out.shape == (BATCH, 32, 32, 3),
          f"samples finite, shape {tuple(out.shape)}")
    print("    launches per forward: "
          + ", ".join(f"{k} {v / STEPS:g}" for k, v in sorted(launches.items())))
    kernels[5]["launches"] = launches.get("gn_int8", 0)
    for k in kernels[:3] + kernels[5:6]:
        check(launches.get(k["name"], 0) > 0, f"{k['name']} launched "
              f"{launches.get(k['name'], 0)} times on the fused-GroupNorm path")
    check(launches["gn_int8"] == 51 * STEPS, "K6: 51 launches per forward")
    bf16_in = lambda mode: lambda x, t: model(x.to(torch.bfloat16), t, mode)
    deploy_sps, _ = steps_per_s(bf16_in(DEPLOY), xb, seq, betas)
    print(f"    the folded W4A8 export in DEPLOY_FUSED")
    fused_sps, out = steps_per_s(bf16_in(DEPLOY_FUSED), xb, seq, betas)  # K7's main path
    launches = dict(_build.launch_counts)
    check(bool(torch.isfinite(out).all()) and out.shape == (BATCH, 32, 32, 3),
          f"samples finite, shape {tuple(out.shape)}")
    kernels[6]["launches"] = launches.get("fakequant_matmul", 0)
    check(launches == {"fakequant_matmul": 61 * STEPS},
          f"K7: 61 launches per forward, nothing else (launches {launches})")
    t500 = torch.full((BATCH,), 500.0, device="cuda")
    for what, fn in (("DEPLOY_INT8", int8_fn), ("DEPLOY_INT8 with the fused GroupNorm", int8_fn),
                     ("DEPLOY_FUSED", bf16_in(DEPLOY_FUSED))):
        print(f"    profile, {what} forward at batch {BATCH}, bf16 carrier:")
        with torch.no_grad(), environ(EDM_FUSED_GN="1" if "fused Group" in what else "0"):
            profile_forward(lambda: fn(xb, t500))
    p14_model = copy.deepcopy(model).cpu()      # phase 14 serves the same export
    del model
    fp32 = DDPMUNet(cfg, qc, device="cuda", seed=0)
    fp32_sps, _ = steps_per_s(lambda x, t: fp32(x, t, FP), xb, seq, betas)
    bf16 = DDPMUNet(cfg, qc, device="cuda", seed=0).to(torch.bfloat16)
    bf16_sps, _ = steps_per_s(lambda x, t: bf16(x.to(torch.bfloat16), t, FP),
                              xb, seq, betas)
    print(f"    steps/s at batch {BATCH} on {smi}: int8 W4A8 {int8_sps:.4f} | int8 W4A8 "
          f"fused GN {gn_sps:.4f} | folded W4A8 DEPLOY {deploy_sps:.4f} | folded W4A8 "
          f"DEPLOY_FUSED {fused_sps:.4f} | bf16-FP {bf16_sps:.4f} | fp32-FP {fp32_sps:.4f}")
    print(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del fp32, bf16
    torch.cuda.empty_cache()

    serving, bedroom_unet = bedroom(kernels, smi)
    torch.cuda.empty_cache()
    sd_serving = sd(kernels, smi)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    calibrated = calibration(kernels, smi, int8_sps)
    print(f"    phase 10: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    latent = latent_calibration(kernels, smi, serving)
    print(f"    phase 11: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    imagenet_serving = imagenet(kernels, smi)
    print(f"    phase 12: {time.perf_counter() - t0:.1f} s")
    free_memory("after phase 12")
    print("[13] the scoring path: checkpoints in through the converters, sample_ddim "
          "(int8 and fp sets), evaluate (FID, IS, sFID) on the FID InceptionV3")
    scored = scoring(smi)
    free_memory("after phase 13")
    parallel_res = parallel(kernels, smi, p14_model)
    free_memory("after phase 14")
    spatial_res = spatial_phase(kernels, smi, p14_model, bedroom_unet)
    del p14_model, bedroom_unet
    free_memory("after phase 15")
    gate_res = gate_phase(smi)
    free_memory("after phase 16")
    clip_res = clip_phase(kernels, smi)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    extra = ("cifar_launches", "bedroom_launches", "per_forward", "device_ms", "chain_ms",
             "einsum_ms", "bmm_f32_ms", "bf16_conv_ms", "plans", "transposing_ms", "streamed_ms",
             "acc_ms", "other_tile_ms", "sd_ms", "shapes_ms", "rates", "plain_by_shape",
             "library_peak", "mma_sync_ms", "mma_sync_launches", "mma_sync_source",
             "calibrated_launches", "latent_calibrated_launches", "church_launches",
             "imagenet_launches", "imagenet_calibrated_launches", "imagenet_ms",
             "parallel_launches", "spatial_launches", "clip_launches")
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{**{k: kern[k] for k in keys},
                                   **{k: kern[k] for k in extra if k in kern},
                                   "check": "pass"} for kern in kernels]}))
    print(json.dumps({"cifar_serving_steps_per_s": {
        "int8": int8_sps, "int8_fused_gn": gn_sps, "folded_deploy": deploy_sps,
        "folded_deploy_fused": fused_sps, "bf16_fp": bf16_sps, "fp32_fp": fp32_sps,
        "batch": BATCH},
        "bedroom_serving": serving, "sd_serving": sd_serving,
        "cifar_calibration": calibrated, "latent_calibration": latent,
        "imagenet": imagenet_serving, "scoring": scored, "parallel": parallel_res,
        "spatial": spatial_res, "gate_recon_deviations": gate_res, "clip": clip_res}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
