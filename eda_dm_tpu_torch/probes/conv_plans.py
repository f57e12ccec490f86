"""K1's tiles, K steps and rings, timed (``csrc/int8_conv.cu``).

On its 16-byte route the kernel fixes one K step of ``K1_KSTEP`` bytes
in a ring of ``K1_STAGES`` slots, and ``ops/int8_conv.py::conv_plan``
picks the 128 x 128 or 128 x 64 tile by Cout.  This probe builds the
source again with each 64- or 128-byte step and 2 to 4 slots (one
``nvcc`` a variant, all started together), holds each variant's bf16
output at both tiles equal to the plain version, and times each, in two
rounds, at the conv shapes that decide them: CIFAR's 3×3 (the most
frequent conv), bedroom's 224-channel 3×3 (Cout = 224 fills 7/8 of two
128-channel tiles), SD's 1×1 ``proj_in`` (K = 320, three 128-byte steps)
and the two ``conv_out``s (Cout = 3 and 4, a 128-channel tile almost
empty).

    python -m eda_dm_tpu_torch.probes.conv_plans      # on one CUDA card

It prints one line a shape and variant and, last, the fastest variant of
each shape; the card's name and power limit belong beside the numbers.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Tuple

import torch

from ..device import resolve_device
from ..ops import _build
from ..ops.int8_conv import (_CONV_SIG, _int8_conv_cuda, border_map, int8_conv_plain,
                             same_pads)
from ..ops.int8_einsum import TILE_LARGE, TILE_SMALL
from .mma_int8 import cuda_ms

BUILDS = ((64, 2), (64, 3), (64, 4), (128, 2), (128, 3), (128, 4))   # K step bytes, slots
TILES = {TILE_LARGE: 128, TILE_SMALL: 64}     # tile index -> its channels
SHAPES = (  # name, batch, height = width, Cin, Cout, taps a side
    ("CIFAR 500x32x32x128->128 3x3", 500, 32, 128, 128, 3),
    ("bedroom 50x64x64x224->224 3x3", 50, 64, 224, 224, 3),
    ("SD proj_in 8x64x64x320->320 1x1", 8, 64, 320, 320, 1),
    ("CIFAR conv_out 500x32x32x128->3 3x3", 500, 32, 128, 3, 3),
    ("SD conv_out 8x64x64x320->4 3x3", 8, 64, 320, 4, 3),
)
Variant = Tuple[int, int, int]      # tile channels, K step bytes, ring slots


def build_variants(builds=BUILDS) -> Dict[Tuple[int, int], object]:
    """``csrc/int8_conv.cu`` at each (K step, slots), built under
    ``_build/conv_plans/`` and loaded."""
    out_dir = _build.BUILD_DIR / "conv_plans"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "int8_conv.cu"
    procs = []
    for v in builds:
        so = out_dir / f"int8_conv-{v[0]}-{v[1]}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DK1_KSTEP={v[0]}",
               f"-DK1_STAGES={v[1]}", "-o", str(so), str(src)]
        procs.append((v, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True)))
    libs, failed = {}, []
    for v, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            failed.append(f"{v}:\n{log}")
        else:
            libs[v] = _build.load_lib(so, _CONV_SIG)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return libs


def conv_inputs(batch, hw, cin, cout, k, g):
    """Seeded codes, weight codes and epilogue terms of one SAME conv."""
    pads = same_pads(hw, hw, k, k, 1, 1)
    x = torch.randint(-128, 128, (batch, hw, hw, cin), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-8, 8, (cout, k, k, cin), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    border = border_map(w, hw, hw, (1, 1), pads) if k > 1 else None
    return (x, w, w.float().sum((1, 2, 3)), torch.tensor(37.0, device="cuda"),
            torch.rand(cout, generator=g, device="cuda") * 1e-3,
            torch.randn(cout, generator=g, device="cuda"), (1, 1), pads, border)


def main(device=None, shapes=SHAPES, builds=BUILDS, rounds: int = 2) -> List[dict]:
    """Build, check and time every variant (each build at each tile) at
    every shape; returns one result a shape and variant (``ms``: the
    median of 20 CUDA-event-timed calls in each round)."""
    if resolve_device(device).type != "cuda":
        raise RuntimeError("conv_plans times kernel variants: it needs a CUDA card")
    libs = build_variants(builds)
    variants = [(TILES[t], *b) for t in TILES for b in builds]
    tile_of = {n: t for t, n in TILES.items()}

    def run(v, args):
        _build._libs["int8_conv"] = libs[v[1:]]
        return _int8_conv_cuda(*args, torch.bfloat16, tile=tile_of[v[0]])

    own = _build._libs.get("int8_conv")
    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    try:
        for name, *shape in shapes:
            args = conv_inputs(*shape, g)
            ref = int8_conv_plain(*args, torch.bfloat16)
            times: Dict[Variant, list] = {v: [] for v in variants}
            for v in variants:
                if not torch.equal(run(v, args), ref):
                    raise RuntimeError(f"K1 variant {v} differs from the plain version at {name}")
            for _ in range(rounds):
                for v in variants:
                    times[v].append(cuda_ms(lambda: run(v, args)))
            for v in variants:
                results.append({"shape": name, "tile_n": v[0], "kstep": v[1], "stages": v[2],
                                "ms": times[v]})
                print(f"K1 {name} tile 128x{v[0]} step {v[1]} B ring {v[2]}: "
                      + " / ".join(f"{t:.4f}" for t in times[v]) + " ms", flush=True)
            best = min(variants, key=lambda v: max(times[v]))
            print(f"K1 {name}: fastest 128x{best[0]} / {best[1]} B / {best[2]} slots "
                  f"(slower round {max(times[best]):.4f} ms)", flush=True)
            del args, ref
    finally:
        if own is None:
            _build._libs.pop("int8_conv", None)
        else:
            _build._libs["int8_conv"] = own
    return results


if __name__ == "__main__":
    main()
