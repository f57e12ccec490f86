"""The plain reference of the benchmark: the W4A8 serving arithmetic of the
benchmark's models written out in plain PyTorch (float32, TF32 off), with
no kernel, cache or batching of the program and nothing imported from it.

The modules mirror the program's parameter names (a state dict made by
``lib/weights.py`` loads into both sides), and recompute for themselves
what the program's set-up derives from those weights: the stand-in quant
state (per-channel symmetric weight ranges rounded to nearest, activation
ranges from one float forward) and the weights' W4/W8 values.

``Ctx.carrier`` rounds every layer's output to a lower-precision carrier:
``None`` is the reference; ``float8_e4m3fn`` is the control, the nearest
precision below the bf16 carrier that the configurations state.
"""
