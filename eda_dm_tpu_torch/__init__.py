"""PyTorch + CUDA port of ``eda_dm_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; each module here mirrors its
counterpart's path and names.  Entry points run on the card unless the
caller passes ``device="cpu"``; on a CUDA tensor every op on the int8
serving path launches its hand-written kernel (``ops/``, ``csrc/``), on a
CPU tensor it runs the kernel's plain PyTorch version.
"""
