"""PyTorch port of the serving path, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports ``jax``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.  On a CPU tensor each kernel wrapper runs
its plain PyTorch version; on a CUDA tensor it launches the hand-written
kernel from ``csrc/`` or raises.
"""
