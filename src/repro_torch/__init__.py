"""PyTorch + CUDA port of the DTO-EE collaborative serving system.

The JAX package ``repro`` is the reference; this package mirrors its layout
and module names.  It imports neither ``jax`` nor ``repro``.
"""
