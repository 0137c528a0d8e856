"""PyTorch / CUDA port of the ``repro`` scheduler simulator.

Mirrors the JAX package's layout and public names.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``; the hot routing path
is the hand-written CUDA kernel ``kernels.route_commit``.  This package
imports torch, numpy and the standard library only.
"""
