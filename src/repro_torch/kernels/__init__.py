"""Scheduler kernels: hand-written CUDA for Hopper, plain PyTorch on the CPU.

``route_commit`` dispatches on the tensors' device (see invrates.use_kernel);
``ref`` holds the plain versions the tests and ``chip_smoke.py`` compare with.
"""
from .invrates import as_matrix, encode
from .ref import route_commit_ref, route_commit_wseq
from .route_commit import LAUNCHES, reset_launch_counts, route_commit

__all__ = ["LAUNCHES", "as_matrix", "encode", "reset_launch_counts",
           "route_commit", "route_commit_ref", "route_commit_wseq"]
