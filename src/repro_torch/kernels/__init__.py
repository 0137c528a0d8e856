"""Scheduler kernels: hand-written CUDA for Hopper, plain PyTorch on the CPU.

Every wrapper dispatches on its tensors' device (``invrates.use_kernel``);
``ref`` holds the plain versions that the tests and ``chip_smoke.py``
compare the kernels with, and ``LAUNCHES`` counts each kernel's launches
(``MATRIX_LAUNCHES``: route_commit's at the per-server [M, 3] operand).

``route_commit`` (full and pod) routes and commits one arrival batch in
sequence, or one batch in each of N cells in one launch (one CTA a cell):
it is the simulator's batched path.  The three snapshot kernels
(``weighted_argmin``, ``pod_route``, ``queue_update``) route a whole batch
against one workload snapshot and then commit it: they serve the paper's
complexity path, O(M) against O(d) work per decision (``chip_smoke.py``
phase 4), and the snapshot routing tick, not the simulator.
"""
from .invrates import (LAUNCHES, MATRIX_LAUNCHES, as_matrix, encode,
                       reset_launch_counts)
from .pod_route import pod_route
from .queue_update import queue_update
from .ref import (pod_route_ref, queue_update_ref, route_commit_ref,
                  route_commit_wseq, weighted_argmin_ref)
from .route_commit import route_commit
from .weighted_argmin import weighted_argmin

__all__ = ["LAUNCHES", "MATRIX_LAUNCHES", "as_matrix", "encode", "pod_route", "pod_route_ref",
           "queue_update", "queue_update_ref", "reset_launch_counts",
           "route_commit", "route_commit_ref", "route_commit_wseq",
           "weighted_argmin", "weighted_argmin_ref"]
