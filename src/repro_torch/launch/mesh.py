"""Production mesh construction (PyTorch mirror of ``repro.launch.mesh``).

Single pod: 256 devices as (data=16, model=16).
Multi-pod:  2 pods x 256 devices as (pod=2, data=16, model=16); the pod
axis crosses the data-centre network, data/model stay inside a pod.

A mesh is a ``DeviceMesh`` over the process group that exists: the
``fake`` backend in a dry run (one process stands for rank 0 of the whole
world), ``gloo`` in the CPU tests, ``nccl`` on cards.  Its size must be
the world's: a world that does not match raises, and no mesh is shrunk to
fit.  Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

import math
import os

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _mesh(shape: tuple, axes: tuple, device_type=None):
    if not dist.is_initialized():
        raise RuntimeError("no process group: init_process_group (nccl, gloo or "
                           "fake) before making a mesh")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} {axes} needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of the production mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    # tests shrink the mesh with REPRO_TEST_MESH, e.g. "2x4" (single pod) /
    # "2x2x2" (multi-pod); production always gets 256/512.
    override = os.environ.get("REPRO_TEST_MESH")
    if override:
        dims = tuple(int(x) for x in override.split("x"))
        if multi_pod and len(dims) == 3:
            shape = dims
        elif not multi_pod and len(dims) == 2:
            shape = dims
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    return _mesh(*production_shape(multi_pod), device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), device_type=None):
    """Small mesh for multi-process tests (8 ranks by default)."""
    return _mesh(shape, axes, device_type)
