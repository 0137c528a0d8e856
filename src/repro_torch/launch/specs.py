"""Abstract input stand-ins + shardings for every dry-run cell (PyTorch
mirror of ``repro.launch.specs``).

Where the reference builds ``ShapeDtypeStruct``s with shardings, the port
builds DTensors whose local shards are FakeTensors (made under
``FakeTensorMode``): the right global shapes, dtypes and placements, and
no storage.  ``shard_tree`` places real tensors the same way.  Modality
frontends are stubs, as in the reference: vlm cells get precomputed patch
embeddings, encdec cells get precomputed frame embeddings.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor

from .. import pytree
from ..configs.base import ArchConfig, ShapeSpec
from ..models import cache_pspecs, init_cache, init_params, param_pspecs
from ..models.sharding import P, even_spec, logical_pspec, mesh_axes, placements, set_rules
from ..optim.adamw import AdamWConfig, opt_pspecs
from ..train.train_step import TrainState, init_train_state


def rules_for(cfg: ArchConfig, shape: ShapeSpec, mesh, extra=None) -> dict:
    """Per-cell logical-rule overrides (the baseline sharding plan; the
    dry run's --variant passes ``extra``)."""
    over = {}
    if cfg.fsdp:
        over["embed_fsdp"] = ("data",)          # ZeRO-3 params+opt over data
    if shape.kind == "decode":
        if shape.global_batch == 1:
            over["batch"] = None                 # cannot shard batch=1
            over["cache_seq"] = ("data", "model")
        else:
            over["cache_seq"] = "model"          # KV sharded over seq x model
    if extra:
        over.update(extra)
    return set_rules(over, mesh_axes=tuple(mesh.mesh_dim_names))


def opt_config_for(cfg: ArchConfig) -> AdamWConfig:
    # trillion-param archs: int8 moments are required to fit
    return AdamWConfig(moment_dtype="int8" if cfg.fsdp else "float32")


def _axis_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    if axes is None:
        return 1
    if isinstance(axes, tuple):
        n = 1
        for a in axes:
            n *= sizes[a]
        return n
    return sizes[axes]


def sanitize_spec(spec: P, shape: tuple, mesh) -> P:
    """Drop mesh axes that do not evenly divide their dim (replication is
    the safe fallback; archs that hit this in a hot tensor get a per-arch
    rule instead, see rules_for)."""
    return even_spec(spec, shape, mesh)


def _is_p(x) -> bool:
    return isinstance(x, P)


def shard_tree(tree, spec_tree, mesh):
    """``tree``'s tensors as DTensors on ``mesh``, each at its spec
    (``spec_tree`` of the same structure, ``P`` leaves) after
    ``sanitize_spec``."""
    leaves, unflatten = pytree.flatten(tree)
    specs = pytree.leaves(spec_tree, is_leaf=_is_p)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    return unflatten([
        distribute_tensor(t, mesh, placements(sanitize_spec(s, tuple(t.shape), mesh), mesh))
        for t, s in zip(leaves, specs)])


def _fake(fn):
    """``fn()`` under FakeTensorMode: its tensors have shapes and dtypes
    and no storage."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        return fn()


def abstract_train_state(cfg: ArchConfig, mesh) -> tuple:
    """(TrainState of fake DTensors, TrainState of PartitionSpecs)."""
    ocfg = opt_config_for(cfg)
    pspecs = TrainState(params=param_pspecs(cfg),
                        opt=opt_pspecs(param_pspecs(cfg), ocfg))
    state = _fake(lambda: shard_tree(init_train_state(cfg, ocfg, 0, device="cpu"),
                                     pspecs, mesh))
    return state, pspecs


def abstract_params(cfg: ArchConfig, mesh):
    pspecs = param_pspecs(cfg)
    return _fake(lambda: shard_tree(init_params(cfg, 0, device="cpu"), pspecs, mesh)), pspecs


def _input(shape: tuple, dtype, spec, mesh):
    return _fake(lambda: shard_tree(torch.zeros(shape, dtype=dtype), spec, mesh))


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
                with_labels: bool) -> dict:
    B, S = shape.global_batch, shape.seq_len
    bsp = logical_pspec("batch", None)
    esp = logical_pspec("batch", None, None)
    S_txt = S - cfg.n_img_tokens if cfg.family == "vlm" else S
    batch = {"tokens": _input((B, S_txt), torch.int32, bsp, mesh)}
    if with_labels:
        batch["labels"] = _input((B, S_txt), torch.int32, bsp, mesh)
    if cfg.family == "vlm":
        batch["img_embeds"] = _input((B, cfg.n_img_tokens, cfg.d_model), torch.bfloat16,
                                     esp, mesh)
    if cfg.family == "encdec":
        batch["enc_embeds"] = _input((B, S, cfg.d_model), torch.bfloat16, esp, mesh)
    return batch


def abstract_cache(cfg: ArchConfig, shape: ShapeSpec, mesh):
    pspecs = cache_pspecs(cfg)
    cache = _fake(lambda: shard_tree(
        init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu"), pspecs, mesh))
    return cache, pspecs


def decode_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh):
    B = shape.global_batch
    tokens = _input((B, 1), torch.int32, logical_pspec("batch", None), mesh)
    pos = _input((B,), torch.int32, logical_pspec("batch"), mesh)
    return tokens, pos
