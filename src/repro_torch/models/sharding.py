"""Logical-axis sharding for the model zoo (PyTorch mirror of
``repro.models.sharding``), on ``torch.distributed``'s ``DeviceMesh`` and
``DTensor``.

Every tensor dimension is named with a *logical* axis; a rules table maps
logical axes to mesh axes.  The rules, ``logical_pspec`` and the
``*_pspecs`` functions of the model modules are the reference's, entry for
entry.  Baseline rules (single-pod mesh ("data", "model"); the multi-pod
mesh adds a leading "pod" axis folded into the batch/fsdp axes):

  batch      -> (pod,) data      activations' batch dim (DP)
  heads/ff/vocab/expert -> model tensor parallelism / expert parallelism
  fsdp       -> data on *param* dims when cfg.fsdp (ZeRO-3)
  cache_seq  -> data              decode KV/state caches sharded over sequence

The port's own pieces, where JAX has GSPMD:

  ``P``              a PartitionSpec: a tuple with one entry a tensor dim
                     (None, a mesh-axis name, or a tuple of names);
  ``NamedSharding``  a (mesh, spec) pair; ``.placements`` are its DTensor
                     placements;
  ``placements``     a spec on a mesh -> one ``Shard(dim)`` / ``Replicate()``
                     a mesh dim (``Replicate()`` on a mesh dim of size 1).  Several mesh axes on one tensor dim, as in
                     ("pod", "data"), each get ``Shard(dim)``, in mesh order
                     (the first the major one, as in JAX); a spec that lists
                     them out of mesh order raises;
  ``constrain``      redistributes a DTensor to ``logical_pspec(*names)`` on
                     its own mesh (the reference's with_sharding_constraint);
                     a plain tensor passes through unchanged, as the
                     reference is a no-op outside a mesh.  An axis that does
                     not divide its dim is left out (GSPMD would pad);
  ``use_mesh``       makes a mesh current, so that a collective named by a
                     mesh axis (``ring_allreduce_q8(x, "pod")``) finds its
                     group, as ``shard_map`` keeps its axis env.

Where DTensor would turn a sharded tensor into a full replica to run an op
that has no sharding rule, the port runs the block on local shards instead
(``models.moe``'s dispatch).  A block that has to gather what the
reference keeps sharded says so through ``note_gather``; the dry run
records the counts in its ``notes``.  The ones there are:

  ``moe.weights_gathered``  the dispatch's expert weights gathered over an
                            axis that also shards the token groups (the
                            moe_ff-over-data variants in training).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# logical axis -> mesh axis (or tuple of mesh axes, or None)
BASE_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    # decode caches: sharded over data only in cells whose batch cannot use
    # the data axis (long_500k, global_batch=1) — see launch/dryrun.py rules.
    "cache_seq": None,
    "embed": None,
    "embed_fsdp": None,          # switched to ("pod", "data") under ZeRO/FSDP
    "heads": "model",
    "heads_flat": "model",       # flattened (H*hd) projections (rwkv)
    "kv_heads": None,
    "head_dim": None,
    "group": None,
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "moe_ff": None,      # expert FF dim; decode shards it over data (EP^2)
    "capacity": None,
    "layers": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv_k": None,
}

_local = threading.local()
GATHERS: collections.Counter = collections.Counter()


class P(tuple):
    """A PartitionSpec: ``P("data", None, ("pod", "model"))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def mesh_axes(mesh) -> dict:
    """{mesh axis name: size} of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim d names, ``Replicate()`` on the others and on every
    mesh dim of size 1 (which holds the whole tensor either way; DTensor's
    view rules trip on a Shard there)."""
    names = list(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} lists mesh axes out of the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def set_rules(overrides: Optional[dict] = None, *, mesh_axes: tuple = ("data", "model")):
    """Install the active rules table, dropping mesh axes that do not exist
    on the current mesh (e.g. "pod" on the single-pod mesh)."""
    rules = dict(BASE_RULES)
    if overrides:
        rules.update(overrides)
    resolved = {}
    for k, v in rules.items():
        if v is None:
            resolved[k] = None
        elif isinstance(v, tuple):
            kept = tuple(a for a in v if a in mesh_axes)
            resolved[k] = kept if kept else None
        else:
            resolved[k] = v if v in mesh_axes else None
    _local.rules = resolved
    return resolved


def get_rules() -> dict:
    if not hasattr(_local, "rules"):
        set_rules()
    return _local.rules


@contextlib.contextmanager
def rules_override(**over):
    """The active rules with these entries replaced, for the block (the
    entries are mesh axes, as ``set_rules`` resolved them)."""
    saved = get_rules()
    _local.rules = {**saved, **over}
    try:
        yield _local.rules
    finally:
        _local.rules = saved


def logical_pspec(*names: Optional[str]) -> P:
    """PartitionSpec for a tensor whose dims carry these logical names.

    A mesh axis may appear on at most one tensor dim; if two logical names
    resolve to the same mesh axis, the first dim wins and later dims drop it.
    """
    rules = get_rules()
    used: set = set()
    out = []
    for n in names:
        v = rules.get(n) if n is not None else None
        axes = v if isinstance(v, tuple) else (v,) if v is not None else ()
        kept = tuple(a for a in axes if a not in used)
        used.update(kept)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


def even_spec(spec, shape: tuple, mesh) -> P:
    """``spec`` padded with None to ``len(shape)`` dims, without the mesh
    axes that do not evenly divide their dim (an axis of size 1 stays)."""
    sizes = mesh_axes(mesh)
    out = []
    for i, axes in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in _axes(axes):
            n *= sizes[a]
        out.append(axes if n == 1 or shape[i] % n == 0 else None)
    return P(*out)


def to_spec(x: torch.Tensor, spec) -> torch.Tensor:
    """A DTensor redistributed to ``spec`` on its own mesh, without the
    axes the mesh lacks or that do not divide their dim, and its gradient
    held to the same placements on the way back (as JAX's sharding
    constraint holds the cotangent); a plain tensor is returned as it
    is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    have = set(mesh.mesh_dim_names)
    spec = P(*(tuple(a for a in _axes(e) if a in have) or None for e in spec))
    want = placements(even_spec(spec, tuple(x.shape), mesh), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    return resolve_grad(x)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to these logical names' spec on its mesh
    (``to_spec``); a plain tensor is returned as it is."""
    return to_spec(x, logical_pspec(*names))


class _ResolveGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def resolve_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; on the way back a DTensor's gradient is redistributed
    to ``x``'s own placements (a partial sum that a local block left is
    reduced here, before it meets a redistribution that cannot take it)."""
    return _ResolveGrad.apply(x) if isinstance(x, DTensor) else x


def note_gather(name: str, n: int = 1) -> None:
    """Count one gather of what the reference keeps sharded (module
    docstring); ``GATHERS`` holds the counts."""
    GATHERS[name] += n


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current for collectives named by a mesh axis."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def current_mesh():
    """The mesh ``use_mesh`` made current; raises outside one."""
    mesh = getattr(_local, "mesh", None)
    if mesh is None:
        raise RuntimeError("no current mesh: call inside models.sharding.use_mesh(mesh)")
    return mesh


def is_sharded(tree_leaves) -> bool:
    """Whether any of these leaves is a DTensor."""
    return any(isinstance(t, DTensor) for t in tree_leaves)


@contextlib.contextmanager
def sharded_region(sharded: bool):
    """Inside a step whose params are DTensors: plain tensors the model
    makes (positions, masks, RoPE tables, zeros) take part as replicas.
    Does nothing when ``sharded`` is false.  (DTensor's own
    ``implicit_replication`` turns the switch off on leaving, even when an
    outer region had it on; this one puts back what it found.)"""
    if not sharded:
        yield
        return
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev
