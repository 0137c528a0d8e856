"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on rank
0 of the production mesh and record its roofline inputs (PyTorch mirror
of ``repro.launch.dryrun``).

Where the reference lowers and compiles the step for 256 / 512 fake XLA
devices, the port joins a ``fake`` process group of that world size as
rank 0 (the counterpart of ``--xla_force_host_platform_device_count``)
and runs rank 0's step once over DTensors whose shards are FakeTensors:
no storage, no compute, no traffic.  For each cell this writes
artifacts/dryrun/<arch>__<shape>__<mesh>.json with:

  memory       rank 0's argument and output bytes (its local shards), and
               the peak and temporary bytes that ``MemTracker`` follows
               through the step (temp = peak - arguments)
  cost         the step's FLOPs from ``torch.utils.flop_counter``'s rules,
               counted on the LOCAL shards' shapes (per device)
  collectives  every collective rank 0 issues, with its result bytes and
               group size, summed with ``roofline.hlo._wire_bytes`` under
               ``hlo.collective_summary``'s keys; the trace is unrolled, so
               ``unknown_trip_conditions`` is 0
  model_flops  6*N_active*D (train) / 2*N_active*D (inference)
  analytic     ``roofline.analytic.cell_cost``
  notes        the gathers the port makes where the reference keeps a
               tensor sharded (``models.sharding.GATHERS``), and the depth
               the step was traced at
  timings      build and trace seconds

The step is traced at one and at two layers (hybrid: groups; encdec: both
stacks) and every traced quantity is taken to full depth as x1 + (L - 1) x
(x2 - x1): the layers are identical, so FLOPs and collectives are exact,
and the peak, which grows by one layer's residents a layer, follows the
same line.  This is the reference's trip-count weighting of its layer
scan's while body.  Argument and output bytes come from the full-depth
inputs and outputs' shapes.

XLA-only pieces have no counterpart: the fields ``cost_xla_flat``,
``collectives_flat`` and ``hlo_lines``, the ``--save-hlo`` flag, and
``parse_collective_bytes`` (a parser of compiled HLO text, which the port
never makes; ``roofline.hlo`` keeps the walk).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both     # every runnable cell
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from .. import pytree
from ..configs.base import SHAPES, ArchConfig, ShapeSpec, all_cells, get, shape_applicable
from ..models import decode_step, forward, logits_fn
from ..models.sharding import GATHERS, sharded_region, use_mesh
from ..roofline import analytic
from ..roofline import hlo as hlo_walk
from ..train.train_step import train_step
from . import specs as S
from .mesh import make_production_mesh, production_shape

def count_params(cfg: ArchConfig) -> dict:
    total = analytic._param_count(cfg)       # init_params under FakeTensorMode
    routed = 0
    if cfg.n_experts:
        per_layer = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff
        routed = per_layer * cfg.n_layers
    active = total - routed
    if cfg.n_experts:
        active += routed * cfg.experts_per_token // cfg.n_experts
    return {"total": int(total), "active": int(active)}


def model_flops(cfg: ArchConfig, shape: ShapeSpec, n_active: int) -> float:
    """Matmul-only convention: 6*N*D train, 2*N*D inference forward,
    2*N*B decode (one token per sequence)."""
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def _n_data(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return math.prod(sizes.get(ax, 1) for ax in ("pod", "data"))


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last (vocab) dim, the first index among equal
    maxima.  Vocab-sharded DTensor logits reduce each shard's (max, first
    index) pair over the vocab axes (an all-reduce of the max, then of the
    least index that reaches it) instead of gathering the logits."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1)
    mesh, pl = logits.device_mesh, logits.placements
    vdim = logits.ndim - 1
    vocab = [isinstance(p, Shard) and p.dim == vdim for p in pl]
    if not any(vocab):
        return torch.argmax(logits, dim=-1)
    local = logits.to_local()
    m, i = local.max(dim=-1)
    sizes, coord, shard = tuple(mesh.shape), mesh.get_coordinate(), 0
    for a, v in enumerate(vocab):
        if v:
            shard = shard * sizes[a] + coord[a]
    i = i + shard * local.shape[-1]

    def reduce(t, op):
        red = DTensor.from_local(t, mesh, tuple(Partial(op) if v else p
                                                for v, p in zip(vocab, pl)), run_check=False)
        return red.redistribute(mesh, tuple(Replicate() if v else p for v, p in zip(vocab, pl)))

    top = reduce(m, "max").to_local()
    return reduce(torch.where(m == top, i, logits.shape[-1]), "min")


def build_step(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """Returns (step function, abstract args tuple): DTensors over fake
    tensors at the cell's shardings (``launch.specs``)."""
    if shape.kind == "train":
        state, _ = S.abstract_train_state(cfg, mesh)
        batch = S.batch_specs(cfg, shape, mesh, with_labels=True)
        from ..models import param_pspecs
        fn = functools.partial(train_step, cfg=cfg, opt_cfg=S.opt_config_for(cfg),
                               dispatch_groups=_n_data(mesh),
                               microbatches=cfg.train_microbatches,
                               param_specs=param_pspecs(cfg))
        return fn, (state, batch)

    params, _ = S.abstract_params(cfg, mesh)
    if shape.kind == "prefill":
        batch = S.batch_specs(cfg, shape, mesh, with_labels=False)

        def prefill(params, batch):
            h, _ = forward(params, cfg, batch)
            with sharded_region(True):
                logits = logits_fn(params["embed"], h[:, -1:])
                return greedy(logits).to(torch.int32)

        return prefill, (params, batch)

    cache, _ = S.abstract_cache(cfg, shape, mesh)
    tokens, pos = S.decode_inputs(cfg, shape, mesh)

    def serve(params, cache, tokens, pos):
        # dispatch_groups=1 at decode: sharding the handful of decode tokens
        # over data would re-claim the axis expert-FF shards need.
        h, cache = decode_step(params, cfg, cache, tokens, pos, dispatch_groups=1)
        with sharded_region(True):
            logits = logits_fn(params["embed"], h)
            return greedy(logits).to(torch.int32), cache

    return serve, (params, cache, tokens, pos)


# --- hillclimb variants: named (rule overrides, config replaces) -----------
VARIANTS: dict = {
    "baseline": ({}, {}),
    # dense-TP cells: drop tensor parallelism, ZeRO-3 everything over BOTH
    # axes; fewer microbatches cut the per-step param re-gather count.
    "fsdp_pure": ({"embed_fsdp": ("data", "model"), "ff": None,
                   "heads": None, "vocab": None, "expert": None},
                  {"fsdp": True, "train_microbatches": 2}),
    "fsdp_mb1": ({"embed_fsdp": ("data", "model"), "ff": None,
                  "heads": None, "vocab": None, "expert": None},
                 {"fsdp": True, "train_microbatches": 1}),
    # MoE train: keep EP over model, shard expert-FF over data (EP^2) so
    # routed weights never re-gather; dense params stay ZeRO over data.
    "moe_ep2": ({"moe_ff": "data"}, {"train_microbatches": 2}),
    "moe_ep2_mb1": ({"moe_ff": "data"}, {"train_microbatches": 1}),
    # decode: no ZeRO re-gather at inference — experts sharded E x F.
    "decode_ep2": ({"embed_fsdp": None, "moe_ff": "data"}, {"fsdp": False}),
    # capacity-factor ablation (compute waste vs drop rate)
    "cf10": ({}, {"capacity_factor": 1.0}),
}

# the functional collectives -> the reference's HLO names
_COLLECTIVE_OPS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "all_to_all_single": "all-to-all"}


class StepCounter(TorchDispatchMode):
    """Counts what the ops on plain (local) tensors do: FLOPs by
    ``torch.utils.flop_counter``'s rules, and each functional collective's
    result bytes and group size.  An op on DTensors is handed back to
    DTensor (``NotImplemented``), which runs it as local ops and
    collectives that come back here, as ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.collectives = []             # (hlo name, result bytes, group size)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        name = _COLLECTIVE_OPS.get(packet.__name__) \
            if getattr(func, "namespace", "") == "_c10d_functional" else None
        if name is not None:
            group = args[-1]
            g = dist.get_world_size(dist.distributed_c10d._resolve_process_group(group))
            self.collectives.append((name, out.numel() * out.element_size(), g))
        return out

    def summary(self) -> dict:
        """``hlo.collective_summary``'s keys over what was recorded."""
        wire = {k: 0.0 for k in hlo_walk.COLLECTIVES}
        result = {k: 0.0 for k in hlo_walk.COLLECTIVES}
        counts = {k: 0.0 for k in hlo_walk.COLLECTIVES}
        for base, R, g in self.collectives:
            wire[base] += hlo_walk._wire_bytes(base, R, g)
            result[base] += R
            counts[base] += 1
        return {"wire_bytes": wire, "result_bytes": result, "counts": counts,
                "total_wire_bytes": sum(wire.values()), "unknown_trip_conditions": 0}


def local_bytes(tree) -> int:
    """Bytes of a tree's tensors as this rank holds them (a DTensor's local
    shard)."""
    n = 0
    for t in pytree.leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def fake_world(n: int) -> None:
    """Join a ``fake`` process group of ``n`` ranks as rank 0 (replacing a
    fake group of another size); raises if a real group is up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is up: the dry run "
                               f"needs its own fake world")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


@contextlib.contextmanager
def _unseen_propagation():
    """DTensor works out an op's output shape by running the op once on
    global-shape fake tensors, the first time it meets the op's schema.
    Those runs are not the step: here they run outside every dispatch mode
    (in a fake mode of their own), so no counter sees them."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    orig = getattr(ShardingPropagator, name)

    def unseen(self, *a, **kw):
        with _disable_current_modes():
            return orig(self, *a, **kw)

    setattr(ShardingPropagator, name, unseen)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def trace_step(fn, args) -> dict:
    """Run ``fn(*args)`` once over fake DTensors under ``MemTracker`` and a
    ``StepCounter``; the record's memory, cost and collectives."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed._tools.mem_tracker import MemTracker

    local = [t.to_local() if isinstance(t, DTensor) else t for t in pytree.leaves(args)]
    mode = next(t.fake_mode for t in local if isinstance(t, FakeTensor))
    arg_bytes = local_bytes(args)
    tracker, counter = MemTracker(), StepCounter()
    tracker.track_external(*[t for t in local if isinstance(t, torch.Tensor)])
    with _unseen_propagation(), mode, tracker, counter:
        out = fn(*args)
    peak = sum(d.get("Total", 0) for d in tracker.get_tracker_snapshot("peak").values())
    peak = max(int(peak), arg_bytes)
    return {"memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": local_bytes(out),
                       "temp_size_in_bytes": peak - arg_bytes,
                       "peak_memory_in_bytes": peak},
            "cost": {"flops": float(counter.flops)},
            "collectives": counter.summary()}


def _depth(cfg: ArchConfig) -> tuple:
    """(layers a depth unit, depth in units) of the config's stacks."""
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    return unit, cfg.n_layers // unit


def _at_depth(cfg: ArchConfig, k: int) -> ArchConfig:
    unit, depth = _depth(cfg)
    over = {"n_layers": k * unit}
    if cfg.family == "encdec":
        over["n_enc_layers"] = k * cfg.n_enc_layers // depth
    return cfg.replace(**over)


def _extrapolate(a, b, depth: int):
    """a + (depth - 1) * (b - a), leaf for leaf over dicts of numbers."""
    if isinstance(a, dict):
        return {k: _extrapolate(a[k], b[k], depth) for k in a}
    return a + (depth - 1) * (b - a)


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    """The record's memory, cost and collectives of the cell's step at
    full depth, from traces at one and two layers (module docstring)."""
    unit, depth = _depth(cfg)
    if cfg.family == "encdec" and cfg.n_enc_layers % depth:
        raise ValueError(f"{cfg.name}: encoder depth {cfg.n_enc_layers} is not a "
                         f"multiple of {depth}")
    one, two = (trace_step(*build_step(_at_depth(cfg, k), shape, mesh)) for k in (1, 2))
    out = _extrapolate(one, two, depth)
    out["collectives"]["unknown_trip_conditions"] = 0
    mem = out["memory"]
    mem["argument_size_in_bytes"] = local_bytes(build_step(cfg, shape, mesh)[1])
    mem["temp_size_in_bytes"] = mem["peak_memory_in_bytes"] - mem["argument_size_in_bytes"]
    out["depth"] = {"traced_units": [1, 2], "unit_layers": unit, "units": depth}
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             save_hlo: bool = False, variant: str = "baseline") -> dict:
    if save_hlo:
        raise ValueError("the port makes no HLO (save_hlo is XLA's)")
    cfg = get(arch)
    rule_over, cfg_over = VARIANTS[variant]
    if cfg_over:
        cfg = cfg.replace(**cfg_over)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    tag = "" if variant == "baseline" else f"@{variant}"
    rec = {"arch": arch + tag, "shape": shape_name, "mesh": mesh_kind,
           "family": cfg.family, "variant": variant}
    if not ok:
        rec["skipped"] = reason
        _write(out_dir, rec)
        return rec

    multi_pod = mesh_kind == "multipod"
    fake_world(math.prod(production_shape(multi_pod)[0]))
    mesh = make_production_mesh(multi_pod=multi_pod)
    S.rules_for(cfg, shape, mesh, extra=rule_over)
    params = count_params(cfg)
    rec["params"] = params
    rec["model_flops"] = model_flops(cfg, shape, params["active"])
    rec["n_devices"] = mesh.size()
    cc = analytic.cell_cost(cfg, shape)
    rec["analytic"] = {"flops_computed": cc.flops_computed,
                       "flops_useful": cc.flops_useful,
                       "hbm_bytes": cc.hbm_bytes,
                       "params_bytes": cc.params_bytes}

    GATHERS.clear()
    with use_mesh(mesh):
        t0 = time.time()
        traced = trace_cell(cfg, shape, mesh)
        t1 = time.time()
    rec["memory"] = traced["memory"]
    rec["cost"] = traced["cost"]
    rec["collectives"] = traced["collectives"]
    rec["notes"] = {"flops": "per device: the local shards' shapes",
                    "gathers": dict(GATHERS), "depth": traced["depth"]}
    rec["timings"] = {"trace_s": t1 - t0}
    _write(out_dir, rec)
    return rec


def _write(out_dir: str, rec: dict):
    os.makedirs(out_dir, exist_ok=True)
    name = rec['arch'].replace('@', '_AT_')
    path = f"{out_dir}/{name}__{rec['shape']}__{rec['mesh']}.json"
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] wrote {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    args = ap.parse_args()

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        for cfg, shape, ok, _ in all_cells():
            for mk in meshes:
                name = cfg.name.replace("-", "_").replace(".", "_")
                run_cell(name, shape.name, mk, args.out)
    else:
        for mk in meshes:
            rec = run_cell(args.arch, args.shape, mk, args.out, variant=args.variant)
            if "skipped" in rec:
                print(f"[dryrun] SKIP {args.arch} x {args.shape}: {rec['skipped']}")
            else:
                print(json.dumps({k: rec[k] for k in ("memory", "cost", "timings")},
                                 indent=1))
                print("collective wire bytes/device:",
                      rec["collectives"]["total_wire_bytes"])


if __name__ == "__main__":
    main()
