"""What each rank runs in the port's multi-rank tests (``_torch_dist``):
one function a case, ``case(rank, world, tmp, **kw)``, returning
picklable results (numpy arrays, numbers, strings)."""
from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def _batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
            for k in ("tokens", "labels")}


def sharded_train_step(rank, world, tmp, *, arch, mesh_shape, B=4, S=16,
                       microbatches=1, fsdp=False, moments="float32"):
    """One train_step of the smoke config in float32 (``fsdp``: ZeRO-3
    over the data axis, as ``launch.specs.rules_for`` sets it), unsharded
    on every rank and sharded on a ("data", "model") mesh from the same
    state, with ``dispatch_groups`` the data axis' size.  Returns both
    steps' metrics, every leaf of both new states (full tensors, by path),
    the sharded params' placements and whether every leaf of the sharded
    state kept its placements."""
    from repro_torch import pytree
    from repro_torch.configs import get
    from repro_torch.launch import specs as S_
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import param_pspecs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.sharding import logical_pspec
    from repro_torch.optim import AdamWConfig, opt_pspecs
    from repro_torch.train import TrainState, init_train_state, train_step

    cfg = get(arch, smoke=True).replace(dtype="float32", fsdp=fsdp)
    mesh = make_test_mesh(mesh_shape, ("data", "model"))
    S_.rules_for(cfg, ShapeSpec("step", S, B, "train"), mesh)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, moment_dtype=moments)
    state = init_train_state(cfg, ocfg, 0, device="cpu")
    batch = _batch(cfg, B, S)
    kw = dict(cfg=cfg, opt_cfg=ocfg, dispatch_groups=mesh_shape[0],
              microbatches=microbatches)
    plain, m_plain = train_step(state, batch, **kw)

    specs = TrainState(params=param_pspecs(cfg), opt=opt_pspecs(param_pspecs(cfg), ocfg))
    sharded = S_.shard_tree(state, specs, mesh)
    sbatch = S_.shard_tree(batch, {k: logical_pspec("batch", None) for k in batch}, mesh)
    new, m = train_step(sharded, sbatch, param_specs=param_pspecs(cfg), **kw)

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().to(F32).numpy()

    kept = all(tuple(a.placements) == tuple(b.placements)
               for a, b in zip(pytree.leaves(new), pytree.leaves(sharded)))
    paths, leaves, _ = pytree.flatten_with_paths(new)
    return {"kept": kept, "metrics": {k: (float(full(m[k])), float(m_plain[k]))
                        for k in ("loss", "grad_norm", "lb_loss", "z_loss")},
            "sharded": {p: full(t) for p, t in zip(paths, leaves)},
            "plain": {p: full(t) for p, t in zip(paths, pytree.leaves(plain))},
            "placements": {p: str(t.placements) for p, t in
                           zip(*pytree.flatten_with_paths(new.params)[:2])},
            "lr": ocfg.lr, "b1": ocfg.b1}


def ring(rank, world, tmp, *, x_path):
    """``ring_allreduce_q8`` of row ``rank`` of the array at ``x_path`` over
    a ("pod",) mesh of every rank; (the sum, the dtypes and sizes of
    every tensor this rank sent)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import use_mesh
    from repro_torch.train import ring_allreduce_q8

    x = torch.from_numpy(np.load(x_path)[rank])
    sent = []
    real = dist.batch_isend_irecv

    def spy(ops):
        sent.extend((str(op.tensor.dtype), op.tensor.numel()) for op in ops
                    if op.op is dist.isend)
        return real(ops)

    dist.batch_isend_irecv = spy
    try:
        mesh = make_test_mesh((world,), ("pod",))
        with use_mesh(mesh):
            got = ring_allreduce_q8(x, "pod")
    finally:
        dist.batch_isend_irecv = real
    return got.numpy(), sent


def pipeline(rank, world, tmp, *, inputs_path, n_micro):
    """``pipeline_forward`` of the saved layer stack over a ("pod",) mesh
    of every rank, and the sequential loop over the same layers."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import pipeline_forward

    d = np.load(inputs_path)
    W, b, x = (torch.from_numpy(d[k]) for k in ("W", "b", "x"))

    def layer(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = make_test_mesh((world,), ("pod",))
    out = pipeline_forward(layer, {"w": W, "b": b}, x, mesh=mesh, n_micro=n_micro)
    ref = x
    for i in range(W.shape[0]):
        ref = layer({"w": W[i], "b": b[i]}, ref)
    return out.numpy(), ref.numpy()


def elastic_save(rank, world, tmp, *, ckpt):
    """Save {"w": [8, 8], "b": [8]} sharded on a (1, 4) mesh."""
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.specs import shard_tree
    from repro_torch.models.sharding import P

    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(8)}
    mesh = make_test_mesh((1, 4), ("data", "model"))
    placed = shard_tree(tree, {"w": P(None, "model"), "b": P("model")}, mesh)
    assert placed["w"].to_local().shape == (8, 2)
    ckpt_mod.save(ckpt, 1, placed)
    return True


def elastic_restore(rank, world, tmp, *, ckpt):
    """Restore that checkpoint onto a (4, 2) mesh; (the full tensors, the
    placements, the local shapes)."""
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import NamedSharding, P

    mesh = make_test_mesh((4, 2), ("data", "model"))
    target = {"w": torch.zeros(8, 8), "b": torch.zeros(8)}
    sh = {"w": NamedSharding(mesh, P("data", "model")), "b": NamedSharding(mesh, P(None))}
    got, manifest = ckpt_mod.restore(ckpt, 1, target, shardings=sh)
    return ({k: v.full_tensor().numpy() for k, v in got.items()},
            {k: (str(v.placements), str(sh[k].placements)) for k, v in got.items()},
            {k: tuple(v.to_local().shape) for k, v in got.items()}, manifest["step"])


def mesh_mismatch(rank, world, tmp):
    """A mesh whose size is not the world's raises."""
    from repro_torch.launch.mesh import make_test_mesh
    try:
        make_test_mesh((2, 4), ("data", "model"))
    except ValueError as e:
        return str(e)
    return None


def ring_axis_one(rank, world, tmp):
    """``ring_allreduce_q8`` over an axis of one rank returns its input."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import use_mesh
    from repro_torch.train import ring_allreduce_q8

    x = torch.randn(5, 3)
    with use_mesh(make_test_mesh((1, 1), ("pod", "data"))):
        return ring_allreduce_q8(x, "pod") is x
