"""Model zoo: every architecture family of ``configs`` in PyTorch (mirror
of ``repro.models``): the train / prefill forward and the decode path.

``params_from_numpy`` turns the reference's parameter pytree, as numpy
arrays, into the port's nested dict of tensors with the same keys, and
``train_state_from_numpy`` its whole ``TrainState``, so both packages can
run on the same weights and optimizer state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.simulator import resolve_device
from .layers import chunked_softmax_xent, dtype_of, flash_attention, logits_fn
from .sharding import constrain, get_rules, logical_pspec, set_rules
from .transformer import (Cache, cache_pspecs, decode_step, forward, init_cache, init_params,
                          param_pspecs)


def _from_numpy(a, dtype, dev) -> torch.Tensor:
    """One numpy leaf as a tensor on ``dev``: integer leaves keep their
    dtype; float leaves become ``dtype`` (by default float32, or float64 for
    a float64 leaf).  A bfloat16 leaf from ``ml_dtypes`` is read through
    float32, which is exact, so this module needs no ``ml_dtypes``."""
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.from_numpy(a.copy()).to(dev)
    if a.dtype.kind != "f" and a.dtype.name != "bfloat16":
        raise TypeError(f"unsupported leaf dtype {a.dtype}")
    own = torch.float64 if a.dtype == np.float64 else torch.float32
    t = torch.from_numpy(a.astype(np.float64 if own == torch.float64
                                  else np.float32))
    return t.to(device=dev, dtype=dtype or own)


# leaves the reference keeps in float32 whatever the model's dtype: the
# MoE router, mamba2's A_log / D / dt_bias, rwkv6's w0 / u / ln_scale
FLOAT32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias", "w0", "u", "ln_scale"})


def params_from_numpy(tree, *, dtype=None, device=None) -> dict:
    """A nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (the card unless named); float leaves become ``dtype`` (a
    torch dtype such as ``layers.dtype_of(cfg)``; by default float32, or
    float64 for a float64 leaf), except the leaves named in
    ``FLOAT32_LEAVES``, which stay float32 as in the reference.  Integer
    leaves keep their dtype."""
    dev = resolve_device(device)

    def walk(x, name=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        keep = dtype is not None and name in FLOAT32_LEAVES
        return _from_numpy(x, torch.float32 if keep else dtype, dev)

    return walk(tree)


def train_state_from_numpy(state_tree, cfg, *, device=None):
    """The reference's ``TrainState`` with numpy leaves (as
    ``jax.tree.map(np.asarray, state)`` gives it: params, an ``OptState``
    whose moments are arrays or ``QTensor``s, and the step) -> the port's
    ``TrainState`` on ``device`` (the card unless named).  Params become
    ``dtype_of(cfg)`` (``FLOAT32_LEAVES`` stay float32); moments keep
    their dtype (float32, bfloat16, or a QTensor's int8 codes and float32
    scales), the step int32."""
    from ..optim.adamw import OptState, QTensor
    from ..train.train_step import TrainState

    dev = resolve_device(device)
    opt = state_tree.opt

    def moment(x):
        if isinstance(x, dict):
            return {k: moment(v) for k, v in x.items()}
        if hasattr(x, "q"):
            return QTensor(q=_from_numpy(x.q, None, dev),
                           scale=_from_numpy(x.scale, None, dev),
                           offset=_from_numpy(x.offset, None, dev), log=bool(x.log))
        bf16 = np.asarray(x).dtype.name == "bfloat16"
        return _from_numpy(x, torch.bfloat16 if bf16 else None, dev)

    return TrainState(
        params=params_from_numpy(state_tree.params, dtype=dtype_of(cfg), device=dev),
        opt=OptState(step=_from_numpy(opt.step, None, dev).to(torch.int32),
                     m=moment(opt.m), v=moment(opt.v)))


__all__ = ["FLOAT32_LEAVES", "Cache", "cache_pspecs", "chunked_softmax_xent", "constrain",
           "decode_step", "flash_attention", "forward", "get_rules", "init_cache",
           "init_params", "logical_pspec", "logits_fn", "param_pspecs",
           "params_from_numpy", "set_rules", "train_state_from_numpy"]
