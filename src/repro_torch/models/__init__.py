"""Model zoo, decode path: the ``dense`` family in PyTorch (mirror of the
decode subset of ``repro.models``).

``params_from_numpy`` turns the reference's parameter pytree, as numpy
arrays, into the port's nested dict of tensors with the same keys, so both
packages can run on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.simulator import resolve_device
from .layers import logits_fn
from .transformer import Cache, decode_step, init_cache, init_params


def params_from_numpy(tree, *, dtype=None, device=None) -> dict:
    """A nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (the card unless named).

    Float leaves become ``dtype`` (a torch dtype such as
    ``layers.dtype_of(cfg)``; by default float32, or float64 for a float64
    leaf).
    A bfloat16 leaf from ``ml_dtypes`` is read through float32, which is
    exact, so this module needs no ``ml_dtypes``.  Integer leaves keep
    their dtype."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.kind in "iub":
            return torch.from_numpy(a.copy()).to(dev)
        if a.dtype.kind != "f" and a.dtype.name != "bfloat16":
            raise TypeError(f"unsupported leaf dtype {a.dtype}")
        own = torch.float64 if a.dtype == np.float64 else torch.float32
        t = torch.from_numpy(a.astype(np.float64 if own == torch.float64
                                      else np.float32))
        return t.to(device=dev, dtype=dtype or own)

    def walk(x):
        return {k: walk(v) for k, v in x.items()} if isinstance(x, dict) else leaf(x)

    return walk(tree)


__all__ = ["Cache", "decode_step", "init_cache", "init_params", "logits_fn",
           "params_from_numpy"]
