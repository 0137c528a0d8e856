"""Shared set-up of the training-path tests: both packages' smoke configs
and optimizer configs from the same arguments, the reference's jitted
``init_train_state`` / ``train_step``, and the conversions between them
(numpy in between; bfloat16 read through float32, which is exact)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.optim as jopt
import repro.train as jtrain
import repro_torch.configs as tconfigs
import repro_torch.models as tm
import repro_torch.optim as topt
from _torch_sim_helpers import one_thread


def cfgs(name: str = "llama3_8b", **kw):
    """(reference config, port config), smoke width, with ``kw`` replaced."""
    return (jconfigs.get(name, smoke=True).replace(**kw),
            tconfigs.get(name, smoke=True).replace(**kw))


def opt_cfgs(**kw):
    return jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)


def np_(a) -> np.ndarray:
    """A JAX array (or a tensor) as numpy; bfloat16 through float32."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def rel(port, ref) -> float:
    """Largest difference over the reference's largest magnitude."""
    r = np_(ref).astype(np.float64)
    return float(np.abs(np_(port).astype(np.float64) - r).max() / max(np.abs(r).max(), 1e-30))


@functools.cache
def _jit_init(cfgj, ocfgj):
    return jax.jit(lambda k: jtrain.init_train_state(cfgj, ocfgj, k))


@functools.cache
def jax_step(cfgj, ocfgj, **kw):
    """The reference's ``train_step`` jitted once per (config, options)."""
    return jax.jit(functools.partial(jtrain.train_step, cfg=cfgj, opt_cfg=ocfgj, **kw))


def jax_state(cfgj, ocfgj, seed: int = 0):
    return _jit_init(cfgj, ocfgj)(jax.random.PRNGKey(seed))


def carried(state_j, cfgt):
    """The reference's TrainState as the port's, on the CPU."""
    return tm.train_state_from_numpy(jax.tree.map(np.asarray, state_j), cfgt, device="cpu")


def batch(cfg, B: int = 8, S: int = 64, seed: int = 0) -> dict:
    """tokens and labels [B, S] int32 from a numpy generator."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture
def single_thread():
    """Each test at one intra-op thread: the smoke widths' tensors are
    tiny, and the suite runs six workers on the machine's cores."""
    with one_thread():
        yield
