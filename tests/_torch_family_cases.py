"""Shared set-up of the model-family tests: both packages' smoke configs,
parameters drawn with numpy in the shapes and dtypes of the reference's
``init_params`` (``jax.eval_shape``: nothing of the reference's init is
compiled), the batches each family reads, and populated caches.

Every leaf is random, the constant ones too (norm scales, mamba2's A_log /
D / dt_bias, rwkv6's w0 / u), so that each term of a layer counts."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
import repro.models as jm
import repro_torch.configs as tconfigs
import repro_torch.models as tm
from repro_torch.models import layers as tl

# one architecture a family beside the dense one, and kimi-k2's MoE
FAMILY_ARCHS = {"moe": "deepseek_moe_16b", "vlm": "internvl2_2b",
                "encdec": "whisper_large_v3", "hybrid": "zamba2_2_7b",
                "ssm": "rwkv6_7b"}


def cfgs(name: str, **kw):
    """(reference config, port config), smoke width, with ``kw`` replaced."""
    return (jconfigs.get(name, smoke=True).replace(**kw),
            tconfigs.get(name, smoke=True).replace(**kw))


def np_(a) -> np.ndarray:
    """A JAX array or a tensor as numpy; bfloat16 through float32."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def rel(port, ref) -> float:
    """Largest difference over the reference's largest magnitude."""
    r = np_(ref).astype(np.float64)
    return float(np.abs(np_(port).astype(np.float64) - r).max() / max(np.abs(r).max(), 1e-30))


def ref_shapes(cfgj):
    """The reference's params tree of ShapeDtypeStructs."""
    return jax.eval_shape(lambda k: jm.init_params(cfgj, k), jax.random.PRNGKey(0))


def _draw(name: str, shape, d: int, rng) -> np.ndarray:
    n = lambda: rng.standard_normal(shape)
    if name in ("scale", "ln_scale", "D"):
        x = rng.uniform(0.5, 1.5, shape)
    elif name.startswith("mu_") or name.startswith("cm_mu_"):
        x = rng.uniform(0.0, 1.0, shape)
    else:
        x = {"tok": lambda: n(), "router": lambda: 0.3 * n(), "A_log": lambda: 0.5 * n(),
             "dt_bias": lambda: -1.5 + 0.5 * n(), "w0": lambda: -0.6 + 0.3 * n(),
             "u": lambda: 0.3 * n(), "conv_b": lambda: 0.1 * n()
             }.get(name, lambda: n() * d ** -0.5)()
    return x.astype(np.float32)


def params(cfgj, cfgt, seed: int = 0):
    """(reference params, port params): the same random values, each
    leaf in the reference's dtype (the port's: ``params_from_numpy``)."""
    assert cfgj.padded_heads == cfgj.n_heads    # no zero-masked heads to keep
    rng = np.random.default_rng(seed)
    shapes = ref_shapes(cfgj)
    host = jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(p[-1].key, s.shape, cfgj.d_model, rng), shapes)
    pj = jax.tree.map(lambda x, s: jnp.asarray(x).astype(s.dtype), host, shapes)
    pt = tm.params_from_numpy(jax.tree.map(np_, pj), dtype=tl.dtype_of(cfgt), device="cpu")
    return pj, pt


def batch(cfg, B: int, S: int, seed: int, labels: bool = False):
    """(reference batch, port batch): tokens [B, S], and the image or
    encoder embeddings the family reads."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1]}
    if labels:
        b["labels"] = toks[:, 1:]
    if cfg.family == "vlm":
        b["img_embeds"] = (rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model))
                           * 0.5).astype(np.float32)
    if cfg.family == "encdec":
        b["enc_embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v.copy()) for k, v in b.items()})


def populated_caches(cfgj, cfgt, B: int, S: int, seed: int):
    """(reference cache, port cache) with every field random (states
    scaled by 0.3), in each field's dtype."""
    rng = np.random.default_rng(seed)
    cj = jm.init_cache(cfgj, B, S)
    ct = tm.init_cache(cfgt, B, S, device="cpu")
    fj, ft = {}, {}
    for name, a, t in zip(cj._fields, cj, ct):
        if a.size == 0:
            continue
        x = rng.standard_normal(a.shape).astype(np.float32)
        x *= 0.3 if name in ("ssm", "wkv") else 1.0
        fj[name] = jnp.asarray(x).astype(a.dtype)
        ft[name] = torch.from_numpy(np_(fj[name]).copy()).to(t.dtype)
    return cj._replace(**fj), ct._replace(**ft)
