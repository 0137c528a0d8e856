"""The port's decode path (``repro_torch.models``) against the JAX
reference's, on the CPU, at the smoke llama3-8b width.

Both packages run on the same weights: the reference's ``init_params``
tree goes through ``params_from_numpy`` (bfloat16 leaves handed over as
float32, which is exact).  Each layer function and ``decode_step`` over
six steps of a populated cache must agree within a tolerance relative to
the largest magnitude of the reference's output: 1e-5 in float32; in
bfloat16 one ulp for each layer function and 1.5e-2 after six decode steps
(the largest seen was 1.23e-2: the port's and XLA's bfloat16 matrix
products round their float32 sums apart by an ulp here and there, and
that compounds through the layers).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jm
from repro.models import layers as jl
import repro_torch.configs as tconfigs
import repro_torch.models as tm
from repro_torch.models import layers as tl

# relative to the reference's largest magnitude; bfloat16: one ulp for a
# single layer function (measured: equal), 1.5e-2 after six whole decode
# steps (measured 1.23e-2: ulp-level differences in bfloat16 products
# compound through the layers)
TOL = {"float32": 1e-5, "bfloat16": 2 ** -8}
TOL_DECODE = {"float32": 1e-5, "bfloat16": 1.5e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = ["float32", "bfloat16"]
# one architecture of each family beside the dense one
OTHER_FAMILIES = ["deepseek_moe_16b", "internvl2_2b", "whisper_large_v3",
                  "zamba2_2_7b", "rwkv6_7b"]


def _cfgs(dtype: str, **kw):
    return (jconfigs.get("llama3_8b", smoke=True).replace(dtype=dtype, **kw),
            tconfigs.get("llama3_8b", smoke=True).replace(dtype=dtype, **kw))


def _np(a) -> np.ndarray:
    """A JAX array as numpy, bfloat16 read through float32 (exact)."""
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _to_np(tree):
    return jax.tree.map(_np, tree)


def _pair(x: np.ndarray, dtype: str):
    """The same values in both packages, rounded to ``dtype`` once."""
    j = jnp.asarray(x).astype(dtype)
    return j, torch.from_numpy(_np(j).copy()).to(TORCH_DTYPE[dtype])


@functools.cache
def _params(dtype: str, head_pad_to: int = 1):
    """Both packages' configs and the reference's weights in each (read
    only: shared by the tests)."""
    cfgj, cfgt = _cfgs(dtype, head_pad_to=head_pad_to)
    pj = _jax_init(cfgj, jax.random.PRNGKey(0))
    pt = tm.params_from_numpy(_to_np(pj), dtype=tl.dtype_of(cfgt), device="cpu")
    return cfgj, cfgt, pj, pt


# the reference's decode as its serving engine runs it: jitted (and its
# init jitted too: one compile, not one a layer op)
_jax_decode = jax.jit(jm.decode_step, static_argnums=(1,))
_jax_init = jax.jit(jm.init_params, static_argnums=(0,))


def _err(port: torch.Tensor, ref) -> float:
    r = _np(ref).astype(np.float64)
    return float(np.abs(port.to(torch.float64).numpy() - r).max() / np.abs(r).max())


def _layer(tree, l):
    return jax.tree.map(lambda a: a[l], tree)


def _populated_cache(cfgj, cfgt, B, S, seed):
    """A cache whose every position holds values (each package gets the
    same ones)."""
    rng = np.random.default_rng(seed)
    shp = (cfgj.n_layers, B, S, cfgj.padded_kv_heads, cfgj.resolved_head_dim)
    kj, kt = _pair(rng.standard_normal(shp).astype(np.float32), cfgj.dtype)
    vj, vt = _pair(rng.standard_normal(shp).astype(np.float32), cfgj.dtype)
    cj = jm.init_cache(cfgj, B, S)._replace(k=kj, v=vj)
    ct = tm.init_cache(cfgt, B, S, device="cpu")._replace(k=kt, v=vt)
    return cj, ct


def test_params_from_numpy_keeps_keys_shapes_dtypes_and_values():
    cfgj, cfgt, pj, pt = _params("bfloat16")
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    flat_t = jax.tree_util.tree_leaves_with_path(pt)
    assert [jax.tree_util.keystr(p) for p, _ in flat_t] == \
        [jax.tree_util.keystr(p) for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert tuple(b.shape) == a.shape and b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.float().numpy(), _np(a))


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_params_tree_shapes_and_dtypes_equal_the_reference(dtype):
    cfgj, cfgt = _cfgs(dtype)
    shapes_j = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            jax.eval_shape(lambda k: jm.init_params(cfgj, k),
                                           jax.random.PRNGKey(0)))
    pt = tm.init_params(cfgt, 0, device="cpu")
    shapes_t = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), pt)
    assert shapes_t == shapes_j
    # fan-in scaled truncated normals: |w| <= 2 / sqrt(fan_in), norms at 1
    wq = pt["layers"]["attn"]["wq"].float()
    assert 0 < wq.abs().max() <= 2 * cfgt.d_model ** -0.5 + 1e-6
    assert (pt["layers"]["ln1"]["scale"] == 1).all()
    # a seed or a generator give the same draws
    again = tm.init_params(cfgt, torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"]["head"], pt["embed"]["head"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_equals_the_reference(dtype):
    cfgj, cfgt = _cfgs(dtype)
    x = np.random.default_rng(1).standard_normal((3, 1, cfgj.d_model)) * 4
    xj, xt = _pair(x.astype(np.float32), dtype)
    scale = np.random.default_rng(2).uniform(0.5, 1.5, cfgj.d_model).astype(np.float32)
    sj, st = _pair(scale, dtype)
    got = tl.rmsnorm({"scale": st}, xt, cfgt.norm_eps)
    assert got.dtype == xt.dtype
    assert _err(got, jl.rmsnorm({"scale": sj}, xj, cfgj.norm_eps)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_equals_the_reference(dtype):
    cfgj, cfgt = _cfgs(dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 2, 4, cfgj.resolved_head_dim)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2)).astype(np.int32)
    xj, xt = _pair(x, dtype)
    got = tl.rope(xt, torch.from_numpy(pos), cfgt.rope_theta)
    assert _err(got, jl.rope(xj, jnp.asarray(pos), cfgj.rope_theta)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode_equals_the_reference(dtype):
    cfgj, cfgt, pj, pt = _params(dtype)
    B, S = 3, 16
    cj, ct = _populated_cache(cfgj, cfgt, B, S, seed=4)
    x = np.random.default_rng(5).standard_normal((B, 1, cfgj.d_model)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    pos = np.array([0, 7, 15], np.int32)
    aj = _layer(pj["layers"], 0)["attn"]
    at = {k: v[0] for k, v in pt["layers"]["attn"].items()}
    oj, kj, vj = jl.attention_decode(aj, cfgj, xj, cj.k[0], cj.v[0], jnp.asarray(pos))
    ot, kt, vt = tl.attention_decode(at, cfgt, xt, ct.k[0], ct.v[0], torch.from_numpy(pos))
    assert _err(ot, oj) <= TOL[dtype]
    for got, ref in [(kt, kj), (vt, vj)]:     # the appended rows, rounded alike
        assert _err(got, ref) <= TOL[dtype]
    assert torch.equal(ct.k[0], _pair(_np(cj.k[0]), dtype)[1])   # input untouched


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_equals_the_reference(dtype):
    cfgj, cfgt, pj, pt = _params(dtype)
    x = np.random.default_rng(6).standard_normal((3, 1, cfgj.d_model)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    mj = _layer(pj["layers"], 1)["mlp"]
    mt = {k: v[1] for k, v in pt["layers"]["mlp"].items()}
    assert _err(tl.mlp(mt, xt), jl.mlp(mj, xj)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_logits_fn_equals_the_reference(dtype):
    cfgj, cfgt, pj, pt = _params(dtype)
    x = np.random.default_rng(7).standard_normal((3, 1, cfgj.d_model)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    got = tl.logits_fn(pt["embed"], xt)
    assert got.shape == (3, 1, cfgt.padded_vocab) and got.dtype == xt.dtype
    assert _err(got, jl.logits_fn(pj["embed"], xj)) <= TOL[dtype]
    tied = {"tok": pt["embed"]["tok"]}         # tie_embeddings: tok.T
    assert _err(tl.logits_fn(tied, xt), jl.logits_fn({"tok": pj["embed"]["tok"]}, xj)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("head_pad_to", [1, 8], ids=["unpadded", "padded"])
def test_decode_step_equals_the_reference_over_six_steps(dtype, head_pad_to):
    """Six decode steps from a populated cache: hidden states, the cache and
    greedy tokens agree (tokens wherever the top two logits are apart)."""
    cfgj, cfgt, pj, pt = _params(dtype, head_pad_to)
    B, S = 3, 16
    cj, ct = _populated_cache(cfgj, cfgt, B, S, seed=8)
    rng = np.random.default_rng(9)
    pos = np.array([0, 4, 9], np.int32)
    for _ in range(6):
        tok = rng.integers(0, cfgj.vocab, (B, 1)).astype(np.int32)
        hj, cj = _jax_decode(pj, cfgj, cj, jnp.asarray(tok), jnp.asarray(pos))
        ht, ct = tm.decode_step(pt, cfgt, ct, torch.from_numpy(tok), torch.from_numpy(pos))
        assert ht.shape == (B, 1, cfgt.d_model) and ht.dtype == tl.dtype_of(cfgt)
        assert _err(ht, hj) <= TOL_DECODE[dtype]
        assert _err(ct.k, cj.k) <= TOL_DECODE[dtype]
        assert _err(ct.v, cj.v) <= TOL_DECODE[dtype]
        lj = _np(jm.logits_fn(pj["embed"], hj))[:, 0]
        lt = tm.logits_fn(pt["embed"], ht)[:, 0].float().numpy()
        top2 = np.sort(lj, axis=-1)[:, -2:]
        apart = (top2[:, 1] - top2[:, 0]) > 1e-3 * np.abs(top2[:, 1])
        np.testing.assert_array_equal(lt.argmax(-1)[apart], lj.argmax(-1)[apart])
        pos = pos + 1
    if head_pad_to > 1:
        assert cfgt.padded_heads > cfgt.n_heads
        mask = tl.head_mask(cfgt)
        pads = mask == 0
        assert pads.any()
        assert (pt["layers"]["attn"]["wq"][:, :, pads] == 0).all()
        own = tm.init_params(cfgt, 1, device="cpu")["layers"]["attn"]
        assert (own["wq"][:, :, pads] == 0).all() and (own["wo"][:, pads] == 0).all()
        assert (own["wq"][:, :, ~pads] != 0).any()


@pytest.mark.parametrize("name", OTHER_FAMILIES)
def test_every_family_initialises_and_decodes_one_step(name):
    """The families beyond ``dense`` at their smoke configs (bfloat16):
    random init, an empty cache and one decode step on the CPU give
    finite hidden states of the right shape and a cache of the same
    shapes and dtypes (held to the reference in
    tests/test_torch_families.py)."""
    cfg = tconfigs.get(name, smoke=True)
    params = tm.init_params(cfg, 0, device="cpu")
    cache = tm.init_cache(cfg, 2, 16, device="cpu")
    tok = torch.tensor([[1], [cfg.vocab - 1]], dtype=torch.int32)
    h, new = tm.decode_step(params, cfg, cache, tok, torch.zeros(2, dtype=torch.int32))
    assert h.shape == (2, 1, cfg.d_model) and h.dtype == tl.dtype_of(cfg)
    assert torch.isfinite(h.float()).all()
    for a, b in zip(cache, new):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_cache_has_the_reference_fields():
    cfgj, cfgt = _cfgs("bfloat16")
    assert tm.Cache._fields == jm.Cache._fields
    cj, ct = jm.init_cache(cfgj, 2, 16), tm.init_cache(cfgt, 2, 16, device="cpu")
    for a, b in zip(cj, ct):
        assert tuple(b.shape) == a.shape
        assert (b == 0).all()
