"""Every architecture of ``configs`` in the port (``repro_torch.models``)
against the JAX reference, on the CPU, at smoke width.

- ``init_params``: the tree, shapes and dtypes equal ``jax.eval_shape``
  of the reference's (bfloat16 models keep the reference's float32
  leaves), drawn one layer slice at a time;
- ``init_cache``: the reference's fields, shapes and dtypes, all zero;
- ``forward`` (float32): hidden states within 1e-5 of the reference's
  largest magnitude, the MoE aux losses within 1e-5;
- ``decode_step`` (float32) over six steps of a populated cache at
  staggered positions: hidden states and every cache field within 1e-5
  (with two dispatch groups: tests/test_torch_moe.py).

Both packages run on the same random parameters (``_torch_family_cases``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro_torch.models as tm
from repro.configs import ARCH_IDS
from _torch_family_cases import batch, cfgs, params, populated_caches, ref_shapes, rel
from _torch_sim_helpers import one_thread

TOL = 1e-5
B, S, STEPS = 2, 16, 6
# the dense llama3-8b is held to the reference in tests/test_torch_models.py
# and tests/test_torch_train_layers.py; every other architecture here
RUN = [a for a in ARCH_IDS if a != "llama3_8b"]

_jax_forward = jax.jit(jm.forward, static_argnums=(1,))
_jax_decode = jax.jit(jm.decode_step, static_argnums=(1,))


@pytest.fixture(autouse=True)
def single_thread():
    with one_thread():
        yield


@functools.cache
def _case(arch: str):
    cfgj, cfgt = cfgs(arch, dtype="float32")
    pj, pt = params(cfgj, cfgt, seed=len(arch))
    return cfgj, cfgt, pj, pt


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_tree_shapes_and_dtypes_equal_the_reference(arch):
    cfgj, cfgt = cfgs(arch)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref_shapes(cfgj))
    pt = tm.init_params(cfgt, 0, device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), pt)
    assert got == want
    leaves = jax.tree.leaves(pt)
    assert all(bool(torch.isfinite(t.float()).all()) for t in leaves)
    # every layer slice drawn: no two layers of a stacked weight alike
    stacked = pt.get("layers") or pt.get("dec_layers") or pt["groups"]
    w = jax.tree.leaves(stacked)[-1].float()
    w = w.reshape(-1, *w.shape[2:]) if "groups" in pt else w
    assert not torch.equal(w[0], w[1])
    assert torch.equal(jax.tree.leaves(tm.init_params(cfgt, torch.Generator().manual_seed(0)))[0],
                       leaves[0])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_equals_the_reference(arch):
    cfgj, cfgt = cfgs(arch)
    cj = jm.init_cache(cfgj, 3, 16)
    ct = tm.init_cache(cfgt, 3, 16, device="cpu")
    assert tm.Cache._fields == jm.Cache._fields
    for name, a, t in zip(cj._fields, cj, ct):
        assert (tuple(t.shape), str(t.dtype).split(".")[1]) == (a.shape, str(a.dtype)), name
        assert not t.any()


@pytest.mark.parametrize("arch", RUN)
def test_forward_equals_the_reference(arch):
    cfgj, cfgt, pj, pt = _case(arch)
    bj, bt = batch(cfgj, B, S, seed=1)
    hj, auxj = _jax_forward(pj, cfgj, bj)
    ht, auxt = tm.forward(pt, cfgt, bt)
    S_out = S + (cfgj.n_img_tokens if cfgj.family == "vlm" else 0)
    assert ht.shape == (B, S_out, cfgt.d_model) and ht.dtype == torch.float32
    assert rel(ht, hj) <= TOL
    for k in ("lb_loss", "z_loss"):
        assert auxt[k].dtype == torch.float32
        assert abs(float(auxt[k]) - float(auxj[k])) <= TOL * max(1.0, abs(float(auxj[k]))), k
    assert (float(auxj["lb_loss"]) > 0) == (cfgj.family == "moe")


@pytest.mark.parametrize("arch", RUN)
def test_decode_step_equals_the_reference_over_six_steps(arch):
    cfgj, cfgt, pj, pt = _case(arch)
    cj, ct = populated_caches(cfgj, cfgt, B, S, seed=2)
    rng = np.random.default_rng(3)
    pos = np.array([0, 5], np.int32)
    for _ in range(STEPS):
        tok = rng.integers(0, cfgj.vocab, (B, 1)).astype(np.int32)
        hj, cj = _jax_decode(pj, cfgj, cj, jnp.asarray(tok), jnp.asarray(pos))
        before = [t.clone() for t in ct]
        ht, ct_new = tm.decode_step(pt, cfgt, ct, torch.from_numpy(tok), torch.from_numpy(pos),
                                    dispatch_groups=1)
        assert all(torch.equal(a, b) for a, b in zip(before, ct))     # input untouched
        ct = ct_new
        assert ht.shape == (B, 1, cfgt.d_model)
        assert rel(ht, hj) <= TOL
        for name, a, t in zip(cj._fields, cj, ct):
            assert t.dtype == before[cj._fields.index(name)].dtype, name
            if a.size:
                assert rel(t, a) <= TOL, name
        pos = pos + 1

