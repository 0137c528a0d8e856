"""The port's train / prefill layers (``repro_torch.models``) against the
JAX reference's, on the CPU, at the smoke widths.

Same inputs in both packages (numpy from a seed, or the reference's
weights carried over).  Tolerances are relative to the reference's largest
magnitude: ``flash_attention`` as ``tests/test_models.py:138`` holds it to
plain attention (1e-5 on the output, 1e-4 on the q / k / v gradients),
against the reference's custom VJP as well as against plain softmax
attention; ``attention_fwd``, ``forward``, ``chunked_softmax_xent`` and
``loss_fn``'s gradients within 1e-5 in float32 (measured: <= 8.5e-7);
``attention_fwd`` within one bfloat16 ulp (measured 4.4e-4); the forward
against the port's own ``decode_step`` within 1e-4 (as
``tests/test_models.py:66``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
import repro.train as jtrain
from repro.models import layers as jl
import repro_torch.models as tm
from repro_torch import pytree
from repro_torch.models import layers as tl
from repro_torch.train.train_step import _grads
from _torch_train_cases import batch, carried, cfgs, jax_state, np_, opt_cfgs, rel, single_thread

pytestmark = pytest.mark.usefixtures("single_thread")

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _plain_attention(q, k, v, causal):
    """Softmax attention written out, [B, S, H, hd] in and out."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S,qb,kb", [(64, 16, 32), (96, 32, 16)])
def test_flash_attention_equals_the_reference_vjp_and_plain_attention(causal, S, qb, kb):
    rng = np.random.default_rng(S + causal)
    q, k, v, do = (rng.standard_normal((2, S, 3, 32)).astype(np.float32) for _ in range(4))
    kw = dict(causal=causal, q_block=qb, kv_block=kb)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out_j = jax.jit(lambda *a: jm.flash_attention(*a, **kw))(jq, jk, jv)
    grads_j = jax.jit(jax.grad(lambda *a: (jm.flash_attention(*a, **kw) * do).sum(),
                               argnums=(0, 1, 2)))(jq, jk, jv)

    def run(fn):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = fn(*ts)
        (out * torch.from_numpy(do)).sum().backward()
        return out.detach(), [t.grad for t in ts]

    out_t, grads_t = run(lambda *a: tm.flash_attention(*a, **kw))
    out_p, grads_p = run(lambda *a: _plain_attention(*a, causal))
    assert rel(out_t, out_j) < 1e-5 and rel(out_t, out_p) < 1e-5
    for name, gt, gj, gp in zip("qkv", grads_t, grads_j, grads_p):
        assert rel(gt, gj) < 1e-4, name
        assert rel(gt, gp) < 1e-4, name


def test_flash_attention_keeps_the_reference_block_rules():
    x = torch.zeros(1, 48, 2, 8)
    # blocks are clamped to the sequence: 512 > 48 runs as one block
    out = tm.flash_attention(x, x, x, causal=True, q_block=512, kv_block=512)
    assert out.shape == x.shape
    with pytest.raises(ValueError, match="do not divide"):
        tm.flash_attention(x, x, x, causal=True, q_block=32, kv_block=16)
    # the lse saved for the backward is [nq, B, H, q_block], -inf nowhere
    _, lse = tl._fa_forward(x, x, x, True, 16, 16)
    assert lse.shape == (3, 1, 2, 16) and torch.isfinite(lse).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2 ** -8)])
def test_attention_fwd_equals_the_reference(dtype, tol):
    cfgj, cfgt = cfgs(dtype=dtype)
    oj, _ = opt_cfgs()
    sj = jax_state(cfgj, oj)
    st = carried(sj, cfgt)
    aj = jax.tree.map(lambda a: a[1], sj.params["layers"])["attn"]
    at = {k: v[1] for k, v in st.params["layers"]["attn"].items()}
    x = np.random.default_rng(1).standard_normal((4, 64, cfgj.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np_(xj).copy()).to(TORCH_DTYPE[dtype])
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (4, 64)).copy()
    got = tl.attention_fwd(at, cfgt, xt, torch.from_numpy(pos))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    ref = jax.jit(lambda a, xx, pp: jl.attention_fwd(a, cfgj, xx, pp))(aj, xj, jnp.asarray(pos))
    assert rel(got, ref) <= tol


def test_forward_equals_the_reference_and_remat_is_bit_exact():
    """float32 llama3-8b smoke: the port's forward within 1e-5 of the
    reference's; with remat on and off the port's hidden states and
    loss gradients are equal to the bit."""
    out = {}
    for remat in (False, True):
        cfgj, cfgt = cfgs(dtype="float32", remat=remat)
        oj, _ = opt_cfgs()
        sj = jax_state(cfgj, oj)
        st = carried(sj, cfgt)
        b = batch(cfgj, 4, 64, seed=2)
        hj, _ = jax.jit(lambda p, t: jm.forward(p, cfgj, {"tokens": t}))(
            sj.params, jnp.asarray(b["tokens"]))
        ht, auxt = tm.forward(st.params, cfgt, {"tokens": torch.from_numpy(b["tokens"])})
        assert ht.shape == hj.shape and ht.dtype == torch.float32
        assert rel(ht, hj) < 1e-5
        assert float(auxt["lb_loss"]) == 0.0 and float(auxt["z_loss"]) == 0.0
        grads, _ = _grads(st.params, cfgt, {k: torch.from_numpy(v) for k, v in b.items()}, 1)
        out[remat] = (ht, pytree.leaves(grads))
    assert torch.equal(out[False][0], out[True][0])
    for a, b_ in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b_)


def test_head_padding_is_exact():
    """Zero-masked head padding (yi-34b smoke, as tests/test_models.py:88):
    the padded layout with the same weights embedded gives the same hidden
    states, in the port and against the reference."""
    cfg0j, cfg0 = cfgs("yi_34b", dtype="float32", remat=False)
    cfgpj, cfgp = cfg0j.replace(head_pad_to=4), cfg0.replace(head_pad_to=4)
    p0j = jax.jit(lambda k: jm.init_params(cfg0j, k))(jax.random.PRNGKey(0))
    p0 = tm.params_from_numpy(jax.tree.map(np.asarray, p0j), device="cpu")
    pp = tm.init_params(cfgp, 0, device="cpu")
    G, Gp, kv = cfg0.q_groups, cfgp.padded_q_groups, cfg0.n_kv_heads
    assert Gp > G
    wq = torch.zeros_like(pp["layers"]["attn"]["wq"])
    wo = torch.zeros_like(pp["layers"]["attn"]["wo"])
    for g in range(kv):
        wq[:, :, g * Gp:g * Gp + G] = p0["layers"]["attn"]["wq"][:, :, g * G:(g + 1) * G]
        wo[:, g * Gp:g * Gp + G] = p0["layers"]["attn"]["wo"][:, g * G:(g + 1) * G]
    pp["layers"]["attn"].update(wq=wq, wo=wo, wk=p0["layers"]["attn"]["wk"],
                                wv=p0["layers"]["attn"]["wv"])
    for nm in ("ln1", "ln2", "mlp"):
        pp["layers"][nm] = p0["layers"][nm]
    pp["embed"], pp["final_ln"] = p0["embed"], p0["final_ln"]
    tokens = np.random.default_rng(0).integers(0, cfg0.vocab, (2, 16)).astype(np.int32)
    h0, _ = tm.forward(p0, cfg0, {"tokens": torch.from_numpy(tokens)})
    hp, _ = tm.forward(pp, cfgp, {"tokens": torch.from_numpy(tokens)})
    assert float((h0 - hp).abs().max()) < 2e-5
    hj, _ = jax.jit(lambda p, t: jm.forward(p, cfg0j, {"tokens": t}))(p0j, jnp.asarray(tokens))
    assert rel(hp, hj) < 1e-5


def test_forward_equals_decode_step_over_sixteen_tokens():
    """The parallel forward against step-by-step decode in the port
    (float32, as tests/test_models.py:66)."""
    _, cfg = cfgs(dtype="float32", remat=False)
    params = tm.init_params(cfg, 2, device="cpu")
    B, S = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, S)))
    h_fwd, _ = tm.forward(params, cfg, {"tokens": tokens})
    cache = tm.init_cache(cfg, B, S, device="cpu")
    hs = []
    for t in range(S):
        h, cache = tm.decode_step(params, cfg, cache, tokens[:, t:t + 1],
                                  torch.full((B,), t, dtype=torch.int32))
        hs.append(h[:, 0])
    h_dec = torch.stack(hs, dim=1)
    assert float((h_fwd - h_dec).abs().max() / h_fwd.abs().max()) < 1e-4


def test_chunked_softmax_xent_and_its_gradients_equal_the_reference():
    """Padded labels (>= vocab) are masked; the loss and its gradients with
    respect to the hidden states and both embedding tables within 1e-5."""
    cfgj, cfgt = cfgs(dtype="float32")
    oj, _ = opt_cfgs()
    sj = jax_state(cfgj, oj)
    ej = sj.params["embed"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64, cfgj.d_model)).astype(np.float32)
    labels = rng.integers(0, cfgj.padded_vocab, (3, 64)).astype(np.int32)
    assert (labels >= cfgj.vocab).any()
    for chunk in (16, 256):
        lj, gj = jax.jit(jax.value_and_grad(
            lambda e, xx: jl.chunked_softmax_xent(e, xx, jnp.asarray(labels), cfgj.vocab,
                                                  chunk), argnums=(0, 1)))(ej, jnp.asarray(x))
        et = {k: torch.from_numpy(np_(v).copy()).requires_grad_(True) for k, v in ej.items()}
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        lt = tl.chunked_softmax_xent(et, xt, torch.from_numpy(labels), cfgt.vocab, chunk)
        lt.backward()
        assert rel(lt, lj) < 1e-5
        assert rel(xt.grad, gj[1]) < 1e-5
        assert et["tok"].grad is None and not np.asarray(gj[0]["tok"]).any()  # untied head
        assert rel(et["head"].grad, gj[0]["head"]) < 1e-5


def test_loss_fn_gradients_equal_the_reference():
    cfgj, cfgt = cfgs(dtype="float32")
    oj, _ = opt_cfgs()
    sj = jax_state(cfgj, oj)
    st = carried(sj, cfgt)
    b = batch(cfgj, 4, 64, seed=5)
    gj, auxj = jax.jit(jax.grad(lambda p, bb: jtrain.loss_fn(p, cfgj, bb),
                                has_aux=True))(sj.params, jax.tree.map(jnp.asarray, b))
    gt, auxt = _grads(st.params, cfgt, {k: torch.from_numpy(v) for k, v in b.items()}, 1)
    assert rel(auxt["loss"], auxj["loss"]) < 1e-5
    paths, leaves_t, _ = pytree.flatten_with_paths(gt)
    flat_j = jax.tree_util.tree_leaves_with_path(gj)
    assert paths == ["/".join(str(k) for k in p) for p, _ in flat_j]
    for p, a, (_, b_) in zip(paths, leaves_t, flat_j):
        assert a.shape == b_.shape and rel(a, b_) < 1e-5, p
