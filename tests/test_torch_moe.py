"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's, on the CPU, in float32 at the deepseek-moe-16b and kimi-k2
smoke widths.

Both packages run on the reference's ``moe_params`` (numpy in between).
Out, ``lb_loss`` and ``z_loss`` must agree within 1e-5 (out relative to
its largest magnitude).  The cases cover no drop (capacity factor 16),
overflow at the default 1.25, where the reference's dispatch scatter
writes every dropped token into its expert's last slot and the last
write (a dropped one) wins, two dispatch groups, and ties in the router
probabilities (top-k takes the lower expert index first).  The dispatch
table itself is held to the reference's ``.at[].set`` of the same sorted
assignments, and the whole MoE models with two dispatch groups to the
reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jm
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
import repro_torch.models as tm
from repro_torch.models import moe as tmoe
from _torch_family_cases import batch as family_batch
from _torch_family_cases import cfgs as family_cfgs
from _torch_family_cases import params as family_params
from _torch_family_cases import populated_caches
from _torch_sim_helpers import one_thread

TOL = 1e-5
B, S = 4, 32
# the reference's layer, jitted: one compile a (config, groups), not one an op
_jax_moe = jax.jit(jmoe.moe_apply, static_argnums=(1, 3))


def _cfgs(name: str, **kw):
    return (jconfigs.get(name, smoke=True).replace(dtype="float32", **kw),
            tconfigs.get(name, smoke=True).replace(dtype="float32", **kw))


def _rel(port: torch.Tensor, ref) -> float:
    r = np.asarray(ref, np.float64)
    return float(np.abs(port.double().numpy() - r).max() / np.abs(r).max())


def _params(cfgj, seed: int):
    pj = jmoe.moe_params(jax.random.PRNGKey(seed), cfgj)
    return pj, tm.params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _ref_disp(se, st, E: int, C: int, Tl: int) -> np.ndarray:
    """The reference's dispatch table of the sorted assignments (its
    lines, ``src/repro/models/moe.py:86-96``)."""
    se, st = jnp.asarray(se), jnp.asarray(st)
    G, N = se.shape
    first = jax.vmap(lambda row: jnp.searchsorted(row, row, side="left"))(se)
    pos = jnp.arange(N)[None, :] - first
    keep = pos < C
    slot = se * C + jnp.minimum(pos, C - 1)
    disp = jnp.full((G, E * C), Tl, jnp.int32).at[jnp.arange(G)[:, None], slot].set(
        jnp.where(keep, st, Tl).astype(jnp.int32), mode="drop")
    return np.asarray(disp)


CASES = {
    # name: (arch, capacity_factor, dispatch_groups)
    "deepseek-no-drop": ("deepseek_moe_16b", 16.0, 1),
    "deepseek-overflow": ("deepseek_moe_16b", 1.25, 1),
    "deepseek-two-groups": ("deepseek_moe_16b", 1.25, 2),
    "kimi-overflow-two-groups": ("kimi_k2_1t_a32b", 1.25, 2),
    "kimi-no-drop": ("kimi_k2_1t_a32b", 16.0, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_equals_the_reference(case):
    arch, cf, G = CASES[case]
    cfgj, cfgt = _cfgs(arch, capacity_factor=cf)
    pj, pt = _params(cfgj, seed=len(case))
    # a skewed router: expert 0 draws most tokens, so it overflows at 1.25
    bias = np.zeros((cfgj.d_model, cfgj.n_experts), np.float32)
    bias[:, 0] = 0.2
    pj = {**pj, "router": pj["router"] + bias}
    pt = {**pt, "router": pt["router"] + torch.from_numpy(bias)}
    x = (np.random.default_rng(3).standard_normal((B, S, cfgj.d_model)) * 0.5
         + 0.3).astype(np.float32)
    oj, auxj = _jax_moe(pj, cfgj, jnp.asarray(x), G)
    with one_thread():
        ot, auxt = tmoe.moe_apply(pt, cfgt, torch.from_numpy(x), G)
    assert ot.shape == x.shape and ot.dtype == torch.float32
    assert _rel(ot, oj) <= TOL
    for k in ("lb_loss", "z_loss"):
        assert abs(float(auxt[k]) - float(auxj[k])) <= TOL * max(1.0, abs(float(auxj[k]))), k
    # overflow where the case says so: some expert holds more than C
    T = B * S
    C = max(8, int(-(-(T // G) * cfgj.experts_per_token * cf // cfgj.n_experts)))
    probs = torch.softmax(torch.from_numpy(x).reshape(G, T // G, -1) @ pt["router"], -1)
    top_e = tmoe._top_k(probs, cfgj.experts_per_token)[1].reshape(G, -1)
    most = int(torch.stack([torch.bincount(r, minlength=cfgj.n_experts) for r in top_e]).max())
    assert (most > C) == (cf < 2), (most, C)


@pytest.mark.parametrize("G", [1, 2])
def test_dispatch_table_equals_the_reference_last_write_wins(G):
    """Sorted assignments with experts far over capacity: the port's table
    equals the reference's scatter, and every overflowing expert's last
    slot holds the pad row (its pos C-1 token is lost)."""
    rng = np.random.default_rng(G)
    E, C, Tl, K = 6, 4, 24, 2
    e = rng.choice(E, size=(G, Tl * K), p=[0.5, 0.2, 0.1, 0.1, 0.05, 0.05])
    t = np.broadcast_to(np.repeat(np.arange(Tl), K), (G, Tl * K))
    order = np.argsort(e, axis=-1, kind="stable")
    se, st = np.take_along_axis(e, order, -1), np.take_along_axis(t, order, -1)
    ref = _ref_disp(se, st, E, C, Tl)
    disp, keep, slot, count = tmoe._dispatch_table(torch.from_numpy(se), torch.from_numpy(st),
                                            E, C, Tl)
    np.testing.assert_array_equal(disp.numpy(), ref)
    np.testing.assert_array_equal(count.numpy(), [np.bincount(r, minlength=E) for r in se])
    over = [(g, x) for g in range(G) for x in range(E) if (se[g] == x).sum() > C]
    assert over
    for g, x in over:
        assert ref[g, x * C + C - 1] == Tl
        assert st[g][se[g] == x][C - 1] != Tl      # a real token, now lost
    assert int(keep.sum()) == sum(min(int((se[g] == x).sum()), C)
                                  for g in range(G) for x in range(E))


@pytest.mark.parametrize("which", ["duplicate-experts", "uniform-router"])
def test_router_ties_take_the_lower_expert_first(which):
    """Equal router probabilities: two experts with one router column
    (every token ties between them), or all-zero inputs (every expert
    ties).  lax.top_k takes the lower index; so must the port."""
    cfgj, cfgt = _cfgs("deepseek_moe_16b", capacity_factor=1.25)
    pj, pt = _params(cfgj, seed=7)
    x = (np.random.default_rng(4).standard_normal((B, S, cfgj.d_model)) * 0.5
         ).astype(np.float32)
    if which == "duplicate-experts":
        r = np.asarray(pj["router"]).copy()
        r[:, 5] = r[:, 2]
        r[:, 2] += 0.3 * np.abs(r).max()          # 2 and 5 lead, tied
        r[:, 5] = r[:, 2]
        pj = {**pj, "router": jnp.asarray(r)}
        pt = {**pt, "router": torch.from_numpy(r)}
    else:
        x[:, ::2] = 0.0
    oj, auxj = _jax_moe(pj, cfgj, jnp.asarray(x), 1)
    with one_thread():
        ot, auxt = tmoe.moe_apply(pt, cfgt, torch.from_numpy(x))
    assert _rel(ot, oj) <= TOL
    for k in ("lb_loss", "z_loss"):
        assert abs(float(auxt[k]) - float(auxj[k])) <= TOL * max(1.0, abs(float(auxj[k])))
    probs = torch.softmax(torch.from_numpy(x).reshape(1, B * S, -1) @ pt["router"], -1)
    _, top_e = tmoe._top_k(probs, cfgj.experts_per_token)
    _, jtop = jax.lax.top_k(probs.numpy(), cfgj.experts_per_token)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop))


def test_moe_params_shapes_and_dtypes_equal_the_reference():
    """bfloat16 model: the router stays float32, the experts bfloat16."""
    for name in ("deepseek_moe_16b", "kimi_k2_1t_a32b"):
        cfgj = jconfigs.get(name, smoke=True)
        cfgt = tconfigs.get(name, smoke=True)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            jax.eval_shape(lambda k: jmoe.moe_params(k, cfgj),
                                           jax.random.PRNGKey(0)))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                           tmoe.moe_params(torch.Generator().manual_seed(0), cfgt))
        assert got == want


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "kimi_k2_1t_a32b"])
def test_model_with_two_dispatch_groups_equals_the_reference(arch):
    """The whole model's forward and decode_step with two dispatch groups
    (the reference's data-parallel groups), float32, random parameters:
    hidden states (and the cache) within 1e-5."""
    cfgj, cfgt = family_cfgs(arch, dtype="float32")
    pj, pt = family_params(cfgj, cfgt, seed=1)
    bj, bt = family_batch(cfgj, 2, 16, seed=4)
    hj, auxj = jax.jit(jm.forward, static_argnums=(1,), static_argnames=("dispatch_groups",))(
        pj, cfgj, bj, dispatch_groups=2)
    ht, auxt = tm.forward(pt, cfgt, bt, dispatch_groups=2)
    assert _rel(ht, hj) <= TOL
    assert abs(float(auxt["lb_loss"]) - float(auxj["lb_loss"])) <= TOL * float(auxj["lb_loss"])
    cj, ct = populated_caches(cfgj, cfgt, 2, 16, seed=5)
    tok, pos = np.array([[3], [7]], np.int32), np.array([2, 9], np.int32)
    hj, cj = jax.jit(jm.decode_step, static_argnums=(1, 5))(
        pj, cfgj, cj, jnp.asarray(tok), jnp.asarray(pos), 2)
    ht, ct = tm.decode_step(pt, cfgt, ct, torch.from_numpy(tok), torch.from_numpy(pos), 2)
    assert _rel(ht, hj) <= TOL and _rel(ct.k, cj.k) <= TOL
