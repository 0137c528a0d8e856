"""The port's BP-family simulator against the JAX reference.

Step parity: from a mid-run JAX state, carried across as numpy, the JAX
``_bp_step`` and the port's ``_bp_step`` run side by side on the CPU for
240 slots, the port fed the JAX step's own random draws through the
``SlotDraws`` seam (the JAX key derivation is reproduced here).  Queues,
servers and every accumulator must be equal after every slot.

Simulator parity (seed-spread confidence intervals) lives in
tests/test_torch_sim_*.py, which run longer.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as jcl
from repro.core import policies as jpol
from repro.core import simulator as jsim
from repro.scenarios.build import realize as jrealize
from repro.scenarios.build import speed_at
from repro.scenarios.spec import get_scenario
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim
from repro_torch.core.policies import PodSpec
from repro_torch.scenarios import realize as trealize

M, K = 20, 4
RATES = (0.1, 0.05, 0.02)
LOAD = 0.9                  # queues build and exact workload ties occur
T0, STEPS = 160, 240        # JAX-only prefix, then side-by-side slots
CFG_J = jsim.SimConfig(T=T0 + STEPS, warmup=60, route_mode="batched")
CFG_T = tsim.SimConfig(T=T0 + STEPS, warmup=60, route_mode="batched")
CL_J, CL_T = jcl.Cluster(M=M, K=K), tcl.Cluster(M=M, K=K)
R_J, R_T = jcl.Rates(*RATES), tcl.Rates(*RATES)
POD_J = {"balanced_pandas": None, "balanced_pandas_pod": jpol.PodSpec(2, 6)}
POD_T = {"balanced_pandas": None, "balanced_pandas_pod": PodSpec(2, 6)}


def _setup():
    scen, lam_cap = jrealize(get_scenario(None), CL_J, R_J, CFG_J.T)
    lam = LOAD * lam_cap
    return scen, jnp.float32(lam), CFG_J.resolve_a_max(lam)


@functools.partial(jax.jit, static_argnames=("pod", "a_max"))
def _jax_step(state, sums, key, t, lam, scen, *, pod, a_max):
    """One slot of the reference, as its ``_run`` drives it."""
    half2_from = CFG_J.warmup + (CFG_J.T - CFG_J.warmup) // 2
    state, sums, _ = jsim._bp_step(
        state, sums, jax.random.fold_in(key, t), cluster=CL_J, rates=R_J,
        cfg=CFG_J, lam_t=lam * scen.lam_shape[t], scen=scen,
        speed=speed_at(scen, t), inv_rate_m=jcl.safe_inv_rates(R_J.as_array()),
        pod=pod, a_max=a_max, measure=t >= CFG_J.warmup,
        in_half2=t >= half2_from, homo=True, t=t)
    return state, sums


@functools.partial(jax.jit, static_argnames=("pod", "a_max"))
def _jax_draws(key, t, lam, scen, class_rows, *, pod, a_max):
    """The draws the reference's slot t consumes, by its key derivation:
    fold_in(key, t) -> (k_sched, k_arr, k_route); k_arr -> (k_n, k_loc);
    k_route -> (k_tie, k_pod, k_seq); split(k_pod)[0] -> pod_candidates;
    k_sched -> the duration uniforms, here evaluated for every class."""
    k_sched, k_arr, k_route = jax.random.split(jax.random.fold_in(key, t), 3)
    k_n, k_loc = jax.random.split(k_arr)
    raw = jax.random.poisson(k_n, lam * scen.lam_shape[t])
    locals_ = jcl.sample_locals(k_loc, CL_J, a_max)
    dur = jnp.stack([jcl.sample_durations(k_sched, class_rows[c], R_J)
                     for c in range(3)], axis=1)
    k_tie, k_pod, _k_seq = jax.random.split(k_route, 3)
    cls = jcl.locality_class(CL_J, locals_)
    out = dict(raw=raw, locals_=locals_, cls=cls, dur=dur,
               prio=jax.random.permutation(k_tie, CL_J.M))
    if pod is not None:
        kc, _ = jax.random.split(k_pod)
        ci, _cc, cv = jpol.pod_candidates(kc, CL_J, locals_, cls, pod)
        out.update(cand_idx=ci, cand_valid=cv)
    return out


def _to_slot_draws(d, pod) -> tsim.SlotDraws:
    t = lambda k, dt: torch.from_numpy(np.array(d[k])).to(dt)
    kw = dict(raw=t("raw", torch.int32), locals_=t("locals_", torch.int32),
              cls=t("cls", torch.int32), dur=t("dur", torch.int32))
    if pod is None:
        kw["prio"] = t("prio", torch.int32)
    else:
        kw.update(cand_idx=t("cand_idx", torch.int32),
                  cand_valid=t("cand_valid", torch.bool))
    return tsim.SlotDraws(**kw)


def _assert_same(jstate, jsums, tstate, tsums, t):
    js, ts = tsim.bp_state_to_numpy(tstate), [np.asarray(x) for x in jstate]
    for name, a, b in zip(tsim.BPState._fields, ts, js):
        np.testing.assert_array_equal(a, b, err_msg=f"slot {t}: {name}")
    tn = tsim.raw_sums_to_numpy(tsums)
    for name, a, b in zip(tsim.RawSums._fields, tn, jsums):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"slot {t}: {name}")


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod"])
def test_bp_step_matches_jax_slot_by_slot(algo):
    scen, lam, a_max = _setup()
    pod_j, pod_t = POD_J[algo], POD_T[algo]
    key = jax.random.PRNGKey(11)
    class_rows = jnp.asarray(np.repeat(np.arange(3, dtype=np.int32)[:, None], M, 1))
    jstate, jsums = jsim.BPState.zero(M), jsim.RawSums.zero()
    for t in range(T0):
        jstate, jsums = _jax_step(jstate, jsums, key, t, lam, scen,
                                  pod=pod_j, a_max=a_max)
    tstate = tsim.bp_state_from_numpy([np.asarray(x) for x in jstate])
    tsums = tsim.raw_sums_from_numpy([np.asarray(x) for x in jsums])
    inv = tcl.safe_inv_rates(R_T.as_array())
    half2_from = CFG_T.warmup + (CFG_T.T - CFG_T.warmup) // 2
    queued, tied = 0, 0
    for t in range(T0, T0 + STEPS):
        d = _jax_draws(key, t, lam, scen, class_rows, pod=pod_j, a_max=a_max)
        w = np.asarray(tsim._bp_workload(tstate.Q, inv))
        tied += int(len(np.unique(w)) < M)
        tstate, tsums = tsim._bp_step(
            tstate, tsums, _to_slot_draws(d, pod_t), cluster=CL_T, cfg=CFG_T,
            inv_rate_m=inv, pod=pod_t, a_max=a_max, measure=t >= CFG_T.warmup,
            in_half2=t >= half2_from)
        jstate, jsums = _jax_step(jstate, jsums, key, t, lam, scen,
                                  pod=pod_j, a_max=a_max)
        _assert_same(jstate, jsums, tstate, tsums, t)
        queued += int(tstate.Q.sum() > 0)
    assert queued > STEPS // 4 and tied > STEPS // 2, (queued, tied)


def test_state_round_trips_through_numpy():
    rng = np.random.default_rng(0)
    state = (rng.integers(0, 9, (M, 3)).astype(np.int32), rng.random(M) < 0.5,
             rng.random(M).astype(np.float32), rng.integers(0, 3, M).astype(np.int32))
    back = tsim.bp_state_to_numpy(tsim.bp_state_from_numpy(state))
    for a, b in zip(state, back):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    sums = [np.float32(i) for i in range(7)] + [np.arange(3, dtype=np.float32)] * 2 \
        + [np.float32(i) for i in range(4)]
    back = tsim.raw_sums_to_numpy(tsim.raw_sums_from_numpy(sums))
    for a, b in zip(sums, back):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo", jsim.ALGORITHMS)
def test_summarize_matches_jax_on_the_same_sums(algo):
    """Given the reference's raw sums, the port's SimResult is the
    reference's, field for field."""
    cfg = jsim.SimConfig(T=800, warmup=200, route_mode="batched")
    jres = jsim.simulate(algo, CL_J, R_J, 0.7, jax.random.PRNGKey(2), cfg)
    scen, lam_cap = jrealize(get_scenario(None), CL_J, R_J, 800)
    lam = 0.7 * lam_cap
    sums, _ = jsim._run(jax.random.PRNGKey(2), jnp.float32(lam), scen, algo=algo,
                        cluster=CL_J, rates=R_J, cfg=cfg,
                        pod=jsim._pod_for(algo, None),
                        a_max=jsim.SimConfig().resolve_a_max(lam),
                        homo_rates=True)
    tres = tsim.summarize(tsim.raw_sums_from_numpy([np.asarray(x) for x in sums]),
                          algo, CL_T, R_T, tsim._pod_for(algo, None))
    for name, a, b in zip(tsim.SimResult._fields, tres, jres):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_realize_uniform_matches_jax_and_rejects_other_scenarios():
    """The uniform realization equals the reference's; the trace-backed
    scenario, the one the port does not realize yet, is refused (every
    other registry scenario: tests/test_torch_scenarios.py)."""
    jscen, jcap = jrealize(get_scenario(None), CL_J, R_J, 100)
    tscen, tcap = trealize(None, CL_T, R_T, 100, device="cpu")
    assert tcap == jcap
    np.testing.assert_array_equal(tscen.lam_shape.numpy(), np.asarray(jscen.lam_shape))
    np.testing.assert_array_equal(tscen.base_speed.numpy(), np.asarray(jscen.base_speed))
    with pytest.raises(NotImplementedError, match="A, item 6"):
        trealize("production_day", CL_T, R_T, 100, device="cpu")


def test_entry_point_refuses_what_is_not_ported_and_needs_a_device_choice():
    cfg = tsim.SimConfig(T=10, warmup=2, route_mode="batched")
    with pytest.raises(NotImplementedError, match="A, item 6"):
        tsim.simulate("jsq_maxweight", CL_T, R_T, 0.5, 0, cfg,
                      scenario="production_day", device="cpu")
    with pytest.raises(ValueError):
        tsim.simulate("nope", CL_T, R_T, 0.5, 0, cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsim.simulate("balanced_pandas", CL_T, R_T, 0.5, 0, cfg)
    assert tsim.SimConfig().resolve_a_max(4.5) == jsim.SimConfig().resolve_a_max(4.5)


def test_config_fields_and_algorithms_equal_the_reference():
    """SimConfig's field names, defaults and order, and the registry."""
    got = [(f.name, f.default) for f in dataclasses.fields(tsim.SimConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jsim.SimConfig)]
    assert got == want
    assert tsim.ALGORITHMS == jsim.ALGORITHMS
    assert tsim.JSQMW_POD_DEFAULT.d_rack == jsim.JSQMW_POD_DEFAULT.d_rack == 6
    assert tsim.JSQMW_POD_DEFAULT.d_remote == jsim.JSQMW_POD_DEFAULT.d_remote == 6


@pytest.mark.parametrize("ours,theirs", [(tsim.simulate, jsim.simulate),
                                         (trealize, jrealize)])
def test_positional_parameters_equal_the_reference(ours, theirs):
    """The positional parameters (names and order) are the reference's;
    the port adds keyword-only ones (device, draws) after them."""
    positional = lambda f: [p.name for p in inspect.signature(f).parameters.values()
                            if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional(ours) == positional(theirs)
