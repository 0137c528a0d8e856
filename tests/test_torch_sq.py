"""The port's SQ-family and FCFS slot steps against the JAX reference.

Step parity, as tests/test_torch_simulator.py does for the BP family: from
a mid-run JAX state, carried across as numpy, the JAX step and the port's
step run side by side on the CPU for 240 slots, the port fed the JAX
step's own random draws through the ``SQDraws`` / ``FCFSDraws`` seam (the
JAX key derivation is reproduced here).  Queues, servers and every
accumulator must be equal after every slot.  s_max = 64 takes every server
as a scheduling row (S == M); s_max = 8 samples S < M rows.  Batched mode
routes through ``route_commit`` (its plain version on the CPU), sequential
mode per arrival with random ties.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cluster as jcl
from repro.core import simulator as jsim
from repro.scenarios.build import realize as jrealize
from repro.scenarios.build import speed_at
from repro.scenarios.spec import get_scenario
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim

M, K = 20, 4
RATES = (0.1, 0.05, 0.02)
T0, STEPS = 160, 240        # JAX-only prefix, then side-by-side slots
WARMUP = 60
CL_J, CL_T = jcl.Cluster(M=M, K=K), tcl.Cluster(M=M, K=K)
R_J, R_T = jcl.Rates(*RATES), tcl.Rates(*RATES)
SQ_ALGOS = ("jsq_maxweight", "jsq_maxweight_pod", "jsq_priority")
# (algo, s_max, route mode, load): at load 0.9 queues build and grant
# conflicts are mostly shared targets; at 0.6 queues are short and
# conflicts deny claimants, so the grant order decides who starts
CASES = ([(a, s, m, 0.9) for a in SQ_ALGOS for s in (64, 8)
          for m in ("batched", "sequential")]
         + [(a, 64, "batched", 0.6) for a in SQ_ALGOS]
         + [("fcfs", s, "batched", 0.9) for s in (64, 8)])


def _cfgs(s_max, mode):
    kw = dict(T=T0 + STEPS, warmup=WARMUP, s_max=s_max, route_mode=mode)
    return jsim.SimConfig(**kw), tsim.SimConfig(**kw)


def _durations(key, n):
    """int32 [n, 3]: the reference's durations for n tasks from ``key``,
    evaluated for every class (the uniforms depend on the key and shape
    only)."""
    return jnp.stack([jcl.sample_durations(key, jnp.full((n,), c, jnp.int32), R_J)
                      for c in range(3)], axis=1)


@functools.partial(jax.jit, static_argnames=("pod", "a_max", "S", "sequential"))
def _jax_sq_draws(key, t, lam, scen, *, pod, a_max, S, sequential):
    """The draws the reference's SQ slot t consumes, by its key derivation:
    fold_in(key, t) -> (k_sched, k_arr, k_route); k_sched -> (k_rows,
    k_cand, k_tie, k_grant, k_dur); k_arr -> (k_n, k_loc); k_route ->
    split(a_max) -> one route-tie draw per arrival."""
    k_sched, k_arr, k_route = jax.random.split(jax.random.fold_in(key, t), 3)
    k_rows, k_cand, k_tie, k_grant, k_dur = jax.random.split(k_sched, 5)
    k_n, k_loc = jax.random.split(k_arr)
    out = dict(raw=jax.random.poisson(k_n, lam * scen.lam_shape[t]),
               locals_=jcl.sample_locals(k_loc, CL_J, a_max),
               dur=_durations(k_dur, S),
               tie=jax.random.uniform(k_tie, (S, M if pod is None else 1 + pod.d)),
               grant=jax.random.uniform(k_grant, (S,)))
    if S < M:
        out["rows"] = jax.random.uniform(k_rows, (M,))
    if pod is not None:
        R = CL_J.rack_size
        hi = jnp.array([max(R - 1, 1)] * pod.d_rack + [max(M - R, 1)] * pod.d_remote,
                       jnp.int32)
        out["cand"] = jax.random.randint(k_cand, (S, pod.d), 0, hi[None, :])
    if sequential:
        keys = jax.random.split(k_route, a_max)
        out["route"] = jax.vmap(
            lambda k: jax.random.uniform(k, (CL_J.n_replicas,)))(keys)
    return out


@functools.partial(jax.jit, static_argnames=("G",))
def _jax_fcfs_draws(key, t, lam, scen, *, G):
    """FCFS slot t: fold_in(key, t) -> (k_rank, k_loc, k_dur, k_arr)."""
    k_rank, k_loc, k_dur, k_arr = jax.random.split(jax.random.fold_in(key, t), 4)
    k_n, _ = jax.random.split(k_arr)
    return dict(raw=jax.random.poisson(k_n, lam * scen.lam_shape[t]),
                rank=jax.random.uniform(k_rank, (M,)),
                locals_=jcl.sample_locals(k_loc, CL_J, G),
                dur=_durations(k_dur, G))


@functools.partial(jax.jit, static_argnames=("algo", "pod", "a_max", "cfg"))
def _jax_step(state, sums, key, t, lam, scen, *, algo, pod, a_max, cfg):
    """One slot of the reference, as its ``_run`` drives it."""
    half2_from = cfg.warmup + (cfg.T - cfg.warmup) // 2
    kw = dict(cluster=CL_J, rates=R_J, cfg=cfg, lam_t=lam * scen.lam_shape[t],
              scen=scen, speed=speed_at(scen, t),
              inv_rate_m=jcl.safe_inv_rates(R_J.as_array()), a_max=a_max,
              measure=t >= cfg.warmup, in_half2=t >= half2_from, homo=True, t=t)
    k = jax.random.fold_in(key, t)
    if algo == "fcfs":
        state, sums, _ = jsim._fcfs_step(state, sums, k, **kw)
    else:
        variant = "priority" if algo == "jsq_priority" else "maxweight"
        state, sums, _ = jsim._sq_step(state, sums, k, variant=variant, pod=pod,
                                       **kw)
    return state, sums


_DTYPES = dict(raw=torch.int32, locals_=torch.int32, dur=torch.int32,
               cand=torch.int32)


def _to_draws(kind, d):
    return kind(**{k: torch.from_numpy(np.array(v)).to(_DTYPES.get(k, torch.float32))
                   for k, v in d.items()})


def _assert_same(jstate, jsums, tstate, tsums, t):
    for name, a, b in zip(type(tstate)._fields, tsim.state_to_numpy(tstate), jstate):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"slot {t}: {name}")
    for name, a, b in zip(tsim.RawSums._fields, tsim.raw_sums_to_numpy(tsums), jsums):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"slot {t}: {name}")


@pytest.mark.parametrize("algo,s_max,mode,load", CASES,
                         ids=[f"{a}-s{s}-{m}-{x}" for a, s, m, x in CASES])
def test_step_matches_jax_slot_by_slot(algo, s_max, mode, load):
    cfg_j, cfg_t = _cfgs(s_max, mode)
    scen, lam_cap = jrealize(get_scenario(None), CL_J, R_J, cfg_j.T)
    lam = load * lam_cap
    a_max = cfg_j.resolve_a_max(lam)
    lam = jnp.float32(lam)
    pod_j = jsim._pod_for(algo, None)
    pod_t = tsim._pod_for(algo, None)
    S = min(s_max, M)
    fcfs = algo == "fcfs"
    variant = "priority" if algo == "jsq_priority" else "maxweight"
    key = jax.random.PRNGKey(23)
    jstate = (jsim.FCFSState if fcfs else jsim.SQState).zero(M)
    jsums = jsim.RawSums.zero()
    step = functools.partial(_jax_step, algo=algo, pod=pod_j, a_max=a_max, cfg=cfg_j)
    for t in range(T0):
        jstate, jsums = step(jstate, jsums, key, t, lam, scen)
    kind = tsim.FCFSState if fcfs else tsim.SQState
    tstate = tsim.state_from_numpy(kind, [np.asarray(x) for x in jstate])
    tsums = tsim.raw_sums_from_numpy([np.asarray(x) for x in jsums])
    consts = tsim.step_consts(CL_T, R_T, pod_t, a_max, "cpu")
    half2_from = cfg_t.warmup + (cfg_t.T - cfg_t.warmup) // 2
    tied = conflicts = denied = queued = 0
    for t in range(T0, T0 + STEPS):
        kw = dict(cluster=CL_T, cfg=cfg_t, consts=consts, a_max=a_max,
                  measure=t >= cfg_t.warmup, in_half2=t >= half2_from)
        if fcfs:
            d = _to_draws(tsim.FCFSDraws, _jax_fcfs_draws(key, t, lam, scen, G=S))
            tstate, tsums = tsim._fcfs_step(tstate, tsums, d, **kw)
        else:
            q = tstate.Q.numpy()
            tied += int(len(np.unique(q[q > 0])) < (q > 0).sum())
            d = _to_draws(tsim.SQDraws, _jax_sq_draws(
                key, t, lam, scen, pod=pod_j, a_max=a_max, S=S,
                sequential=mode == "sequential"))
            # the slot's grants, as its step makes them: a conflict is two
            # grants from one queue, or a claimant denied
            busy, rem, _ = tsim._progress_service(tstate.busy, tstate.rem)
            *_, n_dec, _rows, tgt, granted = tsim._sq_schedule(
                d, CL_T, tstate.Q, busy, rem, tstate.cls, consts=consts, S=S,
                variant=variant, pod=pod_t)
            g = tgt[granted].numpy()
            conflicts += int(len(np.unique(g)) < len(g) or granted.sum() < n_dec)
            denied += int(granted.sum() < n_dec)
            tstate, tsums = tsim._sq_step(tstate, tsums, d, pod=pod_t,
                                          variant=variant, **kw)
        jstate, jsums = step(jstate, jsums, key, t, lam, scen)
        _assert_same(jstate, jsums, tstate, tsums, t)
        queued += int(tstate[0].sum() > 0)
    assert queued > STEPS // 2, queued
    if not fcfs:
        assert tied > STEPS // 2 and conflicts > 0, (tied, conflicts)
        assert load > 0.6 or denied > STEPS // 40, denied
