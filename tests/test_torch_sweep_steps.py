"""Step parity of the batched slot step (the grid's), cell by cell.

Four cells in one batched step (both route modes for Balanced-Pandas): uniform and rack_outage, realized against
one canonical pad and stacked (``scenarios.stack_scenarios``), each at
loads 0.6 and 0.9.  From a mid-run JAX state of every cell, the port's
batched step (all four cells at once, on the stacked scenario's per-cell
[N, M, 3] speeds and rates) and the JAX step of each cell run side by side
on the CPU for 240 slots, the port fed every cell's JAX draws through the
seam (tests/_torch_scenario_steps.py derives them).  Every cell's state and
accumulators must equal its JAX step's after every slot, with no tolerance.
Every row of the stack also equals the reference's padded realization of
its scenario, leaf by leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_scenario_steps import (CL_J, CL_T, M, R_J, R_T, STEPS, T, T0, WARMUP,
                                   _jax_draws, _jax_step, _port_draws)
from _torch_sim_helpers import one_thread
from repro.core import simulator as jsim
from repro.scenarios import build as jbuild
from repro.scenarios.spec import get_scenario
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim
from repro_torch.scenarios import build as tbuild

NAMES = ("uniform", "rack_outage")
LOADS = (0.6, 0.9)
CELLS = [(s, l) for s in range(len(NAMES)) for l in LOADS]      # cell n -> (row, load)
CASES = [(a, "batched") for a in ("balanced_pandas", "balanced_pandas_pod",
                                   "jsq_maxweight_pod", "fcfs")]
CASES.append(("balanced_pandas", "sequential"))


def _stack(draws):
    """Slot draws of the cells, each field stacked on a leading [N]."""
    return type(draws[0])(*(None if xs[0] is None else torch.stack(xs)
                            for xs in zip(*draws)))


@pytest.mark.parametrize("algo,mode", CASES, ids=[f"{a}-{m}" for a, m in CASES])
def test_batched_step_matches_jax_cell_by_cell(algo, mode):
    with one_thread():
        _run(algo, mode)


def _run(algo, mode):
    cfg_j = jsim.SimConfig(T=T, warmup=WARMUP, route_mode=mode)
    cfg_t = tsim.SimConfig(T=T, warmup=WARMUP, route_mode=mode)
    tpad = tbuild.canonical_pad(CL_T)         # the port's registry: no trace entry
    jpad = jbuild.ScenarioPad(*tpad)
    jscens = [jbuild.realize(get_scenario(n), CL_J, R_J, T, pad=jpad) for n in NAMES]
    stacked, caps = tbuild.stack_scenarios(NAMES, CL_T, R_T, T, tpad, device="cpu")
    assert caps.tolist() == [c for _, c in jscens]
    lams = [jnp.float32(load * jscens[s][1]) for s, load in CELLS]
    a_max = max(cfg_j.resolve_a_max(float(l), float(np.max(np.asarray(jscens[s][0].lam_shape))))
                for (s, _), l in zip(CELLS, lams))
    pod_j, pod_t = jsim._pod_for(algo, None), tsim._pod_for(algo, None)
    family = tsim._family(algo)
    key = jax.random.PRNGKey(41)
    jkind = {"bp": jsim.BPState, "sq": jsim.SQState, "fcfs": jsim.FCFSState}[family]
    step = functools.partial(_jax_step, algo=algo, pod=pod_j, a_max=a_max, cfg=cfg_j,
                             homo=False)
    jstates, jsums = [], []
    for (s, _), lam in zip(CELLS, lams):
        state, sums = jkind.zero(M), jsim.RawSums.zero()
        for t in range(T0):
            state, sums = step(state, sums, key, t, lam, jscens[s][0])
        jstates.append(state)
        jsums.append(sums)
    tkind = {"bp": tsim.BPState, "sq": tsim.SQState, "fcfs": tsim.FCFSState}[family]
    tstate = tkind(*(torch.stack([torch.from_numpy(np.array(js[f])) for js in jstates])
                     for f in range(4)))
    tsums = tsim.RawSums(*(torch.stack([torch.from_numpy(np.array(js[f])) for js in jsums])
                           for f in range(13)))
    consts = tsim.step_consts(CL_T, R_T, pod_t, a_max, "cpu")
    rate_vec = R_T.as_array()
    rows = torch.tensor([s for s, _ in CELLS])
    half2_from = cfg_t.warmup + (cfg_t.T - cfg_t.warmup) // 2
    for t in range(T0, T0 + STEPS):
        speed = tbuild.speed_at(stacked, t)[rows]                        # [N, M, 3]
        kw = dict(cluster=CL_T, cfg=cfg_t, a_max=a_max, measure=t >= cfg_t.warmup,
                  in_half2=t >= half2_from, speed=speed)
        d = _stack([_port_draws(algo, mode, _jax_draws(
            key, t, lam, jscens[s][0], algo=algo, pod=pod_j, a_max=a_max, sized=False))
            for (s, _), lam in zip(CELLS, lams)])
        if family == "bp":
            tstate, tsums = tsim._bp_step(tstate, tsums, d, pod=pod_t,
                                          inv_rate_m=tcl.safe_inv_rates(speed * rate_vec),
                                          **kw)
        elif family == "sq":
            tstate, tsums = tsim._sq_step(tstate, tsums, d, consts=consts,
                                          variant="maxweight", pod=pod_t, **kw)
        else:
            tstate, tsums = tsim._fcfs_step(tstate, tsums, d, consts=consts, **kw)
        for n, ((s, _), lam) in enumerate(zip(CELLS, lams)):
            jstates[n], jsums[n] = step(jstates[n], jsums[n], key, t, lam, jscens[s][0])
            for name, a, b in zip(tkind._fields, tstate, jstates[n]):
                np.testing.assert_array_equal(a[n].numpy(), np.asarray(b),
                                              err_msg=f"slot {t} cell {n}: {name}")
            for name, a, b in zip(tsim.RawSums._fields, tsums, jsums[n]):
                np.testing.assert_array_equal(a[n].numpy(), np.asarray(b),
                                              err_msg=f"slot {t} cell {n}: {name}")
    assert all(float(s.arrivals) > 0 for s in jsums)
    # the stack's rows are the reference's padded realizations, leaf by leaf
    for s, (jscen, _) in enumerate(jscens):
        for name, a in zip(tbuild.ScenarioData._fields, tbuild.scenario_row(stacked, s)):
            b = getattr(jscen, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
