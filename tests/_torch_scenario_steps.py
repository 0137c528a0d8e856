"""Shared body of the scenario step-parity tests
(tests/test_torch_sim_scenario_steps*.py): the port's slot steps on
heterogeneous scenarios against the JAX reference.  The cases are split
over two files so that no file runs long.

Step parity, as tests/test_torch_simulator.py and tests/test_torch_sq.py
hold it on ``uniform``: the reference realizes the scenario, its arrays go
across as numpy (``scenario_from_numpy``), and from a mid-run JAX state the
JAX step and the port's step run side by side on the CPU for 240 slots,
the port fed the JAX step's own draws through the seam (the JAX key
derivation is reproduced here, the replica triples drawn by the
reference's ``sample_locals_scenario`` and the size law's normals by its
salted fold).  Queues, servers and every accumulator must be equal after
every slot, with no tolerance.

Scenarios: ``slow_rack`` (persistent speeds, the [M, 3] rate operand all
slots), ``rack_outage`` (rack 0 drained for slots 180-219 of 400: the run
crosses the window both ways, with ``+inf`` inverse rates on the main
path), ``zipf_hotspot`` (skewed placement) and ``slow_rack`` composed with
a lognormal size law (sigma 0.8, the size multiplier on every start).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_sim_helpers import one_thread
from repro.core import cluster as jcl
from repro.core import policies as jpol
from repro.core import simulator as jsim
from repro.scenarios import build as jbuild
from repro.scenarios import spec as jspec
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim
from repro_torch.scenarios import build as tbuild
from repro_torch.scenarios import spec as tspec

M, K = 20, 4
RATES = (0.1, 0.05, 0.02)
T0, STEPS = 160, 240        # JAX-only prefix, then side-by-side slots
T, WARMUP = T0 + STEPS, 60
CL_J, CL_T = jcl.Cluster(M=M, K=K), tcl.Cluster(M=M, K=K)
R_J, R_T = jcl.Rates(*RATES), tcl.Rates(*RATES)
SIGMA = 0.8
SCENARIOS = ("slow_rack", "rack_outage", "zipf_hotspot", "slow_rack+sized")


def _scenario(spec, name):
    """The named scenario in one package's spec module; "slow_rack+sized"
    composes slow_rack with a lognormal size law."""
    if name == "slow_rack+sized":
        return spec.compose("slow_rack", spec.Scenario(
            "sized", sizes=spec.SizeSpec(sigma=SIGMA)))
    return spec.get_scenario(name)


def _durations(key, n):
    """int32 [n, 3]: the reference's durations for n tasks from ``key``,
    evaluated for every class (the uniforms depend on key and shape only)."""
    return jnp.stack([jcl.sample_durations(key, jnp.full((n,), c, jnp.int32), R_J)
                      for c in range(3)], axis=1)


def _size_e(key, n, sized):
    """The size law's draws as the reference's ``_task_work`` uses them:
    its normal is sqrt(2) * erfinv(u), and its compiled program folds the
    sqrt(2) into sigma, so the seam carries erfinv(u) (see
    ``repro_torch.core.simulator._task_work``)."""
    if not sized:
        return {}
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = jax.random.uniform(jax.random.fold_in(key, 7), (n,), jnp.float32, lo, 1.0)
    return {"size_e": jax.lax.erf_inv(u)}


@functools.partial(jax.jit, static_argnames=("algo", "pod", "a_max", "sized"))
def _jax_draws(key, t, lam, scen, *, algo, pod, a_max, sized):
    """Slot t's draws by the reference's key derivation (see
    tests/test_torch_simulator.py and tests/test_torch_sq.py), with the
    replica triples under the scenario's placement law."""
    k = jax.random.fold_in(key, t)
    pe = jbuild.placement_epoch_at(scen, t)
    if algo == "fcfs":
        k_rank, k_loc, k_dur, k_arr = jax.random.split(k, 4)
        k_n, _ = jax.random.split(k_arr)
        return dict(raw=jax.random.poisson(k_n, lam * scen.lam_shape[t]),
                    rank=jax.random.uniform(k_rank, (M,)),
                    locals_=jbuild.sample_locals_scenario(k_loc, CL_J, scen, M, pe=pe),
                    dur=_durations(k_dur, M), **_size_e(k_dur, M, sized))
    k_sched, k_arr, k_route = jax.random.split(k, 3)
    k_n, k_loc = jax.random.split(k_arr)
    raw = jax.random.poisson(k_n, lam * scen.lam_shape[t])
    locals_ = jbuild.sample_locals_scenario(k_loc, CL_J, scen, a_max, pe=pe)
    if algo == "jsq_maxweight_pod":
        _k_rows, k_cand, k_tie, k_grant, k_dur = jax.random.split(k_sched, 5)
        R = CL_J.rack_size
        hi = jnp.array([R - 1] * pod.d_rack + [M - R] * pod.d_remote, jnp.int32)
        return dict(raw=raw, locals_=locals_, dur=_durations(k_dur, M),
                    tie=jax.random.uniform(k_tie, (M, 1 + pod.d)),
                    grant=jax.random.uniform(k_grant, (M,)),
                    cand=jax.random.randint(k_cand, (M, pod.d), 0, hi[None, :]),
                    **_size_e(k_dur, M, sized))
    k_tie, k_pod, _k_seq = jax.random.split(k_route, 3)
    cls = jcl.locality_class(CL_J, locals_)
    out = dict(raw=raw, locals_=locals_, cls=cls, dur=_durations(k_sched, M),
               prio=jax.random.permutation(k_tie, M),
               tie_rnd=jax.random.uniform(k_tie, (M,)), **_size_e(k_sched, M, sized))
    if pod is not None:
        kc, _ = jax.random.split(k_pod)
        ci, _cc, cv = jpol.pod_candidates(kc, CL_J, locals_, cls, pod)
        out.update(cand_idx=ci, cand_valid=cv)
    return out


@functools.partial(jax.jit, static_argnames=("algo", "pod", "a_max", "cfg", "homo"))
def _jax_step(state, sums, key, t, lam, scen, *, algo, pod, a_max, cfg, homo):
    """One slot of the reference, as its ``_run`` drives it."""
    half2_from = cfg.warmup + (cfg.T - cfg.warmup) // 2
    speed = jbuild.speed_at(scen, t)
    kw = dict(cluster=CL_J, rates=R_J, cfg=cfg, lam_t=lam * scen.lam_shape[t],
              scen=scen, speed=speed, inv_rate_m=jcl.inv_rate_matrix(R_J, speed),
              a_max=a_max, measure=t >= cfg.warmup, in_half2=t >= half2_from,
              homo=homo, t=t)
    k = jax.random.fold_in(key, t)
    if algo == "fcfs":
        state, sums, _ = jsim._fcfs_step(state, sums, k, **kw)
    elif algo == "jsq_maxweight_pod":
        state, sums, _ = jsim._sq_step(state, sums, k, variant="maxweight",
                                       pod=pod, **kw)
    else:
        state, sums, _ = jsim._bp_step(state, sums, k, pod=pod, **kw)
    return state, sums


_DTYPES = dict(raw=torch.int32, locals_=torch.int32, cls=torch.int32,
               dur=torch.int32, prio=torch.int32, cand=torch.int32,
               cand_idx=torch.int32, cand_valid=torch.bool)


def _port_draws(algo, mode, d):
    kind = {"fcfs": tsim.FCFSDraws, "jsq_maxweight_pod": tsim.SQDraws}.get(
        algo, tsim.SlotDraws)
    if kind is tsim.SlotDraws:
        drop = ("tie_rnd",) if mode == "batched" else ("prio",)
        d = {k: v for k, v in d.items() if k not in drop}
    return kind(**{k: torch.from_numpy(np.array(v)).to(_DTYPES.get(k, torch.float32))
                   for k, v in d.items()})


def _assert_same(jstate, jsums, tstate, tsums, t):
    for name, a, b in zip(type(tstate)._fields, tsim.state_to_numpy(tstate), jstate):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"slot {t}: {name}")
    for name, a, b in zip(tsim.RawSums._fields, tsim.raw_sums_to_numpy(tsums), jsums):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"slot {t}: {name}")


def cases(algos):
    """(algo, route mode, scenario) for every scenario, and pytest ids."""
    c = [(a, m, s) for s in SCENARIOS for a, m in algos]
    return c, [f"{a}-{m}-{s}" for a, m, s in c]


def run_case(algo, mode, scenario):
    """240 slots side by side; state and sums equal after every slot."""
    with one_thread():
        _run_case(algo, mode, scenario)


def _run_case(algo, mode, scenario):
    cfg_j = jsim.SimConfig(T=T, warmup=WARMUP, route_mode=mode)
    cfg_t = tsim.SimConfig(T=T, warmup=WARMUP, route_mode=mode)
    jscen, lam_cap = jbuild.realize(_scenario(jspec, scenario), CL_J, R_J, T)
    tscen = tbuild.scenario_from_numpy(jscen)
    _, tcap = tbuild.realize(_scenario(tspec, scenario), CL_T, R_T, T, device="cpu")
    assert tcap == lam_cap
    homo = jsim._rates_homogeneous(jscen)
    assert tsim._rates_homogeneous(tscen) == homo == (scenario == "zipf_hotspot")
    sized = scenario.endswith("sized")
    lam = 0.9 * lam_cap
    a_max = cfg_j.resolve_a_max(lam, float(np.max(np.asarray(jscen.lam_shape))))
    lam = jnp.float32(lam)
    pod_j, pod_t = jsim._pod_for(algo, None), tsim._pod_for(algo, None)
    family = tsim._family(algo)
    key = jax.random.PRNGKey(31)
    jstate = {"bp": jsim.BPState, "sq": jsim.SQState,
              "fcfs": jsim.FCFSState}[family].zero(M)
    jsums = jsim.RawSums.zero()
    step = functools.partial(_jax_step, algo=algo, pod=pod_j, a_max=a_max,
                             cfg=cfg_j, homo=homo)
    for t in range(T0):
        jstate, jsums = step(jstate, jsums, key, t, lam, jscen)
    kind = {"bp": tsim.BPState, "sq": tsim.SQState, "fcfs": tsim.FCFSState}[family]
    tstate = tsim.state_from_numpy(kind, [np.asarray(x) for x in jstate])
    tsums = tsim.raw_sums_from_numpy([np.asarray(x) for x in jsums])
    consts = tsim.step_consts(CL_T, R_T, pod_t, a_max, "cpu")
    rate_vec = R_T.as_array()
    half2_from = cfg_t.warmup + (cfg_t.T - cfg_t.warmup) // 2
    dead = queued = 0
    for t in range(T0, T0 + STEPS):
        speed = tbuild.speed_at(tscen, t)
        np.testing.assert_array_equal(speed.numpy(), np.asarray(jbuild.speed_at(jscen, t)))
        kw = dict(cluster=CL_T, cfg=cfg_t, a_max=a_max, measure=t >= cfg_t.warmup,
                  in_half2=t >= half2_from, speed=None if homo else speed,
                  scen=tscen)
        d = _port_draws(algo, mode, _jax_draws(key, t, lam, jscen, algo=algo,
                                               pod=pod_j, a_max=a_max, sized=sized))
        if family == "bp":
            inv = tcl.safe_inv_rates(rate_vec if homo else speed * rate_vec[None, :])
            tstate, tsums = tsim._bp_step(
                tstate, tsums, d, inv_rate_m=inv, pod=pod_t, **kw)
        elif family == "sq":
            tstate, tsums = tsim._sq_step(tstate, tsums, d, consts=consts,
                                          variant="maxweight", pod=pod_t, **kw)
        else:
            tstate, tsums = tsim._fcfs_step(tstate, tsums, d, consts=consts, **kw)
        jstate, jsums = step(jstate, jsums, key, t, lam, jscen)
        _assert_same(jstate, jsums, tstate, tsums, t)
        dead += int((speed == 0).any())
        queued += int(tstate[0].sum() > 0)
    assert queued > STEPS // 2, queued
    assert (dead == 40) == (scenario == "rack_outage"), dead
