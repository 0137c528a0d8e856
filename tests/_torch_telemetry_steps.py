"""Shared body of the telemetry step-parity tests
(tests/test_torch_telemetry_steps*.py): the port's slot steps with the
collectors on, against the JAX reference's, slot by slot.  The cases are
split over files (family x scenario) so that no file runs long.

As in tests/_torch_scenario_steps.py: the reference runs a prefix of T0
slots with its telemetry on; its state, sums and Telemetry go across as
numpy; then both steps run side by side for 240 slots, the port fed the
reference's own draws through the seam (its key derivation is reproduced
here for every family and both route modes, the sequential path's
per-arrival keys included).  After every slot:

  exact    the state, every RawSums field, the rings, head, tail,
           cur_arr, sojourn_dropped, every count channel of the windows
           (slots, sum_N, the queue masses, completions, busy, arrivals,
           clipped, probe_rank, probe_decisions), the window maxima, and
           every histogram bin (queue length, workload, sojourn): the
           port's ``bin_index`` is the reference's float32 bins exactly,
           so no value moves across an edge (the count of moved values is
           asserted to be 0);
  rtol     w_mean (a float mean over M, summed in another order):
           relative 1e-6; w_max and probe_regret (float sums over a
           batch): relative 1e-6.

Scenarios: ``uniform`` (the homogeneous path) and ``slow_rack`` (the [M, 3]
rate operand and the speed gathers on every slot).
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
from repro.telemetry import collectors as jtlm
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim
from repro_torch.scenarios import build as tbuild
from repro_torch.telemetry import collectors as ttlm

M, K = 20, 4
RATES = (0.1, 0.05, 0.02)
T0, STEPS = 120, 240        # reference-only prefix, then side-by-side slots
T, WARMUP = T0 + STEPS, 60
LOAD = 0.9
CL_J, CL_T = jcl.Cluster(M=M, K=K), tcl.Cluster(M=M, K=K)
R_J, R_T = jcl.Rates(*RATES), tcl.Rates(*RATES)
TCFG_J = jtlm.TelemetryConfig(n_windows=16)
TCFG_T = ttlm.TelemetryConfig(n_windows=16)
MODES = ("batched", "sequential")
# window channels held within a relative tolerance; every other one exactly
FLOAT_CHANNELS = ("w_mean", "w_max", "probe_regret")
RTOL = 1e-6


def _durations(key, n):
    """int32 [n, 3]: the reference's durations for n tasks from ``key``,
    evaluated for every class."""
    return jnp.stack([jcl.sample_durations(key, jnp.full((n,), c, jnp.int32), R_J)
                      for c in range(3)], axis=1)


@functools.partial(jax.jit, static_argnames=("algo", "pod", "a_max", "S",
                                             "sequential"))
def _jax_draws(key, t, lam, scen, *, algo, pod, a_max, S, sequential):
    """Slot t's draws by the reference's key derivation, every family."""
    k = jax.random.fold_in(key, t)
    pe = jbuild.placement_epoch_at(scen, t)
    lam_t = lam * scen.lam_shape[t]
    if algo == "fcfs":
        k_rank, k_loc, k_dur, k_arr = jax.random.split(k, 4)
        k_n, _ = jax.random.split(k_arr)
        return dict(raw=jax.random.poisson(k_n, lam_t),
                    rank=jax.random.uniform(k_rank, (M,)),
                    locals_=jbuild.sample_locals_scenario(k_loc, CL_J, scen, S, pe=pe),
                    dur=_durations(k_dur, S))
    k_sched, k_arr, k_route = jax.random.split(k, 3)
    k_n, k_loc = jax.random.split(k_arr)
    raw = jax.random.poisson(k_n, lam_t)
    locals_ = jbuild.sample_locals_scenario(k_loc, CL_J, scen, a_max, pe=pe)
    if algo.startswith("jsq"):
        k_rows, k_cand, k_tie, k_grant, k_dur = jax.random.split(k_sched, 5)
        out = dict(raw=raw, locals_=locals_, dur=_durations(k_dur, S),
                   tie=jax.random.uniform(k_tie, (S, M if pod is None else 1 + pod.d)),
                   grant=jax.random.uniform(k_grant, (S,)))
        if S < M:
            out["rows"] = jax.random.uniform(k_rows, (M,))
        if pod is not None:
            R = CL_J.rack_size
            hi = jnp.array([R - 1] * pod.d_rack + [M - R] * pod.d_remote, jnp.int32)
            out["cand"] = jax.random.randint(k_cand, (S, pod.d), 0, hi[None, :])
        if sequential:
            keys = jax.random.split(k_route, a_max)
            out["route"] = jax.vmap(
                lambda kr: jax.random.uniform(kr, (CL_J.n_replicas,)))(keys)
        return out
    k_tie, k_pod, k_seq = jax.random.split(k_route, 3)
    cls = jcl.locality_class(CL_J, locals_)
    out = dict(raw=raw, locals_=locals_, cls=cls, dur=_durations(k_sched, M))
    if pod is None:
        if sequential:
            out["tie_rnd"] = jax.random.uniform(k_tie, (M,))
        else:
            out["prio"] = jax.random.permutation(k_tie, M)
    elif sequential:
        # per arrival: split(k_seq, A)[b] -> (kc: its candidates, kt: ties)
        def one(kr, loc, c):
            kc, kt = jax.random.split(kr)
            ci, _cc, cv = jpol.pod_candidates(kc, CL_J, loc, c, pod)
            return ci, cv, jax.random.uniform(kt, ci.shape)
        ci, cv, rnd = jax.vmap(one)(jax.random.split(k_seq, a_max), locals_, cls)
        out.update(cand_idx=ci, cand_valid=cv, cand_rnd=rnd)
    else:
        kc, _ = jax.random.split(k_pod)
        ci, _cc, cv = jpol.pod_candidates(kc, CL_J, locals_, cls, pod)
        out.update(cand_idx=ci, cand_valid=cv)
    return out


@functools.partial(jax.jit, static_argnames=("algo", "pod", "a_max", "cfg", "homo"))
def _jax_step(state, sums, tele, key, t, lam, scen, *, algo, pod, a_max, cfg, homo):
    """One slot of the reference with its collectors, as its ``_run``
    drives it."""
    half2_from = cfg.warmup + (cfg.T - cfg.warmup) // 2
    speed = jbuild.speed_at(scen, t)
    kw = dict(cluster=CL_J, rates=R_J, cfg=cfg, lam_t=lam * scen.lam_shape[t],
              scen=scen, speed=speed,
              inv_rate_m=(jcl.safe_inv_rates(R_J.as_array()) if homo
                          else jcl.inv_rate_matrix(R_J, speed)),
              a_max=a_max, measure=t >= cfg.warmup, in_half2=t >= half2_from,
              homo=homo, t=t, tele=tele, tcfg=TCFG_J)
    k = jax.random.fold_in(key, t)
    family = jsim._family(algo)
    if family == "fcfs":
        return jsim._fcfs_step(state, sums, k, **kw)
    if family == "sq":
        variant = "priority" if algo == "jsq_priority" else "maxweight"
        return jsim._sq_step(state, sums, k, variant=variant, pod=pod, **kw)
    return jsim._bp_step(state, sums, k, pod=pod,
                         class_tiebreak=algo != "balanced_pandas_randomtie", **kw)


_DTYPES = dict(raw=torch.int32, locals_=torch.int32, cls=torch.int32,
               dur=torch.int32, prio=torch.int32, cand=torch.int32,
               cand_idx=torch.int32, cand_valid=torch.bool)


def _port_draws(family, d):
    kind = {"bp": tsim.SlotDraws, "sq": tsim.SQDraws, "fcfs": tsim.FCFSDraws}[family]
    return kind(**{k: torch.from_numpy(np.array(v)).to(_DTYPES.get(k, torch.float32))
                   for k, v in d.items()})


def port_telemetry(jtele) -> ttlm.Telemetry:
    """The reference's Telemetry as the port's (writable tensor copies)."""
    return ttlm.Telemetry(*(None if x is None else torch.from_numpy(np.array(x))
                            for x in jtele))


def assert_telemetry_equal(ttele, jtele, where):
    """Every leaf as the module docstring says: exact, or within RTOL for
    the float window channels; histogram bins exact (0 moved values)."""
    for name, a, b in zip(ttlm.Telemetry._fields, ttele, jtele):
        assert (a is None) == (b is None), (where, name)
        if a is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        if name == "win":
            for c, ch in enumerate(ttlm.WINDOW_SUMS):
                if ch in FLOAT_CHANNELS:
                    np.testing.assert_allclose(a[..., c], b[..., c], rtol=RTOL,
                                               err_msg=f"{where}: win {ch}")
                else:
                    np.testing.assert_array_equal(a[..., c], b[..., c],
                                                  err_msg=f"{where}: win {ch}")
        elif name == "win_max":
            np.testing.assert_array_equal(a[..., 0], b[..., 0], err_msg=f"{where}: max_N")
            np.testing.assert_allclose(a[..., 1], b[..., 1], rtol=RTOL,
                                       err_msg=f"{where}: max_w")
        elif name.endswith("_hist"):
            moved = int(np.abs(a - b).sum())
            assert moved == 0, (where, name, "values moved across an edge", moved)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")


def _assert_state_sums(jstate, jsums, tstate, tsums, t):
    for name, a, b in zip(type(tstate)._fields, tsim.state_to_numpy(tstate), jstate):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"slot {t}: {name}")
    for name, a, b in zip(tsim.RawSums._fields, tsim.raw_sums_to_numpy(tsums), jsums):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"slot {t}: {name}")


def cases(algos, scenario):
    """(algo, route mode) for both modes, and pytest ids."""
    c = [(a, m) for m in MODES for a in algos]
    return c, [f"{a}-{m}-{scenario}" for a, m in c]


def run_case(algo, mode, scenario):
    """STEPS slots side by side; everything equal after every slot."""
    with one_thread():
        return _run_case(algo, mode, scenario)


def _run_case(algo, mode, scenario):
    cfg_j = jsim.SimConfig(T=T, warmup=WARMUP, route_mode=mode)
    cfg_t = tsim.SimConfig(T=T, warmup=WARMUP, route_mode=mode)
    jscen, lam_cap = jbuild.realize(jspec.get_scenario(scenario), CL_J, R_J, T)
    tscen = tbuild.scenario_from_numpy(jscen)
    homo = jsim._rates_homogeneous(jscen)
    assert tsim._rates_homogeneous(tscen) == homo == (scenario == "uniform")
    lam = LOAD * lam_cap if algo != "fcfs" else 0.15 * lam_cap
    a_max = cfg_j.resolve_a_max(lam, float(np.max(np.asarray(jscen.lam_shape))))
    lam = jnp.float32(lam)
    pod_j, pod_t = jsim._pod_for(algo, None), tsim._pod_for(algo, None)
    family = tsim._family(algo)
    S = min(cfg_t.s_max, M)
    key = jax.random.PRNGKey(23)
    jstate = {"bp": jsim.BPState, "sq": jsim.SQState,
              "fcfs": jsim.FCFSState}[family].zero(M)
    jsums = jsim.RawSums.zero()
    jtele = jtlm.zero_telemetry(TCFG_J, M, family)
    step = functools.partial(_jax_step, algo=algo, pod=pod_j, a_max=a_max,
                             cfg=cfg_j, homo=homo)
    for t in range(T0):
        jstate, jsums, jtele = step(jstate, jsums, jtele, key, t, lam, jscen)
    kind = {"bp": tsim.BPState, "sq": tsim.SQState, "fcfs": tsim.FCFSState}[family]
    tstate = tsim.state_from_numpy(kind, [np.asarray(x) for x in jstate])
    tsums = tsim.raw_sums_from_numpy([np.asarray(x) for x in jsums])
    ttele = port_telemetry(jtele)
    consts = tsim.step_consts(CL_T, R_T, pod_t, a_max, "cpu")
    rate_vec = R_T.as_array()
    half2_from = cfg_t.warmup + (cfg_t.T - cfg_t.warmup) // 2
    for t in range(T0, T):
        speed = tbuild.speed_at(tscen, t)
        kw = dict(cluster=CL_T, cfg=cfg_t, a_max=a_max, measure=t >= cfg_t.warmup,
                  in_half2=t >= half2_from, speed=None if homo else speed,
                  scen=tscen, t=t, tele=ttele, tcfg=TCFG_T)
        d = _port_draws(family, _jax_draws(key, t, lam, jscen, algo=algo, pod=pod_j,
                                           a_max=a_max, S=S,
                                           sequential=mode == "sequential"))
        if family == "bp":
            inv = tcl.safe_inv_rates(rate_vec if homo else speed * rate_vec[None, :])
            tstate, tsums = tsim._bp_step(
                tstate, tsums, d, inv_rate_m=inv, pod=pod_t,
                class_tiebreak=algo != "balanced_pandas_randomtie", **kw)
        elif family == "sq":
            tstate, tsums = tsim._sq_step(
                tstate, tsums, d, consts=consts, pod=pod_t,
                variant="priority" if algo == "jsq_priority" else "maxweight", **kw)
        else:
            tstate, tsums = tsim._fcfs_step(tstate, tsums, d, consts=consts, **kw)
        jstate, jsums, jtele = step(jstate, jsums, jtele, key, t, lam, jscen)
        _assert_state_sums(jstate, jsums, tstate, tsums, t)
        assert_telemetry_equal(ttele, jtele, f"slot {t}")
    return ttele
