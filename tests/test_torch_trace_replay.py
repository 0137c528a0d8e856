"""The port's ReplayEngine against the JAX reference's, on the CPU.

Chunk-step parity: both engines pack the same log (their arrival tensors
must be equal), then chunk by chunk the reference's ``_replay_chunk`` and
the port's run side by side, the port fed the reference's own draws
through the chunk seam (candidates from the chunk key, then each slot's
durations, size-law draws and tie permutation, by the reference's key
derivation).  State, every RawSums field and the telemetry must be equal
after every chunk, with no tolerance (M=8, T=256, 64-slot chunks, both
algorithms, telemetry on).

A CPU run holds the gates ``chip_smoke.py`` holds on the card: every task
routed, the mean finite, throughput within 5% of arrivals, the windows'
arrivals summing to the trace's tasks, valid telemetry events; with an odd
number of chunks (5).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sim_helpers import one_thread
from repro.core import cluster as jcl
from repro.core import policies as jpol
from repro.core import simulator as jsim
from repro.telemetry import collectors as jtlm
from repro.trace import replay as jreplay
from repro.trace import synth_trace as jsynth
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim
from repro_torch.telemetry import collectors as ttlm
from repro_torch.telemetry import export as texp
from repro_torch.trace import replay as treplay
from repro_torch.trace import synth_trace as tsynth

M, K = 8, 2
T, WARMUP, CHUNK = 256, 64, 64
CL_J, CL_T = jcl.Cluster(M=M, K=K), tcl.Cluster(M=M, K=K)
R_J, R_T = jcl.Rates(), tcl.Rates()
SEED = 4


def _log(pkg_synth, n=600):
    return pkg_synth(name="small", n_tasks=n, seed=3, churn_t=(0.5,), n_tenants=2,
                     n_chunks=64)


def _durations(key):
    return jnp.stack([jcl.sample_durations(key, jnp.full((M,), c, jnp.int32), R_J)
                      for c in range(3)], axis=1)


def _size_e(key):
    """The size law's draw as the port's ``_task_work`` takes it: the
    reference's normal is sqrt(2) * erfinv(u), its program folds the
    sqrt(2) into sigma (see repro_torch.core.simulator._task_work)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = jax.random.uniform(jax.random.fold_in(key, 7), (M,), jnp.float32, lo, 1.0)
    return jax.lax.erf_inv(u)


def _chunk_draws(key_c, locals_c, full_bp, pod):
    """The reference's chunk draws: split off the candidates' key (pod),
    then slot s of the chunk draws from fold_in(key, s) -> (k_sched,
    k_tie)."""
    out = {}
    key = key_c
    if not full_bp:
        k_cand, key = jax.random.split(key)
        cls_c = jcl.locality_class(CL_J, locals_c)
        ci, _cc, cv = jpol.pod_candidates(k_cand, CL_J, locals_c, cls_c, pod)
        out.update(cand_idx=np.asarray(ci), cand_valid=np.asarray(cv))
    ks = [jax.random.split(jax.random.fold_in(key, s)) for s in range(CHUNK)]
    out["dur"] = np.stack([np.asarray(_durations(k[0])) for k in ks])
    out["size_e"] = np.stack([np.asarray(_size_e(k[0])) for k in ks])
    if full_bp:
        out["prio"] = np.stack([np.asarray(jax.random.permutation(k[1], M)) for k in ks])
    return treplay.ReplayDraws(**{k: torch.from_numpy(np.array(v)) for k, v in out.items()})


@pytest.mark.filterwarnings("ignore:Some donated buffers were not usable")
@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod"])
def test_chunk_step_equals_the_reference_given_its_draws(algo):
    cfg_j = jsim.SimConfig(T=T, warmup=WARMUP)
    cfg_t = tsim.SimConfig(T=T, warmup=WARMUP)
    tcfg_j = jtlm.TelemetryConfig(n_windows=16)
    eng_j = jreplay.ReplayEngine(_log(jsynth), CL_J, R_J, cfg=cfg_j, algo=algo,
                                 chunk_slots=CHUNK, telemetry=tcfg_j)
    eng_t = treplay.ReplayEngine(_log(tsynth), CL_T, R_T, cfg=cfg_t, algo=algo,
                                 chunk_slots=CHUNK,
                                 telemetry=ttlm.TelemetryConfig(n_windows=16),
                                 device="cpu")
    assert (eng_t.n_chunks, eng_t.a_cap, eng_t.load) == (eng_j.n_chunks, eng_j.a_cap,
                                                         eng_j.load)
    for c in range(eng_j.n_chunks):
        np.testing.assert_array_equal(eng_t._host_chunk(c)[0].numpy(), eng_j._chunks[c][0])
        np.testing.assert_array_equal(eng_t._host_chunk(c)[1].numpy(), eng_j._chunks[c][1])
    full_bp = algo == "balanced_pandas"
    kw_j = eng_j._step_kwargs()
    kw_t = dict(cluster=CL_T, cfg=cfg_t, pod=eng_t.pod, tcfg=eng_t.tcfg,
                t_pad=eng_t._t_pad,
                inv_rates=tcl.safe_inv_rates(R_T.as_array()), cand_cls=eng_t._cand_cls)
    state_j, sums_j = jsim.BPState.zero(M), jsim.RawSums.zero()
    tele_j = jtlm.zero_telemetry(eng_j.tcfg, M, "bp")
    state_t = tsim.BPState.zero(M, "cpu", 1)
    sums_t = tsim.RawSums.zero("cpu", 1)
    tele_t = ttlm.zero_telemetry(eng_t.tcfg, M, "bp", cells=1)
    key = jax.random.PRNGKey(SEED)
    with one_thread():
        for c, locals_c, mask_c in eng_t._chunks():
            key_c = jax.random.fold_in(key, c)
            loc_j = jnp.asarray(eng_j._chunks[c][0])
            draws = _chunk_draws(key_c, loc_j, full_bp, eng_j.pod)
            state_t, sums_t = treplay._replay_chunk(
                state_t, sums_t, tele_t, tcl.locality_class(CL_T, locals_c), mask_c,
                c * CHUNK, eng_t.scen, draws, **kw_t)
            state_j, sums_j, tele_j = jreplay._replay_chunk(
                state_j, sums_j, tele_j, jnp.array(eng_j._chunks[c][0]),
                jnp.array(eng_j._chunks[c][1]), jnp.int32(c * CHUNK), eng_j._sizes,
                key_c, **kw_j)
            for name, a, b in zip(tsim.BPState._fields, state_t, state_j):
                np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                              err_msg=f"chunk {c}: {name}")
            for name, a, b in zip(tsim.RawSums._fields, sums_t, sums_j):
                np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                              err_msg=f"chunk {c}: {name}")
            for name, a, b in zip(ttlm.Telemetry._fields, tele_t, tele_j):
                assert (a is None) == (b is None), name
                if a is None:
                    continue
                if name == "win":        # w_mean: a float mean over M
                    np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-6,
                                               err_msg=f"chunk {c}: {name}")
                else:
                    np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                                  err_msg=f"chunk {c}: {name}")
    assert float(sums_t.completions[0]) > 0 and float(sums_t.sum_N[0]) > 0
    res_t = tsim.summarize(tsim._drop(sums_t), algo, CL_T, R_T, eng_t.pod)
    res_j = jsim.summarize(sums_j, algo, CL_J, R_J, eng_j.pod)
    for name, a, b in zip(res_t._fields, res_t, res_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod"])
def test_cpu_replay_run_holds_the_smoke_gates(algo):
    """Five chunks (an odd count); the trace sized to load ~0.45."""
    cfg = tsim.SimConfig(T=5 * 400 - 10, warmup=200)
    cl, rates = tcl.Cluster(M=16, K=4), tcl.Rates(0.05, 0.025, 0.01)
    make = lambda n: treplay.ReplayEngine(
        tsynth(name="g", n_tasks=n, seed=8, churn_t=(0.4,), n_chunks=64), cl, rates,
        cfg=cfg, algo=algo, chunk_slots=400, telemetry=ttlm.TelemetryConfig(),
        device="cpu")
    eng = make(int(1000 * 0.45 / make(1000).load))
    log = eng.log
    assert eng.n_chunks == 5 and 0.4 < eng.load < 0.5
    with one_thread():
        res = eng.run(seed=1)
        again = eng.benchmark(seed=1)
    assert res.routed_tasks == log.n_tasks and res.trace_count == 0
    assert res.wall_s > 0 and res.tasks_per_s > 0
    r = res.result
    assert np.isfinite(float(r.mean_completion_slots))
    assert abs(float(r.throughput) / float(r.arrival_rate_hat) - 1.0) < 0.05
    assert float(res.telemetry.win[:, 7].sum()) == log.n_tasks
    assert texp.validate_events(eng.telemetry_events(res)) == []
    for name, a, b in zip(r._fields, r, again.result):      # same seed, same run
        assert torch.equal(a, b) or bool(a.isnan().all() and b.isnan().all()), name
    with pytest.raises(ValueError, match="BP family"):
        treplay.ReplayEngine(log, CL_T, R_T, algo="jsq_maxweight", device="cpu")


def test_engine_takes_the_reference_arguments():
    ours = inspect.signature(treplay.ReplayEngine).parameters
    theirs = inspect.signature(jreplay.ReplayEngine).parameters
    assert [p for p in ours if p != "device"] == list(theirs)
    for name, p in theirs.items():
        if p.default is not p.empty and name != "cfg":
            assert ours[name].default == p.default, name
    assert dataclasses.asdict(ours["cfg"].default) == dataclasses.asdict(theirs["cfg"].default)
    assert treplay.ReplayResult._fields == jreplay.ReplayResult._fields
