"""The port's ``ServeEngine`` against the JAX reference's, on the CPU.

Both engines serve the same workload (the float32 smoke llama3-8b, 8
replicas in 2 pods, 12 requests of ``max_new=4``) with the same weights
(the reference's ``init_params`` through ``params_from_numpy``), the
port's router fed the reference router's recorded draws.  Every request's
replica, class, start and done ticks and generated tokens must be equal,
and so must ``EngineStats``: completions, locality, probes, both traces,
the latency histogram, p50 and p95.  Then the same for ``run_arrivals`` on
the MMPP arrival schedule of ``tests/test_sched.py``.
"""
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jm
import repro.scenarios as jscen
import repro.sched as jsched
import repro.serve as jserve
import repro_torch.configs as tconfigs
import repro_torch.models as tm
import repro_torch.scenarios as tscen
import repro_torch.sched as tsched
import repro_torch.serve as tserve
from _torch_router_draws import RecordingRouter, ReferenceDraws

N_REP, N_PODS, N_PREFIX = 8, 2, 4


def _models():
    cfgj = jconfigs.get("llama3_8b", smoke=True).replace(dtype="float32")
    cfgt = tconfigs.get("llama3_8b", smoke=True).replace(dtype="float32")
    pj = jm.init_params(cfgj, jax.random.PRNGKey(0))
    pt = tm.params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")
    return cfgj, cfgt, pj, pt


def _engines(policy: str):
    """(reference engine, port engine) on one workload's fleet and homes."""
    cfgj, cfgt, pj, pt = _models()
    rng = np.random.default_rng(0)
    homes = {i: rng.choice(N_REP, size=3, replace=False) for i in range(N_PREFIX)}
    rj = RecordingRouter(jsched.FleetTopology(N_REP, N_PODS),
                         jsched.service_rates(), policy=policy, seed=1)
    rt = tsched.PodRouter(tsched.FleetTopology(N_REP, N_PODS),
                          tsched.service_rates(), policy=policy, seed=1,
                          device="cpu", draws=ReferenceDraws(rj))
    ej = jserve.ServeEngine(cfgj, pj, jsched.FleetTopology(N_REP, N_PODS), rj,
                            homes, max_batch=4)
    et = tserve.ServeEngine(cfgt, pt, tsched.FleetTopology(N_REP, N_PODS), rt,
                            homes, max_batch=4)
    return ej, et, cfgj.vocab


def _requests(pkg, vocab: int, n: int, seed: int, max_new: int = 4):
    rng = np.random.default_rng(seed)
    return [pkg.Request(rid=i, prefix_id=i % N_PREFIX,
                        prompt=rng.integers(0, vocab, size=3),
                        max_new=max_new, arrival=0) for i in range(n)]


def _assert_same_run(ej, et, sj, st):
    key = lambda r: r.rid
    done_j, done_t = sorted(ej.done, key=key), sorted(et.done, key=key)
    assert [r.rid for r in et.done] == [r.rid for r in ej.done]
    for a, b in zip(done_j, done_t):
        assert (b.replica, b.cls, b.start_tick, b.done_tick, b.arrival) == \
            (a.replica, a.cls, a.start_tick, a.done_tick, a.arrival)
        assert b.generated == [int(t) for t in a.generated]
    assert st.completions == sj.completions
    np.testing.assert_array_equal(st.locality, sj.locality)
    assert st.probes_per_decision == sj.probes_per_decision
    np.testing.assert_array_equal(st.queue_depth_trace, sj.queue_depth_trace)
    np.testing.assert_array_equal(st.batch_size_trace, sj.batch_size_trace)
    np.testing.assert_array_equal(st.latency_hist, sj.latency_hist)
    assert (st.latency_p50, st.latency_p95, st.note) == \
        (sj.latency_p50, sj.latency_p95, sj.note)
    np.testing.assert_array_equal(et.router.Q.numpy(), np.asarray(ej.router.Q))
    np.testing.assert_array_equal(et.router.W.numpy().view(np.int32),
                                  np.asarray(ej.router.W).view(np.int32))
    np.testing.assert_array_equal(et.router.stats.routed_by_class,
                                  ej.router.stats.routed_by_class)


@pytest.mark.parametrize("policy", ["pod", "full"])
def test_engine_equals_the_reference(policy):
    ej, et, vocab = _engines(policy)
    ej.submit(_requests(jserve, vocab, 12, seed=5))
    sj = ej.run(until_done=12, max_ticks=500)
    et.submit(_requests(tserve, vocab, 12, seed=5))
    st = et.run(until_done=12, max_ticks=500)
    assert len(st.completions) == 12 and all(c > 0 for c in st.completions)
    assert st.probes_per_decision == (11 if policy == "pod" else N_REP)
    for r in et.done:
        assert len(r.generated) == 4
        assert all(0 <= t < tconfigs.get("llama3_8b", smoke=True).padded_vocab
                   for t in r.generated)
    assert int(et.router.Q.sum()) == 0          # every request retired
    _assert_same_run(ej, et, sj, st)


def test_run_arrivals_equals_the_reference_on_an_mmpp_schedule():
    """Scenario-driven load replay: the bursty (MMPP) arrival counts of
    the reference's test, from both packages' ``arrival_counts`` (equal),
    through ``run_arrivals``; every request completes, as in the
    reference."""
    ej, et, vocab = _engines("pod")
    kw = dict(T=10, mean_per_tick=1.0, seed=3)
    sched_j = jscen.arrival_counts(jscen.TrafficSpec(
        kind="mmpp", burst=4.0, p_enter=0.2, p_exit=0.2), **kw)
    sched_t = tscen.arrival_counts(tscen.TrafficSpec(
        kind="mmpp", burst=4.0, p_enter=0.2, p_exit=0.2), **kw)
    np.testing.assert_array_equal(np.asarray(sched_t), np.asarray(sched_j))

    def maker(pkg):
        rid = iter(range(10_000))
        rng = np.random.default_rng(7)

        def make_request(tick):
            i = next(rid)
            return pkg.Request(rid=i, prefix_id=i % N_PREFIX,
                               prompt=rng.integers(0, vocab, size=3),
                               max_new=3, arrival=tick)
        return make_request

    sj = ej.run_arrivals(sched_j, maker(jserve), max_ticks=500)
    st = et.run_arrivals(sched_t, maker(tserve), max_ticks=500)
    assert len(st.completions) == int(np.sum(sched_t)) > 0
    assert all(c > 0 for c in st.completions)
    _assert_same_run(ej, et, sj, st)


def test_entry_points_raise_without_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tconfigs.get("llama3_8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsched.PodRouter(tsched.FleetTopology(8, 2), tsched.service_rates())
    # the engine runs where its params are, and only with a router there
    params = tm.init_params(cfg, 0, device="cpu")
    elsewhere = types.SimpleNamespace(Q=torch.empty(0, device="meta"))
    with pytest.raises(ValueError, match="one device"):
        tserve.ServeEngine(cfg, params, tsched.FleetTopology(8, 2), elsewhere,
                           {0: np.array([0, 1, 2])})
