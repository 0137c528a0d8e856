"""The port's scenario engine against the JAX reference (``repro.scenarios``).

The registry, the compose() algebra and the host-side realizers are copies
of plain Python and numpy, so they are held equal: the same names in the
same order (minus the trace-backed ``production_day``), the same specs,
arrays bit-equal to the reference's for every scenario with and without
the canonical pad, and ``lam_cap`` equal (1e-9 relative where it is the
fluid LP's optimum: HiGHS runs twice).  ``speed_at`` is bit-equal at every
window boundary.  The placement draw follows the Zipf law (a chi-square
test), per churn epoch.  ``simulate`` runs every scenario for every
algorithm, and a drained rack absorbs no task.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from _torch_sim_helpers import one_thread
from repro.core import cluster as jcl
from repro.core import simulator as jsim
from repro.scenarios import build as jbuild
from repro.scenarios import capacity as jcap
from repro.scenarios import generators as jgen
from repro.scenarios import spec as jspec
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim
from repro_torch.scenarios import build as tbuild
from repro_torch.scenarios import capacity as tcap
from repro_torch.scenarios import generators as tgen
from repro_torch.scenarios import spec as tspec

M, K, T = 24, 4, 500
CL_J, CL_T = jcl.Cluster(M=M, K=K), tcl.Cluster(M=M, K=K)
R_J, R_T = jcl.Rates(0.05, 0.025, 0.01), tcl.Rates(0.05, 0.025, 0.01)
NAMES = tspec.scenario_names()
LP = ("zipf_hotspot", "adversarial_placement", "hetero_storm", "cascade_flash")
ALPHA = 1e-4     # chi-square tests: a correct sampler fails one with this odds


def _spec_dict(s):
    return dataclasses.asdict(s)


def test_registry_equals_the_reference_minus_the_trace_entry():
    assert jspec.scenario_names() == NAMES + ("production_day",)
    assert len(NAMES) == 15
    for n in NAMES:
        assert _spec_dict(tspec.get_scenario(n)) == _spec_dict(jspec.get_scenario(n)), n
    assert tspec.get_scenario(None).name == "uniform"
    assert tspec.COMPOSE_DEPTH == jspec.COMPOSE_DEPTH
    for depth in (None, 1, 3):
        assert tspec.registry_limits(compose_depth=depth) == \
            jspec.registry_limits(NAMES, compose_depth=depth)
    with pytest.raises(NotImplementedError, match="A, item 6"):
        tspec.get_scenario("production_day")
    with pytest.raises(KeyError):
        tspec.get_scenario("no_such_scenario")


@pytest.mark.parametrize("parts,kw", [
    (("slow_rack", "flash_crowd"), {}),
    (("tor_cascade", "zipf_hotspot", "mmpp_bursty"), {}),
    (("diurnal_burst", "flash_crowd", "mmpp_bursty"), dict(name="tides", seed=9)),
    (("zipf_hotspot", "adversarial_placement", "network_degraded"), {}),
])
def test_compose_algebra_equals_the_reference(parts, kw):
    t = tspec.compose(*parts, **kw)
    j = jspec.compose(*parts, **kw)
    assert _spec_dict(t) == _spec_dict(j)
    sized = tspec.compose(t, tspec.Scenario("s1", sizes=tspec.SizeSpec(0.3)),
                          tspec.Scenario("s2", sizes=tspec.SizeSpec(0.4)))
    assert sized.sizes.sigma == jspec.SizeSpec(0.3).merge(jspec.SizeSpec(0.4)).sigma


def test_generators_equal_the_reference():
    for seed in range(5):
        for kw in (dict(n_events=3, n_racks=4), dict(n_events=7, n_racks=10)):
            assert tgen.correlated_outages(seed=seed, **kw) == tuple(
                tspec.WindowSpec(**dataclasses.asdict(w))
                for w in jgen.correlated_outages(seed=seed, **kw))
            assert tgen.cascading_stragglers(seed=seed, **kw) == tuple(
                tspec.WindowSpec(**dataclasses.asdict(w))
                for w in jgen.cascading_stragglers(seed=seed, **kw))


def _assert_data_equal(tscen, jscen, what):
    for name in tbuild.ScenarioData._fields:
        a, b = getattr(tscen, name), getattr(jscen, name)
        assert (a is None) == (b is None), f"{what}: {name}"
        if a is None:
            continue
        b = np.asarray(b)
        assert a.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(np.int32): torch.int32}[b.dtype], f"{what}: {name}"
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{what}: {name}")


def _boundaries(scen, T):
    s = np.asarray(scen.win_start).tolist() + np.asarray(scen.win_end).tolist()
    return sorted({min(max(t + d, 0), T - 1) for t in s + [0, T - 1] for d in (-1, 0, 1)})


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "canonical_pad"])
def test_realize_equals_the_reference_for_every_scenario(padded):
    tpad = tbuild.canonical_pad(CL_T) if padded else None
    jpad = jbuild.canonical_pad(CL_J, NAMES) if padded else None
    assert tpad == (tuple(jpad) if padded else None)
    for n in NAMES:
        tscen, tcap_ = tbuild.realize(n, CL_T, R_T, T, tpad, device="cpu")
        jscen, jcap_ = jbuild.realize(jspec.get_scenario(n), CL_J, R_J, T, pad=jpad)
        _assert_data_equal(tscen, jscen, n)
        if n in LP:
            assert tcap_ == pytest.approx(jcap_, rel=1e-9, abs=0), n
        else:
            assert tcap_ == jcap_, n
        for t in _boundaries(jscen, T):
            np.testing.assert_array_equal(
                tbuild.speed_at(tscen, t).numpy(), np.asarray(jbuild.speed_at(jscen, t)),
                err_msg=f"{n} slot {t}")
        np.testing.assert_array_equal(tbuild.speed_trace(tscen, T),
                                      jbuild.speed_trace(jscen, T), err_msg=n)
        assert tbuild.capacity_scale(tscen, T) == jbuild.capacity_scale(jscen, T), n
        assert tsim._rates_homogeneous(tscen) == jsim._rates_homogeneous(jscen), n


def test_speed_at_folds_overlapping_windows_in_the_reference_order():
    """Three or more non-unit factors on one server, none a power of two,
    so the order of the products decides the last bit: every slot equal."""
    rng = np.random.default_rng(4)
    windows = tuple((float(a), float(min(a + 0.5, 1.0)), tuple(rng.uniform(0.3, 0.95, 3)))
                    for a in rng.uniform(0, 0.6, 6))
    scen = {}
    for name, spec in (("t", tspec), ("j", jspec)):
        scen[name] = spec.Scenario("overlap", fleet=spec.FleetSpec(
            rack_speeds=(0.7, 0.9), slow_frac=0.3, slow_mult=0.55,
            windows=tuple(spec.WindowSpec(t0=a, t1=b, mult=m, every=1 + i % 3)
                          for i, (a, b, m) in enumerate(windows))))
    tscen, _ = tbuild.realize(scen["t"], CL_T, R_T, T, device="cpu")
    jscen, _ = jbuild.realize(scen["j"], CL_J, R_J, T)
    at = jax.jit(jbuild.speed_at)
    folded = 0
    for t in range(T):
        a = tbuild.speed_at(tscen, t).numpy()
        np.testing.assert_array_equal(a, np.asarray(at(jscen, jnp.int32(t))), err_msg=f"slot {t}")
        active = (np.asarray(jscen.win_start) <= t) & (t < np.asarray(jscen.win_end))
        folded += int(active.sum() >= 3)
    assert folded > T // 4


@pytest.mark.parametrize("kind", ["stationary", "diurnal", "flash", "mmpp", "product"])
def test_traffic_shape_and_arrival_counts_equal_the_reference(kind):
    def spec(mod):
        if kind == "product":
            return mod.compose("diurnal_burst", "flash_crowd", "mmpp_bursty").traffic
        return mod.TrafficSpec(kind=kind, amp=1.3)       # amp > 1: clamped dead zones
    for seed in range(3):
        a = tbuild.traffic_shape(spec(tspec), 3000, np.random.default_rng(seed))
        b = jbuild.traffic_shape(spec(jspec), 3000, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(tbuild.arrival_counts(spec(tspec), 3000, 7.5, seed),
                                      jbuild.arrival_counts(spec(jspec), 3000, 7.5, seed))


def test_canonical_a_max_and_the_lp_edge_equal_the_reference():
    cfg_t, cfg_j = tsim.SimConfig(T=T), jsim.SimConfig(T=T)
    for load in (0.5, 0.9):
        assert tbuild.canonical_a_max(CL_T, R_T, cfg_t, load) == \
            jbuild.canonical_a_max(CL_J, R_J, cfg_j, load, NAMES)
    tscen, _ = tbuild.realize("adversarial_placement", CL_T, R_T, T, device="cpu")
    jscen, _ = jbuild.realize(jspec.get_scenario("adversarial_placement"), CL_J, R_J, T)
    assert tcap.fluid_edge(tscen, CL_T, R_T, T) == pytest.approx(
        jcap.fluid_edge(jscen, CL_J, R_J, T), rel=1e-9, abs=0)
    assert tcap.uniform_edge(tscen, R_T, T) == jcap.uniform_edge(jscen, R_J, T)
    pbar_t, loc_t = tcap.chunk_demand(tscen, T)
    pbar_j, loc_j = jcap.chunk_demand(jscen, T)
    np.testing.assert_array_equal(pbar_t, pbar_j)
    np.testing.assert_array_equal(loc_t, loc_j)


def _chi2_pvalue(counts, expected):
    """Pearson chi-square p-value, bins with expected count < 5 merged."""
    small = expected < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    keep = exp > 0
    stat = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    return scipy.stats.chi2.sf(stat, keep.sum() - 1)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "canonical_pad"])
def test_sample_locals_scenario_follows_the_zipf_law(padded):
    """200 000 draws on zipf_hotspot: the triples' frequencies against the
    catalog's law (chunks sharing a triple pooled), chi-square p > 1e-4;
    on the padded realization pad chunks are never drawn."""
    pad = tbuild.canonical_pad(CL_T) if padded else None
    scen, _ = tbuild.realize("zipf_hotspot", CL_T, R_T, T, pad, device="cpu")
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    got = tbuild.sample_locals_scenario(gen, CL_T, scen, n).numpy()
    assert got.shape == (n, 3) and got.dtype == np.int32
    logits = scen.chunk_logits.double()
    p = torch.softmax(logits, 0).numpy()
    triples = scen.chunk_locals.numpy()
    keys, inv = np.unique(triples, axis=0, return_inverse=True)
    expected = np.bincount(inv.ravel(), weights=p, minlength=len(keys)) * n
    lookup = {tuple(k): i for i, k in enumerate(keys)}
    idx = np.array([lookup[tuple(r)] for r in got])
    assert _chi2_pvalue(np.bincount(idx, minlength=len(keys)), expected) > ALPHA
    if padded:
        live = triples[p > 0]
        assert np.isin(idx, [lookup[tuple(r)] for r in live]).all()


def test_padded_uniform_placement_is_uniform():
    """canonical_pad on a uniform scenario: placement_on = 0 selects the
    uniform triples by data; every server is a replica 3/M of the time
    (chi-square p > 1e-4) and a task's replicas are distinct."""
    scen, _ = tbuild.realize("slow_rack", CL_T, R_T, T, tbuild.canonical_pad(CL_T),
                             device="cpu")
    assert float(scen.placement_on) == 0.0
    n = 50_000
    got = tbuild.sample_locals_scenario(torch.Generator().manual_seed(1), CL_T, scen,
                                        n).numpy()
    assert (np.diff(np.sort(got, 1), axis=1) > 0).all()
    counts = np.bincount(got.ravel(), minlength=M)
    assert _chi2_pvalue(counts, np.full(M, 3 * n / M)) > ALPHA


class _TwoEpochs(jspec.PlacementSpec):
    """A duck-typed churning placement (the trace package's hook): two
    epochs with disjoint hot halves of the catalog, switching at T/2."""

    n_epochs = 2

    def realize_catalog(self, cluster, rng):
        C = 2 * cluster.M
        locals_ = np.argsort(rng.random((C, cluster.M)), 1)[:, :3].astype(np.int32)
        elog = np.full((2, C), -1e30, np.float32)
        elog[0, :C // 2] = np.log(1.0 / (C // 2))
        elog[1, C // 2:] = np.log(1.0 / (C // 2))
        return elog.mean(0), locals_, elog

    def realize_epochs(self, T):
        return (np.arange(T) >= T // 2).astype(np.int32)


class _Recorded(jspec.TrafficSpec):
    """A duck-typed recorded arrival shape (the trace package's hook)."""

    def realize_shape(self, T, rng):
        return rng.poisson(4.0, T) - 1.0            # clamped at 0 by the realizer


def test_churn_epochs_select_their_popularity_rows():
    """The trace package's hooks (a churning catalog, a recorded arrival
    shape) realize equal to the reference's, and the draw source takes
    each slot's triples from its own epoch's chunks."""
    spec_t = tspec.Scenario("churn", placement=_TwoEpochs(kind="zipf"),
                            traffic=_Recorded(kind="recorded"))
    spec_j = jspec.Scenario("churn", placement=_TwoEpochs(kind="zipf"),
                            traffic=_Recorded(kind="recorded"))
    for pad in (None, tbuild.ScenarioPad(1, 2 * M, 2)):
        tscen, tcap_ = tbuild.realize(spec_t, CL_T, R_T, 64, pad, device="cpu")
        jscen, jcap_ = jbuild.realize(spec_j, CL_J, R_J, 64,
                                      pad=None if pad is None else jbuild.ScenarioPad(*pad))
        _assert_data_equal(tscen, jscen, f"churn pad={pad}")
        assert tcap_ == pytest.approx(jcap_, rel=1e-9, abs=0)
    triples = tscen.chunk_locals.numpy()
    halves = [{tuple(r) for r in triples[:M]}, {tuple(r) for r in triples[M:2 * M]}]
    cfg = tsim.SimConfig(T=64, warmup=0, route_mode="batched")
    draws = tsim.TorchDraws(torch.Generator().manual_seed(2), CL_T, R_T, cfg, None, 8,
                            torch.full((64,), 3.0), "bp", tscen)
    for t in range(64):
        own = {tuple(r) for r in draws(t).locals_.numpy()}
        assert own <= halves[int(t >= 32)] and not own <= halves[int(t < 32)], t


def test_simulate_runs_every_scenario_for_every_algorithm():
    cfg = tsim.SimConfig(T=40, warmup=8, route_mode="batched")
    pad = tbuild.canonical_pad(CL_T)
    with one_thread():
        for n in NAMES:
            for algo in tsim.ALGORITHMS:
                for p in (None, pad):
                    r = tsim.simulate(algo, CL_T, R_T, 0.6, 3, cfg, scenario=n, pad=p,
                                      device="cpu")
                    assert np.isfinite(float(r.mean_tasks_in_system)), (n, algo, p)
                    assert float(r.arrival_rate_hat) > 0, (n, algo, p)


def test_realize_and_simulate_without_a_device_run_on_the_card_or_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path is not reachable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild.realize("slow_rack", CL_T, R_T, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.simulate("balanced_pandas", CL_T, R_T, 0.5, 0, tsim.SimConfig(T=10),
                      scenario="rack_outage")


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod"])
def test_a_drained_rack_absorbs_no_task(algo):
    """Rack 0 drained for the whole run: BP routing never commits a task to
    it (every task has a live candidate: its remote samples), so its queues
    stay empty at every slot, as the reference's
    test_outage_window_does_not_absorb_tasks_end_to_end requires."""
    spec = tspec.Scenario("drain", fleet=tspec.FleetSpec(windows=(
        tspec.WindowSpec(t0=0.0, t1=1.0, mult=0.0, rack=0),)))
    cfg = tsim.SimConfig(T=400, warmup=0, route_mode="batched")
    scen, lam_cap = tbuild.realize(spec, CL_T, R_T, cfg.T, device="cpu")
    pod = tsim._pod_for(algo, None)
    lam = 0.6 * lam_cap
    a_max = cfg.resolve_a_max(lam)
    draws = tsim.TorchDraws(torch.Generator().manual_seed(4), CL_T, R_T, cfg, pod,
                            a_max, torch.full((cfg.T,), lam), "bp", scen)
    state, sums = tsim.BPState.zero(M), tsim.RawSums.zero()
    rate_vec = R_T.as_array()
    R = CL_T.rack_size
    for t in range(cfg.T):
        speed = tbuild.speed_at(scen, t)
        state, sums = tsim._bp_step(
            state, sums, draws(t), cluster=CL_T, cfg=cfg,
            inv_rate_m=tcl.safe_inv_rates(speed * rate_vec[None, :]), pod=pod,
            a_max=a_max, measure=True, in_half2=t >= cfg.T // 2, speed=speed, scen=scen)
        assert int(state.Q[:R].sum()) == 0 and not state.busy[:R].any(), t
    assert float(sums.completions) > 0.8 * float(sums.arrivals)
