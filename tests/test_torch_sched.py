"""The port's ``sched`` (router, fleet locality, shard balancer) and its
``configs`` against the JAX reference's, on the CPU.

Router parity: ``repro.sched.PodRouter`` routes 20 batches with
``complete`` calls between them; a subclass defined in the tests
(``_torch_router_draws.RecordingRouter``) records the candidates its
``_sample_candidates`` returns and the keys ``_next_key`` hands out, and
the port's ``PodRouter(device="cpu")`` gets exactly those draws through
its ``RouterDraws`` seam (the full variant's tie permutation recomputed as
``jax.random.permutation(key, M)``).  ``sel``, ``sel_cls``,
``Q``, ``W`` and the stats must then be equal bit for bit, for both
policies, with the homogeneous ``[3]`` rates and with an ``[M, 3]`` rate
matrix that drains one replica.  The reference's ``sel_cls`` is read by
wrapping the ``route_commit`` its router module calls (nothing in
``repro`` is edited).

The reference's own router tests (``tests/test_sched.py``) then run on the
port with the port's draws.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.sched as jsched
import repro.sched.router as jrouter
import repro_torch.configs as tconfigs
import repro_torch.sched as tsched
from _torch_router_draws import RecordingRouter, ReferenceDraws
from repro_torch.core import PodSpec
from repro_torch.core import cluster as tcl

M, K, B, BATCHES = 32, 4, 8, 20


def _rate_matrix():
    """Per-replica rates: a slow replica, a half-speed pod, replica 5
    drained (rate 0 -> +inf inverse rate)."""
    r = jsched.service_rates()
    speed = np.ones(M, np.float32)
    speed[0] = 0.125
    speed[M // K: 2 * M // K] = 0.5
    rm = (speed[:, None] * np.array([r.alpha, r.beta, r.gamma], np.float32)
          ).astype(np.float32)
    rm[5] = 0.0
    return rm


def _homes(rng):
    """A batch's prefix homes: half on a hot triple (so load piles up and
    spills), half random distinct triples."""
    rows = [rng.choice(M, size=3, replace=False) for _ in range(B)]
    rows[: B // 2] = [np.array([4, 5, 6])] * (B // 2)
    return np.stack(rows).astype(np.int64)


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("policy", ["pod", "full"])
@pytest.mark.parametrize("hetero", [False, True], ids=["inv3", "invM3"])
def test_router_equals_the_reference_given_its_draws(monkeypatch, policy, hetero):
    fleet_j = jsched.FleetTopology(n_replicas=M, n_pods=K)
    fleet_t = tsched.FleetTopology(n_replicas=M, n_pods=K)
    rm = _rate_matrix() if hetero else None
    ref_sel_cls = []
    orig = jrouter.route_commit

    def recording_route_commit(*a, **kw):
        out = orig(*a, **kw)
        ref_sel_cls.append(np.asarray(out[3]))
        return out

    monkeypatch.setattr(jrouter, "route_commit", recording_route_commit)
    ref = RecordingRouter(fleet_j, jsched.service_rates(), policy=policy,
                          seed=3, rate_matrix=rm)
    port = tsched.PodRouter(fleet_t, tsched.service_rates(), policy=policy,
                            seed=3, rate_matrix=rm, device="cpu",
                            draws=ReferenceDraws(ref))
    assert port.heterogeneous == ref.heterogeneous == hetero
    np.testing.assert_array_equal(_bits(port._inv), _bits(ref._inv))

    rng = np.random.default_rng(11)
    routed = []
    for i in range(BATCHES):
        homes = _homes(rng)
        np.testing.assert_array_equal(
            port._classes(torch.from_numpy(homes)).numpy(), ref._classes(homes))
        sel_j = ref.route(homes)
        sel_t = port.route(homes)
        np.testing.assert_array_equal(sel_t, sel_j)
        np.testing.assert_array_equal(port.last_classes, ref_sel_cls[-1])
        routed.append((sel_t, port.last_classes))
        if i >= 2:      # retire the batch routed two batches before
            done, cls = routed[i - 2]
            ref.complete(done[::2], cls[::2])
            port.complete(done[::2], cls[::2])
        np.testing.assert_array_equal(port.Q.numpy(), np.asarray(ref.Q))
        np.testing.assert_array_equal(_bits(port.W.numpy()), _bits(ref.W))
    if hetero:
        assert port.Q[5].sum() == 0          # the drained replica got nothing
    assert int(port.Q.sum()) > 0
    assert port.stats.decisions == ref.stats.decisions == BATCHES * B
    assert port.stats.probes == ref.stats.probes
    np.testing.assert_array_equal(port.stats.routed_by_class,
                                  ref.stats.routed_by_class)


def test_complete_folds_workloads_in_the_reference_order():
    """``complete`` recomputes W from Q at the rates a fleet of mixed
    speeds gives: every row sum equal to the reference's to the bit (the
    reference's is XLA's three-term sum, which the port writes out)."""
    n = 512
    fleet = tsched.FleetTopology(n_replicas=n, n_pods=8)
    rng = np.random.default_rng(0)
    rm = (rng.uniform(0.01, 0.9, (n, 3))).astype(np.float32)
    rm[rng.random(n) < 0.05] = 0.0
    ref = jsched.PodRouter(jsched.FleetTopology(n_replicas=n, n_pods=8),
                           jsched.service_rates(), rate_matrix=rm)
    port = tsched.PodRouter(fleet, tsched.service_rates(), rate_matrix=rm,
                            device="cpu")
    q = rng.integers(0, 400, (n, 3)).astype(np.int32)
    ref.Q = jax.numpy.asarray(q)
    port.Q = torch.from_numpy(q.copy())
    ids = rng.integers(0, n, 300)
    cls = rng.integers(0, 3, 300)
    ref.complete(ids, cls)
    port.complete(ids, cls)
    np.testing.assert_array_equal(port.Q.numpy(), np.asarray(ref.Q))
    np.testing.assert_array_equal(_bits(port.W.numpy()), _bits(ref.W))


def test_router_raises_without_a_card_or_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    fleet = tsched.FleetTopology(n_replicas=8, n_pods=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsched.PodRouter(fleet, tsched.service_rates())
    with pytest.raises(ValueError):
        tsched.PodRouter(fleet, tsched.service_rates(), policy="snapshot",
                         device="cpu")


def test_fleet_topology_and_service_rates_equal_the_reference():
    for n, k, rep in [(32, 4, 3), (16, 4, 2), (5000, 50, 3)]:
        fj = jsched.FleetTopology(n_replicas=n, n_pods=k, replication=rep)
        ft = tsched.FleetTopology(n_replicas=n, n_pods=k, replication=rep)
        assert dataclasses.asdict(ft) == dataclasses.asdict(fj)
        cj, ct = fj.as_cluster(), ft.as_cluster()
        assert isinstance(ct, tcl.Cluster)
        assert (ct.M, ct.K, ct.n_replicas) == (cj.M, cj.K, cj.n_replicas)
        assert [ft.pod_of(r) for r in range(n)] == [fj.pod_of(r) for r in range(n)]
    for kw in [{}, dict(prefix_tokens=512, decode_tokens=64, tok_per_s_hit=20.0),
               dict(decode_tokens=8)]:
        rj, rt = jsched.service_rates(**kw), tsched.service_rates(**kw)
        assert isinstance(rt, tcl.Rates)
        assert tuple(rt) == tuple(rj)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_configs_equal_the_reference(smoke):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SUBQUADRATIC_FAMILIES == jconfigs.SUBQUADRATIC_FAMILIES
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    props = ("resolved_head_dim", "q_groups", "padded_kv_heads",
             "padded_q_groups", "padded_heads", "padded_vocab", "ssm_inner",
             "ssm_heads")
    for name in tconfigs.ARCH_IDS:
        ct, cj = tconfigs.get(name, smoke=smoke), jconfigs.get(name, smoke=smoke)
        assert type(ct).__module__.startswith("repro_torch.")
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj), name
        assert [getattr(ct, p) for p in props] == [getattr(cj, p) for p in props]
        assert tconfigs.get(name.replace("_", "-"), smoke=smoke) == ct
        for shape in tconfigs.SHAPES.values():
            assert tconfigs.shape_applicable(ct, shape) == \
                jconfigs.shape_applicable(cj, jconfigs.SHAPES[shape.name])


def test_shard_balancer_equals_the_reference():
    """Same seed, same observations and shard homes: the same picks,
    reassignments, probes and worker state."""
    bj = jsched.ShardBalancer(n_workers=24, n_pods=4, d=6, seed=5)
    bt = tsched.ShardBalancer(n_workers=24, n_pods=4, d=6, seed=5)
    rng = np.random.default_rng(2)
    for step in range(300):
        if step % 10 == 0:
            w = int(rng.integers(24))
            t = float(rng.uniform(0.5, 5.0))
            bj.observe(w, t, 1.0)
            bt.observe(w, t, 1.0)
        homes = rng.choice(24, size=3, replace=False)
        assert bt.assign(homes) == bj.assign(homes)
        bj.drain(0.4)
        bt.drain(0.4)
    assert (bt.reassignments, bt.decisions, bt.probes) == \
        (bj.reassignments, bj.decisions, bj.probes)
    assert [dataclasses.asdict(w) for w in bt.workers] == \
        [dataclasses.asdict(w) for w in bj.workers]


# -- the reference's router tests (tests/test_sched.py), on the port --------


def test_router_sequential_commit_spreads_batch():
    fleet = tsched.FleetTopology(n_replicas=32, n_pods=4)
    router = tsched.PodRouter(fleet, tsched.service_rates(), policy="pod",
                              device="cpu")
    homes = np.array([[0, 1, 2]] * 16)
    sel = router.route(homes)
    # empty cluster: the class tie-break sends the first requests to their
    # (local) home replicas, in slot order
    assert sel[:3].tolist() == [0, 1, 2]
    # in-batch sequential commits spread the rest of the burst
    assert np.bincount(sel, minlength=32).max() <= 2, sel
    for _ in range(20):
        router.route(homes)
    router.route(homes)
    assert router.stats.decisions == 16 * 22
    assert router.stats.probes == 16 * 22 * (3 + 8)   # O(1): 11 probes


def test_router_full_policy_probes_M():
    fleet = tsched.FleetTopology(n_replicas=32, n_pods=4)
    router = tsched.PodRouter(fleet, tsched.service_rates(), policy="full",
                              device="cpu")
    router.route(np.array([[0, 1, 2]] * 8))
    assert router.stats.probes == 8 * 32                # O(M)


def test_router_heterogeneous_rate_matrix_avoids_slow_replicas():
    """Replicas 0-2 at 1/8 speed: the router spills load to fast replicas
    far sooner than a homogeneous one; probe accounting is unchanged."""
    fleet = tsched.FleetTopology(n_replicas=32, n_pods=4)
    rates = tsched.service_rates()
    speed = torch.ones(32)
    speed[:3] = 0.125
    rm = tcl.rate_matrix(rates, speed).numpy()
    slow = tsched.PodRouter(fleet, rates, policy="pod", rate_matrix=rm,
                            seed=1, device="cpu")
    base = tsched.PodRouter(fleet, rates, policy="pod", seed=1, device="cpu")
    assert slow.heterogeneous and not base.heterogeneous
    homes = np.array([[0, 1, 2]] * 8)
    n_slow_s = n_slow_b = 0
    for _ in range(30):
        n_slow_s += int(np.isin(slow.route(homes), [0, 1, 2]).sum())
        n_slow_b += int(np.isin(base.route(homes), [0, 1, 2]).sum())
    assert n_slow_s < 0.5 * n_slow_b, (n_slow_s, n_slow_b)
    assert slow.stats.probes == base.stats.probes == 30 * 8 * (3 + 8)
    full = tsched.PodRouter(fleet, rates, policy="full", rate_matrix=rm,
                            device="cpu")
    full.route(homes)
    assert full.stats.probes == 8 * 32


def test_straggler_rebalancing():
    bal = tsched.ShardBalancer(n_workers=16, n_pods=4, seed=0)
    for _ in range(10):
        bal.observe(3, step_time=4.0, expected=1.0)
        for w in range(16):
            if w != 3:
                bal.observe(w, step_time=1.0, expected=1.0)
    rng = np.random.default_rng(0)
    picks = []
    for _ in range(200):
        picks.append(bal.assign(rng.choice(16, size=3, replace=False)))
        bal.drain(0.3)
    counts = np.bincount(picks, minlength=16)
    assert counts[3] < 0.5 * np.delete(counts, 3).mean(), counts


def test_candidates_are_uniform_over_each_class_pool():
    """The port's batch-wide sampler: locals first, then rack draws only
    from the locals' pods (never a local), remote draws only from other
    pods, each pool hit uniformly; an empty pool gives invalid slots."""
    fleet = tsched.FleetTopology(n_replicas=32, n_pods=4)
    router = tsched.PodRouter(fleet, tsched.service_rates(), device="cpu")
    homes = torch.tensor([[0, 1, 9]] * 4000)
    cls = router._classes(homes)
    gen = torch.Generator().manual_seed(0)
    idx, ccls, valid = tsched.sample_candidates(gen, cls, homes, PodSpec(2, 6))
    assert valid.all()
    assert (idx[:, :3] == homes).all() and (ccls[:, :3] == 0).all()
    rack, remote = idx[:, 3:5].flatten().numpy(), idx[:, 5:].flatten().numpy()
    pool_rack = sorted(set(range(16)) - {0, 1, 9})
    pool_remote = list(range(16, 32))
    assert set(rack) == set(pool_rack) and set(remote) == set(pool_remote)
    for vals, pool in [(rack, pool_rack), (remote, pool_remote)]:
        counts = np.bincount(vals, minlength=32)[pool]
        expect = len(vals) / len(pool)
        assert np.abs(counts - expect).max() < 5 * np.sqrt(expect), counts
    one_pod = tsched.PodRouter(tsched.FleetTopology(n_replicas=8, n_pods=1),
                               tsched.service_rates(), device="cpu")
    h = torch.tensor([[0, 1, 2]])
    idx, ccls, valid = tsched.sample_candidates(gen, one_pod._classes(h), h,
                                                PodSpec(2, 6))
    assert valid[0].tolist() == [True] * 5 + [False] * 6
    assert idx[0, 5:].tolist() == [0] * 6 and ccls[0, 5:].tolist() == [0] * 6


@pytest.mark.parametrize("policy", ["pod", "full"])
def test_shared_draws_let_a_second_router_repeat_the_first(policy):
    """``SharedDraws.echo`` hands a second router the first one's draws
    (the smoke's and the gpu tests' CPU check of the card's router): two
    routers fed so stay equal batch after batch."""
    fleet = tsched.FleetTopology(n_replicas=40, n_pods=5)
    shared = tsched.SharedDraws(tsched.TorchRouterDraws(9, "cpu"))
    first = tsched.PodRouter(fleet, tsched.service_rates(), policy=policy,
                             device="cpu", draws=shared)
    second = tsched.PodRouter(fleet, tsched.service_rates(), policy=policy,
                              device="cpu", draws=shared.echo("cpu"))
    other = tsched.PodRouter(fleet, tsched.service_rates(), policy=policy,
                             seed=10, device="cpu")
    gen = torch.Generator().manual_seed(0)
    differ = 0
    for _ in range(10):
        homes = tcl.sample_locals(gen, fleet.as_cluster(), 16).numpy()
        sel = first.route(homes)
        np.testing.assert_array_equal(second.route(homes), sel)
        differ += int((other.route(homes) != sel).sum())
        assert torch.equal(first.Q, second.Q) and torch.equal(first.W, second.W)
    assert differ > 0                  # other draws route otherwise
