"""The port's event-accurate oracle (``repro_torch.core.refsim``) equals
the reference's (``repro.core.refsim``) on fixed seeds: the same numpy
draws, so every field of ``RefResult`` is equal, the per-task sojourns
included.  Small fleets and few slots: refsim is plain Python a task."""
import dataclasses

import numpy as np
import pytest

from repro.core import refsim as jref
from repro.core.cluster import Cluster as JCluster
from repro.core.cluster import Rates as JRates
from repro_torch.core import refsim as tref
from repro_torch.core.cluster import Cluster, Rates

RATES = (0.1, 0.05, 0.02)


def _speed(M: int, per_class: bool) -> np.ndarray:
    """A slow rack, a drained server and (per class) a drained remote tier."""
    rng = np.random.default_rng(M)
    s = np.ones((M, 3)) if per_class else np.ones(M)
    s[:M // 4] = 0.5
    s[M - 1] = 0.0
    if per_class:
        s[M // 2:M // 2 + 2, 2] = 0.0
        s *= rng.uniform(0.8, 1.2, (M, 1))
    return s


CASES = {
    "bp": dict(),
    "bp-pod": dict(pod=True, d_rack=2, d_remote=3),
    "bp-speed": dict(speed="whole"),
    "bp-pod-speed-per-class": dict(pod=True, d_rack=1, d_remote=2, speed="class"),
    "bp-pod-placement": dict(pod=True, d_rack=2, d_remote=2, placement=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 11])
def test_refsim_equals_the_reference(case, seed):
    M, K, load, T, warmup = 12, 3, 0.6, 600, 150
    kw = dict(CASES[case])
    if "speed" in kw:
        kw["speed"] = _speed(M, kw["speed"] == "class")
    if kw.pop("placement", False):
        rng = np.random.default_rng(5)
        probs = rng.zipf(1.5, 8).astype(np.float64)
        kw["placement"] = (probs, np.stack([rng.choice(M, 3, replace=False) for _ in range(8)]))
    want = jref.simulate_bp_ref(JCluster(M, K), JRates(*RATES), load, T, warmup, seed, **kw)
    got = tref.simulate_bp_ref(Cluster(M, K), Rates(*RATES), load, T, warmup, seed, **kw)
    assert isinstance(got, tref.RefResult)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.n_completed == want.n_completed > 0
    for f in ("mean_completion_slots", "mean_tasks_in_system", "throughput"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.locality_fractions, want.locality_fractions)
    np.testing.assert_array_equal(got.sojourns, want.sojourns)


def test_locality_classes_equal_the_reference():
    rng = np.random.default_rng(0)
    for M, K in ((12, 3), (20, 4)):
        for _ in range(5):
            locs = rng.choice(M, 3, replace=False)
            np.testing.assert_array_equal(tref._locality(Cluster(M, K), locs),
                                          jref._locality(JCluster(M, K), locs))
