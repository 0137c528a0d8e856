"""Sojourn percentiles against refsim's exact per-task sojourns
(tests/test_telemetry.py's check of the reference, at the CPU's size):
the histogram's p50 and p95 within 5%."""
import numpy as np

from _torch_sim_helpers import one_thread
from repro_torch.core import simulator as tsim
from repro_torch.core.cluster import Cluster, Rates
from repro_torch.core.refsim import simulate_bp_ref
from repro_torch.telemetry import collectors as ttlm
from repro_torch.telemetry import export as texp

TCFG = ttlm.TelemetryConfig()


def test_sojourn_percentiles_match_refsim_within_5pct():
    """BP at load 0.45, M=40: the port's histogram percentiles (p50, p95),
    pooled over four seeds run as one grid, within 5% of the exact
    percentiles of refsim's per-task sojourns pooled over four seeds."""
    cl, rates = Cluster(M=40, K=4), Rates(0.05, 0.025, 0.01)
    T, warmup, load, seeds = 8000, 2000, 0.45, 4
    cfg = tsim.SimConfig(T=T, warmup=warmup, route_mode="batched")
    with one_thread():
        _, tele = tsim.simulate_grid_with_telemetry("balanced_pandas", cl, rates, [load],
                                                    seeds, cfg, device="cpu")
    got = texp.sojourn_percentiles(tele, TCFG, ps=(50, 95))
    assert got["dropped"] == 0.0 and got["n"] > 4000
    ref = np.concatenate([
        simulate_bp_ref(Cluster(M=40, K=4), Rates(0.05, 0.025, 0.01), load, T=T,
                        warmup=warmup, seed=s).sojourns for s in range(seeds)])
    for key, want in zip(("p50", "p95"), np.percentile(ref, [50, 95])):
        assert abs(got[key] - want) / want < 0.05, (key, got[key], want)
