"""The JAX reference on the heterogeneous cells of ``chip_smoke.py``
phase 3, on the CPU: the values the port's card run is expected near.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_scenario_cells.py

Each cell (algorithm, cluster, scenario, load, T, warmup, batched routing,
rates (0.01, 0.005, 0.002)) runs with seeds 1 and 2, so the line shows the
spread one seed has; the port's run uses another random stream, so it is
held to that spread, not to a digit.  A few minutes on a CPU.
"""
import time

import jax
import numpy as np

from repro.core import Cluster, Rates, SimConfig, simulate

RATES = Rates(0.01, 0.005, 0.002)
PAPER, PLACED = Cluster(M=500, K=10), Cluster(M=100, K=10)
CELLS = ([(algo, PAPER, scenario, load, 5_000, 1_250)
          for algo in ("balanced_pandas", "balanced_pandas_pod")
          for scenario, load in (("slow_rack", 0.9), ("rack_outage", 0.5))]
         + [("balanced_pandas_pod", PAPER, "network_degraded", 0.9, 5_000, 1_250),
            ("balanced_pandas_pod", PAPER, "mmpp_bursty", 0.5, 5_000, 1_250),
            ("jsq_maxweight_pod", PAPER, "slow_rack", 0.9, 5_000, 1_250),
            ("fcfs", PAPER, "rack_outage", 0.15, 5_000, 1_250)]
         + [(algo, PLACED, scenario, 0.5, 10_000, 2_500)
            for scenario in ("zipf_hotspot", "hetero_storm")
            for algo in ("balanced_pandas_pod", "jsq_maxweight_pod")])


def main():
    """Run every cell with seeds 1 and 2 and print one line a run."""
    for algo, cl, scenario, load, T, warmup in CELLS:
        cfg = SimConfig(T=T, warmup=warmup, route_mode="batched")
        for seed in (1, 2):
            t0 = time.perf_counter()
            r = simulate(algo, cl, RATES, load, jax.random.PRNGKey(seed), cfg,
                         scenario=scenario)
            thr = float(r.throughput) / float(r.arrival_rate_hat)
            loc = np.round(np.asarray(r.locality_fractions, np.float64), 4).tolist()
            print(f"{algo:20s} {scenario:17s} M={cl.M} load={load} T={T} "
                  f"seed={seed}: mean_completion_slots="
                  f"{float(r.mean_completion_slots):.2f} throughput/arrivals={thr:.4f} "
                  f"locality={loc} drift={float(r.drift):.3f} "
                  f"clip={float(r.clip_fraction):.6f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
