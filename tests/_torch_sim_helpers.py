"""Shared helpers of the level-3 simulator parity tests
(tests/test_torch_sim_*.py): the port's ``simulate`` on the CPU against the
JAX ``simulate``, and the port's sequential route mode against its batched
one.  Each side runs in its own file, so that no file runs long.

The random streams differ (threefry vs Philox), so single runs cannot be
compared.  Each side runs six seeds at M=20, K=4, load 0.6 (FCFS 0.15: it
serves most tasks remotely and is unstable above about 0.2), T=6000, on
``uniform`` or on the scenario a file names; mean
completion slots and the three locality fractions must agree within a
confidence interval built from the seed spread:
|mean_a - mean_b| < 3 * sqrt(se_a^2 + se_b^2), se = sample std / sqrt(n).
"""
import contextlib

import numpy as np
import torch

from repro.core import cluster as jcl
from repro.core import simulator as jsim
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim

M, K, LOAD, SEEDS = 20, 4, 0.6, 6
RATES = (0.1, 0.05, 0.02)
T, WARMUP = 6000, 1500


@contextlib.contextmanager
def one_thread():
    """Tiny tensors: intra-op threads only add overhead to the slot loop."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def metrics(res) -> np.ndarray:
    """[seeds, 4]: mean completion slots and the locality fractions."""
    return np.stack([np.concatenate([[float(r.mean_completion_slots)],
                                     np.asarray(r.locality_fractions, np.float64)])
                     for r in res])


def port(algo, mode, seeds, load=LOAD, scenario=None):
    cfg = tsim.SimConfig(T=T, warmup=WARMUP, route_mode=mode)
    with one_thread():
        return metrics([tsim.simulate(algo, tcl.Cluster(M=M, K=K),
                                      tcl.Rates(*RATES), load, 1000 + s, cfg,
                                      scenario=scenario, device="cpu")
                        for s in seeds])


def jax_batched(algo, load=LOAD, scenario=None):
    cfg = jsim.SimConfig(T=T, warmup=WARMUP, route_mode="batched")
    res = jsim.simulate_grid(algo, jcl.Cluster(M=M, K=K), jcl.Rates(*RATES),
                             [load], SEEDS, cfg, scenario=scenario)
    return np.concatenate([np.asarray(res.mean_completion_slots)[:, :1],
                           np.asarray(res.locality_fractions)[:, 0, :]], axis=1)


def assert_within_ci(a, b, what):
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    gap = np.abs(a.mean(0) - b.mean(0))
    names = ("mean_completion_slots", "local", "rack", "remote")
    for n, g, s, ma, mb in zip(names, gap, se, a.mean(0), b.mean(0)):
        assert g <= 3 * s + 1e-6, f"{what}: {n} {ma:.4f} vs {mb:.4f} (3se={3 * s:.4f})"
