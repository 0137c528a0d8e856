"""Driver of a ``sweep`` cell: back-to-back ``simulate_sweep`` calls of the
port, scenarios x seeds x loads of one algorithm in one slot loop, as the
scenario registry's grid (``benchmarks/scenarios.py`` ``grid_main``) runs
them: every cell on its scenario's time-varying per-class speeds.

Configuration: the cluster, the loads (fractions of each scenario's capacity
edge), T, the ``scenarios`` by registered name and the ``pad`` ("registry":
the registry-wide ``canonical_pad``).  Traffic: ``algo`` and ``n_seeds``.
The program sizes the arrival buffer (``a_max``) from the scenarios' peak
intensities; the plain reference (``portbench/reference_hetero.py``)
realizes the same scenarios from their specs and sizes it again.  Call i of
a run draws its cells from generators seeded ``seed0(i) + k`` (k <
n_seeds), as the grid driver's calls do.  The work of a call is S x seeds x
loads x T simulated cell-slots.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import reference, reference_hetero
from portbench.drivers.grid import Grid, seed0


class Sweep(Grid):
    """One cell's set-up, its timed calls and its comparison."""

    def configure(self, config: dict, traffic: dict, seed: int, device):
        """The cell's shapes and traffic, the scenarios realized by the
        reference from the registry's specs."""
        from repro_torch import scenarios
        c = config
        self.seed, self.dev = int(seed), torch.device(device)
        self.algo, self.loads = traffic["algo"], [float(l) for l in c["loads"]]
        self.n_seeds = int(traffic["n_seeds"])
        self.pod = tuple(c["bp_pod"])
        self.M, self.K, self.rates = int(c["M"]), int(c["K"]), tuple(c["rates"])
        self.T, self.warmup, self.s_max = int(c["T"]), int(c["warmup"]), int(c["s_max"])
        self.route_mode, self.service = c["route_mode"], c["service_dist"]
        if c["pad"] != "registry":
            raise ValueError(f"pad {c['pad']!r}: a sweep cell pads to the registry")
        self.names = list(c["scenarios"])
        self.pad = scenarios.canonical_pad(self.sim.Cluster(self.M, self.K))
        self.scens = reference_hetero.realize(
            [scenarios.get_scenario(n) for n in self.names], self.M, self.K, self.rates,
            self.T, self.pad.n_windows)
        self.a_max = reference_hetero.a_max_for(self.scens, self.loads)
        self.cells = len(self.names) * self.n_seeds * len(self.loads)
        self.results = []               # each call's summary, on the host

    def _call(self, i: int, T: int, warmup: int):
        sim = self.sim
        cfg = sim.SimConfig(T=T, warmup=warmup, s_max=self.s_max,
                            route_mode=self.route_mode, service_dist=self.service)
        # the program sizes a_max in the timed calls; the warm call, shorter,
        # is given theirs so that it runs their shapes
        _, res, _ = sim.simulate_sweep(
            self.algo, sim.Cluster(self.M, self.K), sim.Rates(*self.rates), self.loads,
            self.n_seeds, cfg, pod=sim.PodSpec(*self.pod),
            seed0=seed0(self.seed, i, self.n_seeds), scenarios=self.names, pad=self.pad,
            a_max=None if T == self.T else self.a_max, device=self.dev)
        return res

    def route_commit_work(self, i: int) -> dict:
        """The routing launches of call i, one a slot, each at the cells'
        own [M, 3] inverse rates (``matrix``): the kernel, servers, arrival
        width, candidates and the arrivals each cell routes in each slot,
        replayed from the draws."""
        live = reference_hetero.arrivals(self._grid(self._seeds(i)), self.dev)
        return {"kernel": "route_commit_pod", "matrix": True, "M": self.M, "B": self.a_max,
                "C": 3 + sum(self.pod), "live": live.numpy()}

    def _grid(self, seeds) -> reference_hetero.Sweep:
        lams, cell_seeds, rows = reference_hetero.cells(self.scens, self.loads, seeds)
        return reference_hetero.Sweep(self.algo, self.M, self.K, self.rates, self.pod,
                                      self.T, self.warmup, self.a_max, self.s_max,
                                      self.scens, lams, cell_seeds, rows)

    def check(self, rng: np.random.Generator, fdt=torch.float32) -> dict:
        """Compare one timed call, drawn from ``rng``, cell by cell with the
        plain reference: {check name: [gap of each cell]}, exact."""
        i = int(rng.integers(len(self.results)))
        want = reference_hetero.run(self._grid(self._seeds(i)), self.dev, fdt)
        got = {k: v.reshape((self.cells,) + v.shape[3:]) if v.ndim >= 3 else v
               for k, v in self.results[i].items()}
        return {"result_gap": reference.gap(got, {k: v.cpu() for k, v in want.items()}).tolist()}


# each compared number's limit: the summaries of a call equal the
# reference's to the bit (readings in PERF.md)
LIMITS = {"result_gap": 0.0}


def prepare(config: dict, traffic: dict, seed: int, device) -> Sweep:
    """Set-up of a sweep cell: the program imported, the cell's shapes warm."""
    return Sweep(config, traffic, seed, device)
