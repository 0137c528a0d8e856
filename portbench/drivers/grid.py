"""Driver of a ``grid`` cell: back-to-back ``simulate_grid`` calls of the
port, loads x seeds of one algorithm in one slot loop, as a paper figure's
grid runs them.

Traffic (the cell's ``traffic`` file): ``algo`` and ``n_seeds``; the
loads, the run length and the cluster are the configuration's, and the
arrival buffer is the simulator's default width for the largest load.
Call i of a run draws its cells from generators seeded ``seed0(i) + k``
(k < n_seeds), so every call simulates new traffic of the same shape.
The work of a call is cells x T simulated cell-slots.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import reference

_CALLS = 1 << 12          # seed space of one run: 4096 / n_seeds calls


def seed0(run_seed: int, call: int, n_seeds: int) -> int:
    """First generator seed of call ``call`` (-1: the set-up's warm call)."""
    slot = _CALLS // n_seeds - 1 if call < 0 else call
    if not 0 <= slot < _CALLS // n_seeds:
        raise ValueError(f"call {call} is past the run's seed space")
    return run_seed * _CALLS + slot * n_seeds


class Grid:
    """One cell's set-up, its timed calls and its comparison."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.core import simulator      # the system under test
        self.sim = simulator
        self.configure(config, traffic, seed, device)
        # the set-up's warm call: every shape of the timed calls, over a draw
        # block and a few slots of the next, at a seed the window never uses
        T_w = min(self.T, reference.draw_block(self._grid([0])) + 8)
        self._call(-1, T=T_w, warmup=T_w // 4)
        self._sync()

    def configure(self, config: dict, traffic: dict, seed: int, device):
        """The cell's shapes and traffic, from its two files."""
        c = config
        self.seed, self.dev = int(seed), torch.device(device)
        self.algo, self.loads = traffic["algo"], list(c["loads"])
        self.n_seeds = int(traffic["n_seeds"])
        pods = {"balanced_pandas_pod": "bp_pod", "jsq_maxweight_pod": "jsqmw_pod"}
        self.pod = tuple(c[pods[self.algo]]) if self.algo in pods else ()
        self.M, self.K, self.rates = int(c["M"]), int(c["K"]), tuple(c["rates"])
        self.T, self.warmup, self.s_max = int(c["T"]), int(c["warmup"]), int(c["s_max"])
        self.route_mode, self.service = c["route_mode"], c["service_dist"]
        self.a_max = reference.a_max_for(self._lams([0]))
        self.cells = self.n_seeds * len(self.loads)
        self.results = []               # each call's summary, on the host

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _call(self, i: int, T: int, warmup: int):
        sim = self.sim
        cfg = sim.SimConfig(T=T, warmup=warmup, s_max=self.s_max,
                            route_mode=self.route_mode, service_dist=self.service)
        return sim.simulate_grid(
            self.algo, sim.Cluster(self.M, self.K), sim.Rates(*self.rates), self.loads,
            self.n_seeds, cfg, pod=sim.PodSpec(*self.pod) if self.pod else None,
            seed0=seed0(self.seed, i, self.n_seeds), device=self.dev)

    def call(self, i: int) -> float:
        """Timed call i, synchronised; returns its cell-slots."""
        res = self._call(i, self.T, self.warmup)
        self._sync()
        self.results.append({k: getattr(res, k).detach().cpu() for k in reference.FIELDS})
        return float(self.cells * self.T)

    def end_to_end(self, work: float, seconds: float) -> dict:
        return {"cell_slots_per_s": work / seconds}

    def slot_steps(self, calls: int) -> int:
        """Slot steps of ``calls`` whole calls (one step advances every cell)."""
        return calls * self.T

    def route_commit_work(self, i: int) -> dict:
        """The routing launches of call i, one a slot: the kernel, servers,
        arrival width, candidates (None: every server) and the arrivals each
        cell routes in each slot, replayed from the draws."""
        live = reference.arrivals(self._grid(self._seeds(i)), self.dev)
        return {"kernel": "route_commit_pod" if self.pod else "route_commit_full",
                "M": self.M, "B": self.a_max,
                "C": (3 + sum(self.pod)) if self.pod else None, "live": live.numpy()}

    def _seeds(self, i: int) -> list:
        s0 = seed0(self.seed, i, self.n_seeds)
        return [s0 + k for k in range(self.n_seeds)]

    def _lams(self, seeds) -> list:
        lam_cap = self.M * self.rates[0]         # uniform placement's capacity edge
        return [float(l) * lam_cap for _ in seeds for l in self.loads]

    def _grid(self, seeds) -> reference.Grid:
        return reference.Grid(self.algo, self.M, self.K, self.rates, self.pod, self.T,
                              self.warmup, self.a_max, self.s_max, self._lams(seeds),
                              [s for s in seeds for _ in self.loads])

    def check(self, rng: np.random.Generator, fdt=torch.float32) -> dict:
        """Compare one timed call, drawn from ``rng``, cell by cell with the
        plain reference: {check name: [gap of each cell]}.  A cell's gap is
        the largest relative gap of any summary field; the comparison is
        exact (``LIMITS``)."""
        i = int(rng.integers(len(self.results)))
        want = reference.run(self._grid(self._seeds(i)), self.dev, fdt)
        got = {k: v.reshape((self.cells,) + v.shape[2:]) if v.ndim >= 2 else v
               for k, v in self.results[i].items()}
        return {"result_gap": reference.gap(got, {k: v.cpu() for k, v in want.items()}).tolist()}


# each compared number's limit: the summaries of a call equal the
# reference's to the bit (readings in PERF.md)
LIMITS = {"result_gap": 0.0}


def prepare(config: dict, traffic: dict, seed: int, device) -> Grid:
    """Set-up of a grid cell: the program imported, the cell's shapes warm."""
    return Grid(config, traffic, seed, device)
