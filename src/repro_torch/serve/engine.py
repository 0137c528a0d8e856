"""Serving engine: batched decode over replica groups, requests routed by
the paper's Balanced-Pandas-Pod (``repro_torch.sched.PodRouter``).

PyTorch mirror of ``repro.serve.engine``.  The engine is two-layer:
  - token generation is real: ``decode_step`` of the supplied model on the
    params' device, one batched decode a replica a tick;
  - the locality cost model is the paper's: a request served by a replica
    that holds its prefix (local) starts decoding immediately; same-pod
    (rack-local) pays a fetch delay; other-pod (remote) a longer one —
    delays in engine ticks (``FETCH_TICKS``), mirroring the alpha / beta /
    gamma service rates of ``sched.locality``.

Metrics: per-request completion time (arrival -> last token), locality
mix, router probes per decision (the paper's O(M) against O(1) axis),
per-tick queue-depth / batch-size traces, and latency p50 / p95 read from
the shared log-spaced histogram (``telemetry.hist``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..models import decode_step, init_cache, logits_fn
from ..sched.locality import FleetTopology
from ..sched.router import PodRouter
from ..telemetry.hist import np_hist, percentiles


@dataclasses.dataclass
class Request:
    rid: int
    prefix_id: int
    prompt: np.ndarray             # [P] int32
    max_new: int
    arrival: int
    replica: int = -1
    cls: int = -1
    start_tick: int = -1
    done_tick: int = -1
    generated: Optional[list] = None


@dataclasses.dataclass
class EngineStats:
    completions: list
    locality: np.ndarray
    probes_per_decision: float
    queue_depth_trace: Optional[np.ndarray] = None   # [ticks] waiting reqs
    batch_size_trace: Optional[np.ndarray] = None    # [ticks] active reqs
    latency_hist: Optional[np.ndarray] = None        # telemetry.hist bins
    latency_p50: float = float("nan")
    latency_p95: float = float("nan")
    note: Optional[str] = None     # set when percentiles are NaN (and why)


def params_device(params: dict) -> torch.device:
    """The device of a params tree (of its first tensor)."""
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class ServeEngine:
    """One engine tick == one decode token per active request (plus any
    locality fetch delay before a request's first token).  Runs on its
    params' device; the router must be on the same one."""

    FETCH_TICKS = {0: 0, 1: 4, 2: 16}     # local / rack (ICI) / remote (DCN)

    def __init__(self, cfg, params, fleet: FleetTopology, router: PodRouter,
                 prefix_homes: dict, max_batch: int = 8, seed: int = 0):
        self.device = params_device(params)
        if router.Q.device != self.device:
            raise ValueError(f"the router is on {router.Q.device}, the params "
                             f"on {self.device}: put both on one device")
        self.cfg, self.params = cfg, params
        self.fleet = fleet
        self.router = router
        self.prefix_homes = prefix_homes     # prefix_id -> [replica ids]
        self.max_batch = max_batch
        self.active: dict[int, list[Request]] = {
            r: [] for r in range(fleet.n_replicas)}
        self.waiting: dict[int, list[Request]] = {
            r: [] for r in range(fleet.n_replicas)}
        self.tick = 0
        self.done: list[Request] = []
        self._queue_depth_trace: list[int] = []
        self._batch_size_trace: list[int] = []
        self._decode = functools.partial(self._decode_impl, cfg=cfg)
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _decode_impl(params, cache, tok, pos, cfg):
        h, cache = decode_step(params, cfg, cache, tok, pos)
        logits = logits_fn(params["embed"], h)[:, 0]
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    # ------------------------------------------------------------------

    def submit(self, reqs: list[Request]):
        homes = np.stack([self.prefix_homes[r.prefix_id] for r in reqs])
        chosen = self.router.route(homes)
        for r, rep in zip(reqs, chosen):
            r.replica = int(rep)
            r.cls = int(0 if rep in self.prefix_homes[r.prefix_id]
                        else 1 if self.fleet.pod_of(rep) in
                        {self.fleet.pod_of(h) for h in
                         self.prefix_homes[r.prefix_id]} else 2)
            r.start_tick = self.tick + self.FETCH_TICKS[r.cls]
            r.generated = []
            self.waiting[r.replica].append(r)

    def step(self):
        """One tick: admit fetch-complete requests, decode one token for
        every active request on every replica (one real batched decode per
        replica), retire finished requests."""
        self.tick += 1
        self._queue_depth_trace.append(
            sum(len(q) for q in self.waiting.values()))
        self._batch_size_trace.append(
            sum(len(b) for b in self.active.values()))
        for rep in range(self.fleet.n_replicas):
            admit = [r for r in self.waiting[rep]
                     if r.start_tick <= self.tick
                     and len(self.active[rep]) < self.max_batch]
            for r in admit:
                self.waiting[rep].remove(r)
                self.active[rep].append(r)
            batch = self.active[rep]
            if not batch:
                continue
            B = len(batch)
            # real decode: feed last token of each request's stream
            toks = np.array([[r.prompt[-1] if not r.generated
                              else r.generated[-1]] for r in batch],
                            np.int32)
            pos = np.array([len(r.prompt) + len(r.generated) - 1
                            for r in batch], np.int32)
            S = int(max(pos.max() + 2, 16))
            cache = init_cache(self.cfg, B, S, device=self.device)
            nxt, _ = self._decode(self.params, cache,
                                  torch.from_numpy(toks).to(self.device),
                                  torch.from_numpy(pos).to(self.device))
            finished = []
            for r, t in zip(batch, nxt.cpu().numpy()):
                r.generated.append(int(t))
                if len(r.generated) >= r.max_new:
                    r.done_tick = self.tick
                    finished.append(r)
            for r in finished:
                self.active[rep].remove(r)
                self.router.complete(np.array([r.replica]),
                                     np.array([r.cls]))
                self.done.append(r)

    def run(self, until_done: int, max_ticks: int = 100_000) -> EngineStats:
        while len(self.done) < until_done and self.tick < max_ticks:
            self.step()
        return self._stats()

    def run_arrivals(self, schedule, make_request,
                     max_ticks: int = 100_000) -> EngineStats:
        """Replay a scenario-driven arrival trace: ``schedule[i]`` requests
        are submitted at tick i (e.g. ``scenarios.arrival_counts`` for
        MMPP / diurnal / flash-crowd traffic shapes), then drain.

        make_request(arrival_tick) -> Request (with ``arrival`` set)."""
        total = int(np.sum(schedule))
        i = 0
        while (i < len(schedule) or len(self.done) < total) \
                and self.tick < max_ticks:
            if i < len(schedule):
                n = int(schedule[i])
                if n:
                    self.submit([make_request(self.tick) for _ in range(n)])
                i += 1
            self.step()
        return self._stats()

    def _stats(self) -> EngineStats:
        comp = [r.done_tick - r.arrival for r in self.done]
        loc = np.bincount([r.cls for r in self.done], minlength=3)
        probes = (self.router.stats.probes
                  / max(self.router.stats.decisions, 1))
        hist = np_hist(comp) if comp else None
        p50 = p95 = float("nan")
        note = None
        if hist is not None:
            p50, p95 = percentiles(hist, (50, 95))
        if not np.isfinite(p50) or not np.isfinite(p95):
            note = (f"zero completions in {self.tick} ticks: latency "
                    f"p50/p95 are NaN (not 0 — nothing finished)")
            print(f"[serve] NOTE: {note}")
        return EngineStats(
            completions=comp, locality=loc / max(len(self.done), 1),
            probes_per_decision=probes,
            queue_depth_trace=np.asarray(self._queue_depth_trace, np.int64),
            batch_size_trace=np.asarray(self._batch_size_trace, np.int64),
            latency_hist=hist, latency_p50=p50, latency_p95=p95, note=note)
