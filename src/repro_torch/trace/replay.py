"""Trace replay over the ``route_commit`` kernel (mirror of
``repro.trace.replay``).

``ReplayEngine`` serves a recorded arrival log through the Balanced-Pandas
family's fused router.  Everything known before the run leaves the slot
loop:

  host prep (once)   timestamps are binned to the slot grid, every task's
                     catalog row is resolved (compile.arrival_rows) and the
                     per-slot arrival tensors ([T, A, 3] replica triples
                     and a validity mask) are packed, on the card's side in
                     pinned host memory.
  chunk prep         per chunk of S slots, the locality classes ([S, A, M])
                     and, for BP-Pod, the candidate lists ([S, A, C]) are
                     made at once; the slot loop then runs service
                     progress, local scheduling, one ``route_commit``
                     launch and the accumulators.  No Poisson draw, no
                     catalog draw, no speed windows (a trace realization
                     has none: the homogeneous path).
  double buffering   on the card, chunk c+1 is copied into the second of
                     two device buffers on a side stream while chunk c runs;
                     the copy into a buffer waits on an event for the chunk
                     that still reads it, and a chunk waits on an event for
                     its own copy.  Device memory holds two chunks however
                     long the trace.  On the CPU the chunks are views.

The dynamics are the simulator's: every slot of the chunk step is its
``_bp_step`` (service progress, local scheduling, one ``route_commit``
launch, the accumulators and the collectors) with the same size law, so
``summarize`` gives a SimResult comparable to ``simulate`` on the
trace-lowered scenario.

Random draws come once a chunk through a seam, as in the simulator: a
callable ``draws(c, locals_c, cls_c)`` returning the chunk's
``ReplayDraws``.  The default (``TorchReplayDraws``) fills it from a
``torch.Generator``; a test fills it from the reference's key derivation
and holds the chunk step to the reference's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.cluster import Cluster, Rates, locality_class, safe_inv_rates
from ..core.policies import PodSpec, pod_candidate_classes, pod_candidates
from ..core.simulator import (_HALF_SQRT2, BPState, RawSums, SimConfig,
                              SimResult, SlotDraws, _bp_step, _drop, _pod_for,
                              draw_durations, resolve_device, summarize)
from ..scenarios.build import host, realize
from ..telemetry import collectors as tlm
from .compile import arrival_rows, scenario_from_trace
from .format import ArrivalLog, ensure_valid


class ReplayDraws(NamedTuple):
    """Every random number one chunk of S slots consumes."""

    dur: torch.Tensor                          # int32 [S, M, 3] duration per
    #                                            server and class
    size_e: Optional[torch.Tensor] = None      # f32 [S, M] N(0, 1/2) size-law
    #                                            draws (size_sigma > 0)
    prio: Optional[torch.Tensor] = None        # int32 [S, M] tie permutation
    #                                            (full BP)
    cand_idx: Optional[torch.Tensor] = None    # int32 [S, A, C] (BP-Pod)
    cand_valid: Optional[torch.Tensor] = None  # bool [S, A, C], before the
    #                                            arrival mask


ChunkDrawSource = Callable[[int, torch.Tensor, torch.Tensor], ReplayDraws]


class TorchReplayDraws:
    """Default chunk draws from ``gen`` (a torch.Generator on the replay's
    device): the candidates of the whole chunk, then the slots' durations,
    size-law draws and (full BP) tie permutations."""

    def __init__(self, gen: torch.Generator, cluster: Cluster, rates: Rates,
                 cfg: SimConfig, pod: Optional[PodSpec], sized: bool,
                 device):
        self.gen, self.cluster, self.cfg, self.pod = gen, cluster, cfg, pod
        self.sized = sized
        self.p = rates.as_array(device)
        if pod is not None:
            self.cand_cls = pod_candidate_classes(cluster.n_replicas, pod, device)

    def __call__(self, c: int, locals_c: torch.Tensor,
                 cls_c: torch.Tensor) -> ReplayDraws:
        del c
        g, M, S = self.gen, self.cluster.M, locals_c.shape[0]
        dev = locals_c.device
        extra = {}
        if self.pod is not None:
            ci, _, cv = pod_candidates(g, self.cluster, locals_c, cls_c, self.pod,
                                       cand_cls=self.cand_cls)
            extra.update(cand_idx=ci, cand_valid=cv)
        dur = draw_durations(g, self.cfg, self.p, S, M)
        if self.sized:
            extra["size_e"] = torch.randn((S, M), generator=g,
                                          device=dev) * _HALF_SQRT2
        if self.pod is None:
            extra["prio"] = torch.rand((S, M), generator=g,
                                       device=dev).argsort(dim=1).to(torch.int32)
        return ReplayDraws(dur, **extra)


def _replay_chunk(state: BPState, sums: RawSums, tele, cls_c: torch.Tensor,
                  mask_c: torch.Tensor, t0: int, sizes, draws: ReplayDraws, *,
                  cluster: Cluster, cfg: SimConfig, pod: Optional[PodSpec],
                  tcfg, t_pad: int, inv_rates: torch.Tensor,
                  cand_cls: Optional[torch.Tensor]):
    """Advance the replay by one chunk of S slots; returns (state, sums)
    and updates the telemetry in place.  Every slot is the simulator's
    ``_bp_step`` on one cell, fed the chunk's slot as its ``SlotDraws``:
    a slot's arrivals are packed at the front of its row, so their count
    stands in for the Poisson draw and never clips.

    state, sums and tele lead by one cell; cls_c: int32 [S, A, M] locality
    classes of the chunk's arrivals; mask_c: bool [S, A]; t0: the chunk's
    first slot; draws: the chunk's ``ReplayDraws``; pod: None for full BP;
    cand_cls: [A, C] int32 (pod); tcfg has sojourns and probes off (the
    slot draws carry no replica triples for the probes)."""
    S, A = mask_c.shape
    half2_from = cfg.warmup + (cfg.T - cfg.warmup) // 2
    step_cfg = dataclasses.replace(cfg, T=t_pad, route_mode="batched")
    raw_c = mask_c.sum(dim=-1, dtype=torch.int32)               # [S]
    cand_valid = None if pod is None else draws.cand_valid & mask_c[..., None]
    one = lambda x, s: None if x is None else x[s][None]  # noqa: E731
    for s in range(S):
        t = t0 + s
        slot = SlotDraws(raw=one(raw_c, s), locals_=None,
                         cls=None if pod is not None else one(cls_c, s),
                         dur=one(draws.dur, s), prio=one(draws.prio, s),
                         cand_idx=one(draws.cand_idx, s),
                         cand_valid=one(cand_valid, s),
                         size_e=one(draws.size_e, s))
        state, sums = _bp_step(
            state, sums, slot, cluster=cluster, cfg=step_cfg,
            inv_rate_m=inv_rates, pod=pod, a_max=A,
            measure=cfg.warmup <= t < cfg.T, in_half2=t >= half2_from,
            cand_cls=cand_cls, scen=sizes, t=t, tele=tele, tcfg=tcfg)
    return state, sums


class ReplayResult(NamedTuple):
    """One replay run: summary statistics and sustained routing throughput
    (the reference's fields, in its order)."""

    result: SimResult               # summarize() over the replayed run
    sums: RawSums
    telemetry: Optional[object]     # Telemetry (None if off)
    routed_tasks: int               # total trace arrivals routed
    wall_s: float
    tasks_per_s: float              # routed_tasks / wall_s (sustained)
    trace_count: int                # the reference counts its chunk step's
    #                                 JAX traces here; the port traces and
    #                                 compiles nothing, so it is always 0


class ReplayEngine:
    """Replay an ArrivalLog through the fused router (see module docstring).

    algo: "balanced_pandas" (full O(M) routing) or "balanced_pandas_pod"
    (power-of-d candidates).  cfg.T sets the slot grid the trace is binned
    into; cfg.route_mode is ignored (replay is always the batched path).
    telemetry: a TelemetryConfig for per-window collection (sojourn rings
    and probes are off: they are per-slot costs the replay path avoids).
    device: None runs on the CUDA card (and raises without one); "cpu"
    runs on the CPU."""

    def __init__(self, log: ArrivalLog, cluster: Cluster, rates: Rates,
                 *, cfg: SimConfig = SimConfig(),
                 algo: str = "balanced_pandas_pod",
                 pod: Optional[PodSpec] = None, chunk_slots: int = 500,
                 chunks_per_server: int = 4,
                 telemetry: Optional[tlm.TelemetryConfig] = None,
                 device=None):
        if algo not in ("balanced_pandas", "balanced_pandas_pod"):
            raise ValueError(f"replay serves the BP family, not {algo!r}")
        self.device = resolve_device(device)
        self.log = ensure_valid(log)
        self.cluster, self.rates, self.cfg = cluster, rates, cfg
        self.algo = algo
        self.pod = _pod_for(algo, pod)
        self.chunk_slots = int(chunk_slots)
        self.tcfg = (dataclasses.replace(telemetry, sojourns=False,
                                         probes=False)
                     if telemetry is not None else None)

        # -- lower + realize (unpadded: window-free == homogeneous path) --
        self.scenario = scenario_from_trace(
            log, name=f"replay:{log.name}",
            chunks_per_server=chunks_per_server)
        self.scen, self.lam_cap = realize(self.scenario, cluster, rates,
                                          cfg.T, device=self.device)
        self.load = float(log.n_tasks / (cfg.T * self.lam_cap))

        # -- host prep: pack per-slot arrival tensors ---------------------
        T = cfg.T
        rows = arrival_rows(log, cluster.M
                            * self.scenario.placement.chunks_per_server)
        triples = host(self.scen.chunk_locals)[rows]            # [N, 3]
        slots = log.slot_of(T)
        counts = np.bincount(slots, minlength=T)
        self.a_cap = int(max(counts.max(), 1))
        offsets = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(log.n_tasks) - offsets[slots]
        S = self.chunk_slots
        self.n_chunks = -(-T // S)
        t_pad = self.n_chunks * S
        locals_pad = np.zeros((t_pad, self.a_cap, cluster.n_replicas),
                              np.int32)
        locals_pad[:, :, :] = np.arange(cluster.n_replicas, dtype=np.int32)
        mask_pad = np.zeros((t_pad, self.a_cap), bool)
        locals_pad[slots, within] = triples
        mask_pad[slots, within] = True
        self._t_pad = t_pad
        self._locals = torch.from_numpy(locals_pad)
        self._mask = torch.from_numpy(mask_pad)
        if self.device.type == "cuda":      # an unpinned copy is synchronous
            self._locals = self._locals.pin_memory()
            self._mask = self._mask.pin_memory()
        self._cand_cls = None
        if self.pod is not None:
            self._cand_cls = pod_candidate_classes(
                cluster.n_replicas, self.pod, self.device).expand(
                self.a_cap, -1).contiguous()

    def _host_chunk(self, c: int):
        S = self.chunk_slots
        return self._locals[c * S:(c + 1) * S], self._mask[c * S:(c + 1) * S]

    def _chunks(self):
        """(c, locals_c, mask_c) on the device, chunk by chunk, with the
        next chunk's copy in flight while the caller computes on this one
        (the caller's work on a chunk is enqueued before it asks for the
        next)."""
        if self.device.type != "cuda":
            for c in range(self.n_chunks):
                yield (c,) + self._host_chunk(c)
            return
        dev = self.device
        compute = torch.cuda.current_stream(dev)
        copy = torch.cuda.Stream(dev)
        S, A, R = self.chunk_slots, self.a_cap, self.cluster.n_replicas
        bufs = [(torch.empty((S, A, R), dtype=torch.int32, device=dev),
                 torch.empty((S, A), dtype=torch.bool, device=dev))
                for _ in range(2)]
        ready = [torch.cuda.Event() for _ in range(2)]
        free = [torch.cuda.Event() for _ in range(2)]

        def put(c):
            b = c % 2
            with torch.cuda.stream(copy):
                copy.wait_event(free[b])       # the chunk that read it is done
                for dst, src in zip(bufs[b], self._host_chunk(c)):
                    dst.copy_(src, non_blocking=True)
                ready[b].record(copy)

        put(0)
        for c in range(self.n_chunks):
            b = c % 2
            if c + 1 < self.n_chunks:
                put(c + 1)                    # overlaps chunk c's slots
            compute.wait_event(ready[b])
            yield (c,) + bufs[b]
            free[b].record(compute)
        copy.synchronize()

    def run(self, seed: int = 0, *,
            draws: Optional[ChunkDrawSource] = None) -> ReplayResult:
        """One full replay pass; the wall time covers the copies and the
        slots (the sustained rate).  ``draws``: a chunk draw source
        replacing the default ``TorchReplayDraws`` seeded ``seed``."""
        dev, cl = self.device, self.cluster
        if draws is None:
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            draws = TorchReplayDraws(gen, cl, self.rates, self.cfg, self.pod,
                                     float(self.scen.size_sigma) > 0.0, dev)
        state = BPState.zero(cl.M, dev, 1)
        sums = RawSums.zero(dev, 1)
        tele = (tlm.zero_telemetry(self.tcfg, cl.M, "bp", device=dev, cells=1)
                if self.tcfg is not None else None)
        kw = dict(cluster=cl, cfg=self.cfg, pod=self.pod, tcfg=self.tcfg,
                  t_pad=self._t_pad,
                  inv_rates=safe_inv_rates(self.rates.as_array(dev)),
                  cand_cls=self._cand_cls)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_start = time.perf_counter()
        for c, locals_c, mask_c in self._chunks():
            cls_c = locality_class(cl, locals_c)                # [S, A, M]
            state, sums = _replay_chunk(state, sums, tele, cls_c, mask_c,
                                        c * self.chunk_slots, self.scen,
                                        draws(c, locals_c, cls_c), **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t_start
        sums = _drop(sums)
        n = self.log.n_tasks
        return ReplayResult(
            result=summarize(sums, self.algo, cl, self.rates, self.pod),
            sums=sums, telemetry=None if tele is None else _drop(tele),
            routed_tasks=n, wall_s=wall, tasks_per_s=n / max(wall, 1e-9),
            trace_count=0)

    def benchmark(self, seed: int = 0) -> ReplayResult:
        """A warm pass, then a timed pass; returns the timed pass's
        result."""
        self.run(seed)
        return self.run(seed)

    def telemetry_events(self, res: ReplayResult, **manifest_extra) -> list:
        """Flatten a replay's telemetry into schema-v1 JSONL events."""
        from ..telemetry import export
        if res.telemetry is None:
            raise ValueError("engine was built without telemetry")
        manifest = export.run_manifest(
            kind="trace_replay", trace=self.log.name, algo=self.algo,
            M=self.cluster.M, K=self.cluster.K, T=self.cfg.T,
            warmup=self.cfg.warmup, load=self.load,
            tasks=res.routed_tasks, wall_s=res.wall_s,
            tasks_per_s=res.tasks_per_s, trace_count=res.trace_count,
            **manifest_extra)
        return export.to_events(res.telemetry, self.tcfg, T=self._t_pad,
                                warmup=self.cfg.warmup, manifest=manifest)
