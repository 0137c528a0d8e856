"""Versioned arrival-log format: ingest, validation, streaming slot batches.

Copy of ``repro.trace.format`` (numpy); the schema string is the
reference's, so a log written by either package reads in the other.

An :class:`ArrivalLog` is the canonical in-memory form of a timestamped,
chunk-addressed arrival trace — the raw material the trace->scenario
compiler (compile.py) lowers and the replay engine (replay.py) serves.
Two on-disk encodings round-trip exactly:

  JSONL   one header object (schema version + trace metadata) followed by
          one object per task: ``{"t": ..., "chunk": ..., "size": ...}``
          (plus ``"tenant"`` when present).  Human-greppable; streams.
  npz     packed columns (t / chunk / size / tenant) plus the same
          metadata — the compact interchange format.

Timestamps are float64 in ``[0, horizon)`` in the trace's own time unit
(the simulator is slot-grid agnostic: lowering bins ``t / horizon`` into
any T).  ``churn_t`` records placement-churn episode boundaries as
fractions of the horizon: at each boundary the chunk-id -> data mapping
changed upstream, so the compiler re-derives the placement catalog per
epoch.  ``validate_log`` is the schema checker (scripts/validate_trace.py runs
the reference's on a file)."""
from __future__ import annotations

import dataclasses
import json
from typing import Iterator, NamedTuple, Optional

import numpy as np

SCHEMA = "repro.trace/v1"


@dataclasses.dataclass(frozen=True, eq=False)
class ArrivalLog:
    """One arrival trace: sorted timestamps + per-task chunk / size / tenant.

    eq=False: comparing numpy columns element-wise has no useful dataclass
    semantics — use ``validate_log`` + explicit column comparison in tests.
    """

    name: str
    horizon: float                         # trace duration, own time unit
    t: np.ndarray                          # [N] f64 sorted, in [0, horizon)
    chunk: np.ndarray                      # [N] i64 chunk ids >= 0
    size: np.ndarray                       # [N] f32 size multipliers > 0
    tenant: Optional[np.ndarray] = None    # [N] i32, optional
    churn_t: tuple = ()                    # placement-churn boundaries (0,1)
    schema: str = SCHEMA

    @property
    def n_tasks(self) -> int:
        """Number of recorded arrivals."""
        return int(self.t.shape[0])

    @property
    def n_epochs(self) -> int:
        """Placement-churn epochs (boundaries + 1)."""
        return len(self.churn_t) + 1

    def epoch_bounds(self) -> np.ndarray:
        """[n_epochs + 1] f64 epoch boundaries in trace time units."""
        return np.asarray((0.0, *self.churn_t, 1.0)) * self.horizon

    def epoch_of(self) -> np.ndarray:
        """[N] int64 placement-epoch index of each task."""
        bounds = self.epoch_bounds()
        return np.clip(np.searchsorted(bounds, self.t, side="right") - 1,
                       0, self.n_epochs - 1)

    def slot_of(self, T: int) -> np.ndarray:
        """[N] int64 slot index on a T-slot grid over the horizon."""
        s = np.floor(self.t / self.horizon * T).astype(np.int64)
        return np.clip(s, 0, T - 1)

    def slot_counts(self, T: int) -> np.ndarray:
        """[T] int64 arrivals per slot (the compiler's lam_shape source)."""
        return np.bincount(self.slot_of(T), minlength=T)


def validate_log(log: ArrivalLog) -> list:
    """Schema check; returns a list of problem strings (empty == valid)."""
    errs = []
    if log.schema != SCHEMA:
        errs.append(f"schema {log.schema!r} != {SCHEMA!r}")
    if not (np.isfinite(log.horizon) and log.horizon > 0):
        errs.append(f"horizon {log.horizon!r} must be finite and > 0")
    n = log.t.shape[0]
    for col, want in (("chunk", n), ("size", n)):
        if getattr(log, col).shape[0] != want:
            errs.append(f"column {col!r} length != {want}")
    if log.tenant is not None and log.tenant.shape[0] != n:
        errs.append(f"column 'tenant' length != {n}")
    if n == 0:
        errs.append("empty trace (no tasks)")
        return errs
    if not np.all(np.diff(log.t) >= 0):
        errs.append("timestamps not sorted ascending")
    if float(log.t[0]) < 0 or float(log.t[-1]) >= log.horizon:
        errs.append("timestamps outside [0, horizon)")
    if not np.all(np.isfinite(log.t)):
        errs.append("non-finite timestamps")
    if np.any(log.chunk < 0):
        errs.append("negative chunk ids")
    if not np.all(np.isfinite(log.size)) or np.any(log.size <= 0):
        errs.append("sizes must be finite and > 0")
    ct = np.asarray(log.churn_t, np.float64)
    if ct.size and (np.any(ct <= 0) or np.any(ct >= 1)
                    or np.any(np.diff(ct) <= 0)):
        errs.append("churn_t must be strictly increasing fractions in (0,1)")
    return errs


def ensure_valid(log: ArrivalLog) -> ArrivalLog:
    """Pass the log through, raising ValueError listing schema errors."""
    errs = validate_log(log)
    if errs:
        raise ValueError("invalid arrival log: " + "; ".join(errs))
    return log


# ---------------------------------------------------------------------------
# JSONL encoding
# ---------------------------------------------------------------------------


def _header(log: ArrivalLog) -> dict:
    return {"schema": log.schema, "name": log.name,
            "horizon": float(log.horizon),
            "churn_t": [float(x) for x in log.churn_t],
            "n_tasks": log.n_tasks,
            "has_tenant": log.tenant is not None}


def write_jsonl(log: ArrivalLog, path) -> None:
    """Write the JSONL encoding: header object, then one task per line."""
    with open(path, "w") as f:
        f.write(json.dumps(_header(log)) + "\n")
        tenant = log.tenant
        for i in range(log.n_tasks):
            rec = {"t": float(log.t[i]), "chunk": int(log.chunk[i]),
                   "size": float(log.size[i])}
            if tenant is not None:
                rec["tenant"] = int(tenant[i])
            f.write(json.dumps(rec) + "\n")


def read_jsonl(path) -> ArrivalLog:
    """Read the JSONL encoding back (exact round-trip of write_jsonl)."""
    with open(path) as f:
        head = json.loads(next(f))
        t, chunk, size, tenant = [], [], [], []
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            t.append(rec["t"])
            chunk.append(rec["chunk"])
            size.append(rec["size"])
            if head.get("has_tenant"):
                tenant.append(rec["tenant"])
    return ArrivalLog(
        name=head.get("name", "unnamed"),
        horizon=float(head["horizon"]),
        t=np.asarray(t, np.float64),
        chunk=np.asarray(chunk, np.int64),
        size=np.asarray(size, np.float32),
        tenant=np.asarray(tenant, np.int32) if head.get("has_tenant")
        else None,
        churn_t=tuple(head.get("churn_t", ())),
        schema=head.get("schema", "missing"))


# ---------------------------------------------------------------------------
# Packed-npz encoding
# ---------------------------------------------------------------------------


def write_npz(log: ArrivalLog, path) -> None:
    """Write the packed-npz encoding (same columns as JSONL)."""
    cols = dict(t=log.t.astype(np.float64),
                chunk=log.chunk.astype(np.int64),
                size=log.size.astype(np.float32),
                schema=np.asarray(log.schema),
                name=np.asarray(log.name),
                horizon=np.asarray(log.horizon, np.float64),
                churn_t=np.asarray(log.churn_t, np.float64))
    if log.tenant is not None:
        cols["tenant"] = log.tenant.astype(np.int32)
    np.savez_compressed(path, **cols)


def read_npz(path) -> ArrivalLog:
    """Read the packed-npz encoding back (exact round-trip)."""
    with np.load(path, allow_pickle=False) as z:
        return ArrivalLog(
            name=str(z["name"]),
            horizon=float(z["horizon"]),
            t=np.asarray(z["t"], np.float64),
            chunk=np.asarray(z["chunk"], np.int64),
            size=np.asarray(z["size"], np.float32),
            tenant=(np.asarray(z["tenant"], np.int32)
                    if "tenant" in z.files else None),
            churn_t=tuple(np.asarray(z["churn_t"], np.float64).tolist()),
            schema=str(z["schema"]))


def load(path) -> ArrivalLog:
    """Read either encoding, dispatched on the file extension."""
    p = str(path)
    if p.endswith(".jsonl"):
        return read_jsonl(p)
    if p.endswith(".npz"):
        return read_npz(p)
    raise ValueError(f"unknown trace extension (want .jsonl or .npz): {p}")


# ---------------------------------------------------------------------------
# Streaming slot-batch reader
# ---------------------------------------------------------------------------


class SlotBatch(NamedTuple):
    """A fixed-width window of slots with its arrivals (host-side).

    slot0    first slot of the batch (multiples of batch_slots)
    counts   [batch_slots] int64 arrivals per slot
    slot     [n] int32 slot of each arrival, RELATIVE to slot0
    chunk    [n] int64
    size     [n] f32
    tenant   [n] i32 or None
    """

    slot0: int
    counts: np.ndarray
    slot: np.ndarray
    chunk: np.ndarray
    size: np.ndarray
    tenant: Optional[np.ndarray]


def iter_slot_batches(log: ArrivalLog, T: int,
                      batch_slots: int) -> Iterator[SlotBatch]:
    """Chunk an in-memory log into fixed-size slot batches (sorted input:
    one searchsorted per boundary, no per-task Python work)."""
    slots = log.slot_of(T)
    for s0 in range(0, T, batch_slots):
        s1 = min(s0 + batch_slots, T)
        lo = int(np.searchsorted(slots, s0, side="left"))
        hi = int(np.searchsorted(slots, s1, side="left"))
        sl = (slots[lo:hi] - s0).astype(np.int32)
        yield SlotBatch(
            slot0=s0,
            counts=np.bincount(sl, minlength=batch_slots),
            slot=sl,
            chunk=log.chunk[lo:hi],
            size=log.size[lo:hi],
            tenant=None if log.tenant is None else log.tenant[lo:hi])


def stream_slot_batches(path, T: int,
                        batch_slots: int) -> Iterator[SlotBatch]:
    """Stream a JSONL log into slot batches WITHOUT materializing the whole
    trace: holds one batch of tasks at a time (the ingest path for logs
    larger than host memory).  npz paths fall back to the in-memory
    iterator (npz is loaded whole by construction)."""
    p = str(path)
    if not p.endswith(".jsonl"):
        yield from iter_slot_batches(load(p), T, batch_slots)
        return
    with open(p) as f:
        head = json.loads(next(f))
        horizon = float(head["horizon"])
        has_tenant = bool(head.get("has_tenant"))
        width = horizon / T

        def flush(s0, buf):
            sl = np.asarray([b[0] for b in buf], np.int32) - s0
            return SlotBatch(
                slot0=s0,
                counts=np.bincount(sl, minlength=batch_slots),
                slot=sl,
                chunk=np.asarray([b[1] for b in buf], np.int64),
                size=np.asarray([b[2] for b in buf], np.float32),
                tenant=(np.asarray([b[3] for b in buf], np.int32)
                        if has_tenant else None))

        s0, buf = 0, []
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            s = min(int(rec["t"] / width), T - 1)
            while s >= s0 + batch_slots:
                yield flush(s0, buf)
                s0, buf = s0 + batch_slots, []
            buf.append((s, rec["chunk"], rec["size"],
                        rec.get("tenant", 0)))
        while s0 < T:
            yield flush(s0, buf)
            s0, buf = s0 + batch_slots, []
