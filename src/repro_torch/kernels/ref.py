"""Plain PyTorch versions of the scheduler kernels (mirror of
``repro.kernels.ref``).

Each ``*_ref`` here is the plain version of one CUDA kernel: the CPU path
runs it, and the tests and ``chip_smoke.py`` hold the kernel to it.  None
is the card's path.

Inverse-rate operand: the homogeneous ``[3]`` vector or a per-server
``[M, 3]`` matrix, ``+inf`` for a dead entry.  Dead entries score ``+inf``
after the multiply and contribute 0 workload.

Class 3 is the Pallas kernels' pad class and scores ``+inf`` in every
routing function here, as it does in the kernels.  (The JAX oracles
``weighted_argmin_ref`` / ``pod_route_ref`` gather ``inv[3]``, which JAX
clamps to class 2, so they score a class-3 entry as a remote one; the
port follows the kernels.)  Classes 0 and 1 read their own rate and any
other class reads class 2's, as the kernels' select chain does.
"""
from __future__ import annotations

from typing import Optional

import torch

from .invrates import CLASSES, FLAG_BASE, encode

_INF = float("inf")
_RANK_BIG = 2**62


def _finite_dead(inv_rates: torch.Tensor, M: int):
    """(finite reciprocal rates [M, 3], dead mask [M, 3]) from the shared
    encoding (invrates.encode)."""
    enc = encode(inv_rates, M)
    return enc[:, :CLASSES], enc[:, FLAG_BASE:FLAG_BASE + CLASSES] > 0


def _rate_lane(c: torch.Tensor) -> torch.Tensor:
    """The rate column a class reads: 0 and 1 their own, any other 2."""
    return torch.where((c == 0) | (c == 1), c, 2)


def _snapshot_scores(w, idx, c, finite, dead, ok=None):
    """w * inv[idx, c] in float32, +inf where the entry is dead, the class
    is 3 or more, or ``ok`` is False."""
    flat = idx * CLASSES + _rate_lane(c)
    bad = dead.reshape(-1).take(flat) | (c >= CLASSES)
    if ok is not None:
        bad |= ~ok
    return (w * finite.reshape(-1).take(flat)).masked_fill_(bad, _INF)


def weighted_argmin_ref(W: torch.Tensor, cls: torch.Tensor,
                        inv_rates: torch.Tensor):
    """Balanced-Pandas O(M) snapshot routing of a batch.

    W: [M] float32 or bfloat16 (cast to float32 first); cls: [B, M] int32;
    inv_rates: [3] or [M, 3].  Returns (sel [B] int32, val [B] float32):
    the lowest m minimising ``W[m] * inv[m, cls[b, m]]`` and that score.
    A row that scores ``+inf`` everywhere gives sel 0, val ``+inf``."""
    M = cls.shape[-1]
    finite, dead = _finite_dead(inv_rates, M)
    m = torch.arange(M, device=cls.device)
    scores = _snapshot_scores(W.to(torch.float32), m, cls.to(torch.int64),
                              finite, dead)
    val, sel = scores.min(dim=-1)
    return sel.to(torch.int32), val


def pod_route_ref(W: torch.Tensor, cand_idx: torch.Tensor,
                  cand_cls: torch.Tensor, valid: torch.Tensor,
                  inv_rates: torch.Tensor):
    """Balanced-Pandas-Pod O(d) snapshot routing over candidate lists.

    W: [M] float32 or bfloat16; cand_idx/cand_cls: [B, C] int32; valid:
    [B, C] bool; inv_rates: [3] or [M, 3].  Returns (sel [B] int32, val
    [B] float32): ``cand_idx[b, c*]`` for the lowest slot c* minimising
    ``W[cand] * inv[cand, cls]`` (invalid slots score ``+inf``), and that
    score.  A row that scores ``+inf`` everywhere gives ``cand_idx[b, 0]``.
    A candidate index outside 0..M-1 scores ``+inf``."""
    M = W.shape[0]
    finite, dead = _finite_dead(inv_rates, M)
    idx = cand_idx.to(torch.int64)
    inside = (idx >= 0) & (idx < M)
    idx_in = idx.clamp(0, M - 1)
    scores = _snapshot_scores(W.to(torch.float32).take(idx_in), idx_in,
                              cand_cls.to(torch.int64), finite, dead,
                              valid.to(torch.bool) & inside)
    val, slot = scores.min(dim=-1, keepdim=True)
    return cand_idx.gather(-1, slot)[:, 0].to(torch.int32), val[:, 0]


def queue_update_ref(Q: torch.Tensor, sel: torch.Tensor, sel_cls: torch.Tensor,
                     valid: torch.Tensor, inv_rates: torch.Tensor):
    """Commit a routed batch and refresh the workloads.

    Q: [M, 3] int32; sel/sel_cls: [B] int32; valid: [B] bool.  Returns
    (Q_new [M, 3] int32, W [M] float32): ``Q_new[sel[b], sel_cls[b]] += 1``
    for each valid arrival whose server is in 0..M-1 and whose class is in
    0..2 (the others, such as the pad server M or the pad class 3, are
    dropped), and ``W = workload(Q_new)`` with dead rates counting 0."""
    M = Q.shape[0]
    finite, _ = _finite_dead(inv_rates, M)
    s = sel.to(torch.int64)
    c = sel_cls.to(torch.int64)
    keep = valid.to(torch.bool) & (s >= 0) & (s < M) & (c >= 0) & (c < CLASSES)
    Q_new = Q.to(torch.int32).clone()
    Q_new.index_put_((s.clamp(0, M - 1), c.clamp(0, CLASSES - 1)),
                     keep.to(torch.int32), accumulate=True)
    return Q_new, workload(Q_new, finite)


def workload(Q: torch.Tensor, finite: torch.Tensor) -> torch.Tensor:
    """W[m] = (Q0*i0 + Q1*i1) + Q2*i2 in float32, in that order (the
    kernel pins the same order so exact ties break alike)."""
    x = Q.to(torch.float32) * finite
    return (x[..., 0] + x[..., 1]) + x[..., 2]


# one-cell rank of each route_commit operand that a cell axis may lead
_CELL_RANK = {"inv_rates": 2, "cls": 2, "prio": 1, "cand_idx": 2,
              "cand_cls": 2, "cand_valid": 2}


def route_commit_ref(Q: torch.Tensor, valid: torch.Tensor,
                     inv_rates: torch.Tensor, **kw):
    """``route_commit_cell`` of one batch (Q [M, 3]), or of one batch in
    each of N cells (Q [N, M, 3], valid [N, B]): a loop over the cells,
    each operand taken per cell when it has the leading N (inv_rates [N, M,
    3], cls [N, B, M], prio [N, M], cand_* [N, B, C]) and shared by every
    cell when it has not.  Returns the five outputs, each with a leading
    [N] when Q has one."""
    if Q.ndim != 3:
        return route_commit_cell(Q, valid, inv_rates, **kw)
    kw["inv_rates"] = inv_rates
    N = Q.shape[0]
    if valid.ndim != 2 or valid.shape[0] != N:
        raise ValueError(f"valid has shape {tuple(valid.shape)}, expected ({N}, B)")
    for name, t in kw.items():
        if t is not None and t.ndim > _CELL_RANK[name] + 1 or (
                t is not None and t.ndim > _CELL_RANK[name] and t.shape[0] != N):
            raise ValueError(f"{name} has shape {tuple(t.shape)}: not one "
                             f"operand a cell for {N} cells, nor one for all")
    cell = lambda n: {k: t[n] if t is not None and t.ndim > _CELL_RANK[k] else t
                      for k, t in kw.items()}
    outs = [route_commit_cell(Q[n], valid[n], **cell(n)) for n in range(N)]
    return tuple(torch.stack(x) for x in zip(*outs))


def route_commit_cell(Q: torch.Tensor, valid: torch.Tensor,
                      inv_rates: torch.Tensor, *,
                      cls: Optional[torch.Tensor] = None,
                      prio: Optional[torch.Tensor] = None,
                      cand_idx: Optional[torch.Tensor] = None,
                      cand_cls: Optional[torch.Tensor] = None,
                      cand_valid: Optional[torch.Tensor] = None):
    """Sequential-commit routing of one arrival batch.

    Arrival b scores against ``W0 + dW``, where ``dW`` holds the commits of
    arrivals ``0..b-1`` (``+inv_rates[sel, cls]`` each, 0 for a dead
    server).  Exact ties break by locality class, then ``prio`` (full
    variant, lower wins), then lowest server index (full, ``cls [B, M]``)
    or lowest candidate slot (pod, ``cand_idx/cand_cls/cand_valid [B, C]``;
    invalid slots lose every tie).  Arrivals with ``valid[b]`` False get a
    decision but commit nothing.

    Returns (Q_new [M, 3] int32, W_new [M] f32, sel [B] int32,
    sel_cls [B] int32, val [B] f32).  Reads ``valid`` on the host: only
    arrivals up to the last valid one route one by one, the rest score
    together against the final workloads.
    """
    M = Q.shape[0]
    dev = Q.device
    finite, dead = _finite_dead(inv_rates, M)
    W0 = workload(Q, finite)
    vl = valid.tolist()
    n_proc = max((b + 1 for b, v in enumerate(vl) if v), default=0)
    B = len(vl)

    # per-(arrival, slot) class, flat [M, 3] rate index and exact tie rank
    m = torch.arange(M, device=dev)
    if cls is not None:
        idx = None                        # slot j of every row is server j
        c = cls.to(torch.int64)
        flat = m * 3 + c.clamp(max=2)
        p = m if prio is None else prio.to(torch.int64)
        rank = (c * M + p) * M + m
    else:
        idx = cand_idx.to(torch.int64)
        c = cand_cls.to(torch.int64)
        v = cand_valid.to(torch.int64)
        flat = idx * 3 + c.clamp(max=2)
        C = idx.shape[1]
        rank = c * C + torch.arange(C, device=dev) + (1 - v) * (4 * C)
    fac = finite.reshape(-1).take(flat)
    bad = dead.reshape(-1).take(flat) | (c > 2)
    if idx is None:
        amt_all = fac * (c < 3)           # a class-3 pick commits nothing
    else:
        bad |= v == 0
        amt_all = fac

    def decide(w, rows):
        """(slot of each row's pick [.., 1], its score) against w."""
        wc = w if idx is None else w.take(idx[rows])
        scores = (wc * fac[rows]).masked_fill_(bad[rows], _INF)
        best = scores.amin(dim=-1, keepdim=True)
        r = rank[rows].masked_fill(scores != best, _RANK_BIG)
        return r.argmin(dim=-1, keepdim=True), best[..., 0]

    dw = torch.zeros(M, dtype=torch.float32, device=dev)
    picks, vals = [], []
    for b in range(n_proc):
        j, best = decide(W0 + dw, b)
        if vl[b]:
            server = j if idx is None else idx[b].take(j)
            dw.index_put_((server,), amt_all[b].take(j), accumulate=True)
        picks.append(j)
        vals.append(best)
    # arrivals after the last valid one all score against the final dW
    j, best = decide(W0 + dw, slice(n_proc, B))
    if picks:
        j = torch.cat([torch.stack(picks), j])
        best = torch.cat([torch.stack(vals), best])
    sel = j[:, 0] if idx is None else idx.gather(1, j)[:, 0]
    scls = c.gather(1, j)[:, 0]

    commit = (valid.to(torch.bool) & (scls < 3)).to(torch.int32)
    Q_new = Q.to(torch.int32).clone()
    Q_new.index_put_((sel, scls.clamp(max=2)), commit, accumulate=True)
    return (Q_new, W0 + dw, sel.to(torch.int32), scls.to(torch.int32),
            best.to(torch.float32))


def route_commit_wseq(Q: torch.Tensor, sel: torch.Tensor, sel_cls: torch.Tensor,
                      valid: torch.Tensor, inv_rates: torch.Tensor) -> torch.Tensor:
    """The pre-commit workload each arrival routed against: [B, M].

    Row b is ``W0 + (commits of arrivals 0..b-1)`` — exactly what
    route_commit scored arrival b with."""
    M = Q.shape[0]
    finite, _ = _finite_dead(inv_rates, M)
    W0 = workload(Q, finite)
    m = torch.arange(M, device=Q.device)
    s = sel.to(torch.int64)
    c = sel_cls.to(torch.int64)
    amt = finite[s, c.clamp(max=2)] * (c < 3) * valid.to(torch.bool)
    dw = torch.zeros(M, dtype=torch.float32, device=Q.device)
    rows = []
    for b in range(s.shape[0]):
        rows.append(W0 + dw)
        dw = dw + torch.where(m == s[b], amt[b], 0.0)
    return torch.stack(rows) if rows else W0.new_empty((0, M))
