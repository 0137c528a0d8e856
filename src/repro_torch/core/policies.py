"""Routing policies from the paper (§IV) as PyTorch functions.

Mirror of ``repro.core.policies``: exact lexicographic arg-min/max with
masking, power-of-d candidate sampling, the O(M) and O(d) Balanced-Pandas
routing rules, join-the-shortest-local-queue routing, the in-rack and
out-of-rack peer draws of JSQ-MaxWeight-Pod scheduling, and the
message-complexity counters.  Random draws come from an explicit
``torch.Generator``; where the reference takes a key to draw tie-break
uniforms, the port takes the uniforms themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .cluster import LOCAL, RACK, REMOTE, Cluster, uniform_int

_INF = float("inf")


def lex_argmin(values: torch.Tensor, *tiebreaks: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Exact staged arg-min over the last axis: minimize ``values`` over
    ``mask``; break ties by each ``tiebreaks`` array in turn (lower wins);
    final ties -> lowest index.  Returns int32 [...]."""
    v = torch.where(mask, values, _INF)
    best = v.min(dim=-1, keepdim=True).values
    tie = (v == best) & mask
    for tb in tiebreaks:
        t = torch.where(tie, tb, _INF)
        tie = tie & (t == t.min(dim=-1, keepdim=True).values)
    return torch.argmax(tie.to(torch.uint8), dim=-1).to(torch.int32)


def lex_argmax(values: torch.Tensor, *tiebreaks: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``lex_argmin`` on negated values: masked argmax with tie lanes."""
    return lex_argmin(-values, *tiebreaks, mask=mask)


def masked_draws(gen: torch.Generator, set_mask: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k uniform-with-replacement draws from each row of ``set_mask``.

    set_mask: bool [..., M].  Returns (idx int32 [..., k], valid bool
    [..., k]); rows with an empty set yield valid=False.  Inversion by
    counting, as in the JAX reference: the (u+1)-th set member is the
    number of prefix counts <= u."""
    csum = torch.cumsum(set_mask.to(torch.int32), dim=-1, dtype=torch.int32)
    total = csum[..., -1:]
    u = uniform_int(gen, set_mask.shape[:-1] + (k,), torch.clamp_min(total, 1),
                    set_mask.device)
    idx = (csum[..., None, :] <= u[..., :, None]).sum(dim=-1, dtype=torch.int32)
    valid = (total > 0).expand(idx.shape)
    return torch.clamp_max(idx, set_mask.shape[-1] - 1), valid


def weighted_score(W: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``W * inv`` under the +inf zero-rate contract: a non-finite inverse
    rate scores ``+inf`` after the multiply, never ``0 * inf = NaN``."""
    return torch.where(torch.isfinite(inv), W * inv, _INF)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` row by row: x [..., M] and idx [..., *k] with the
    same leading dimensions give [..., *k]; a 1-d x is indexed by idx
    whole."""
    if x.ndim == 1:
        return x[idx.to(torch.int64)]
    lead = x.shape[:-1]
    flat = idx.to(torch.int64).reshape(*lead, -1)
    return torch.gather(x, -1, flat).reshape(idx.shape)


def inv_rate_for(inv_rates: torch.Tensor, idx: torch.Tensor,
                 cls: torch.Tensor) -> torch.Tensor:
    """Reciprocal service rate of server ``idx`` for a task of class
    ``cls``; inv_rates is the homogeneous [3] vector, a per-server [M, 3]
    matrix, or one [M, 3] matrix a cell ([N, M, 3], with idx/cls leading
    by N).  idx/cls broadcast together."""
    if inv_rates.ndim == 1:
        return inv_rates[cls.to(torch.int64)]
    if inv_rates.ndim == 2:
        return inv_rates[idx.to(torch.int64), cls.to(torch.int64)]
    idx, cls = torch.broadcast_tensors(idx.to(torch.int64), cls.to(torch.int64))
    return take_last(inv_rates.flatten(-2), idx * 3 + cls)


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """Power-of-d sampling spec: rack-local / remote servers probed in
    addition to the task's local servers.  The paper's §V uses d=8 as
    (2 rack-local, 6 remote) for Balanced-Pandas-Pod and d'=12 as (6, 6)
    for JSQ-MaxWeight-Pod scheduling."""

    d_rack: int
    d_remote: int

    @property
    def d(self) -> int:
        """Total probe budget (rack + remote candidates)."""
        return self.d_rack + self.d_remote


def pod_candidate_classes(n_rep: int, pod: PodSpec, device="cpu") -> torch.Tensor:
    """[C] int32 class of each candidate slot: [locals | rack | remote]."""
    return torch.tensor([LOCAL] * n_rep + [RACK] * pod.d_rack
                        + [REMOTE] * pod.d_remote, dtype=torch.int32,
                        device=device)


def pod_candidates(gen: torch.Generator, cluster: Cluster,
                   locals_: torch.Tensor, cls: torch.Tensor, pod: PodSpec,
                   cand_cls: Optional[torch.Tensor] = None):
    """Candidate lists for Balanced-Pandas-Pod routing.

    locals_: int32 [..., n_rep]; cls: int32 [..., M] locality classes.
    Returns (cand_idx, cand_cls, valid), each [..., C] with
    C = n_rep + d_rack + d_remote, ordered [locals | rack draws | remote
    draws] so that slot order prefers faster classes.  ``cand_cls`` may
    pass a precomputed ``pod_candidate_classes`` row."""
    del cluster  # the sets come from cls; kept for the reference's signature
    n_rep = locals_.shape[-1]
    # one counting pass over both sets: independent uniform draws either way
    sets = torch.stack([cls == RACK, cls == REMOTE])
    idx, ok = masked_draws(gen, sets, max(pod.d_rack, pod.d_remote))
    rack_idx, rack_ok = idx[0, ..., :pod.d_rack], ok[0, ..., :pod.d_rack]
    rem_idx, rem_ok = idx[1, ..., :pod.d_remote], ok[1, ..., :pod.d_remote]
    cand_idx = torch.cat([locals_.to(torch.int32), rack_idx, rem_idx], dim=-1)
    if cand_cls is None:
        cand_cls = pod_candidate_classes(n_rep, pod, locals_.device)
    cand_cls = cand_cls.expand(cand_idx.shape)
    ones = torch.ones(locals_.shape, dtype=torch.bool, device=locals_.device)
    valid = torch.cat([ones, rack_ok, rem_ok], dim=-1)
    return cand_idx, cand_cls, valid


def route_pod_candidates(rnd: torch.Tensor, W: torch.Tensor,
                         cand_idx: torch.Tensor, cand_cls: torch.Tensor,
                         valid: torch.Tensor, inv_rates: torch.Tensor):
    """Argmin of weighted workload over an explicit candidate list.

    Ties: faster class first (candidate ordering), then the uniform ``rnd``
    [..., C] (the reference draws it from its key), then slot.  W is [M],
    or [N, M] with the candidates leading by N (one cell each).  Returns
    (server, class) for each task."""
    idx = cand_idx.to(torch.int64)
    scores = weighted_score(take_last(W, idx),
                            inv_rate_for(inv_rates, idx, cand_cls))
    c = lex_argmin(scores, cand_cls.to(torch.float32), rnd,
                   mask=valid.to(torch.bool)).to(torch.int64)[..., None]
    sel = torch.gather(cand_idx, -1, c)[..., 0]
    sel_cls = torch.gather(cand_cls, -1, c)[..., 0]
    return sel.to(torch.int32), sel_cls.to(torch.int32)


def route_balanced_pandas_full(W: torch.Tensor, cls: torch.Tensor,
                               inv_rates: torch.Tensor, tie_rnd: torch.Tensor,
                               class_tiebreak: bool = True):
    """Balanced-Pandas O(M) routing: argmin over all M of the weighted
    workload (paper §IV-A).  Ties -> faster class (unless
    ``class_tiebreak`` is False), then ``tie_rnd`` (a [M] random priority
    shared within a slot).  inv_rates: [3] or per-server [M, 3], or [N,
    M, 3] with W, cls and tie_rnd leading by N."""
    m = torch.arange(cls.shape[-1], device=cls.device)
    ww = weighted_score(W, inv_rate_for(inv_rates, m, cls))
    mask = torch.ones(cls.shape, dtype=torch.bool, device=cls.device)
    keys = (cls.to(torch.float32),) if class_tiebreak else ()
    sel = lex_argmin(ww, *keys, tie_rnd.expand(cls.shape), mask=mask)
    sel_cls = torch.gather(cls, -1, sel.to(torch.int64)[..., None])[..., 0]
    return sel, sel_cls.to(torch.int32)


def route_jsq_local(rnd: torch.Tensor, Q: torch.Tensor,
                    locals_: torch.Tensor) -> torch.Tensor:
    """JSQ-MaxWeight(-Pod) / JSQ-Priority routing: join the shortest *local*
    queue (paper §IV-B).  Q: [M]; locals_: int32 [..., R]; rnd: [..., R]
    tie uniforms (lower wins).  Already O(1): only the n_replicas local
    queues are examined.  Q may be [N, M] with locals_ and rnd leading by
    N.  Returns the chosen server, int32 [...]."""
    qloc = take_last(Q, locals_)
    mask = torch.ones(locals_.shape, dtype=torch.bool, device=locals_.device)
    pick = lex_argmin(qloc.to(torch.float32), rnd, mask=mask)
    return torch.gather(locals_, -1, pick.to(torch.int64)[..., None])[..., 0]


# ----------------------------------------------------------------------------
# O(1) in-rack / out-of-rack draws (server ids are contiguous by rack, so both
# sets are index intervals).  Used by JSQ-MW-Pod scheduling.
# ----------------------------------------------------------------------------


def rack_peer_of(cluster: Cluster, server: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The x-th server of ``server``'s rack other than itself; x in
    [0, rack_size - 1), shape [..., k] against server [...]."""
    start = (server // cluster.rack_size) * cluster.rack_size
    return start[..., None] + x + (x >= (server - start)[..., None])


def remote_peer_of(cluster: Cluster, server: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """The y-th server outside ``server``'s rack; y in [0, M - rack_size)."""
    R = cluster.rack_size
    start = (server // R) * R
    return y + torch.where(y >= start[..., None], R, 0)


def sample_rack_peer(gen: torch.Generator, cluster: Cluster,
                     server: torch.Tensor, k: int) -> torch.Tensor:
    """k uniform draws (with replacement) from ``server``'s rack, excluding
    itself.  server: int [...]; returns [..., k]."""
    x = uniform_int(gen, server.shape + (k,), max(cluster.rack_size - 1, 1),
                    server.device)
    return rack_peer_of(cluster, server, x)


def sample_remote_peer(gen: torch.Generator, cluster: Cluster,
                       server: torch.Tensor, k: int) -> torch.Tensor:
    """k uniform draws (with replacement) from outside ``server``'s rack."""
    y = uniform_int(gen, server.shape + (k,),
                    max(cluster.M - cluster.rack_size, 1), server.device)
    return remote_peer_of(cluster, server, y)


def bp_candidates_per_route(cluster: Cluster, pod: Optional[PodSpec]) -> int:
    """Servers BP(-Pod) scores per routing decision (complexity table)."""
    if pod is None:
        return cluster.M
    return cluster.n_replicas + pod.d


def jsqmw_candidates_per_schedule(cluster: Cluster,
                                  pod: Optional[PodSpec]) -> int:
    """Queues JSQ-MW(-Pod) scans per scheduling decision."""
    if pod is None:
        return cluster.M
    return 1 + pod.d
