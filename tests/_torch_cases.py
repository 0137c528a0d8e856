"""Inputs shared by the port's CPU parity tests and its card tests."""
import numpy as np


def valid_patterns(B: int, lam: float, rng) -> dict:
    """The ``valid`` patterns the route_commit kernels branch on (their
    chain runs to the last valid arrival, the rest score against the final
    W): none valid, only the last, only the first, a Poisson(lam) prefix as
    the simulator draws it, and gaps before the last valid arrival."""
    gaps = rng.random(B) < 0.5
    last = B - 1 - B // 4
    gaps[last], gaps[last + 1:] = True, False
    return {"none": np.zeros(B, bool), "last": np.arange(B) == B - 1,
            "first": np.arange(B) == 0,
            "poisson": np.arange(B) < min(B, rng.poisson(lam)), "gaps": gaps}


# Slot splits of a pod_route row: a lane's slots, a segment of lanes, a
# warp and a batch of loads (lower slot of each pair = split - 1).
POD_SPLITS = (1, 2, 4, 8, 16, 32, 33, 64)


def pod_route_case(seed: int, M: int, B: int, C: int, outside: bool = True):
    """Tie-forcing pod_route inputs (numpy): W float32, cand_idx/cand_cls
    [B, C] int32, valid [B, C] bool, [M, 3] float32 rates with dead servers
    and dead columns.

    Servers 0..3 (planted) have W = 0 and finite rates, so they score 0
    and every other candidate scores above 0 (W in {1, 2.5, 77}) or +inf.
    Even rows hold two different planted servers at the slots on both
    sides of a split of the row (valid, classes 0..2): the lower slot must
    win.  Odd rows repeat each candidate at the next slot, so equal scores
    tie across slots.  With B >= 3 the last row has no valid slot and the
    one before holds class 3 only.  With ``outside`` every third row holds
    the candidates -1 (slot 0) and M (the last slot), valid: both score
    +inf, and a row without a finite score gives its slot 0's candidate."""
    rng = np.random.default_rng(seed)
    planted = 4
    W = rng.choice(np.array([1.0, 2.5, 77.0], np.float32), M)
    W[:planted] = 0.0
    pool = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (4, 3)))
    inv = pool[rng.integers(4, size=M)].astype(np.float32)
    inv[rng.choice(M, size=max(1, M // 8), replace=False)] = np.inf
    inv[rng.random(M) < 0.3, rng.integers(3)] = np.inf
    inv[:planted] = [1.0, 2.0, 4.0]
    ci = rng.integers(planted, M, (B, C)).astype(np.int32)
    cc = rng.integers(0, 4, (B, C)).astype(np.int32)
    cv = rng.random((B, C)) < 0.85
    pairs = [(s - 1, s) for s in (*POD_SPLITS, C - 1) if 0 < s < C]
    for b in range(B):
        if b % 2 == 0 and pairs:
            lo, hi = pairs[(b // 2) % len(pairs)]
            ci[b, [lo, hi]] = rng.choice(planted, 2, replace=False)
            cc[b, [lo, hi]] = rng.integers(0, 3, 2)
            cv[b, [lo, hi]] = True
        elif b % 2 == 1:
            ci[b, 1::2] = ci[b, 0::2][:ci[b, 1::2].shape[0]]
        if outside and b % 3 == 0:
            ci[b, 0], ci[b, -1] = -1, M
            cv[b, 0] = cv[b, -1] = True
    if B >= 3:
        cv[B - 1] = False
        cc[B - 2] = 3
    return W, ci, cc, cv, inv


def jsq_operand(M: int, B: int, seed: int):
    """Batched JSQ routing's ``route_commit`` pod operand (numpy): Q [M, 3]
    int32 nonzero in column 0 only, with three distinct lengths, so that
    equal queues tie across a triple's slots; cand_idx [B, 3] distinct
    replica triples, every third of them three servers of one length;
    cand_cls all 0, cand_valid all True; inv_rates ones(3)."""
    rng = np.random.default_rng(seed)
    Q = np.zeros((M, 3), np.int32)
    Q[:, 0] = rng.integers(0, 3, M)
    ci = np.stack([rng.choice(M, 3, replace=False) for _ in range(B)])
    for b in range(0, B, 3):
        same = np.flatnonzero(Q[:, 0] == Q[ci[b, 0], 0])
        if len(same) >= 3:
            ci[b] = rng.choice(same, 3, replace=False)
    return (Q, ci.astype(np.int32), np.zeros((B, 3), np.int32),
            np.ones((B, 3), bool), np.ones(3, np.float32))


def cells_case(seed: int, N: int, M: int, B: int, C: int, lam: float,
               inv: str = "[N,M,3]") -> dict:
    """N cells of ``route_commit`` inputs (numpy) for one batched launch:
    each cell its own queues (few lengths), classes 0..3 (every third cell
    with an all-class-3 row), prio, candidates and ``valid`` pattern (cell n
    takes pattern n mod 5 of ``valid_patterns``, so the cells' chains stop
    at different arrivals); the candidate classes one [B, C] block every
    cell shares (BP-Pod's path).  ``inv``: "[3]", "[M,3]" (one pooled
    matrix with dead servers and columns, shared) or "[N,M,3]" (one a
    cell)."""
    rng = np.random.default_rng(seed)

    def pooled(lead):
        pool = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (4, 3)))
        r = pool[rng.integers(4, size=lead + (M,))].astype(np.float32)
        r[rng.random(lead + (M,)) < 0.125] = np.inf
        at = np.nonzero(rng.random(lead + (M,)) < 0.3)
        r[at + (rng.integers(3, size=len(at[0])),)] = np.inf
        return r
    rates = {"[3]": np.array([10.0, 20.0, 50.0], np.float32),
             "[M,3]": pooled(()), "[N,M,3]": pooled((N,))}[inv]
    valid = np.stack([list(valid_patterns(B, lam, np.random.default_rng(seed + n))
                           .values())[n % 5] for n in range(N)])
    cls = rng.integers(0, 4, (N, B, M)).astype(np.int32)
    cls[::3, B // 2] = 3
    return dict(Q=rng.integers(0, 3, (N, M, 3)).astype(np.int32), valid=valid,
                inv=rates, cls=cls,
                prio=np.argsort(rng.random((N, M)), axis=1).astype(np.int32),
                cand_idx=rng.integers(0, M, (N, B, C)).astype(np.int32),
                cand_cls=rng.integers(0, 4, (B, C)).astype(np.int32),
                cand_valid=rng.random((N, B, C)) < 0.85)
