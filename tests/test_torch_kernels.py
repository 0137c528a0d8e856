"""The port's kernel layer and building blocks against the JAX reference.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as tests/test_kernels.py runs them on the CPU) and through
its PyTorch counterpart on the CPU.  ``route_commit``'s decisions (sel,
sel_cls) and queues must be exactly equal; W and val are compared to the
f32 bit, except on the random heterogeneous batteries, where rtol=1e-6
covers the reference kernel's own summation order (tests/test_kernels.py
holds the Pallas kernel to its oracles with the same tolerance).  Samplers
whose random streams differ (threefry vs Philox) are compared by
distribution.  The CUDA kernel is held to its plain version in
tests/test_torch_gpu.py, which runs on the card.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import cells_case, valid_patterns
from repro.core import cluster as jcl
from repro.core import policies as jpol
from repro.kernels import invrates as jinv
from repro.kernels import ref as jref
from repro.kernels import route_commit as j_route_commit
from repro_torch.core import cluster as tcl
from repro_torch.core import policies as tpol
from repro_torch.kernels import invrates as tinv
from repro_torch.kernels import ref as tref
from repro_torch import kernels as tk

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(64, 3, 5), (128, 8, 8), (129, 9, 16), (96, 17, 11)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(xs):
    return [np.asarray(x) for x in xs]


def _case(seed: int):
    """A randomized routing instance built to force ties: log-uniform
    heterogeneous rates, optionally few distinct rate rows, dead servers,
    dead rate columns and few distinct queue lengths."""
    rng = np.random.default_rng(seed)
    M, B, C = SHAPES[seed % len(SHAPES)]
    inv_m = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (M, 3))).astype(np.float32)
    if rng.random() < 0.5:
        inv_m = inv_m[:4][rng.integers(4, size=M)]
    if rng.random() < 0.6:
        inv_m[rng.choice(M, size=max(1, M // 8), replace=False)] = np.inf
    if rng.random() < 0.4:
        inv_m[rng.random(M) < 0.3, rng.integers(3)] = np.inf
    hi = 3 if rng.random() < 0.5 else 30
    Q = rng.integers(0, hi, (M, 3)).astype(np.int32)
    valid = rng.random(B) < 0.85
    return rng, M, B, C, inv_m, Q, valid


def _both(Q, valid, inv, **kw):
    jout = _np(j_route_commit(jnp.asarray(Q), jnp.asarray(valid), jnp.asarray(inv),
                              **{k: None if v is None else jnp.asarray(v)
                                 for k, v in kw.items()}))
    tout = _np(tref.route_commit_ref(_t(Q), _t(valid), _t(inv),
                                     **{k: None if v is None else _t(v)
                                        for k, v in kw.items()}))
    return jout, tout


def _assert_equal(jout, tout, rtol=0.0):
    """Q, sel and sel_cls exactly; W and val to the bit, or to ``rtol``."""
    for i, name in ((0, "Q"), (2, "sel"), (3, "sel_cls")):
        np.testing.assert_array_equal(tout[i], jout[i], err_msg=name)
    for i, name in ((1, "W"), (4, "val")):
        if rtol:
            np.testing.assert_allclose(tout[i], jout[i], rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(tout[i], jout[i], err_msg=name)


# ---------------------------------------------------------------------------
# route_commit: plain version vs the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_route_commit_full_matches_jax_on_tie_battery(seed):
    rng, M, B, C, inv_m, Q, valid = _case(seed)
    cls = rng.integers(0, 3, (B, M)).astype(np.int32)
    prio = rng.permutation(M).astype(np.int32) if seed % 2 else None
    _assert_equal(*_both(Q, valid, inv_m, cls=cls, prio=prio), rtol=1e-6)


@pytest.mark.parametrize("seed", range(12))
def test_route_commit_pod_matches_jax_on_tie_battery(seed):
    rng, M, B, C, inv_m, Q, valid = _case(seed)
    ci = rng.integers(0, M, (B, C)).astype(np.int32)
    if seed % 2:                         # duplicate candidates: slot ties
        ci[:, 1::2] = ci[:, 0::2][:, :ci[:, 1::2].shape[1]]
    cc = rng.integers(0, 3, (B, C)).astype(np.int32)
    cv = (rng.random((B, C)) < 0.85).astype(np.int32)
    cv[:, 0] = 1
    _assert_equal(*_both(Q, valid, inv_m, cand_idx=ci, cand_cls=cc,
                         cand_valid=cv), rtol=1e-6)


@pytest.mark.parametrize("inv", [np.array([10.0, 20.0, 50.0], np.float32),
                                 np.array([100.0, 200.0, 500.0], np.float32)])
def test_route_commit_homogeneous_rates_bit_exact(inv):
    """The simulator's operand: a [3] vector of exact lattice rates, where
    exact score ties are routine.  W and val agree to the bit."""
    rng = np.random.default_rng(int(inv[0]))
    M, B, C = 40, 12, 11
    Q = rng.integers(0, 4, (M, 3)).astype(np.int32)
    valid = np.arange(B) < 9
    cls = rng.integers(0, 3, (B, M)).astype(np.int32)
    prio = rng.permutation(M).astype(np.int32)
    _assert_equal(*_both(Q, valid, inv, cls=cls, prio=prio))
    ci = rng.integers(0, M, (B, C)).astype(np.int32)
    cc = np.tile(np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 2, 2], np.int32), (B, 1))
    cv = (rng.random((B, C)) < 0.9).astype(np.int32)
    _assert_equal(*_both(Q, valid, inv, cand_idx=ci, cand_cls=cc, cand_valid=cv))


@pytest.mark.parametrize("offset", [0, 333])
def test_route_commit_class_tiebreak_at_large_workload(offset):
    """Every score ties exactly at W = 3*offset: the integer rank lane must
    still route each arrival to its LOCAL server, as the reference does."""
    M, B = 64, 8
    Q = np.full((M, 3), offset, np.int32)
    inv = np.ones(3, np.float32)
    rng = np.random.default_rng(5)
    local_at = rng.choice(np.arange(1, M), size=B, replace=False)
    cls = np.full((B, M), 2, np.int32)
    cls[np.arange(B), local_at] = 0
    jout, tout = _both(Q, np.ones(B, bool), inv, cls=cls)
    _assert_equal(jout, tout)
    np.testing.assert_array_equal(tout[2], local_at)
    C = 5
    ci = np.stack([rng.choice(M, size=C, replace=False) for _ in range(B)]).astype(np.int32)
    cc = np.tile(np.array([2, 1, 0, 1, 2], np.int32), (B, 1))
    jout, tout = _both(Q, np.ones(B, bool), inv, cand_idx=ci, cand_cls=cc,
                       cand_valid=np.ones((B, C), np.int32))
    _assert_equal(jout, tout)
    np.testing.assert_array_equal(tout[2], ci[:, 2])


def test_route_commit_burst_spreads_like_the_reference():
    """A burst into an all-empty equal-rate fleet lands one task per server
    (each arrival sees the previous commits), in both variants."""
    M, B = 64, 48
    Q = np.zeros((M, 3), np.int32)
    jout, tout = _both(Q, np.ones(B, bool), np.ones(3, np.float32),
                       cls=np.zeros((B, M), np.int32))
    _assert_equal(jout, tout)
    assert tout[0].max() == 1 and len(np.unique(tout[2])) == B
    ci = np.broadcast_to(np.arange(M, dtype=np.int32), (B, M)).copy()
    jout, tout = _both(Q, np.ones(B, bool), np.ones(3, np.float32), cand_idx=ci,
                       cand_cls=np.zeros((B, M), np.int32),
                       cand_valid=np.ones((B, M), np.int32))
    _assert_equal(jout, tout)
    assert tout[0].max() == 1 and len(np.unique(tout[2])) == B


def test_route_commit_all_dead_and_no_valid_arrivals():
    """Every server dead: all scores are +inf, the rank lane still picks
    deterministically and commits 0 workload; no valid arrival: Q is
    unchanged and every decision scores against W0."""
    rng = np.random.default_rng(3)
    M, B = 16, 5
    Q = rng.integers(0, 5, (M, 3)).astype(np.int32)
    inv = np.full((M, 3), np.inf, np.float32)
    cls = rng.integers(0, 3, (B, M)).astype(np.int32)
    _assert_equal(*_both(Q, np.ones(B, bool), inv, cls=cls))
    _assert_equal(*_both(Q, np.zeros(B, bool), np.ones(3, np.float32), cls=cls))


@pytest.mark.parametrize("pattern", ["none", "last", "first", "poisson", "gaps"])
@pytest.mark.parametrize("variant", ["full", "pod"])
@pytest.mark.parametrize("lattice", [True, False])
def test_route_commit_valid_patterns_match_jax(pattern, variant, lattice):
    """The split at the last valid arrival means what the JAX kernel means
    on every valid pattern, with class-3 entries (an all-class-3 row in the
    full variant): lattice rates to the bit, heterogeneous rates with dead
    entries to rtol 1e-6 (the reference kernel's summation order)."""
    rng = np.random.default_rng(17)
    M, B, C = 40, 12, 11
    Q = rng.integers(0, 4, (M, 3)).astype(np.int32)
    if lattice:
        inv = np.array([10.0, 20.0, 50.0], np.float32)
    else:
        inv = np.exp(rng.uniform(np.log(1e-2), np.log(1e2), (M, 3))).astype(np.float32)
        inv[rng.choice(M, size=M // 8, replace=False)] = np.inf
        inv[rng.random(M) < 0.3, 1] = np.inf
    valid = valid_patterns(B, B / 4, rng)[pattern]
    if variant == "full":
        cls = rng.integers(0, 4, (B, M)).astype(np.int32)
        cls[B // 2] = 3
        kw = dict(cls=cls, prio=rng.permutation(M).astype(np.int32))
    else:
        kw = dict(cand_idx=rng.integers(0, M, (B, C)).astype(np.int32),
                  cand_cls=rng.integers(0, 4, (B, C)).astype(np.int32),
                  cand_valid=(rng.random((B, C)) < 0.85).astype(np.int32))
    _assert_equal(*_both(Q, valid, inv, **kw), rtol=0.0 if lattice else 1e-6)


def test_route_commit_wseq_matches_jax():
    rng = np.random.default_rng(9)
    M, B = 96, 17
    Q = rng.integers(0, 20, (M, 3)).astype(np.int32)
    inv_m = rng.uniform(0.1, 10.0, (M, 3)).astype(np.float32)
    inv_m[5] = np.inf
    sel = rng.integers(0, M, B).astype(np.int32)
    scls = rng.integers(0, 3, B).astype(np.int32)
    valid = rng.random(B) < 0.8
    j = np.asarray(jref.route_commit_wseq(jnp.asarray(Q), jnp.asarray(sel),
                                          jnp.asarray(scls), jnp.asarray(valid),
                                          jnp.asarray(inv_m)))
    t = tref.route_commit_wseq(_t(Q), _t(sel), _t(scls), _t(valid), _t(inv_m))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel: the launch counters stay."""
    tk.reset_launch_counts()
    M, B = 8, 3
    out = tk.route_commit(torch.zeros((M, 3), dtype=torch.int32),
                          torch.ones(B, dtype=torch.bool), torch.ones(3),
                          cls=torch.zeros((B, M), dtype=torch.int32))
    assert out[0].sum() == B
    assert set(tk.LAUNCHES.values()) == {0}
    assert {"route_commit_full", "route_commit_pod"} <= set(tk.LAUNCHES)
    with pytest.raises(ValueError):
        tk.route_commit(torch.zeros((M, 3), dtype=torch.int32),
                        torch.ones(B, dtype=torch.bool), torch.ones(3))


CELL_CASES = [(n, inv) for n in (1, 3, 7) for inv in ("[3]", "[M,3]", "[N,M,3]")]
CELL_OPERANDS = {"full": ("cls", "prio"), "full-noprio": ("cls",),
                 "pod": ("cand_idx", "cand_cls", "cand_valid")}


@pytest.mark.parametrize("variant", list(CELL_OPERANDS))
@pytest.mark.parametrize("N,inv", CELL_CASES, ids=[f"N{n}-{i}" for n, i in CELL_CASES])
def test_route_commit_over_cells_equals_one_call_a_cell(N, inv, variant):
    """The plain version with a leading cell axis equals one unbatched call
    a cell, each cell with its own queues, valid pattern, classes, prio and
    candidates and with the shared operands (the [3] or [M, 3] rates, the
    candidate classes) as they are, or the cell's row of a per-cell [N, M,
    3]; the wrapper on CPU tensors returns the same and launches nothing."""
    x = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in cells_case(N, N, 40, 9, 6, 3.0, inv).items()}
    kw = {k: x[k] for k in CELL_OPERANDS[variant]}
    tk.reset_launch_counts()
    got = tref.route_commit_ref(x["Q"], x["valid"], x["inv"], **kw)
    wrapped = tk.route_commit(x["Q"], x["valid"], x["inv"], **kw)
    assert set(tk.LAUNCHES.values()) == {0}
    assert [tuple(o.shape) for o in got] == [(N, 40, 3), (N, 40), (N, 9), (N, 9), (N, 9)]
    for n in range(N):
        one = {k: (v[n] if k != "cand_cls" else v) for k, v in kw.items()}
        inv_n = x["inv"][n] if inv == "[N,M,3]" else x["inv"]
        want = tref.route_commit_cell(x["Q"][n], x["valid"][n], inv_n, **one)
        for name, a, b, c in zip(("Q", "W", "sel", "sel_cls", "val"), got, wrapped, want):
            assert torch.equal(a[n], c) and torch.equal(b[n], c), (n, name)


def test_route_commit_over_cells_shares_the_jsq_operands():
    """Batched JSQ routing's operand: the class and valid blocks [B, 3]
    shared by every cell, the unit rates [3]: equal to one call a cell."""
    N, M, B = 4, 30, 8
    rng = np.random.default_rng(2)
    Q = torch.zeros((N, M, 3), dtype=torch.int32)
    Q[..., 0] = torch.from_numpy(rng.integers(0, 3, (N, M)).astype(np.int32))
    ci = torch.from_numpy(np.stack([[rng.choice(M, 3, replace=False) for _ in range(B)]
                                    for _ in range(N)]).astype(np.int32))
    cc, cv = torch.zeros((B, 3), dtype=torch.int32), torch.ones((B, 3), dtype=torch.bool)
    valid = torch.arange(B) < torch.tensor([[0], [3], [8], [5]])
    got = tk.route_commit(Q, valid, torch.ones(3), cand_idx=ci, cand_cls=cc, cand_valid=cv)
    for n in range(N):
        want = tref.route_commit_ref(Q[n], valid[n], torch.ones(3), cand_idx=ci[n],
                                     cand_cls=cc, cand_valid=cv)
        assert all(torch.equal(a[n], b) for a, b in zip(got, want)), n


def test_route_commit_over_cells_rejects_wrong_shapes():
    """A cell axis that disagrees with Q's, or an operand with more axes
    than one a cell, raises rather than routing some other cells."""
    x = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in cells_case(0, 3, 20, 5, 6, 2.0).items()}
    bad = [dict(valid=x["valid"][:2]), dict(valid=x["valid"][0]),
           dict(cls=x["cls"][:2]), dict(prio=x["prio"][:1]),
           dict(inv=x["inv"][:2]), dict(cls=x["cls"][None])]
    for change in bad:
        y = {**x, **change}
        with pytest.raises(ValueError):
            tref.route_commit_ref(y["Q"], y["valid"], y["inv"], cls=y["cls"],
                                  prio=y["prio"])
    with pytest.raises(ValueError):
        tref.route_commit_ref(x["Q"], x["valid"], x["inv"], cand_idx=x["cand_idx"][:1],
                              cand_cls=x["cand_cls"], cand_valid=x["cand_valid"])


# ---------------------------------------------------------------------------
# Building blocks vs JAX on shared inputs (exact)
# ---------------------------------------------------------------------------


def test_encode_matches_jax():
    rng = np.random.default_rng(0)
    inv = rng.uniform(0.1, 10, (33, 3)).astype(np.float32)
    inv[::5, 1] = np.inf
    for x in (inv, inv[0]):
        for flags in (True, False):
            np.testing.assert_array_equal(
                tinv.encode(_t(x), 33, flags=flags).numpy(),
                np.asarray(jinv.encode(jnp.asarray(x), 33, flags=flags)))
    np.testing.assert_array_equal(tinv.as_matrix(_t(inv[0]), 4).numpy(),
                                  np.asarray(jinv.as_matrix(jnp.asarray(inv[0]), 4)))


def test_locality_class_and_inverse_rates_match_jax():
    c_j, c_t = jcl.Cluster(M=60, K=6), tcl.Cluster(M=60, K=6)
    locals_ = np.random.default_rng(1).integers(0, 60, (25, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tcl.locality_class(c_t, _t(locals_)).numpy(),
        np.asarray(jcl.locality_class(c_j, jnp.asarray(locals_))))
    rates = np.array([[0.01, 0.005, 0.002], [0.0, 0.3, 1e-13],
                      [0.7, 0.0, 0.0], [1e-12, 3.0, 0.1]], np.float32)
    np.testing.assert_array_equal(tcl.safe_inv_rates(_t(rates)).numpy(),
                                  np.asarray(jcl.safe_inv_rates(jnp.asarray(rates))))
    r = (0.01, 0.005, 0.002)
    speed = np.random.default_rng(2).choice([0.0, 0.5, 1.0, 2.0], (7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tcl.inv_rate_matrix(tcl.Rates(*r), _t(speed)).numpy(),
        np.asarray(jcl.inv_rate_matrix(jcl.Rates(*r), jnp.asarray(speed))))
    assert tcl.capacity_arrival_rate(c_t, tcl.Rates(*r), 0.9) == \
        jcl.capacity_arrival_rate(c_j, jcl.Rates(*r), 0.9)


def test_lex_argmin_and_argmax_match_jax():
    rng = np.random.default_rng(4)
    v = rng.integers(0, 3, (50, 9)).astype(np.float32)
    t1 = rng.integers(0, 2, (50, 9)).astype(np.float32)
    t2 = rng.random((50, 9)).astype(np.float32)
    mask = rng.random((50, 9)) < 0.7
    for fn_t, fn_j in ((tpol.lex_argmin, jpol.lex_argmin),
                       (tpol.lex_argmax, jpol.lex_argmax)):
        np.testing.assert_array_equal(
            fn_t(_t(v), _t(t1), _t(t2), mask=_t(mask)).numpy(),
            np.asarray(fn_j(jnp.asarray(v), jnp.asarray(t1), jnp.asarray(t2),
                            mask=jnp.asarray(mask))))


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("class_tiebreak", [True, False])
def test_route_balanced_pandas_full_matches_jax(hetero, class_tiebreak):
    rng = np.random.default_rng(6)
    M, B = 30, 7
    W = rng.choice(np.array([0.0, 10.0, 20.0, 30.0], np.float32), M)
    cls = rng.integers(0, 3, (B, M)).astype(np.int32)
    inv = (rng.choice(np.array([1.0, 2.0, np.inf], np.float32), (M, 3))
           if hetero else np.array([1.0, 2.0, 5.0], np.float32))
    tie = rng.random(M).astype(np.float32)
    j = _np(jpol.route_balanced_pandas_full(jnp.asarray(W), jnp.asarray(cls),
                                            jnp.asarray(inv), jnp.asarray(tie),
                                            class_tiebreak))
    t = _np(tpol.route_balanced_pandas_full(_t(W), _t(cls), _t(inv), _t(tie),
                                            class_tiebreak))
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


def test_route_pod_candidates_matches_jax_given_the_tie_draws():
    """The reference draws its tie uniforms from its key; the port takes
    them as an argument, so the test hands over the reference's draws."""
    rng = np.random.default_rng(8)
    M, B, C = 30, 9, 11
    W = rng.choice(np.array([0.0, 5.0, 10.0], np.float32), M)
    ci = rng.integers(0, M, (B, C)).astype(np.int32)
    cc = np.tile(np.array([0] * 3 + [1] * 2 + [2] * 6, np.int32), (B, 1))
    cv = rng.random((B, C)) < 0.8
    inv = np.array([1.0, 2.0, 5.0], np.float32)
    key = jax.random.PRNGKey(3)
    rnd = np.asarray(jax.random.uniform(key, ci.shape))
    j = _np(jpol.route_pod_candidates(key, jnp.asarray(W), jnp.asarray(ci),
                                      jnp.asarray(cc), jnp.asarray(cv),
                                      jnp.asarray(inv)))
    t = _np(tpol.route_pod_candidates(_t(rnd), _t(W), _t(ci), _t(cc), _t(cv),
                                      _t(inv)))
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


def test_complexity_counters_match_jax():
    for M in (20, 500):
        cj, ct = jcl.Cluster(M=M, K=4), tcl.Cluster(M=M, K=4)
        for pod in (None, (2, 6), (6, 6)):
            pj = None if pod is None else jpol.PodSpec(*pod)
            pt = None if pod is None else tpol.PodSpec(*pod)
            assert tpol.bp_candidates_per_route(ct, pt) == \
                jpol.bp_candidates_per_route(cj, pj)
            assert tpol.jsqmw_candidates_per_schedule(ct, pt) == \
                jpol.jsqmw_candidates_per_schedule(cj, pj)


# ---------------------------------------------------------------------------
# Samplers vs JAX by distribution (the random streams differ)
# ---------------------------------------------------------------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sample_locals_distribution_matches_jax():
    """Distinct triples, and per-server marginals both uniform: each
    server holds a replica with probability 3/M (binomial 5-sigma band)."""
    M, N = 12, 20_000
    t = tcl.sample_locals(_gen(0), tcl.Cluster(M=M, K=3), N).numpy()
    j = np.asarray(jcl.sample_locals(jax.random.PRNGKey(0), jcl.Cluster(M=M, K=3), N))
    for x in (t, j):
        assert x.dtype == np.int32 and x.shape == (N, 3)
        assert (np.sort(x, 1)[:, 1:] != np.sort(x, 1)[:, :-1]).all()
        freq = np.bincount(x.ravel(), minlength=M) / N
        sd = np.sqrt((3 / M) * (1 - 3 / M) / N)
        assert np.abs(freq - 3 / M).max() < 5 * sd
    ft = np.bincount(t.ravel(), minlength=M) / N
    fj = np.bincount(j.ravel(), minlength=M) / N
    assert np.abs(ft - fj).max() < 5 * np.sqrt(2 * (3 / M) / N)


def test_masked_draws_distribution_matches_jax():
    M, N, k = 10, 5_000, 4
    rng = np.random.default_rng(2)
    mask = rng.random((3, M)) < 0.5
    mask[2] = False
    ti, tv = tpol.masked_draws(_gen(1), _t(mask).expand(N, 3, M), k)
    ji, jv = jpol.masked_draws(jax.random.PRNGKey(1),
                               jnp.broadcast_to(jnp.asarray(mask), (N, 3, M)), k)
    ti, tv, ji, jv = ti.numpy(), tv.numpy(), np.asarray(ji), np.asarray(jv)
    np.testing.assert_array_equal(tv, jv)
    for row in range(2):
        members = np.flatnonzero(mask[row])
        for idx in (ti, ji):
            assert np.isin(idx[:, row], members).all()
        p = 1 / len(members)
        sd = np.sqrt(p * (1 - p) / (N * k))
        ft = np.bincount(ti[:, row].ravel(), minlength=M)[members] / (N * k)
        fj = np.bincount(ji[:, row].ravel(), minlength=M)[members] / (N * k)
        assert np.abs(ft - p).max() < 5 * sd and np.abs(fj - p).max() < 5 * sd


@pytest.mark.parametrize("dist", ["geometric", "lognormal"])
def test_sample_durations_distribution_matches_jax(dist):
    """Per-class sample means agree within 5 standard errors (lognormal:
    the ceil of a sigma=0.5 law) and the support is >= 1, int32."""
    r = (0.1, 0.05, 0.02)
    N = 20_000
    cls = np.repeat(np.arange(3, dtype=np.int32), N)
    t = tcl.sample_durations(_gen(5), _t(cls), tcl.Rates(*r), dist, 0.5).numpy()
    j = np.asarray(jcl.sample_durations(jax.random.PRNGKey(5), jnp.asarray(cls),
                                        jcl.Rates(*r), dist, 0.5))
    assert t.dtype == np.int32 and t.min() >= 1
    for c in range(3):
        a, b = t[cls == c].astype(np.float64), j[cls == c].astype(np.float64)
        se = np.sqrt(a.var() / N + b.var() / N)
        assert abs(a.mean() - b.mean()) < 5 * se, (c, a.mean(), b.mean())


def test_duration_formula_matches_jax_on_shared_uniforms():
    """Given the same uniforms, the geometric formula agrees with the
    reference's except where log1p differs by an ulp and moves a ceil:
    at most 0.1% of draws, each by exactly one slot."""
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (50_000,),
                                      minval=1e-7, maxval=1 - 1e-7))
    p = np.float32(0.02)
    j = np.asarray(jnp.clip(jnp.ceil(jnp.log1p(-jnp.asarray(u)) / jnp.log1p(-p)),
                            1, 1_000_000).astype(jnp.int32))
    t = tcl.durations_from_uniform(_t(u), torch.tensor(p)).numpy()
    diff = np.abs(t - j)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 8
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (f, name)
