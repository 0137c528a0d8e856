"""The port's snapshot-routing kernels against the JAX reference, on the CPU.

``weighted_argmin``, ``pod_route`` and ``queue_update``: the same numpy
inputs go through the JAX kernels (Pallas in interpret mode, as
tests/test_kernels.py runs them on the CPU) and through the port's plain
versions (a CPU tensor takes the plain version).  ``sel`` and ``Q`` must be
equal, and ``val`` equal to the f32 bit: a score is one multiply of the
same float32 operands on both sides.  The CUDA kernels are held to these
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).

Class 3 is the Pallas kernels' pad class and scores +inf there; the port
follows the kernels, so inputs that hold class 3 are compared with the JAX
kernels only (the JAX oracles clamp the class-3 gather to class 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pod_route as j_pod_route
from repro.kernels import queue_update as j_queue_update
from repro.kernels import ref as jref
from repro.kernels import weighted_argmin as j_weighted_argmin
from _torch_cases import pod_route_case
from repro_torch import kernels as tk

SHAPES = [(64, 3, 5), (128, 8, 8), (500, 37, 11), (1000, 130, 19), (129, 9, 16)]
HETERO_SHAPES = [(64, 3, 5), (128, 8, 8), (129, 9, 16), (96, 17, 11)]
INV = np.array([25.0, 50.0, 125.0], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _w_both(W32: np.ndarray, bf16: bool):
    """W for both sides: f32, or the same bfloat16 values."""
    if not bf16:
        return jnp.asarray(W32), _t(W32)
    wj = jnp.asarray(W32).astype(jnp.bfloat16)
    return wj, _t(np.asarray(wj.astype(jnp.float32))).to(torch.bfloat16)


def _wam_both(W32, cls, inv, bf16=False):
    wj, wt = _w_both(W32, bf16)
    j = [np.asarray(x) for x in j_weighted_argmin(wj, jnp.asarray(cls), jnp.asarray(inv))]
    t = [x.numpy() for x in tk.weighted_argmin(wt, _t(cls), _t(inv))]
    return j, t


def _pod_both(W32, ci, cc, cv, inv, bf16=False):
    wj, wt = _w_both(W32, bf16)
    j = [np.asarray(x) for x in j_pod_route(wj, jnp.asarray(ci), jnp.asarray(cc),
                                             jnp.asarray(cv), jnp.asarray(inv))]
    t = [x.numpy() for x in tk.pod_route(wt, _t(ci), _t(cc), _t(cv), _t(inv))]
    return j, t


def _qu_both(Q, sel, scl, valid, inv):
    j = [np.asarray(x) for x in j_queue_update(jnp.asarray(Q), jnp.asarray(sel),
                                                jnp.asarray(scl), jnp.asarray(valid),
                                                jnp.asarray(inv))]
    t = [x.numpy() for x in tk.queue_update(_t(Q), _t(sel), _t(scl), _t(valid), _t(inv))]
    return j, t


def _assert_route_equal(j, t):
    """sel exactly, val to the f32 bit (one multiply of equal operands)."""
    np.testing.assert_array_equal(t[0], j[0], err_msg="sel")
    np.testing.assert_array_equal(t[1], j[1], err_msg="val")


def _assert_queue_equal(j, t, rtol=0.0):
    """Q_new exactly; W to the f32 bit, or to ``rtol``.  The JAX kernel
    sums eight lanes (q * rate, five of them 0) in XLA's order and the port
    pins (q0*i0 + q1*i1) + q2*i2: with the homogeneous lattice rates the
    two orders round alike (bit-equal), with log-uniform per-server rates
    they differ in the last bit of some sums, hence rtol=1e-6 there."""
    np.testing.assert_array_equal(t[0], j[0], err_msg="Q_new")
    if rtol:
        np.testing.assert_allclose(t[1], j[1], rtol=rtol, err_msg="W")
    else:
        np.testing.assert_array_equal(t[1], j[1], err_msg="W")


def _hetero_case(seed: int):
    """The heterogeneous battery of tests/test_kernels.py: log-uniform
    rates over 1e-3..1e3, optionally few distinct rate rows (dense exact
    ties), dead servers, a dead rate column, few distinct workloads, and
    bfloat16 workloads 40% of the time."""
    rng = np.random.default_rng(seed)
    M, B, C = HETERO_SHAPES[rng.integers(len(HETERO_SHAPES))]
    inv_m = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (M, 3))).astype(np.float32)
    if rng.random() < 0.5:
        inv_m = inv_m[:4][rng.integers(4, size=M)]
    if rng.random() < 0.6:
        inv_m[rng.choice(M, size=max(1, M // 8), replace=False)] = np.inf
    if rng.random() < 0.4:
        inv_m[rng.random(M) < 0.3, rng.integers(3)] = np.inf
    if rng.random() < 0.5:
        W = rng.choice(np.array([0.0, 1.0, 2.5, 77.0], np.float32), size=M)
    else:
        W = rng.uniform(0, 100, M).astype(np.float32)
    return rng, M, B, C, inv_m, W, bool(rng.random() < 0.4)


# ---------------------------------------------------------------------------
# weighted_argmin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,B,C", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_weighted_argmin_matches_jax(M, B, C, bf16):
    rng = np.random.default_rng(M * 1000 + B)
    W = (rng.random(M) * 100).astype(np.float32)
    cls = rng.integers(0, 3, (B, M)).astype(np.int32)
    j, t = _wam_both(W, cls, INV, bf16)
    _assert_route_equal(j, t)
    # the JAX oracle agrees too on classes 0..2
    rj = jref.weighted_argmin_ref(_w_both(W, bf16)[0], jnp.asarray(cls), jnp.asarray(INV))
    np.testing.assert_array_equal(t[0], np.asarray(rj[0]))
    np.testing.assert_array_equal(t[1], np.asarray(rj[1]))


@pytest.mark.parametrize("seed", range(10))
def test_weighted_argmin_matches_jax_on_hetero_battery(seed):
    rng, M, B, C, inv_m, W, bf16 = _hetero_case(seed)
    cls = rng.integers(0, 3, (B, M)).astype(np.int32)
    _assert_route_equal(*_wam_both(W, cls, inv_m, bf16))


# ---------------------------------------------------------------------------
# pod_route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,B,C", SHAPES)
def test_pod_route_matches_jax(M, B, C):
    rng = np.random.default_rng(M + B)
    W = (rng.random(M) * 100).astype(np.float32)
    ci = rng.integers(0, M, (B, C)).astype(np.int32)
    cc = rng.integers(0, 3, (B, C)).astype(np.int32)
    cv = rng.random((B, C)) < 0.85
    cv[:, 0] = True
    j, t = _pod_both(W, ci, cc, cv, INV)
    _assert_route_equal(j, t)
    rj = jref.pod_route_ref(jnp.asarray(W), jnp.asarray(ci), jnp.asarray(cc),
                            jnp.asarray(cv), jnp.asarray(INV))
    np.testing.assert_array_equal(t[0], np.asarray(rj[0]))
    np.testing.assert_array_equal(t[1], np.asarray(rj[1]))


@pytest.mark.parametrize("seed", range(10))
def test_pod_route_matches_jax_on_hetero_battery(seed):
    """Dense ties, dead servers and columns, and (odd seeds) duplicate
    candidates, where equal scores tie across slots."""
    rng, M, B, C, inv_m, W, _ = _hetero_case(seed)
    ci = rng.integers(0, M, (B, C)).astype(np.int32)
    if seed % 2:
        ci[:, 1::2] = ci[:, 0::2][:, :ci[:, 1::2].shape[1]]
    cc = rng.integers(0, 3, (B, C)).astype(np.int32)
    cv = rng.random((B, C)) < 0.85
    cv[:, 0] = True
    _assert_route_equal(*_pod_both(W, ci, cc, cv, inv_m))


@pytest.mark.parametrize("C", [1, 11, 32, 33, 40])
def test_pod_route_matches_jax_on_the_card_battery(C):
    """The inputs the card's battery holds the CUDA kernel to
    (tests/_torch_cases.py: equal minima at different servers across every
    split of a row, duplicate candidates, a row with no valid slot, a row of
    class 3 only, dead rates), float32 and bfloat16 W, [M, 3] and [3]
    rates.  Candidates stay inside 0..M-1: the JAX kernel's one-hot gather
    has no rule for others."""
    W, ci, cc, cv, inv = pod_route_case(C, 97, 17, C, outside=False)
    for bf16 in (False, True):
        for rates in (inv, np.array([10.0, np.inf, 50.0], np.float32)):
            _assert_route_equal(*_pod_both(W, ci, cc, cv, rates, bf16))


# ---------------------------------------------------------------------------
# Class 3 and rows that score +inf everywhere
# ---------------------------------------------------------------------------


def test_class3_follows_the_jax_kernel_not_the_oracle():
    """W=[1, 2, 0.1, 4], rates [25, 50, 125], class 3 on server 2: the JAX
    kernel masks class 3 to +inf (sel 1, val 50), as the port does; the JAX
    oracle gathers inv[3], which JAX clamps to inv[2], and so picks server
    2 at 0.1 * 125 = 12.5."""
    W = np.array([1.0, 2.0, 0.1, 4.0], np.float32)
    cls = np.array([[2, 0, 3, 1]], np.int32)
    j, t = _wam_both(W, cls, INV)
    _assert_route_equal(j, t)
    assert t[0][0] == 1 and t[1][0] == np.float32(50.0)
    rsel, rval = jref.weighted_argmin_ref(jnp.asarray(W), jnp.asarray(cls), jnp.asarray(INV))
    assert int(rsel[0]) == 2 and float(rval[0]) == float(np.float32(0.1) * INV[2])

    ci = np.array([[0, 2, 1]], np.int32)
    cc = np.array([[2, 3, 0]], np.int32)
    cv = np.ones((1, 3), bool)
    j, t = _pod_both(W, ci, cc, cv, INV)
    _assert_route_equal(j, t)
    assert t[0][0] == 1 and t[1][0] == np.float32(50.0)
    rsel, _ = jref.pod_route_ref(jnp.asarray(W), jnp.asarray(ci), jnp.asarray(cc),
                                 jnp.asarray(cv), jnp.asarray(INV))
    assert int(rsel[0]) == 2


@pytest.mark.parametrize("seed", range(4))
def test_class3_entries_match_the_jax_kernels(seed):
    rng, M, B, C, inv_m, W, bf16 = _hetero_case(100 + seed)
    cls = rng.integers(0, 4, (B, M)).astype(np.int32)
    cls[0] = 3                                   # a row of pad class only
    _assert_route_equal(*_wam_both(W, cls, inv_m, bf16))
    ci = rng.integers(0, M, (B, C)).astype(np.int32)
    cc = rng.integers(0, 4, (B, C)).astype(np.int32)
    cv = rng.random((B, C)) < 0.85
    _assert_route_equal(*_pod_both(W, ci, cc, cv, inv_m))


def test_rows_without_a_finite_score():
    """All dead, or all class 3 (weighted_argmin): sel 0, val +inf.  All
    slots invalid or dead (pod_route): sel cand_idx[b, 0], val +inf."""
    M, B, C = 96, 4, 11
    rng = np.random.default_rng(7)
    W = rng.uniform(0, 10, M).astype(np.float32)
    inv_m = np.full((M, 3), 2.0, np.float32)
    inv_m[: M // 2] = np.inf
    cls = rng.integers(0, 3, (B, M)).astype(np.int32)
    dead_inv = np.full((M, 3), np.inf, np.float32)
    for inv, rows in ((dead_inv, cls), (inv_m, np.full((B, M), 3, np.int32))):
        j, t = _wam_both(W, rows, inv)
        _assert_route_equal(j, t)
        assert (t[0] == 0).all() and np.isposinf(t[1]).all()

    ci = rng.integers(1, M, (B, C)).astype(np.int32)
    cc = rng.integers(0, 3, (B, C)).astype(np.int32)
    cv = np.ones((B, C), bool)
    cv[0] = False                                # row 0: no valid slot
    ci[1] = rng.integers(0, M // 2, C)           # row 1: only dead servers
    j, t = _pod_both(W, ci, cc, cv, inv_m)
    _assert_route_equal(j, t)
    np.testing.assert_array_equal(t[0][:2], ci[:2, 0])
    assert np.isposinf(t[1][:2]).all() and np.isfinite(t[1][2:]).all()


# ---------------------------------------------------------------------------
# queue_update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,B,C", SHAPES)
def test_queue_update_matches_jax(M, B, C):
    rng = np.random.default_rng(M * 7 + B)
    Q = rng.integers(0, 50, (M, 3)).astype(np.int32)
    sel = rng.integers(0, M, B).astype(np.int32)
    scl = rng.integers(0, 3, B).astype(np.int32)
    valid = rng.random(B) < 0.8
    _assert_queue_equal(*_qu_both(Q, sel, scl, valid, INV))


@pytest.mark.parametrize("seed", range(8))
def test_queue_update_matches_jax_with_dropped_arrivals(seed):
    """Heterogeneous rates with dead entries, collisions on a few servers,
    and arrivals that must drop: valid False, class 3, server M."""
    rng, M, B, C, inv_m, _, _ = _hetero_case(seed)
    Q = rng.integers(0, 30, (M, 3)).astype(np.int32)
    sel = rng.integers(0, max(2, M // 8), B).astype(np.int32)
    sel[rng.random(B) < 0.2] = M
    scl = rng.integers(0, 4, B).astype(np.int32)
    valid = rng.random(B) < 0.8
    j, t = _qu_both(Q, sel, scl, valid, inv_m)
    _assert_queue_equal(j, t, rtol=1e-6)
    keep = valid & (sel < M) & (scl < 3)
    assert t[0].sum() - Q.sum() == keep.sum()


# ---------------------------------------------------------------------------
# One routing tick, end to end (tests/test_kernels.py:428-446)
# ---------------------------------------------------------------------------


def test_routing_tick_matches_jax():
    """classes -> pod_route -> queue_update, three ticks on both sides with
    the same candidate lists (drawn once by the JAX samplers)."""
    from repro.core import Cluster, PodSpec, locality_class, pod_candidates, sample_locals
    c = Cluster(M=128, K=8)
    key = jax.random.PRNGKey(0)
    locals_ = sample_locals(key, c, 32)
    cls = locality_class(c, locals_)
    ci, cc, cv = (np.asarray(x) for x in pod_candidates(key, c, locals_, cls,
                                                         PodSpec(2, 6)))
    Qj, Wj = jnp.zeros((c.M, 3), jnp.int32), jnp.zeros((c.M,), jnp.float32)
    Qt, Wt = torch.zeros((c.M, 3), dtype=torch.int32), torch.zeros(c.M)
    ones = np.ones(32, bool)
    for _ in range(3):
        sel, _ = j_pod_route(Wj, jnp.asarray(ci), jnp.asarray(cc), jnp.asarray(cv), INV)
        take = (jnp.asarray(ci) == sel[:, None]).argmax(axis=1)
        scl = jnp.take_along_axis(jnp.asarray(cc), take[:, None], axis=1)[:, 0]
        Qj, Wj = j_queue_update(Qj, sel, scl, jnp.asarray(ones), INV)

        sel_t, _ = tk.pod_route(Wt, _t(ci), _t(cc), _t(cv), _t(INV))
        take_t = (_t(ci) == sel_t[:, None]).to(torch.int8).argmax(dim=1)
        scl_t = _t(cc).gather(1, take_t[:, None])[:, 0]
        Qt, Wt = tk.queue_update(Qt, sel_t, scl_t, _t(ones), _t(INV))
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel))
    assert int(Qt.sum()) == 96
    np.testing.assert_array_equal(Qt.numpy(), np.asarray(Qj))
    np.testing.assert_array_equal(Wt.numpy(), np.asarray(Wj))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_cpu_wrappers_launch_nothing_and_other_devices_raise():
    tk.reset_launch_counts()
    M, B, C = 8, 3, 4
    W = torch.zeros(M)
    tk.weighted_argmin(W, torch.zeros((B, M), dtype=torch.int32), torch.ones(3))
    tk.pod_route(W, torch.zeros((B, C), dtype=torch.int32),
                 torch.zeros((B, C), dtype=torch.int32),
                 torch.ones((B, C), dtype=torch.bool), torch.ones(3))
    tk.queue_update(torch.zeros((M, 3), dtype=torch.int32),
                    torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
                    torch.ones(B, dtype=torch.bool), torch.ones(3))
    assert set(tk.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="weighted_argmin"):
        tk.weighted_argmin(W.to("meta"), torch.zeros((B, M), dtype=torch.int32),
                           torch.ones(3))
