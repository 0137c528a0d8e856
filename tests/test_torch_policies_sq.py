"""The port's SQ-family policies and balls-and-bins against the reference.

``route_jsq_local`` and the peer maps, given the reference's own uniforms
and integers, must equal the JAX functions exactly; the port's peer
samplers must stay in (rack) or out of (remote) the server's rack and never
return the server; ``ballsbins.place`` must equal a numpy loop, and the
max load over 20 seeds must agree with JAX's within 3 standard errors.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import ballsbins as jbb
from repro.core import cluster as jcl
from repro.core import policies as jpol
from repro_torch.core import ballsbins as tbb
from repro_torch.core import cluster as tcl
from repro_torch.core import policies as tpol

CLUSTERS = [(20, 4), (500, 10), (12, 12)]     # last: racks of one server


@pytest.mark.parametrize("M,K", CLUSTERS[:2])
def test_route_jsq_local_equals_jax_on_the_same_uniforms(M, K):
    rng = np.random.default_rng(M)
    Q = rng.integers(0, 3, M).astype(np.int32)          # few lengths: ties
    locals_ = np.stack([rng.choice(M, 3, replace=False) for _ in range(64)]
                       ).astype(np.int32)
    key = jax.random.PRNGKey(M)
    want = jpol.route_jsq_local(key, Q, locals_)
    rnd = jax.random.uniform(key, locals_.shape)
    got = tpol.route_jsq_local(torch.from_numpy(np.array(rnd)),
                               torch.from_numpy(Q), torch.from_numpy(locals_))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    q = Q[locals_]
    assert (q == q.min(axis=1, keepdims=True)).sum(axis=1).max() > 1  # ties seen


@pytest.mark.parametrize("M,K", CLUSTERS)
def test_peer_maps_equal_jax_samplers_on_the_same_integers(M, K):
    jc, tc = jcl.Cluster(M=M, K=K), tcl.Cluster(M=M, K=K)
    np.testing.assert_array_equal(tc.rack_of.numpy(), np.asarray(jc.rack_of))
    R = jc.rack_size
    server = np.arange(M, dtype=np.int32).repeat(4)
    for j, (sampler, peer_of, hi) in enumerate([
            (jpol.sample_rack_peer, tpol.rack_peer_of, max(R - 1, 1)),
            (jpol.sample_remote_peer, tpol.remote_peer_of, max(M - R, 1))]):
        key = jax.random.PRNGKey(j)
        want = sampler(key, jc, server, 7)
        x = jax.random.randint(key, server.shape + (7,), 0, hi)
        got = peer_of(tc, torch.from_numpy(server), torch.from_numpy(np.array(x)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,K", CLUSTERS[:2])
def test_peer_samplers_stay_in_or_out_of_the_rack(M, K):
    cl = tcl.Cluster(M=M, K=K)
    R = cl.rack_size
    gen = torch.Generator().manual_seed(0)
    server = torch.arange(M).repeat(50)
    rack = tpol.sample_rack_peer(gen, cl, server, 6)
    remote = tpol.sample_remote_peer(gen, cl, server, 6)
    s = server[:, None]
    assert ((rack // R == s // R) & (rack != s)).all()
    assert ((remote // R != s // R) & (remote >= 0) & (remote < M)).all()
    # every peer is reachable: each rack's other members, every outside server
    assert len(torch.unique(rack[server == 0])) == R - 1
    assert len(torch.unique(remote)) == M


def test_place_equals_a_numpy_loop_on_fixed_candidates():
    rng = np.random.default_rng(0)
    for n, d in ((50, 1), (50, 2), (200, 3)):
        cand = rng.integers(0, n, (n, d))
        cand[::7, 1 % d] = cand[::7, 0]                  # duplicate candidates
        loads = np.zeros(n, np.int32)
        for c in cand:
            loads[c[np.argmin(loads[c])]] += 1
        got = tbb.place(torch.from_numpy(cand), n)
        np.testing.assert_array_equal(got.numpy(), loads)


@pytest.mark.parametrize("d", [1, 2])
def test_max_load_agrees_with_jax_over_seeds(d):
    n, seeds = 1000, 20
    ours = np.array([float(tbb.max_load(torch.Generator().manual_seed(s), n, d,
                                        device="cpu")) for s in range(seeds)])
    theirs = np.array([float(jbb.max_load(jax.random.PRNGKey(s), n, d))
                       for s in range(seeds)])
    se = np.sqrt(ours.var(ddof=1) / seeds + theirs.var(ddof=1) / seeds)
    assert abs(ours.mean() - theirs.mean()) <= 3 * se + 1e-6, (ours, theirs)
    assert tbb.theory_d1(n) == jbb.theory_d1(n)
    assert tbb.theory_d(n, 2) == jbb.theory_d(n, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbb.max_load(torch.Generator(), 10, d)
