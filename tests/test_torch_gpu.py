"""On the card: each CUDA kernel against its plain version, and the
simulator's CUDA path against its CPU path.

Marked ``gpu``; each test skips without a CUDA device.  This file imports
no JAX (the card's machine has none).  Run it there with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core import Cluster, Rates, SimConfig, TorchDraws, simulate
from repro_torch.core.simulator import BP_POD_DEFAULT, SlotDraws
from repro_torch.kernels import (pod_route_ref, queue_update_ref,
                                 route_commit_ref, weighted_argmin_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda")


def _case(seed: int, M: int, B: int, C: int):
    """Tie-forcing inputs: pooled or lattice rates, dead servers and dead
    rate columns, few distinct queue lengths."""
    rng = np.random.default_rng(seed)
    inv = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (4, 3)))
    inv = inv[rng.integers(4, size=M)].astype(np.float32)
    inv[rng.choice(M, size=max(1, M // 8), replace=False)] = np.inf
    inv[rng.random(M) < 0.3, rng.integers(3)] = np.inf
    return dict(
        Q=rng.integers(0, 3, (M, 3)).astype(np.int32),
        valid=rng.random(B) < 0.85, inv=inv,
        cls=rng.integers(0, 3, (B, M)).astype(np.int32),
        prio=rng.permutation(M).astype(np.int32),
        cand_idx=rng.integers(0, M, (B, C)).astype(np.int32),
        cand_cls=rng.integers(0, 3, (B, C)).astype(np.int32),
        cand_valid=rng.random((B, C)) < 0.85)


@pytest.mark.parametrize("seed,M,B,C", [(0, 64, 3, 5), (1, 129, 9, 16),
                                        (2, 500, 22, 11), (3, 5000, 90, 11)])
@pytest.mark.parametrize("homogeneous", [False, True])
def test_cuda_route_commit_equals_plain_version(dev, seed, M, B, C, homogeneous):
    x = _case(seed, M, B, C)
    inv = np.array([10.0, 20.0, 50.0], np.float32) if homogeneous else x["inv"]
    for keys in (("cls", "prio"), ("cls",), ("cand_idx", "cand_cls", "cand_valid")):
        args = [torch.from_numpy(np.array(a)) for a in (x["Q"], x["valid"], inv)]
        kw = {k: torch.from_numpy(x[k]) for k in keys}
        plain = route_commit_ref(*args, **kw)
        cuda = tk.route_commit(*(a.to(dev) for a in args),
                               **{k: v.to(dev) for k, v in kw.items()})
        torch.cuda.synchronize()
        for name, a, b in zip(("Q", "W", "sel", "sel_cls", "val"), plain, cuda):
            assert torch.equal(a, b.cpu()), (keys, name)


def test_cuda_launch_counter_and_input_checks(dev):
    tk.reset_launch_counts()
    M, B = 64, 4
    Q = torch.zeros((M, 3), dtype=torch.int32, device=dev)
    v = torch.ones(B, dtype=torch.bool, device=dev)
    tk.route_commit(Q, v, torch.ones(3, device=dev),
                    cls=torch.zeros((B, M), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["route_commit_full"] == 1
    assert tk.LAUNCHES["route_commit_pod"] == 0
    assert sum(tk.LAUNCHES.values()) == 1
    with pytest.raises(TypeError):
        tk.route_commit(Q, v, torch.ones(3, device=dev),
                        cls=torch.zeros((B, M), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        tk.route_commit(Q, v, torch.ones(3, device=dev),
                        cls=torch.zeros((B, M), dtype=torch.int32))
    assert tk.LAUNCHES["route_commit_full"] == 1


def _snapshot_case(seed: int, M: int, B: int, C: int, homogeneous: bool):
    """Tie-forcing snapshot inputs: few distinct workloads (or, odd seeds,
    uniform ones), pooled rates with dead servers and columns, class-3
    entries, a row of class 3 only, duplicate candidates, invalid slots, a
    row with no valid slot, and commits that drop (server M, class 3)."""
    x = _case(seed, M, B, C)
    rng = np.random.default_rng(seed + 1000)
    inv = np.array([10.0, 20.0, 50.0], np.float32) if homogeneous else x["inv"]
    W = (rng.choice(np.array([0.0, 1.0, 2.5, 77.0], np.float32), M) if seed % 2 == 0
         else rng.uniform(0, 100, M).astype(np.float32))
    cls = rng.integers(0, 4, (B, M)).astype(np.int32)
    cls[0] = 3
    ci = x["cand_idx"]
    ci[:, 1::2] = ci[:, 0::2][:, :ci[:, 1::2].shape[1]]
    cv = x["cand_valid"]
    cv[0] = False
    sel = rng.integers(0, M, B).astype(np.int32)
    sel[rng.random(B) < 0.2] = M
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return dict(W=t(W), cls=t(cls), inv=t(inv), cand_idx=t(ci),
                cand_cls=t(rng.integers(0, 4, (B, C)).astype(np.int32)),
                cand_valid=t(cv), Q=t(x["Q"]), sel=t(sel),
                sel_cls=t(rng.integers(0, 4, B).astype(np.int32)), valid=t(x["valid"]))


def _snapshot_calls(x):
    """(name, kernel wrapper, plain version, args) of each snapshot kernel;
    weighted_argmin also with a bfloat16 W."""
    w16 = x["W"].to(torch.bfloat16)
    return [("weighted_argmin", tk.weighted_argmin, weighted_argmin_ref,
             (x["W"], x["cls"], x["inv"])),
            ("weighted_argmin", tk.weighted_argmin, weighted_argmin_ref,
             (w16, x["cls"], x["inv"])),
            ("pod_route", tk.pod_route, pod_route_ref,
             (x["W"], x["cand_idx"], x["cand_cls"], x["cand_valid"], x["inv"])),
            ("queue_update", tk.queue_update, queue_update_ref,
             (x["Q"], x["sel"], x["sel_cls"], x["valid"], x["inv"]))]


@pytest.mark.parametrize("seed,M,B,C", [(0, 64, 3, 5), (1, 129, 9, 16),
                                        (2, 500, 256, 11), (3, 5000, 256, 11),
                                        (4, 8192, 256, 11), (5, 500, 37, 40)])
@pytest.mark.parametrize("homogeneous", [False, True])
def test_cuda_snapshot_kernels_equal_plain_versions(dev, seed, M, B, C, homogeneous):
    x = _snapshot_case(seed, M, B, C, homogeneous)
    for name, kernel, plain, args in _snapshot_calls(x):
        want = plain(*args)
        got = kernel(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(want, got)):
            assert torch.equal(a, b.cpu()), (name, args[0].dtype, i)


def test_cuda_snapshot_wrappers_count_only_their_own_launches_and_check_inputs(dev):
    x = _snapshot_case(0, 64, 4, 5, False)
    for name, kernel, _, args in _snapshot_calls(x):
        args = [a.to(dev) for a in args]
        tk.reset_launch_counts()
        kernel(*args)
        torch.cuda.synchronize()
        assert tk.LAUNCHES[name] == 1 and sum(tk.LAUNCHES.values()) == 1, name
        for i in range(len(args)):
            bad = list(args)
            bad[i] = args[i].to(torch.float64)
            with pytest.raises(TypeError):
                kernel(*bad)
            if i:                     # dispatch reads the first tensor's device
                bad[i] = args[i].cpu()
                with pytest.raises(ValueError):
                    kernel(*bad)
        assert sum(tk.LAUNCHES.values()) == 1, name


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod"])
def test_simulate_cuda_path_equals_cpu_path_on_shared_draws(dev, algo):
    """Fed the same draws (made on the CPU), the CUDA path (kernel) and the
    CPU path (plain version) give bit-identical results."""
    cl, rates = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
    cfg = SimConfig(T=500, warmup=100, route_mode="batched")
    pod = BP_POD_DEFAULT if algo == "balanced_pandas_pod" else None
    a_max = cfg.resolve_a_max(0.9 * rates.alpha * cl.M)
    lam_t = torch.full((cfg.T,), 0.9 * rates.alpha * cl.M)
    out = []
    for run_dev in ("cpu", dev):
        src = TorchDraws(torch.Generator().manual_seed(3), cl, rates, cfg, pod,
                         a_max, lam_t)

        def draw(t, src=src, run_dev=run_dev):
            return SlotDraws(*(None if d is None else d.to(run_dev)
                               for d in src(t)))
        tk.reset_launch_counts()
        out.append(simulate(algo, cl, rates, 0.9, 0, cfg, a_max=a_max,
                            device=run_dev, draws=draw))
    assert sum(tk.LAUNCHES.values()) == cfg.T
    for name, a, b in zip(out[0]._fields, *out):
        assert torch.equal(a, b.cpu()), name
