"""On the card: the CUDA ``route_commit`` against its plain version, and
the simulator's CUDA path against its CPU path.

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
from repro_torch.kernels import route_commit_ref

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
    assert tk.LAUNCHES == {"route_commit_full": 1, "route_commit_pod": 0}
    with pytest.raises(TypeError):
        tk.route_commit(Q, v, torch.ones(3, device=dev),
                        cls=torch.zeros((B, M), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        tk.route_commit(Q, v, torch.ones(3, device=dev),
                        cls=torch.zeros((B, M), dtype=torch.int32))
    assert tk.LAUNCHES["route_commit_full"] == 1


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
