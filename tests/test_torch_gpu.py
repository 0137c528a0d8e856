"""On the card: each CUDA kernel against its plain version, and the
simulator's CUDA path against its CPU path.

Marked ``gpu``; each test skips without a CUDA device.  This file imports
no JAX (the card's machine has none).  Run it there with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import contextlib
import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cases import cells_case, jsq_operand, pod_route_case, valid_patterns
from repro_torch import kernels as tk
from repro_torch.core import Cluster, Rates, SimConfig, TorchDraws, simulate
from repro_torch.core.simulator import _family, _pod_for
from repro_torch.kernels import (pod_route_ref, queue_update_ref,
                                 route_commit_ref, weighted_argmin_ref)
from repro_torch.kernels.pod_route import launch as pod_route_launch
from repro_torch.kernels.queue_update import launch as queue_update_launch
from repro_torch.kernels.route_commit import launch
from repro_torch.kernels.weighted_argmin import launch as weighted_argmin_launch

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


def _assert_route_commit_equal(dev, Q, valid, inv, **kw):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (Q, valid, inv)]
    kw = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in kw.items()}
    plain = route_commit_ref(*args, **kw)
    cuda = tk.route_commit(*(a.to(dev) for a in args),
                           **{k: v.to(dev) for k, v in kw.items()})
    torch.cuda.synchronize()
    for name, a, b in zip(("Q", "W", "sel", "sel_cls", "val"), plain, cuda):
        assert torch.equal(a, b.cpu()), (sorted(kw), name)


@pytest.mark.parametrize("M,B,lam", [(500, 16, 2.5), (500, 22, 4.5), (5000, 90, 45.0)])
@pytest.mark.parametrize("pattern", ["none", "last", "first", "poisson", "gaps"])
def test_cuda_route_commit_pod_jsq_operand(dev, M, B, lam, pattern):
    """Batched JSQ routing's operand (C=3 replica triples, class 0, all
    valid, unit rates, Q in column 0 with slot-order ties) at the batches
    of M=500, loads 0.5 / 0.9, and of M=5000: equal to the plain version
    to the bit on every ``valid`` pattern."""
    Q, ci, cc, cv, inv = jsq_operand(M, B, M + B)
    valid = valid_patterns(B, lam, np.random.default_rng(B))[pattern]
    _assert_route_commit_equal(dev, Q, valid, inv, cand_idx=ci, cand_cls=cc,
                               cand_valid=cv)


@pytest.mark.parametrize("M,B,C,lam", [(500, 22, 11, 4.5), (5000, 90, 11, 45.0),
                                       (1500, 17, 40, 6.0), (29056, 5, 11, 2.0)])
@pytest.mark.parametrize("pattern", ["none", "last", "first", "poisson", "gaps"])
def test_cuda_route_commit_valid_patterns(dev, M, B, C, lam, pattern):
    """Both variants equal the plain version to the bit on every ``valid``
    pattern: at the main path's shapes, at an M that is not a multiple of
    the thread count (with more than 32 candidates), and at the largest M
    the wrapper accepts; with class-3 entries and an all-class-3 row,
    heterogeneous, homogeneous and all-dead rates, prio given and absent."""
    x = _case(M + B, M, B, C)
    rng = np.random.default_rng(M)
    valid = valid_patterns(B, lam, rng)[pattern]
    cls = rng.integers(0, 4, (B, M)).astype(np.int32)
    cls[B // 2] = 3
    cand_cls = rng.integers(0, 4, (B, C)).astype(np.int32)
    for inv in (x["inv"], np.array([10.0, 20.0, 50.0], np.float32),
                np.full((M, 3), np.inf, np.float32)):
        for prio in (x["prio"], None):
            kw = {} if prio is None else {"prio": prio}
            _assert_route_commit_equal(dev, x["Q"], valid, inv, cls=cls, **kw)
        _assert_route_commit_equal(dev, x["Q"], valid, inv, cand_idx=x["cand_idx"],
                                   cand_cls=cand_cls, cand_valid=x["cand_valid"])


@pytest.mark.parametrize("N", [1, 3, 133])
@pytest.mark.parametrize("M,B,C,lam", [(500, 22, 11, 4.5), (5000, 90, 11, 45.0)])
@pytest.mark.parametrize("inv", ["[3]", "[M,3]", "[N,M,3]"])
def test_cuda_route_commit_cells_equal_plain_version(dev, N, M, B, C, lam, inv):
    """A launch with a leading cell axis, one CTA a cell, equals the plain
    version (a loop over the cells) to the bit: each cell its own queues,
    classes, prio, candidates and valid pattern, the rates shared at a cell
    stride of 0 or one matrix a cell, the candidate classes shared; both
    variants, the full one also without prio.  133 cells are a full wave of
    the card's 132 SMs and one CTA of a second wave; it counts one launch."""
    x = cells_case(N + M, N, M, B, C, lam, inv)
    for keys in (("cls", "prio"), ("cls",), ("cand_idx", "cand_cls", "cand_valid")):
        tk.reset_launch_counts()
        _assert_route_commit_equal(dev, x["Q"], x["valid"], x["inv"],
                                   **{k: x[k] for k in keys})
        assert sum(tk.LAUNCHES.values()) == 1
        assert sum(tk.MATRIX_LAUNCHES.values()) == (inv != "[3]")


@pytest.mark.parametrize("B,C", [(700, 11), (3, 8000)])
def test_cuda_route_commit_pod_past_its_staging_room(dev, B, C):
    """At the largest M the pod kernel stages ~7000 candidate slots: 700
    valid rows of 11 take two chunks, and rows of 8000 slots are built
    partly from device memory in the step."""
    M = 29056
    x = _case(7, M, B, C)
    valid = np.ones(B, bool)
    valid[B // 3] = False
    _assert_route_commit_equal(dev, x["Q"], valid, x["inv"], cand_idx=x["cand_idx"],
                               cand_cls=x["cand_cls"], cand_valid=x["cand_valid"])


class _AllocProp(ctypes.Structure):      # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("win32_meta", ctypes.c_void_p), ("compression", ctypes.c_ubyte),
                ("rdma", ctypes.c_ubyte), ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _AccessDesc(ctypes.Structure):     # CUmemAccessDesc
    _fields_ = [("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("flags", ctypes.c_int)]


class _CudaArray:
    """The bytes at a device address, seen as a tensor of ``like``'s shape
    and dtype (zero-copy, through ``__cuda_array_interface__``)."""

    def __init__(self, ptr: int, like: torch.Tensor):
        typestr = {torch.int32: "<i4", torch.int16: "<i2", torch.float32: "<f4",
                   torch.bool: "|b1"}
        self.__cuda_array_interface__ = {
            "shape": tuple(like.shape), "typestr": typestr[like.dtype],
            "data": (ptr, False), "strides": None, "version": 2}


@contextlib.contextmanager
def _fenced(tensors, at_end: bool):
    """Copies of the CUDA ``tensors``, each in device memory of its own
    (mapped with cuMemCreate and cuMemMap) flush against a page that is
    reserved and never mapped: the page after its last byte (``at_end``)
    or the one before its first.  A kernel that touches a byte outside a
    buffer then faults with an illegal address."""
    cu = ctypes.CDLL("libcuda.so.1")
    u64, size = ctypes.c_uint64, ctypes.c_size_t

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    dev_id = torch.cuda.current_device()
    prop = _AllocProp(type=1, loc_type=1, loc_id=dev_id)    # pinned, this device
    gran = size()
    ok(cu.cuMemGetAllocationGranularity(ctypes.byref(gran), ctypes.byref(prop), 0),
       "cuMemGetAllocationGranularity")
    G = gran.value
    held, out = [], []     # (reserved base, reserved bytes, handle, mapped bytes)
    try:
        for t in tensors:
            n = -(-t.nbytes // G) * G
            base, h = u64(), u64()
            ok(cu.cuMemAddressReserve(ctypes.byref(base), size(n + 2 * G), size(0),
                                      u64(0), u64(0)), "cuMemAddressReserve")
            held.append([base.value, n + 2 * G, None, 0])
            ok(cu.cuMemCreate(ctypes.byref(h), size(n), ctypes.byref(prop), u64(0)),
               "cuMemCreate")
            held[-1][2] = h.value
            ok(cu.cuMemMap(u64(base.value + G), size(n), size(0), h, u64(0)),
               "cuMemMap")
            held[-1][3] = n
            acc = _AccessDesc(loc_type=1, loc_id=dev_id, flags=3)   # read-write
            ok(cu.cuMemSetAccess(u64(base.value + G), size(n), ctypes.byref(acc),
                                 size(1)), "cuMemSetAccess")
            ptr = base.value + G + (n - t.nbytes if at_end else 0)
            f = torch.as_tensor(_CudaArray(ptr, t), device=t.device)
            assert f.data_ptr() == ptr
            f.copy_(t)
            out.append(f)
        torch.cuda.synchronize()
        yield out
    finally:
        torch.cuda.synchronize()
        for base, reserved, h, mapped in reversed(held):
            if mapped:
                cu.cuMemUnmap(u64(base + G), size(mapped))
            if h is not None:
                cu.cuMemRelease(u64(h))
            cu.cuMemAddressFree(u64(base), size(reserved))


@pytest.mark.parametrize("M,B,C", [(500, 22, 11), (1025, 17, 40), (5000, 90, 11),
                                   (29056, 5, 11)])
@pytest.mark.parametrize("at_end", [True, False], ids=["fence_after", "fence_before"])
def test_cuda_route_commit_stays_inside_its_buffers(dev, M, B, C, at_end):
    """Every input and output of both variants lies flush against a page
    that is never mapped, so one byte read or written past either end of a
    buffer faults; then the outputs equal the plain version.  M=1025 leaves
    all but one server of the last strip past M, M=500 the end of the only
    one; [M, 3] and [3] rates, prio given and absent, with a tail.  Then
    the same for a launch of 3 cells, whose last cell ends each per-cell
    buffer (and whose first starts it), with one rate matrix a cell and
    the candidate classes shared."""
    x = _case(M, M, B, C)
    rng = np.random.default_rng(M + 1)
    valid = valid_patterns(B, B / 4, rng)["gaps"]
    cls = rng.integers(0, 4, (B, M)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pod_keys = ("cand_idx", "cand_cls", "cand_valid")
    cases = [(x["Q"], valid, inv, kw)
             for inv in (x["inv"], np.array([10.0, 20.0, 50.0], np.float32))
             for kw in ({"cls": cls, "prio": x["prio"]}, {"cls": cls},
                        {k: x[k] for k in pod_keys})]
    y = cells_case(M + 2, 3, M, B, C, B / 4)
    y["valid"][-1] = valid
    cases += [(y["Q"], y["valid"], y["inv"], kw)
              for kw in ({"cls": y["cls"], "prio": y["prio"]}, {"cls": y["cls"]},
                         {k: y[k] for k in pod_keys})]
    for Q, v, inv, kw in cases:
        args = [t(Q), t(v), t(inv)]
        kw = {k: t(a) for k, a in kw.items()}
        plain = route_commit_ref(*args, **kw)
        garbage = [torch.full_like(o, 7).to(dev) for o in plain]
        with _fenced([a.to(dev) for a in args + list(kw.values())] + garbage,
                     at_end) as f:
            ins, outs = f[:len(args) + len(kw)], f[len(args) + len(kw):]
            launch(*ins[:3], outs, **dict(zip(kw, ins[3:])))
            torch.cuda.synchronize()
            got = [o.cpu() for o in outs]
        for name, a, b in zip(("Q", "W", "sel", "sel_cls", "val"), plain, got):
            assert torch.equal(a, b), (sorted(kw), inv.shape, name)


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


# weighted_argmin splits a row at a thread's 4 servers (int4), a warp's
# 128, the 1024 between a thread's loads and the 4096 of a batch of loads
# (with 1, 32, 256 and 4096 when the row is not 16-byte aligned).
_SPLITS = (4, 32, 128, 256, 1024, 4096, 8192)


def _argmin_case(seed: int, M: int, B: int):
    """W, cls and [M, 3] rates (dead servers and columns) for
    weighted_argmin, with row 0 all class 3 and, in every other row, equal
    minima planted in pairs on both sides of a boundary: of a chunk, of a
    thread's four servers, of a warp's servers, or the last two servers.
    Planted servers have W = 0 and finite rates (score 0, every other score
    is positive), each row keeps only its pair (other planted slots get
    class 3), so the lower index of the pair must win."""
    rng = np.random.default_rng(seed)
    inv = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (4, 3)))
    inv = inv[rng.integers(4, size=M)].astype(np.float32)
    inv[rng.choice(M, size=max(1, M // 8), replace=False)] = np.inf
    inv[rng.random(M) < 0.3, rng.integers(3)] = np.inf
    W = rng.uniform(1, 100, M).astype(np.float32)
    cls = rng.integers(0, 4, (B, M)).astype(np.int32)
    pairs = [(p - 1, p) for p in (*_SPLITS, M - 1) if 0 < p < M]
    planted = sorted({m for pair in pairs for m in pair})
    W[planted] = 0.0
    inv[planted] = [1.0, 2.0, 4.0]
    for b in range(1, B):
        cls[b, planted] = 3
        pair = list(pairs[b % len(pairs)])
        cls[b, pair] = rng.integers(0, 3, 2)
    cls[0] = 3
    return W, cls, inv


def _assert_argmin_equal(dev, W, cls, inv):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    for w in (t(W), t(W).to(torch.bfloat16)):
        for rates in (t(inv), t(np.array([10.0, np.inf, 50.0], np.float32))):
            want = weighted_argmin_ref(w, t(cls), rates)
            got = tk.weighted_argmin(w.to(dev), t(cls).to(dev), rates.to(dev))
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(want, got)):
                assert torch.equal(a, b.cpu()), (w.dtype, tuple(rates.shape), i)


@pytest.mark.parametrize("M", [64, 129, 1025, 8192, 10001, 16000])
@pytest.mark.parametrize("B", [1, 3, 131, 133, 256, 300])
def test_cuda_weighted_argmin_battery(dev, B, M):
    """Bit-equal to the plain version for B from 1 to 300, for M that is
    not a multiple of 4 (int loads) and rows of several batches of loads
    (M=8192 and up); float32
    and bfloat16 W, [M, 3] and [3] rates with dead entries, an all-class-3
    row and ties planted across every split of M."""
    _assert_argmin_equal(dev, *_argmin_case(B + M, M, B))


@pytest.mark.parametrize("M,B", [(129, 3), (1025, 133), (8192, 256), (16000, 131)])
@pytest.mark.parametrize("at_end", [True, False], ids=["fence_after", "fence_before"])
def test_cuda_weighted_argmin_stays_inside_its_buffers(dev, M, B, at_end):
    """W, cls, the rates and the outputs each lie flush against a page that
    is never mapped, so a load one byte past either end of a buffer
    faults; then the outputs equal the plain version.  M=129 with the
    fence after puts cls off 16-byte alignment (the int loads)."""
    W, cls, inv = _argmin_case(M, M, B)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    for w in (t(W), t(W).to(torch.bfloat16)):
        for rates in (t(inv), t(np.array([10.0, np.inf, 50.0], np.float32))):
            want = weighted_argmin_ref(w, t(cls), rates)
            ins = [w.view(torch.int16) if w.dtype == torch.bfloat16 else w,
                   t(cls), rates]
            outs = [torch.full((B,), 7, dtype=torch.int32), torch.full((B,), 7.0)]
            with _fenced([a.to(dev) for a in ins + outs], at_end) as f:
                fw = f[0].view(torch.bfloat16) if w.dtype == torch.bfloat16 else f[0]
                weighted_argmin_launch(fw, f[1], f[2], f[3], f[4])
                torch.cuda.synchronize()
                got = [f[3].cpu(), f[4].cpu()]
            for i, (a, b) in enumerate(zip(want, got)):
                assert torch.equal(a, b), (w.dtype, tuple(rates.shape), i)


def _commit_case(seed: int, M: int, B: int):
    rng = np.random.default_rng(seed)
    x = _case(seed, M, B, 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(x["Q"]), t(rng.integers(0, M, B).astype(np.int32)),
            t(rng.integers(0, 4, B).astype(np.int32)), t(x["valid"]), t(x["inv"]))


@pytest.mark.parametrize("M,B,one_server", [(500, 1000, True), (257, 700, True),
                                            (1000, 256, False), (257, 3, False),
                                            (8192, 300, False)])
def test_cuda_queue_update_batches_and_tiles(dev, M, B, one_server):
    """Bit-equal to the plain version when the batch is larger than a
    block (every commit on one server, so one counter takes them all) and
    when M is not a multiple of the 256-server tile; [M, 3] and [3] rates."""
    Q, sel, sel_cls, valid, inv = _commit_case(M + B, M, B)
    if one_server:
        sel[:] = M // 2
        sel[::7] = M                       # the pad server drops
    for rates in (inv, torch.tensor([10.0, np.inf, 50.0])):
        args = (Q, sel, sel_cls, valid, rates)
        want = queue_update_ref(*args)
        got = tk.queue_update(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(want, got)):
            assert torch.equal(a, b.cpu()), (tuple(rates.shape), i)


def test_cuda_queue_update_waits_for_the_kernel_in_front(dev):
    """queue_update may start before the kernel in front of it has
    finished (programmatic stream serialization) and must read nothing
    before that kernel's writes land.  weighted_argmin at M=16000 writes
    sel as its blocks end, into a buffer that holds a stale batch;
    queue_update launched straight after must commit the new sel.  Then
    an in-place PyTorch kernel writes Q right before each queue_update."""
    M, B = 16000, 256
    W, cls, inv = _argmin_case(3, M, B)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    W, cls, inv = t(W), t(cls), t(inv)
    new_sel, _ = weighted_argmin_ref(W, cls, inv)
    Q, _, sel_cls, valid, _ = _commit_case(5, M, B)
    stale = torch.full((B,), M - 1, dtype=torch.int32)
    assert not torch.equal(stale, new_sel)
    want = queue_update_ref(Q, new_sel, sel_cls, valid, inv)
    d = {k: v.to(dev) for k, v in dict(W=W, cls=cls, inv=inv, Q=Q, sel_cls=sel_cls,
                                      valid=valid, stale=stale).items()}
    sel = torch.empty(B, dtype=torch.int32, device=dev)
    val = torch.empty(B, device=dev)
    Q_new = torch.empty_like(d["Q"])
    W_new = torch.empty(M, device=dev)
    for _ in range(20):
        sel.copy_(d["stale"])
        weighted_argmin_launch(d["W"], d["cls"], d["inv"], sel, val)
        queue_update_launch(d["Q"], sel, d["sel_cls"], d["valid"], d["inv"], Q_new,
                            W_new)
        torch.cuda.synchronize()
        assert torch.equal(Q_new.cpu(), want[0]) and torch.equal(W_new.cpu(), want[1])
    Qd = d["Q"].clone()
    for k in range(1, 21):
        Qd.add_(1)
        queue_update_launch(Qd, sel, d["sel_cls"], d["valid"], d["inv"], Q_new, W_new)
        torch.cuda.synchronize()
        want = queue_update_ref(Q + k, new_sel, sel_cls, valid, inv)
        assert torch.equal(Q_new.cpu(), want[0]) and torch.equal(W_new.cpu(), want[1])


def _pod_inputs(W, ci, cc, cv, inv):
    """The battery's (W, cand_idx, cand_cls, valid) as tensors, with W in
    float32 and bfloat16 and the [M, 3] and [3] rates (dead column 1)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    for w in (t(W), t(W).to(torch.bfloat16)):
        for rates in (t(inv), t(np.array([10.0, np.inf, 50.0], np.float32))):
            yield w, t(ci), t(cc), t(cv), rates


@pytest.mark.parametrize("M", [97, 16000])
@pytest.mark.parametrize("B", [1, 3, 256, 300])
@pytest.mark.parametrize("C", [1, 11, 32, 33, 40])
def test_cuda_pod_route_battery(dev, C, B, M):
    """Bit-equal to the plain version for C from 1 to 40 (one slot a lane,
    two, and rows longer than a warp), B from 1 to 300: float32 and
    bfloat16 W, [M, 3] and [3] rates with dead entries and a dead column,
    equal minima at two different servers on both sides of every split of
    a row, duplicate candidates, a row with no valid slot, a row of class 3
    only, and the candidates -1 and M."""
    for args in _pod_inputs(*pod_route_case(C * 1000 + B, M, B, C)):
        want = pod_route_ref(*args)
        got = tk.pod_route(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(want, got)):
            assert torch.equal(a, b.cpu()), (args[0].dtype, tuple(args[4].shape), i)


@pytest.mark.parametrize("M,B,C", [(500, 256, 11), (97, 3, 11), (5000, 300, 40),
                                   (64, 1, 40)])
@pytest.mark.parametrize("at_end", [True, False], ids=["fence_after", "fence_before"])
def test_cuda_pod_route_stays_inside_its_buffers(dev, M, B, C, at_end):
    """W, cand_idx, cand_cls, valid, the rates and the outputs each lie
    flush against a page that is never mapped, so a load one byte past
    either end of a buffer faults; then the outputs equal the plain
    version.  Rows of 11 and 40 slots are not 16-byte aligned; the
    candidates -1 and M must not be loaded, nor a slot or row past the
    last."""
    for w, ci, cc, cv, rates in _pod_inputs(*pod_route_case(M + C, M, B, C)):
        want = pod_route_ref(w, ci, cc, cv, rates)
        ins = [w.view(torch.int16) if w.dtype == torch.bfloat16 else w, ci, cc, cv,
               rates]
        outs = [torch.full((B,), 7, dtype=torch.int32), torch.full((B,), 7.0)]
        with _fenced([a.to(dev) for a in ins + outs], at_end) as f:
            fw = f[0].view(torch.bfloat16) if w.dtype == torch.bfloat16 else f[0]
            pod_route_launch(fw, *f[1:5], f[5], f[6])
            torch.cuda.synchronize()
            got = [f[5].cpu(), f[6].cpu()]
        for i, (a, b) in enumerate(zip(want, got)):
            assert torch.equal(a, b), (w.dtype, tuple(rates.shape), i)


def test_cuda_pod_route_waits_for_the_kernel_in_front(dev):
    """pod_route may start before the kernel in front of it has finished
    (programmatic stream serialization) and must read nothing before that
    kernel's writes land.  20 rounds each: fresh candidate lists written
    by a PyTorch kernel over stale ones (cand_idx, cand_cls and valid in
    turn; a kernel, not a copy_ that runs as a memcpy) and an in-place
    PyTorch write to W, the one or the other right before the launch; then
    queue_update at M=16000 launched straight into a pod_route that reads
    its W_new, which held stale workloads."""
    M, B, C = 16000, 256, 11
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    W, ci, cc, cv, inv = (t(a) for a in pod_route_case(5, M, B, C, outside=False))
    rng = np.random.default_rng(6)
    stale = dict(ci=torch.zeros_like(ci), cc=torch.full_like(cc, 3),
                 cv=torch.zeros_like(cv))
    d = {k: v.to(dev) for k, v in dict(W=W, ci=ci, cc=cc, cv=cv, inv=inv).items()}
    sel = torch.empty(B, dtype=torch.int32, device=dev)
    val = torch.empty(B, device=dev)
    for k in range(20):
        delta = t(rng.uniform(0, 50, M).astype(np.float32))
        fresh = dict(ci=t(rng.integers(0, M, (B, C)).astype(np.int32)),
                     cc=t(rng.integers(0, 3, (B, C)).astype(np.int32)),
                     cv=t(rng.random((B, C)) < 0.9))
        name = ("ci", "cc", "cv")[k % 3]
        lists = {**fresh, name: stale[name]}
        W = W + delta
        want = pod_route_ref(W, fresh["ci"], fresh["cc"], fresh["cv"], inv)
        old = pod_route_ref(W, lists["ci"], lists["cc"], lists["cv"], inv)
        assert not torch.equal(want[0], old[0]), k
        for n, a in lists.items():
            d[n].copy_(a.to(dev))
        dd, fd = delta.to(dev), fresh[name].to(dev)
        torch.cuda.synchronize()
        write = ((lambda: torch.logical_or(fd, fd, out=d["cv"])) if name == "cv"
                 else (lambda: torch.add(fd, 0, out=d[name])))
        if k % 2:
            d["W"].add_(dd)
            write()
        else:
            write()
            d["W"].add_(dd)
        pod_route_launch(d["W"], d["ci"], d["cc"], d["cv"], d["inv"], sel, val)
        torch.cuda.synchronize()
        assert torch.equal(sel.cpu(), want[0]) and torch.equal(val.cpu(), want[1]), k
    Q, qsel, qcls, qvalid, _ = _commit_case(7, M, B)
    Qd = Q.to(dev, copy=True)
    q_args = [a.to(dev) for a in (qsel, qcls, qvalid)]
    Q_new = torch.empty_like(Qd)
    W_new = torch.empty(M, device=dev)
    stale_w = torch.full((M,), 1e6)
    stale_w[:4] = 0.0                  # the planted servers
    for n, a in dict(ci=ci, cc=cc, cv=cv).items():
        d[n].copy_(a.to(dev))
    stale_w_d = stale_w.to(dev)
    for k in range(1, 21):
        W_k = queue_update_ref(Q + k, qsel, qcls, qvalid, inv)[1]
        want = pod_route_ref(W_k, ci, cc, cv, inv)
        assert not torch.equal(want[0], pod_route_ref(stale_w, ci, cc, cv, inv)[0])
        W_new.copy_(stale_w_d)
        Qd.add_(1)
        queue_update_launch(Qd, *q_args, d["inv"], Q_new, W_new)
        pod_route_launch(W_new, d["ci"], d["cc"], d["cv"], d["inv"], sel, val)
        torch.cuda.synchronize()
        assert torch.equal(sel.cpu(), want[0]) and torch.equal(val.cpu(), want[1]), k



def _late_writer():
    """write(src, dst): copies src's bytes over dst's in a kernel that lets
    the kernel after it start at once and writes only after ~50 us
    (tests/late_writer.cu)."""
    from repro_torch.kernels import build
    lib = ctypes.CDLL(str(build.build(
        "late_writer", source=Path(__file__).resolve().with_name("late_writer.cu"))))
    fn = lib.late_write
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def write(src, dst):
        assert src.nbytes == dst.nbytes and src.is_contiguous() and dst.is_contiguous()
        err = fn(src.data_ptr(), dst.data_ptr(), dst.nbytes, 100_000,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err == 0, f"late_write: CUDA error {err}"
    return write


def _snapshot_launch_case(kernel: str, bf16: bool, per_server: bool):
    """(fresh inputs, stale value of each input, plain version, launch,
    output buffers) of one snapshot kernel at the routing tick's shapes,
    with W in bfloat16 or float32 and [M, 3] or [3] rates."""
    M, B, C = 16000, 256, 11
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    rates = lambda inv: inv if per_server else torch.tensor([10.0, np.inf, 50.0])
    w = lambda W: W.to(torch.bfloat16) if bf16 else W
    if kernel == "pod_route":
        W, ci, cc, cv, inv = (t(a) for a in pod_route_case(5, M, B, C, outside=False))
        x = dict(W=w(W), cand_idx=ci, cand_cls=cc, valid=cv, inv=rates(inv))
        stale = dict(W=x["W"].flip(0), cand_idx=torch.zeros_like(ci),
                     cand_cls=torch.full_like(cc, 3), valid=torch.zeros_like(cv),
                     inv=x["inv"].flip(0))
        return x, stale, pod_route_ref, pod_route_launch, (
            torch.empty(B, dtype=torch.int32), torch.empty(B))
    if kernel == "weighted_argmin":
        W, cls, inv = (t(a) for a in _argmin_case(3, M, B))
        x = dict(W=w(W), cls=cls, inv=rates(inv))
        stale = dict(W=x["W"].flip(0), cls=torch.full_like(cls, 3), inv=x["inv"].flip(0))
        return x, stale, weighted_argmin_ref, weighted_argmin_launch, (
            torch.empty(B, dtype=torch.int32), torch.empty(B))
    Q, sel, sel_cls, valid, inv = _commit_case(5, M, B)
    x = dict(Q=Q, sel=sel, sel_cls=sel_cls, valid=valid, inv=rates(inv))
    stale = dict(Q=Q + 5, sel=torch.full_like(sel, M - 1),
                 sel_cls=torch.full_like(sel_cls, 3), valid=torch.zeros_like(valid),
                 inv=x["inv"].flip(0))
    return x, stale, queue_update_ref, queue_update_launch, (
        torch.empty_like(Q), torch.empty(M))


_OPERANDS = {"pod_route": ("W", "cand_idx", "cand_cls", "valid", "inv"),
             "weighted_argmin": ("W", "cls", "inv"),
             "queue_update": ("Q", "sel", "sel_cls", "valid", "inv")}


@pytest.mark.parametrize("kernel,operand,bf16,per_server", [
    (k, o, bf16, per_server) for k, ops in _OPERANDS.items() for o in ops
    for bf16 in ((False, True) if k != "queue_update" else (False,))
    for per_server in (True, False)])
def test_cuda_snapshot_kernel_waits_for_an_early_trigger(dev, kernel, operand, bf16,
                                                         per_server):
    """A kernel in front that lets its dependents start at once and writes
    an input ~50 us later: a snapshot kernel (a programmatic dependent
    launch) that read that input before its griddepcontrol.wait would see
    the stale value.  PyTorch's kernels never let a dependent start early,
    so the tests behind them above cannot catch such a read; this one
    does, for each input of each compiled variant (float32 or bfloat16 W,
    [M, 3] or [3] rates), a load the compiler moved above the wait
    included.  Five rounds each."""
    write = _late_writer()
    x, stale, ref, launch_fn, outs = _snapshot_launch_case(kernel, bf16, per_server)
    want = ref(*x.values())
    old = ref(*{**x, operand: stale[operand]}.values())
    assert not all(torch.equal(a, b) for a, b in zip(want, old))
    d = {k: v.to(dev) for k, v in x.items()}
    fresh, stale_d = d[operand].clone(), stale[operand].to(dev)
    outs = [o.to(dev) for o in outs]
    for k in range(5):
        d[operand].copy_(stale_d)
        torch.cuda.synchronize()
        write(fresh, d[operand])
        launch_fn(*d.values(), *outs)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(want, outs)):
            assert torch.equal(a, b.cpu()), (k, i)


@pytest.mark.parametrize("route", ["weighted_argmin", "pod_route"])
def test_cuda_routing_chain_equals_plain_chain(dev, route):
    """50 snapshot routing ticks, route -> queue_update with Q and W fed
    forward, on the card (no synchronisation between ticks) and on the
    plain versions: equal to the bit after every tick."""
    M, B, C = 500, 256, 11
    rng = np.random.default_rng(11)
    inv = torch.from_numpy(_case(11, M, B, C)["inv"])
    state = {"cpu": (torch.zeros((M, 3), dtype=torch.int32), torch.zeros(M)),
             "cuda": (torch.zeros((M, 3), dtype=torch.int32, device=dev),
                      torch.zeros(M, device=dev))}
    history = {"cpu": [], "cuda": []}
    for _ in range(50):
        valid = torch.from_numpy(np.arange(B) < rng.integers(B // 2, B + 1))
        cls = torch.from_numpy(rng.integers(0, 3, (B, M)).astype(np.int32))
        ci = torch.from_numpy(rng.integers(0, M, (B, C)).astype(np.int32))
        cc = torch.from_numpy(rng.integers(0, 3, (B, C)).astype(np.int32))
        cv = torch.from_numpy(rng.random((B, C)) < 0.9)
        for where, d in (("cpu", "cpu"), ("cuda", dev)):
            Q, W = state[where]
            if route == "weighted_argmin":
                sel, _ = tk.weighted_argmin(W, cls.to(d), inv.to(d))
                sel_cls = cls.to(d).gather(1, sel.long()[:, None])[:, 0]
            else:
                sel, _ = tk.pod_route(W, ci.to(d), cc.to(d), cv.to(d), inv.to(d))
                first = (ci.to(d) == sel[:, None]).to(torch.int32).argmax(dim=1)
                sel_cls = cc.to(d).gather(1, first[:, None])[:, 0]
            state[where] = tk.queue_update(Q, sel, sel_cls, valid.to(d), inv.to(d))
            history[where].append(state[where])
    torch.cuda.synchronize()
    for tick, (a, b) in enumerate(zip(history["cpu"], history["cuda"])):
        assert torch.equal(a[0], b[0].cpu()) and torch.equal(a[1], b[1].cpu()), tick


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("algo,s_max", [
    ("balanced_pandas", 64), ("balanced_pandas_pod", 64), ("jsq_maxweight", 64),
    ("jsq_maxweight_pod", 64), ("jsq_maxweight_pod", 8), ("jsq_priority", 64),
    ("fcfs", 64)])
def test_simulate_cuda_path_equals_cpu_path_on_shared_draws(dev, algo, s_max, mode):
    """Fed the same draws (made on the CPU), the CUDA path and the CPU path
    give bit-identical results in both route modes; in batched mode the BP
    and SQ families launch route_commit once a slot (the CPU path runs its
    plain version), FCFS never, and sequential mode never launches it.
    s_max=8 runs the S < M scheduling branch."""
    cl, rates = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
    cfg = SimConfig(T=500, warmup=100, s_max=s_max, route_mode=mode)
    pod = _pod_for(algo, None)
    a_max = cfg.resolve_a_max(0.9 * rates.alpha * cl.M)
    lam_t = torch.full((cfg.T,), 0.9 * rates.alpha * cl.M)
    out = []
    for run_dev in ("cpu", dev):
        src = TorchDraws(torch.Generator().manual_seed(3), cl, rates, cfg, pod,
                         a_max, lam_t, _family(algo))

        def draw(t, src=src, run_dev=run_dev):
            d = src(t)
            return type(d)(*(None if x is None else x.to(run_dev) for x in d))
        tk.reset_launch_counts()
        out.append(simulate(algo, cl, rates, 0.9, 0, cfg, a_max=a_max,
                            device=run_dev, draws=draw))
    launches = 0 if algo == "fcfs" or mode == "sequential" else cfg.T
    assert sum(tk.LAUNCHES.values()) == launches
    for name, a, b in zip(out[0]._fields, *out):
        assert torch.equal(a, b.cpu()) or (a.isnan().all() and b.isnan().all()), name


SCENARIO_CASES = [("balanced_pandas", "batched", "rack_outage"),
                  ("balanced_pandas", "sequential", "slow_rack"),
                  ("balanced_pandas_pod", "batched", "slow_rack+sized"),
                  ("balanced_pandas_pod", "batched", "zipf_hotspot"),
                  ("jsq_maxweight_pod", "batched", "rack_outage"),
                  ("jsq_priority", "batched", "network_degraded"),
                  ("fcfs", "batched", "rack_outage")]


def _scenario(name):
    from repro_torch.scenarios import Scenario, SizeSpec, compose
    if name == "slow_rack+sized":
        return compose("slow_rack", Scenario("sized", sizes=SizeSpec(sigma=0.8)))
    return name


@pytest.mark.parametrize("algo,mode,scenario", SCENARIO_CASES,
                         ids=[f"{a}-{m}-{s}" for a, m, s in SCENARIO_CASES])
def test_simulate_cuda_path_equals_cpu_path_on_a_heterogeneous_scenario(
        dev, algo, mode, scenario):
    """A heterogeneous scenario for each family, fed the same draws (made
    on the CPU under the scenario's placement and size laws): the CUDA path
    equals the CPU path bit for bit; batched BP launches route_commit once
    a slot at the [M, 3] operand on a heterogeneous fleet and at the [3]
    operand on zipf_hotspot; batched JSQ routing keeps the [3] operand."""
    from repro_torch.scenarios import realize

    cl, rates = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
    cfg = SimConfig(T=400, warmup=100, route_mode=mode)
    spec = _scenario(scenario)
    scen, lam_cap = realize(spec, cl, rates, cfg.T, device="cpu")
    pod = _pod_for(algo, None)
    a_max = cfg.resolve_a_max(0.9 * lam_cap, float(scen.lam_shape.max()))
    lam_t = torch.tensor(0.9 * lam_cap, dtype=torch.float32) * scen.lam_shape
    out = []
    for run_dev in ("cpu", dev):
        src = TorchDraws(torch.Generator().manual_seed(5), cl, rates, cfg, pod,
                         a_max, lam_t, _family(algo), scen)

        def draw(t, src=src, run_dev=run_dev):
            d = src(t)
            return type(d)(*(None if x is None else x.to(run_dev) for x in d))
        tk.reset_launch_counts()
        out.append(simulate(algo, cl, rates, 0.9, 0, cfg, scenario=spec, a_max=a_max,
                            device=run_dev, draws=draw))
    launches = 0 if algo == "fcfs" or mode == "sequential" else cfg.T
    matrix = launches if algo.startswith("balanced_pandas") and \
        scenario != "zipf_hotspot" else 0
    assert sum(tk.LAUNCHES.values()) == launches
    assert sum(tk.MATRIX_LAUNCHES.values()) == matrix
    for name, a, b in zip(out[0]._fields, *out):
        assert torch.equal(a, b.cpu()) or (a.isnan().all() and b.isnan().all()), name


def test_scenario_arithmetic_on_the_card_equals_the_cpu(dev):
    """speed_at at every slot of every registry scenario, the inverse-rate
    matrix, the size multiplier's exp and the Zipf draw's inversion: the
    card computes the CPU's values to the bit."""
    from repro_torch.core.cluster import safe_inv_rates
    from repro_torch.core.simulator import _exp_f32, _fma32
    from repro_torch.scenarios import realize, scenario_names, speed_at
    from repro_torch.scenarios.build import placement_cdf

    cl, rates = Cluster(M=40, K=4), Rates(0.1, 0.05, 0.02)
    r = rates.as_array()
    for name in scenario_names():
        cpu, _ = realize(name, cl, rates, 200, device="cpu")
        gpu, _ = realize(name, cl, rates, 200, device=dev)
        for t in range(200):
            a, b = speed_at(cpu, t), speed_at(gpu, t)
            assert torch.equal(a, b.cpu()), (name, t)
            assert torch.equal(safe_inv_rates(a * r[None, :]),
                               safe_inv_rates(b * r.to(dev)[None, :]).cpu()), (name, t)
        if cpu.chunk_locals is not None:
            assert torch.equal(placement_cdf(cpu), placement_cdf(gpu).cpu()), name
    z = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0)) * 0.7
    for sigma in (0.3, 0.8, 2.0):
        s = torch.tensor(sigma, dtype=torch.float32)
        mu = torch.tensor(-0.5 * sigma * sigma, dtype=torch.float32)
        a = _exp_f32(_fma32(z, s, mu))
        b = _exp_f32(_fma32(z.to(dev), s.to(dev), mu.to(dev)))
        assert torch.equal(a, b.cpu()), sigma


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod",
                                  "jsq_maxweight_pod", "fcfs"])
def test_grid_cells_equal_looped_runs_on_the_card(dev, algo):
    """On the card, with the card's generators: every cell of a
    simulate_grid (2 seeds x 2 loads) and of a simulate_sweep (uniform and
    rack_outage) equals the looped run of that cell to the bit, and a grid
    launches route_commit once a slot for all its cells (never for FCFS)."""
    from repro_torch.core import simulate_grid, simulate_sweep, sweep_grid
    from repro_torch.scenarios import canonical_pad, realize

    cl, rates = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
    cfg = SimConfig(T=300, warmup=75, s_max=16, route_mode="batched")
    loads = (0.45, 0.85)
    same = lambda a, b: all(torch.equal(x.cpu(), y.cpu()) or
                            (x.isnan().all() and y.isnan().all()) for x, y in zip(a, b))
    cell = lambda r, i: type(r)(*(x[i] if x.ndim >= len(i) else x for x in r))
    tk.reset_launch_counts()
    grid = simulate_grid(algo, cl, rates, loads, 2, cfg, seed0=7, device=dev)
    assert sum(tk.LAUNCHES.values()) == (0 if algo == "fcfs" else cfg.T)
    scen, cap = realize(None, cl, rates, cfg.T, device="cpu")
    a_max = cfg.resolve_a_max(float(np.float32(max(loads) * cap)))
    for k in range(2):
        for l, load in enumerate(loads):
            one = simulate(algo, cl, rates, load, 7 + k, cfg, a_max=a_max, device=dev)
            assert same(cell(grid, (k, l)), one), (k, load)
    names, pad = ["uniform", "rack_outage"], canonical_pad(cl)
    a_max = sweep_grid(cl, rates, cfg, loads, names, pad, device=dev)[3]
    _, res, _ = simulate_sweep(algo, cl, rates, loads, 2, cfg, seed0=7, scenarios=names,
                               pad=pad, device=dev)
    for s, name in enumerate(names):
        looped = simulate_grid(algo, cl, rates, loads, 2, cfg, seed0=7, scenario=name,
                               pad=pad, a_max=a_max, device=dev)
        assert same(cell(res, (s,)), looped), name


# ---------------------------------------------------------------------------
# Telemetry and trace replay on the card
# ---------------------------------------------------------------------------


TELEMETRY_FLOAT = ("w_mean", "probe_regret")      # float reductions over M / a batch


def assert_telemetry_close(a, b, label):
    """The card's Telemetry against the CPU's: every leaf exact but the two
    float reductions whose order the card chooses (w_mean, probe_regret:
    1e-6 relative); histogram bins exact (the card's bucketize)."""
    from repro_torch.telemetry import WINDOW_SUMS, Telemetry

    for name, x, y in zip(Telemetry._fields, a, b):
        assert (x is None) == (y is None), (label, name)
        if x is None:
            continue
        x, y = x.cpu(), y.cpu()
        if name == "win":
            for c, ch in enumerate(WINDOW_SUMS):
                if ch in TELEMETRY_FLOAT:
                    assert torch.allclose(x[..., c], y[..., c], rtol=1e-6, atol=0), (label, ch)
                else:
                    assert torch.equal(x[..., c], y[..., c]), (label, ch)
        else:
            assert torch.equal(x, y), (label, name)


@pytest.mark.parametrize("scenario", ["uniform", "slow_rack"])
@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod",
                                  "balanced_pandas_randomtie", "jsq_maxweight",
                                  "jsq_maxweight_pod", "jsq_priority", "fcfs"])
def test_telemetry_cuda_path_equals_cpu_path_on_shared_draws(dev, algo, mode, scenario):
    """simulate_with_telemetry on the card against the CPU path, fed the
    same draws: the SimResult bit for bit, the Telemetry as
    ``assert_telemetry_close`` says; batched BP and SQ launch route_commit
    once a slot."""
    from repro_torch.core import simulate_with_telemetry
    from repro_torch.scenarios import realize
    from repro_torch.telemetry import TelemetryConfig

    cl, rates = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
    cfg = SimConfig(T=400, warmup=100, route_mode=mode)
    scen, lam_cap = realize(scenario, cl, rates, cfg.T, device="cpu")
    load = 0.15 if algo == "fcfs" else 0.9
    pod = _pod_for(algo, None)
    a_max = cfg.resolve_a_max(load * lam_cap)
    lam_t = torch.tensor(load * lam_cap, dtype=torch.float32) * scen.lam_shape
    tcfg = TelemetryConfig(n_windows=16)
    out = []
    for run_dev in ("cpu", dev):
        src = TorchDraws(torch.Generator().manual_seed(9), cl, rates, cfg, pod,
                         a_max, lam_t, _family(algo), scen)

        def draw(t, src=src, run_dev=run_dev):
            d = src(t)
            return type(d)(*(None if x is None else x.to(run_dev) for x in d))
        tk.reset_launch_counts()
        out.append(simulate_with_telemetry(algo, cl, rates, load, 0, cfg,
                                           scenario=scenario, a_max=a_max,
                                           telemetry=tcfg, device=run_dev, draws=draw))
    launches = 0 if algo == "fcfs" or mode == "sequential" else cfg.T
    assert sum(tk.LAUNCHES.values()) == launches
    (r_cpu, t_cpu), (r_gpu, t_gpu) = out
    for name, a, b in zip(r_cpu._fields, r_cpu, r_gpu):
        assert torch.equal(a, b.cpu()) or (a.isnan().all() and b.isnan().all()), name
    assert_telemetry_close(t_cpu, t_gpu, (algo, mode, scenario))


@pytest.mark.parametrize("scenario", ["uniform", "slow_rack", "network_degraded"])
def test_full_bp_probe_rank_is_zero_on_the_card(dev, scenario):
    """Full Balanced-Pandas is the O(M) oracle: on the card every batched
    decision ranks 0 against the workloads the kernel scored it with, on a
    heterogeneous fleet too (non-integer inverse rates)."""
    from repro_torch.core import simulate_with_telemetry
    from repro_torch.telemetry import probe_summary

    cl, rates = Cluster(M=100, K=10), Rates(0.01, 0.005, 0.002)
    cfg = SimConfig(T=1500, warmup=300, route_mode="batched")
    _, tele = simulate_with_telemetry("balanced_pandas", cl, rates, 0.9, 3, cfg,
                                      scenario=scenario, device=dev)
    s = probe_summary(tele)
    assert s["decisions"] > 1000
    assert s["mean_rank"] == 0.0 and s["mean_regret"] == 0.0


def _replay_engines(dev, algo, T, chunk, n_tasks):
    from repro_torch.telemetry import TelemetryConfig
    from repro_torch.trace import ReplayEngine, production_day

    cl, rates = Cluster(M=24, K=4), Rates(0.05, 0.025, 0.01)
    kw = dict(cfg=SimConfig(T=T, warmup=T // 5), algo=algo, chunk_slots=chunk,
              telemetry=TelemetryConfig(n_windows=16))
    log = production_day(n_tasks=n_tasks, seed=5)
    return (ReplayEngine(log, cl, rates, device="cpu", **kw),
            ReplayEngine(log, cl, rates, device=dev, **kw))


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod"])
def test_replay_cuda_equals_cpu_given_the_same_draws(dev, algo):
    """Five chunks (odd, so both device buffers are reused across the
    pipeline's turns): the card's replay, its chunks copied on the side
    stream into two buffers, equals the CPU's replay fed the same draws (made
    on the CPU) bit for bit, telemetry included; route_commit launched once
    a padded slot."""
    from repro_torch.trace.replay import TorchReplayDraws

    cpu, gpu = _replay_engines(dev, algo, T=5 * 64 - 7, chunk=64, n_tasks=900)
    assert gpu.n_chunks == 5
    results = []
    for eng in (cpu, gpu):
        src = TorchReplayDraws(torch.Generator().manual_seed(2), eng.cluster, eng.rates,
                               eng.cfg, eng.pod, float(eng.scen.size_sigma) > 0, "cpu")

        def draws(c, locals_c, cls_c, src=src, d=eng.device):
            x = src(c, locals_c.cpu(), cls_c.cpu())
            return type(x)(*(None if v is None else v.to(d) for v in x))
        tk.reset_launch_counts()
        results.append(eng.run(draws=draws))
    assert sum(tk.LAUNCHES.values()) == gpu.n_chunks * gpu.chunk_slots
    a, b = results
    assert a.routed_tasks == b.routed_tasks == 900
    for name, x, y in zip(a.result._fields, a.result, b.result):
        assert torch.equal(x, y.cpu()) or (x.isnan().all() and y.isnan().all()), name
    for name, x, y in zip(a.sums._fields, a.sums, b.sums):
        assert torch.equal(x, y.cpu()), name
    assert_telemetry_close(a.telemetry, b.telemetry, algo)


def test_replay_agrees_with_simulator_on_production_day(dev):
    """The reference's acceptance check (tests/test_trace.py), on the card:
    replay's mean delay, averaged over 8 seeds, within 5% of the
    simulator's 16-seed grid on the same lowered scenario, at the frozen
    configuration (M=24, T=30 000, production_day(12 960) == load 0.45)."""
    from repro_torch.core import simulate_grid
    from repro_torch.trace import ReplayEngine, production_day, scenario_from_trace

    cluster, rates = Cluster(M=24, K=4), Rates()
    cfg = SimConfig(T=30_000, warmup=6_000)
    log = production_day(n_tasks=12_960)
    eng = ReplayEngine(log, cluster, rates, cfg=cfg, chunks_per_server=12, device=dev)
    assert eng.load == pytest.approx(0.45, abs=1e-6)
    replay = np.mean([float(eng.run(seed=s).result.mean_completion_norm)
                      for s in range(8)])
    scn = scenario_from_trace(log, chunks_per_server=12, seed=0)
    grid = simulate_grid("balanced_pandas_pod", cluster, rates, [eng.load], n_seeds=16,
                         cfg=cfg, scenario=scn, device=dev)
    sim = float(grid.mean_completion_norm[:, 0].mean())
    rel = abs(replay - sim) / sim
    assert rel < 0.05, f"replay {replay:.4f} vs sim {sim:.4f}: rel {rel:.4f}"


def test_telemetry_grid_cells_equal_looped_runs_on_the_card(dev):
    """A BP-Pod grid with telemetry (2 seeds x 2 loads) on the card: each
    cell's Telemetry equals its looped run's to the bit."""
    from repro_torch.core import simulate_grid_with_telemetry, simulate_with_telemetry
    from repro_torch.scenarios import realize
    from repro_torch.telemetry import Telemetry, TelemetryConfig

    cl, rates = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
    cfg = SimConfig(T=300, warmup=75, route_mode="batched")
    loads, tcfg = (0.45, 0.85), TelemetryConfig(n_windows=8)
    _, tele = simulate_grid_with_telemetry("balanced_pandas_pod", cl, rates, loads, 2,
                                           cfg, seed0=7, telemetry=tcfg, device=dev)
    scen, cap = realize(None, cl, rates, cfg.T, device="cpu")
    a_max = cfg.resolve_a_max(float(np.float32(max(loads) * cap)))
    for k in range(2):
        for l, load in enumerate(loads):
            _, one = simulate_with_telemetry("balanced_pandas_pod", cl, rates, load,
                                             7 + k, cfg, a_max=a_max, telemetry=tcfg,
                                             device=dev)
            cell = Telemetry(*(None if x is None else x[k, l] for x in tele))
            for name, x, y in zip(Telemetry._fields, cell, one):
                assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), \
                    (k, l, name)


# -- the serving path: PodRouter and ServeEngine on the card -----------------


def _router_pair(dev, policy, M, K, rate_matrix=None, seed=0):
    from repro_torch.core import PodSpec
    from repro_torch.sched import (FleetTopology, PodRouter, SharedDraws, TorchRouterDraws,
                                   service_rates)

    fleet = FleetTopology(n_replicas=M, n_pods=K)
    shared = SharedDraws(TorchRouterDraws(seed, dev, PodSpec(2, 6)))
    card = PodRouter(fleet, service_rates(), policy=policy, rate_matrix=rate_matrix,
                     device=dev, draws=shared)
    cpu = PodRouter(fleet, service_rates(), policy=policy, rate_matrix=rate_matrix,
                    device="cpu", draws=shared.echo("cpu"))
    return card, cpu


@pytest.mark.parametrize("policy", ["pod", "full"])
@pytest.mark.parametrize("operand", ["[3]", "[M,3]"])
def test_router_on_the_card_equals_the_cpu_router(dev, policy, operand):
    """M=500 in 10 pods, 40 batches of 64 requests, each batch retiring
    the one routed two before: after every batch the card's sel, sel_cls,
    Q and W equal the CPU router's (the plain route_commit) to the bit, one
    route_commit launch a batch (at the [M, 3] operand when heterogeneous),
    and the probes are 11 a decision (pod) or M (full)."""
    from repro_torch.core import Cluster, sample_locals

    M, K, B, n = 500, 10, 64, 40
    rm = None
    if operand == "[M,3]":
        rm = np.tile(np.array([0.9, 0.45, 0.18], np.float32), (M, 1))
        rm[:50] = 0.0                     # pod 0 drained
        rm[50:100] *= 0.25                # pod 1 slow
    card, cpu = _router_pair(dev, policy, M, K, rm)
    gen = torch.Generator().manual_seed(1)
    routed = []
    tk.reset_launch_counts()
    for i in range(n):
        homes = sample_locals(gen, Cluster(M, K), B).numpy()
        sel = card.route(homes)
        assert np.array_equal(cpu.route(homes), sel)
        assert np.array_equal(cpu.last_classes, card.last_classes)
        routed.append((sel, card.last_classes))
        if i >= 2:
            for r in (card, cpu):
                r.complete(*routed[i - 2])
        assert torch.equal(card.Q.cpu(), cpu.Q) and torch.equal(card.W.cpu(), cpu.W)
    name = f"route_commit_{policy}"
    assert tk.LAUNCHES[name] == n and sum(tk.LAUNCHES.values()) == n
    assert tk.MATRIX_LAUNCHES[name] == (n if rm is not None else 0)
    assert card.stats.probes == n * B * (11 if policy == "pod" else M)
    assert np.array_equal(card.stats.routed_by_class, cpu.stats.routed_by_class)
    if rm is not None:
        assert int(card.Q[:50].sum()) == 0


def test_engine_on_the_card_equals_the_cpu_engine(dev):
    """The float32 smoke llama3-8b serving 12 requests on 8 replicas in 2
    pods (max_new=4): the card's engine and the CPU engine, on the same
    weights and router draws, give every request the same replica, class,
    ticks and tokens, and the same stats."""
    from repro_torch.configs import get
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sched import FleetTopology

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("llama3_8b", smoke=True).replace(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    to_card = lambda t: {k: to_card(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.to(dev)
    on_card = to_card(params)
    card_router, cpu_router = _router_pair(dev, "pod", 8, 2)
    rng = np.random.default_rng(0)
    homes = {i: rng.choice(8, size=3, replace=False) for i in range(4)}
    prompts = [rng.integers(0, cfg.vocab, size=3) for _ in range(12)]
    engines = {}
    for name, p, router in (("card", on_card, card_router), ("cpu", params, cpu_router)):
        eng = ServeEngine(cfg, p, FleetTopology(8, 2), router, homes, max_batch=4)
        engines[name] = eng
    for name in ("card", "cpu"):      # card first: the CPU router echoes its draws
        engines[name].submit([Request(rid=i, prefix_id=i % 4, prompt=prompts[i],
                                      max_new=4, arrival=0) for i in range(12)])
    stats = {name: eng.run(until_done=12, max_ticks=500) for name, eng in engines.items()}
    key = lambda r: (r.rid, r.replica, r.cls, r.start_tick, r.done_tick, r.generated)
    assert [key(r) for r in engines["card"].done] == [key(r) for r in engines["cpu"].done]
    assert len(engines["card"].done) == 12
    a, b = stats["card"], stats["cpu"]
    assert a.completions == b.completions and a.probes_per_decision == 11
    for f in ("locality", "queue_depth_trace", "batch_size_trace", "latency_hist"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert (a.latency_p50, a.latency_p95) == (b.latency_p50, b.latency_p95)


@pytest.mark.parametrize("kw", [dict(), dict(microbatches=4),
                                dict(microbatches=2, grad_compress=True)],
                         ids=["mb1", "mb4", "mb2-ef"])
def test_train_step_on_the_card_equals_the_cpu(dev, kw):
    """The float32 smoke llama3-8b, one train_step from the same state on
    the card and on the CPU (TF32 off): loss and grad norm within 1e-4
    relative, every gradient leaf (read from the first moment, m = (1 -
    b1) * clip * g) within 1e-4 of its largest magnitude; with int8 error
    feedback within one code (1/127) of it."""
    from repro_torch import pytree
    from repro_torch.configs import get
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("llama3_8b", smoke=True).replace(dtype="float32")
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)
    host = init_train_state(cfg, ocfg, 0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(dev), host)
    b = SyntheticLM(PipelineConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)).next_batch()
    card, m_card = train_step(card, b, cfg=cfg, opt_cfg=ocfg, **kw)
    host, m_cpu = train_step(host, b, cfg=cfg, opt_cfg=ocfg, **kw)
    assert pytree.leaves(card.params)[0].device.type == "cuda"
    for k in ("loss", "grad_norm"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= 1e-4 * abs(float(m_cpu[k])), k
    tol = 1 / 127 if kw.get("grad_compress") else 1e-4
    for a, h in zip(pytree.leaves(card.opt.m), pytree.leaves(host.opt.m)):
        assert float((a.cpu() - h).abs().max()) <= tol * float(h.abs().max())


def test_trainer_resume_on_the_card_is_bitwise(dev, tmp_path):
    """scripts/train_resume_check.py in a fresh process (deterministic
    algorithms, CUBLAS_WORKSPACE_CONFIG set before cuBLAS starts): the
    smoke-config Trainer crashed at step 13 and resumed from step 12 gives
    the 20 straight steps' losses bit for bit, and its last checkpoint
    restores byte for byte."""
    import json
    import os
    import subprocess
    import sys

    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, str(root / "scripts" / "train_resume_check.py"),
                        str(tmp_path)], capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["resume"]["device"].startswith("cuda") and res["resume"]["resumed_losses_equal"]
    assert res["resume"]["leaves_byte_equal"] == res["resume"]["leaves"] == 37


FAMILY_ARCHS = ["deepseek_moe_16b", "kimi_k2_1t_a32b", "internvl2_2b", "whisper_large_v3",
                "zamba2_2_7b", "rwkv6_7b"]


def _family_batch(cfg, B: int, S: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, dtype=torch.int32)}
    if cfg.family == "vlm":
        b["img_embeds"] = torch.randn((B, cfg.n_img_tokens, cfg.d_model), generator=gen) * 0.5
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.randn((B, S, cfg.d_model), generator=gen) * 0.5
    return b


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_decode_on_the_card_equal_the_cpu(dev, arch):
    """Each family's float32 smoke config from the same parameters on the
    card and on the CPU (TF32 off): forward (and the MoE aux losses) and
    four decode steps from the same populated cache within 1e-4 of the
    largest magnitude; every cache field too."""
    from repro_torch import pytree
    from repro_torch.configs import get
    from repro_torch.models import decode_step, forward, init_cache, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(arch, smoke=True).replace(dtype="float32")
    host = init_params(cfg, 3, device="cpu")
    card = pytree.tree_map(lambda t: t.to(dev), host)
    b = _family_batch(cfg, 2, 32, seed=1)
    with torch.no_grad():
        hc, ac = forward(card, cfg, {k: v.to(dev) for k, v in b.items()})
        hh, ah = forward(host, cfg, b)
        assert float((hc.cpu() - hh).abs().max()) <= 1e-4 * float(hh.abs().max())
        for k in ah:
            assert abs(float(ac[k]) - float(ah[k])) <= 1e-4 * max(abs(float(ah[k])), 1e-30)
        gen = torch.Generator().manual_seed(2)
        ch = init_cache(cfg, 2, 24, device="cpu")
        ch = ch._replace(**{n: torch.randn(t.shape, generator=gen).to(t.dtype)
                            for n, t in zip(ch._fields, ch) if t.numel()})
        cc = type(ch)(*(t.to(dev) for t in ch))
        tok, pos = b["tokens"][:, -1:], torch.tensor([3, 17], dtype=torch.int32)
        for _ in range(4):
            hc, cc = decode_step(card, cfg, cc, tok.to(dev), pos.to(dev))
            hh, ch = decode_step(host, cfg, ch, tok, pos)
            assert float((hc.cpu() - hh).abs().max()) <= 1e-4 * float(hh.abs().max())
            for a, h in zip(cc, ch):
                if h.numel():
                    assert float((a.cpu() - h).abs().max()) <= 1e-4 * float(h.abs().max())
            tok, pos = (tok * 7 + 3) % cfg.vocab, pos + 1


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_2_7b", "deepseek_moe_16b"])
def test_prefill_equals_decode_on_the_card(dev, arch):
    """The reference's property (tests/test_models.py:64-86) on the card:
    a float32 forward over 16 tokens equals 16 decode steps from an empty
    cache within 1e-4 (MoE capacity factor 16: no drop)."""
    from repro_torch.configs import get
    from repro_torch.models import decode_step, forward, init_cache, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(arch, smoke=True).replace(remat=False, dtype="float32", capacity_factor=16.0)
    params = init_params(cfg, 2, device=dev)
    tokens = _family_batch(cfg, 2, 16, seed=3)["tokens"].to(dev)
    with torch.no_grad():
        h_fwd, _ = forward(params, cfg, {"tokens": tokens})
        cache = init_cache(cfg, 2, 16, device=dev)
        hs = []
        for t in range(16):
            h, cache = decode_step(params, cfg, cache, tokens[:, t:t + 1],
                                   torch.full((2,), t, dtype=torch.int32, device=dev))
            hs.append(h[:, 0])
    assert float((torch.stack(hs, 1) - h_fwd).abs().max()) < 1e-4 * float(h_fwd.abs().max())


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "zamba2_2_7b", "rwkv6_7b"])
def test_family_train_step_on_the_card_equals_the_cpu(dev, arch):
    """One float32 train_step of the moe, hybrid and ssm smoke configs from
    the same state on the card and on the CPU: loss, grad norm and the aux
    losses within 1e-4 relative, every gradient leaf (the first moment)
    within 1e-4 of its largest magnitude."""
    from repro_torch import pytree
    from repro_torch.configs import get
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(arch, smoke=True).replace(dtype="float32")
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)
    host = init_train_state(cfg, ocfg, 0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(dev), host)
    b = SyntheticLM(PipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)).next_batch()
    card, m_card = train_step(card, b, cfg=cfg, opt_cfg=ocfg)
    host, m_cpu = train_step(host, b, cfg=cfg, opt_cfg=ocfg)
    for k in ("loss", "grad_norm", "lb_loss", "z_loss"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= 1e-4 * abs(float(m_cpu[k])), k
    for a, h in zip(pytree.leaves(card.opt.m), pytree.leaves(host.opt.m)):
        assert float((a.cpu() - h).abs().max()) <= 1e-4 * float(h.abs().max())


def test_moe_dispatch_on_the_card_equals_the_cpu(dev):
    """Experts far over capacity (capacity factor 1.25, a skewed router):
    the card's dispatch table equals the CPU's to the index (the pad row
    in every overflowing expert's last slot), and the layer's output and
    aux losses agree within 1e-5."""
    from repro_torch.configs import get
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("deepseek_moe_16b", smoke=True).replace(dtype="float32")
    p = moe.moe_params(torch.Generator().manual_seed(5), cfg)
    p["router"][:, 0] += 0.2
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(6)) + 0.3
    pc = {k: (v.to(dev) if torch.is_tensor(v) else {n: t.to(dev) for n, t in v.items()})
          for k, v in p.items()}
    oc, ac = moe.moe_apply(pc, cfg, x.to(dev), 2)
    oh, ah = moe.moe_apply(p, cfg, x, 2)
    assert float((oc.cpu() - oh).abs().max()) <= 1e-5 * float(oh.abs().max())
    for k in ah:
        assert abs(float(ac[k]) - float(ah[k])) <= 1e-5 * abs(float(ah[k]))
    rng = np.random.default_rng(0)
    E, C, Tl = 6, 4, 24
    se = np.sort(rng.choice(E, size=(2, Tl * 2), p=[0.5, 0.2, 0.1, 0.1, 0.05, 0.05]), axis=-1)
    st = rng.integers(0, Tl, se.shape)
    args = [torch.from_numpy(a) for a in (se, st)]
    want = moe._dispatch_table(*args, E, C, Tl)
    got = moe._dispatch_table(*(a.to(dev) for a in args), E, C, Tl)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert (want[3] > C).any()
