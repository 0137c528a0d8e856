"""Run a function on N CPU ranks of a gloo process group, for the port's
multi-rank tests.

``run_ranks(case, n, tmp_path, timeout=..., **kw)`` starts N processes
(spawned, so each imports torch afresh), joins them into one gloo group
through a ``FileStore`` under ``tmp_path`` (no ports, so pytest-xdist
workers cannot collide), calls ``_torch_dist_cases.<case>(rank, n, tmp,
**kw)`` on each, and returns the ranks' results in rank order.  Past
``timeout`` seconds every rank is killed and the call fails, so a hang
fails fast.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback


def _worker(case: str, rank: int, n: int, tmp: str, kw: dict) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    import torch.distributed as dist

    import _torch_dist_cases as cases

    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), n),
                                rank=rank, world_size=n)
        res = ("ok", getattr(cases, case)(rank, n, tmp, **kw))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        res = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(res, f)


def run_ranks(case: str, n: int, tmp_path, *, timeout: float = 120, **kw) -> list:
    tmp = str(tmp_path / f"ranks_{case}_{time.monotonic_ns()}")
    os.makedirs(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(case, r, n, tmp, kw)) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(n):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise AssertionError(f"rank {r} of {case} left no result (hung ranks {hung}, "
                                 f"exit codes {[p.exitcode for p in procs]})")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise AssertionError(f"rank {r} of {case} failed:\n{value}")
        results.append(value)
    if hung:
        raise AssertionError(f"{case}: ranks {hung} still running after {timeout} s")
    return results
