"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py            # the full check (one card)
    python3 chip_smoke.py --quick    # a short first run: build, kernels,
                                     # T/20 (at least 5 000 slots)
    python3 chip_smoke.py --profile  # only timings: the slot profile
                                     # (BP, BP-Pod, JSQ-MaxWeight-Pod, on
                                     # uniform and on rack_outage; BP-Pod
                                     # grids of 1, 32 and 132 cells; BP-Pod
                                     # with telemetry at 1 and 32 cells
                                     # beside without; the replay's slot),
                                     # route_commit at every valid-prefix
                                     # length, the snapshot kernels, the
                                     # complexity table and the tick's
                                     # route -> queue_update sequence
                                     # (with the launch floor)

Phases (any failure exits non-zero; the result lines print only at the end):
  1. device and build: the card's name, count and power limit; nvcc builds
     every source under src/repro_torch/kernels/csrc/ and the launch-floor
     kernel (scripts/launch_floor.cu), all at once, and prints each
     kernel's registers and shared memory (-Xptxas -v).
  2. kernels against their plain PyTorch versions on the card, at the
     shapes their paths use (and route_commit at the largest M its wrapper
     accepts), with homogeneous, heterogeneous (dead-entry) and all-dead
     rates and tie-forcing inputs (class-3 entries, duplicate candidates,
     rows without a finite score, dropped commits, bfloat16 W, every
     pattern of route_commit's valid mask); outputs must be equal to the
     bit.  Each is timed with CUDA events beside its bound and its plain
     version's time; route_commit also per sequential step, at two valid
     prefixes; the snapshot kernels (up to M=16000) each behind a plain
     PyTorch kernel, as on the routing tick, beside the launch floor: a
     kernel that only waits and stores, timed the same way, launched
     plainly and as a dependent launch.
     route_commit's pod variant also at batched JSQ routing's operand
     (C=3 replica triples, class 0, all valid, unit rates, slot-order ties),
     and both variants are timed at the [M, 3] operand that BP hands them on
     a heterogeneous fleet (a drained rack at +inf, a slow rack, a degraded
     remote tier) beside the [3] operand of the uniform scenario.  Both
     variants also with a leading cell axis (one CTA a cell) at 1, 3, 132
     and 133 cells, with shared and per-cell rates, and timed at 1, 32, 132
     and 264 cells (``by_cells`` in the kernels line).
  3. the simulator on the card: the port's own CPU path and its CUDA path,
     fed the same draws, must give bit-identical sums at a small size, for
     every family (and JSQ-MaxWeight-Pod with s_max < M), on `uniform` and
     on compose("slow_rack", "network_degraded"); then Balanced-Pandas and
     BP-Pod at paper scale (M=500) and at M=5000, JSQ-MaxWeight-Pod
     likewise, JSQ-MaxWeight, JSQ-Priority and FCFS at M=500, all on
     `uniform`; then the heterogeneous scenarios at M=500 (slow_rack,
     rack_outage, network_degraded, mmpp_bursty) and the placement axis at
     M=100 (zipf_hotspot, hetero_storm).  The launch counters are zeroed
     just before each run and read just after: route_commit must launch
     once per slot (FCFS: never), at the [M, 3] operand exactly when BP
     runs on a heterogeneous fleet.  Then the grid entry points: the corner
     cells of simulate_grid (every algorithm) and of simulate_sweep (BP,
     BP-Pod) equal looped simulate runs to the bit, and full-width grids
     (32 cells of loads x seeds; sweeps of 132 and 24 cells) launch
     route_commit once a slot for all their cells.
  4. complexity (paper §IV-C), on the port's public functions: probes per
     decision; microseconds per routing decision of weighted_argmin (O(M))
     and pod_route (O(d)) as M grows; the device time of the tick's
     sequence route -> class gather -> slot < n -> queue_update at M=500
     and 5000; and 200 snapshot routing ticks
     (sample -> classes -> route -> queue_update) of BP and BP-Pod at M=500
     and M=5000, checking Q and W after every tick and one launch per call.
  5. telemetry (``simulate_with_telemetry``) at M=500: BP, BP-Pod,
     JSQ-MaxWeight-Pod and FCFS on `uniform`, BP-Pod on slow_rack, each
     bit-equal to its run without telemetry, route_commit launched T times,
     the windows' sums past warmup equal to the run's totals, full BP's probe
     rank 0, no dropped sojourn record, valid JSONL events; sojourn p50 /
     p95 / p99, probe rank and regret, slots/s with and without, peak
     memory; a 32-cell BP-Pod grid with telemetry, its corners equal to
     looped runs.  Phase 3's small-run check compares the telemetry too.
  6. trace: production_day in the registry and simulated at M=500;
     ReplayEngine (BP, BP-Pod) at M=500, T=10 000 on a production day at
     load ~0.45: route_commit once a padded slot, every task routed,
     throughput within 5% of arrivals, valid events; replay tasks/s beside
     the simulator's routed tasks/s on the same lowered scenario, and the
     size law's ``_exp_f32`` against a slot.
It prints the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 peak outside tensor cores
CSRC = "src/repro_torch/kernels/csrc/"
FLOOR_SOURCE = Path(__file__).resolve().parent / "scripts" / "launch_floor.cu"
FLOOR_GRIDS = ((1, 32), (132, 128))     # (blocks, threads): one warp; a block an SM
SOURCES = {"route_commit_full": CSRC + "route_commit.cu",
           "route_commit_pod": CSRC + "route_commit.cu",
           "weighted_argmin": CSRC + "snapshot_route.cu",
           "pod_route": CSRC + "snapshot_route.cu",
           "queue_update": CSRC + "snapshot_route.cu"}
REPLACES = {"route_commit_full": "src/repro/kernels/route_commit.py:93",
            "route_commit_pod": "src/repro/kernels/route_commit.py:176",
            "weighted_argmin": "src/repro/kernels/weighted_argmin.py:45",
            "pod_route": "src/repro/kernels/pod_route.py:45",
            "queue_update": "src/repro/kernels/queue_update.py:37"}
NO_LIBRARY = {
    "route_commit": "no single PyTorch call computes a sequential commit",
    "weighted_argmin": "no single PyTorch call masks, weights and takes a "
                       "first-index argmin per row",
    "pod_route": "no single PyTorch call gathers candidates, weights them "
                 "and takes a first-slot argmin",
    "queue_update": "no single PyTorch call scatters the commits and sums "
                    "the weighted rows"}
JSQ_SHAPES = ((500, 16, 2.5), (500, 22, 4.5), (5000, 90, 45.0))  # M, a_max, lambda
SNAPSHOT_SHAPES = [(500, 256, 11), (5000, 256, 11), (8192, 256, 11),
                   (16000, 256, 11)]


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 20) -> float:
    """Mean milliseconds of ``fn`` on the card, CUDA events around a run
    of ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int = 500, warmup: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``, the calls back to back
    in the stream.  A spin kernel holds the stream while the host enqueues
    the calls, so the host's issue time is not counted; the spin grows
    until the start event is still pending when the last call is queued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 10_000_000
    while cycles < 10**11:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail("the host could not enqueue the timed calls ahead of the card")


def device_time_behind_ms(fn, iters: int = 500) -> float:
    """Mean device milliseconds a call of ``fn`` adds behind a plain PyTorch
    kernel, as on the routing tick, where a PyTorch kernel runs just before
    each snapshot kernel: (kernel, fn) back to back less the kernel alone.
    Back to back with itself, a dependent launch of ``fn`` could overlap its
    own previous call; a PyTorch kernel never lets its dependents start early."""
    x = torch.zeros(1, device="cuda")
    step = lambda: x.add_(1)
    return device_time_ms(lambda: (step(), fn()), iters) - device_time_ms(step, iters)


def load_floor(path: Path):
    """launch(out, blocks, threads, dependent) of the launch-floor kernel."""
    fn = ctypes.CDLL(str(path)).launch_floor
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(out, blocks: int, threads: int, dependent: bool):
        err = fn(out.data_ptr(), blocks, threads, int(dependent),
                 ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream))
        if err != 0:
            fail(f"launch_floor failed: CUDA error {err}")
    return launch


def launch_floor_ms(floor, dev, iters: int = 500) -> dict:
    """{"plain"/"dependent": [ms at each grid of FLOOR_GRIDS]}: device time
    the launch-floor kernel adds behind a plain PyTorch kernel, timed as
    the snapshot kernels are."""
    out = torch.empty(max(b for b, _ in FLOOR_GRIDS), dtype=torch.int32, device=dev)
    return {mode: [device_time_behind_ms(
                lambda: floor(out, blocks, threads, mode == "dependent"), iters)
                   for blocks, threads in FLOOR_GRIDS]
            for mode in ("plain", "dependent")}


def floor_text(f: dict) -> str:
    return (f"dependent {' / '.join(f'{t:.6f}' for t in f['dependent'])} ms, "
            f"plain {' / '.join(f'{t:.6f}' for t in f['plain'])} ms")


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, "bytes" or "operations"): bytes over the memory
    rate against float32 operations over the peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


RATES = ("homo", "hetero", "dead", "fleet")
PAPER_RATES = (0.01, 0.005, 0.002)


def fleet_inv_rates(M: int, K: int = 10) -> np.ndarray:
    """The [M, 3] inverse rates BP hands route_commit on a heterogeneous
    fleet (the simulator's ``inv_rate_matrix``, paper rates): rack 0
    drained (+inf, as rack_outage in its window), rack 1 at half speed (as
    slow_rack), every server's remote tier at a quarter (as
    network_degraded's gamma)."""
    speed = np.ones((M, 3), np.float32)
    R = M // K
    speed[:R] = 0.0
    speed[R:2 * R] *= np.float32(0.5)
    speed[:, 2] *= np.float32(0.25)
    rate = speed * np.asarray(PAPER_RATES, np.float32)
    with np.errstate(divide="ignore"):
        return np.where(rate > 0, np.float32(1.0) / np.maximum(rate, np.float32(1e-12)),
                        np.float32(np.inf)).astype(np.float32)


def kernel_inputs(M: int, B: int, C: int, rates: str, seed: int, dev, valid=None,
                  class3: bool = False):
    """Tie-forcing inputs: few distinct queue lengths, and ``rates`` "homo"
    (the [3] lattice operand), "hetero" (pooled [M, 3] rates with dead
    servers and dead rate columns), "dead" (every rate dead) or "fleet"
    (``fleet_inv_rates``, the main path's [M, 3] operand).  ``valid``
    defaults to the 3B/4 prefix the timings have used since the first
    slice; ``class3`` draws the full variant's classes from 0..3 with an
    all-class-3 row."""
    rng = np.random.default_rng(seed)
    if rates == "fleet":
        inv = fleet_inv_rates(M)
    elif rates != "homo":
        pool = np.exp(rng.uniform(np.log(1e-2), np.log(1e2), (4, 3)))
        inv = pool[rng.integers(4, size=M)].astype(np.float32)
        inv[rng.choice(M, size=max(1, M // 8), replace=False)] = np.inf
        inv[rng.random(M) < 0.2, rng.integers(3)] = np.inf
        if rates == "dead":
            inv[:] = np.inf
    else:
        inv = np.array([100.0, 200.0, 500.0], np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    x = dict(
        Q=t(rng.integers(0, 4, (M, 3)).astype(np.int32)),
        valid=t(np.arange(B) < max(1, (3 * B) // 4) if valid is None else valid),
        inv=t(inv),
        cls=rng.integers(0, 3, (B, M)).astype(np.int32),
        prio=t(rng.permutation(M).astype(np.int32)),
        cand_idx=t(rng.integers(0, M, (B, C)).astype(np.int32)),
        cand_cls=t(np.tile(np.array([0] * 3 + [1] * 2 + [2] * (C - 5), np.int32),
                           (B, 1))),
        cand_valid=t(rng.random((B, C)) < 0.9))
    if class3:
        x["cls"] = rng.integers(0, 4, (B, M)).astype(np.int32)
        x["cls"][B // 2] = 3
    x["cls"] = t(x["cls"])
    return x


def valid_patterns(B: int, lam: float, seed: int) -> dict:
    """The ``valid`` patterns the kernels branch on (the chain runs to the
    last valid arrival): none valid, only the last, only the first, a
    Poisson(lam) prefix as the simulator draws it, the 3B/4 prefix the
    timings use, and gaps before the last valid one.  The tests draw the
    same patterns from tests/_torch_cases.py; this script keeps its own
    copy so that it imports nothing from tests/."""
    rng = np.random.default_rng(seed)
    gaps = rng.random(B) < 0.5
    last = B - 1 - B // 4
    gaps[last], gaps[last + 1:] = True, False
    return {"none": np.zeros(B, bool), "last": np.arange(B) == B - 1,
            "first": np.arange(B) == 0,
            "poisson": np.arange(B) < min(B, rng.poisson(lam)),
            "3B/4": np.arange(B) < max(1, (3 * B) // 4), "gaps": gaps}


def variant_args(x: dict, variant: str) -> dict:
    if variant == "full":
        return dict(cls=x["cls"], prio=x["prio"])
    return dict(cand_idx=x["cand_idx"], cand_cls=x["cand_cls"],
                cand_valid=x["cand_valid"])


def bound(x: dict, variant: str):
    """Least time for the work: each input read once, each output written
    once, over the memory rate; the multiply-adds over the f32 peak."""
    ins = [x["Q"], x["valid"], x["inv"]] + list(variant_args(x, variant).values())
    M, B = x["Q"].shape[0], x["valid"].shape[0]
    out_bytes = M * 3 * 4 + M * 4 + 3 * B * 4
    cand = M if variant == "full" else x["cand_idx"].shape[1]
    ops = 5 * M + 2 * B * cand          # W0, then one add + multiply a score
    return bound_ms(nbytes(*ins) + out_bytes, ops)


def check_kernels(dev, quick: bool) -> dict:
    """Both route_commit variants against the plain version on the
    battery (main-path shapes and the largest M the wrapper accepts): three
    seeds of classes 0..2 at the 3B/4 prefix with prio given, homogeneous
    and heterogeneous rates; then every valid pattern with class 3, with
    homogeneous, heterogeneous and all-dead rates, prio given and absent.
    Then timed at the main path's shapes with two valid prefixes: 3B/4
    (comparable with the earlier slices) and round(lambda), the
    simulator's mean arrival count, at the uniform scenario's [3] operand
    and at the heterogeneous fleet's [M, 3] operand (``fleet_inv_rates``).
    Returns {(variant, M, valid is round(lambda), rates): row}."""
    from repro_torch.kernels import route_commit, route_commit_ref

    err = {}

    def check_equal(x: dict, kw: dict, variant: str, label: str):
        got = route_commit(x["Q"], x["valid"], x["inv"], **kw)
        torch.cuda.synchronize()
        want = route_commit_ref(x["Q"], x["valid"], x["inv"], **kw)
        for name, a, b in zip(("Q", "W", "sel", "sel_cls", "val"), got, want):
            if not torch.equal(a, b):
                fail(f"route_commit_{variant} {label} prio={'prio' in kw}: "
                     f"{name} differs from the plain version")
            if a.is_floating_point() and a.numel():
                d = (a - b).abs().nan_to_num(0.0)
                err[variant] = max(err.get(variant, 0.0), float(d.max()))
        return got

    shapes = [(500, 22, 11, 4.5), (5000, 90, 11, 45.0), (29056, 5, 11, 2.0)]
    rows = {}
    for M, B, C, lam in shapes:
        for variant in ("full", "pod"):
            for rates in ("homo", "hetero"):
                for seed in range(3):
                    x = kernel_inputs(M, B, C, rates, seed, dev)
                    check_equal(x, variant_args(x, variant), variant,
                                f"M={M} B={B} rates={rates} seed={seed}")
                log(f"  route_commit_{variant:4s} M={M:5d} B={B:3d} "
                    f"rates={rates}: equal to the plain version on seeds 0-2 "
                    f"(classes 0..2, valid 3B/4)")
            for rates in RATES:
                for pattern, valid in valid_patterns(B, lam, M).items():
                    x = kernel_inputs(M, B, C, rates, M + B, dev, valid, class3=True)
                    kws = [variant_args(x, variant)]
                    if variant == "full":
                        kws.append(dict(cls=x["cls"]))
                    for kw in kws:
                        check_equal(x, kw, variant, f"M={M} B={B} rates={rates} "
                                                    f"valid={pattern}")
                log(f"  route_commit_{variant:4s} M={M:5d} B={B:3d} "
                    f"rates={rates}: "
                    f"equal to the plain version on valid patterns "
                    f"{', '.join(valid_patterns(B, lam, M))}"
                    f"{' (prio given and absent)' if variant == 'full' else ''}")
            if M > 5000:
                continue
            # time at the main path's operands: [3] on uniform, [M, 3] on a
            # heterogeneous fleet
            for rates in ("homo", "fleet"):
                for n_valid in (max(1, (3 * B) // 4), int(lam + 0.5)):
                    x = kernel_inputs(M, B, C, rates, 0, dev, np.arange(B) < n_valid)
                    rows[(variant, M, n_valid == int(lam + 0.5), rates)] = \
                        time_route_commit(
                            x, variant, quick, f"route_commit_{variant} M={M} B={B}"
                            f"{'' if variant == 'full' else f' C={C}'} valid={n_valid} "
                            f"inv={'[3]' if rates == 'homo' else '[M,3] fleet'}")
    for key, r in rows.items():
        r["max_abs_err"] = err[key[0]]
    return rows


def time_route_commit(x: dict, variant: str, quick: bool, label: str) -> dict:
    """route_commit on ``x``: the kernel alone into preallocated outputs
    (device time), the whole wrapper as the host issues it, and the plain
    version, beside the bound."""
    from repro_torch.kernels import route_commit, route_commit_ref
    from repro_torch.kernels.route_commit import launch

    iters = 200 if quick else 500
    kw = variant_args(x, variant)
    B, n_valid = x["valid"].shape[0], int(x["valid"].sum())
    outs = tuple(torch.empty_like(o)
                 for o in route_commit(x["Q"], x["valid"], x["inv"], **kw))
    k_ms = device_time_ms(lambda: launch(x["Q"], x["valid"], x["inv"], outs, **kw),
                          iters)
    w_ms = cuda_time_ms(lambda: route_commit(x["Q"], x["valid"], x["inv"], **kw),
                        iters)
    p_ms = cuda_time_ms(lambda: route_commit_ref(x["Q"], x["valid"], x["inv"], **kw),
                        5 if quick else 20, warmup=2)
    b_ms, b_by = bound(x, variant)
    log(f"  {label}: kernel {k_ms:.6f} ms ({k_ms * 1e3 / n_valid:.4f} us a "
        f"sequential step)  wrapper {w_ms:.6f} ms  plain {p_ms:.6f} ms  "
        f"bound {b_ms:.8f} ms ({b_by})  library n/a ({NO_LIBRARY['route_commit']})")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, B=B,
                n_valid=n_valid, us_per_step=k_ms * 1e3 / n_valid)


GRID_CELLS = (1, 3, 132, 133)      # cells a batched launch is checked at
TIMED_CELLS = (1, 32, 132, 264)    # and timed at (one wave of 132 CTAs, two)
INV_MODES = ("[3]", "[M,3]", "[N,M,3]")


def batched_inputs(M: int, B: int, C: int, N: int, inv: str, lam: float,
                   seed: int, dev, valid=None) -> dict:
    """Tie-forcing inputs of N cells for one batched launch: each cell its
    own queues (few lengths), classes 0..3 (every third cell with an
    all-class-3 row), prio, candidates and ``valid`` pattern (cell n takes
    pattern n mod 6 of ``valid_patterns``, so one launch holds every
    pattern and its cells' chains stop at different arrivals), unless
    ``valid`` gives one [B] mask for all.  ``inv``: "[3]" (the lattice
    vector), "[M,3]" (one pooled matrix with dead servers and columns, read
    by every cell at a cell stride of 0, as simulate_grid on a
    heterogeneous scenario) or "[N,M,3]" (one a cell, as simulate_sweep).
    The candidate classes are one [B, C] block all cells share, as on
    BP-Pod's path."""
    rng = np.random.default_rng(seed)

    def pooled(lead):
        pool = np.exp(rng.uniform(np.log(1e-2), np.log(1e2), (4, 3)))
        r = pool[rng.integers(4, size=lead + (M,))].astype(np.float32)
        r[rng.random(lead + (M,)) < 0.125] = np.inf          # dead servers
        at = np.nonzero(rng.random(lead + (M,)) < 0.2)         # a dead column
        r[at + (rng.integers(3, size=len(at[0])),)] = np.inf
        return r
    rates = {"[3]": np.array([100.0, 200.0, 500.0], np.float32),
             "[M,3]": pooled(()), "[N,M,3]": pooled((N,))}[inv]
    if valid is None:
        valid = np.stack([list(valid_patterns(B, lam, seed + n).values())[n % 6]
                          for n in range(N)])
    else:
        valid = np.broadcast_to(valid, (N, B))
    cls = rng.integers(0, 4, (N, B, M)).astype(np.int32)
    cls[::3, B // 2] = 3
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return dict(
        Q=t(rng.integers(0, 4, (N, M, 3)).astype(np.int32)), valid=t(valid),
        inv=t(rates), cls=t(cls),
        prio=t(np.argsort(rng.random((N, M)), axis=1).astype(np.int32)),
        cand_idx=t(rng.integers(0, M, (N, B, C)).astype(np.int32)),
        cand_cls=t(np.tile(np.array([0] * 3 + [1] * 2 + [2] * (C - 5), np.int32),
                           (B, 1))),
        cand_valid=t(rng.random((N, B, C)) < 0.9))


def batched_bound(x: dict, variant: str):
    """``bound`` of a batched launch: every input read once (a shared one
    once for all cells), every cell's outputs written once, every cell's
    multiply-adds."""
    ins = [x["Q"], x["valid"], x["inv"]] + list(variant_args(x, variant).values())
    N, M, _ = x["Q"].shape
    B = x["valid"].shape[1]
    cand = M if variant == "full" else x["cand_idx"].shape[-1]
    return bound_ms(nbytes(*ins) + N * (M * 3 * 4 + M * 4 + 3 * B * 4),
                    N * (5 * M + 2 * B * cand))


def check_batched_route_commit(dev, quick: bool):
    """Both variants with a leading cell axis, one CTA a cell, against the
    plain version (a loop over the cells) to the bit, at N = 1, 3, 132 and
    133 cells (a full wave of the card's 132 SMs and one cell past it) at
    the main path's shapes, M=500 and M=5000, with the [3], a shared [M, 3]
    and a per-cell [N, M, 3] rate operand; the full variant also with prio
    absent at N = 3.  Then timed at N = 1, 32, 132 and 264 at M=500 B=22
    (every cell's 3B/4 prefix), at the [3] and the per-cell operand.
    Returns ({variant: {"N=.. inv=..": row}}, largest float difference)."""
    from repro_torch.kernels import route_commit, route_commit_ref
    from repro_torch.kernels.route_commit import launch

    err = 0.0
    t0 = time.perf_counter()
    for M, B, C, lam in ((500, 22, 11, 4.5), (5000, 90, 11, 45.0)):
        for variant in ("full", "pod"):
            for inv in INV_MODES:
                for N in GRID_CELLS:
                    x = batched_inputs(M, B, C, N, inv, lam, M + N, dev)
                    kws = [variant_args(x, variant)]
                    if variant == "full" and N == 3:
                        kws.append(dict(cls=x["cls"]))
                    for kw in kws:
                        got = route_commit(x["Q"], x["valid"], x["inv"], **kw)
                        torch.cuda.synchronize()
                        want = route_commit_ref(x["Q"], x["valid"], x["inv"], **kw)
                        for name, a, b in zip(("Q", "W", "sel", "sel_cls", "val"),
                                              got, want):
                            if not torch.equal(a, b):
                                fail(f"route_commit_{variant} M={M} B={B} N={N} "
                                     f"inv={inv} prio={'prio' in kw}: {name} "
                                     f"differs from the plain version")
                            if a.is_floating_point() and a.numel():
                                err = max(err, float((a - b).abs().nan_to_num(0.0).max()))
            log(f"  route_commit_{variant:4s} M={M:5d} B={B:3d} cells "
                f"{', '.join(map(str, GRID_CELLS))} x inv {', '.join(INV_MODES)}: "
                f"equal to the plain version (every valid pattern in each launch"
                f"{', prio given and absent' if variant == 'full' else ''})")
    log(f"  batched checks took {time.perf_counter() - t0:.1f} s")
    rows = {"full": {}, "pod": {}}
    M, B, C = 500, 22, 11
    iters = 200 if quick else 500
    for inv in ("[3]", "[N,M,3]"):
        for N in TIMED_CELLS:
            x = batched_inputs(M, B, C, N, inv, 4.5, N, dev,
                               valid=np.arange(B) < (3 * B) // 4)
            for variant in ("full", "pod"):
                kw = variant_args(x, variant)
                outs = tuple(torch.empty_like(o)
                             for o in route_commit(x["Q"], x["valid"], x["inv"], **kw))
                k_ms = device_time_ms(lambda: launch(x["Q"], x["valid"], x["inv"],
                                                     outs, **kw), iters)
                p_ms = cuda_time_ms(lambda: route_commit_ref(x["Q"], x["valid"],
                                                             x["inv"], **kw),
                                    1 if N >= 132 else 2 if N > 1 else 20,
                                    warmup=0 if N >= 132 else 1)
                b_ms, b_by = batched_bound(x, variant)
                log(f"  route_commit_{variant} N={N} M={M} B={B}"
                    f"{'' if variant == 'full' else f' C={C}'} valid={(3 * B) // 4} "
                    f"inv={inv}: kernel {k_ms:.6f} ms ({k_ms * 1e3 / N:.4f} us a cell)"
                    f"  plain {p_ms:.6f} ms  bound {b_ms:.8f} ms ({b_by})")
                rows[variant][f"N={N} inv={inv}"] = dict(
                    ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    return rows, err


def jsq_inputs(M: int, B: int, seed: int, dev, valid) -> dict:
    """Batched JSQ routing's route_commit operand (the simulator's
    ``_sq_step``): Q nonzero in column 0 only, with three lengths, so that
    equal queues tie across a triple's slots (every third triple is three
    servers of one length); distinct replica triples as the C=3
    candidates, all of class 0 and valid; unit rates.  The tests draw the
    same operand from tests/_torch_cases.py; this script keeps its own
    copy so that it imports nothing from tests/."""
    rng = np.random.default_rng(seed)
    Q = np.zeros((M, 3), np.int32)
    Q[:, 0] = rng.integers(0, 3, M)
    ci = np.stack([rng.choice(M, 3, replace=False) for _ in range(B)])
    for b in range(0, B, 3):
        same = np.flatnonzero(Q[:, 0] == Q[ci[b, 0], 0])
        if len(same) >= 3:
            ci[b] = rng.choice(same, 3, replace=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(Q=t(Q), valid=t(valid), inv=t(np.ones(3, np.float32)),
                cand_idx=t(ci.astype(np.int32)),
                cand_cls=t(np.zeros((B, 3), np.int32)),
                cand_valid=t(np.ones((B, 3), bool)))


def check_jsq_operand(dev, quick: bool):
    """route_commit_pod at batched JSQ routing's operand, B = a_max of
    M=500 at loads 0.5 / 0.9 and of M=5000 at 0.9: equal to the plain
    version on every valid pattern, then timed as ``check_kernels`` times
    the other shapes.  Returns ({(M, B, n_valid is round(lambda)): row},
    largest float difference)."""
    from repro_torch.kernels import route_commit, route_commit_ref

    err, rows = 0.0, {}
    for M, B, lam in JSQ_SHAPES:
        patterns = valid_patterns(B, lam, M + B)
        for pattern, valid in patterns.items():
            x = jsq_inputs(M, B, M + B, dev, valid)
            kw = variant_args(x, "pod")
            got = route_commit(x["Q"], x["valid"], x["inv"], **kw)
            torch.cuda.synchronize()
            want = route_commit_ref(x["Q"], x["valid"], x["inv"], **kw)
            for name, a, b in zip(("Q", "W", "sel", "sel_cls", "val"), got, want):
                if not torch.equal(a, b):
                    fail(f"route_commit_pod JSQ operand M={M} B={B} "
                         f"valid={pattern}: {name} differs from the plain version")
                if a.is_floating_point() and a.numel():
                    err = max(err, float((a - b).abs().nan_to_num(0.0).max()))
        log(f"  route_commit_pod M={M:5d} B={B:3d} JSQ operand (C=3, class 0, "
            f"unit rates, slot-order ties): equal to the plain version on "
            f"valid patterns {', '.join(patterns)}")
        for n_valid in (max(1, (3 * B) // 4), int(lam + 0.5)):
            x = jsq_inputs(M, B, 0, dev, np.arange(B) < n_valid)
            rows[(M, B, n_valid == int(lam + 0.5))] = time_route_commit(
                x, "pod", quick, f"route_commit_pod JSQ M={M} B={B} C=3 "
                                 f"valid={n_valid}")
    return rows, err


def snapshot_inputs(M: int, B: int, C: int, hetero: bool, seed: int, dev):
    """Tie-forcing snapshot inputs: few distinct workloads (even seeds) or
    uniform ones, lattice or pooled rates with dead servers and columns
    (hetero), class-3 entries and a row of class 3 only, duplicate
    candidates, invalid slots and a row with none valid, and commits that
    must drop (invalid, class 3, server M)."""
    rng = np.random.default_rng(seed)
    x = kernel_inputs(M, B, C, "hetero" if hetero else "homo", seed, dev)
    W = (rng.choice(np.array([0.0, 1.0, 2.5, 77.0], np.float32), M)
         if seed % 2 == 0 else rng.uniform(0, 100, M).astype(np.float32))
    cls = rng.integers(0, 4, (B, M)).astype(np.int32)
    cls[0] = 3
    ci = rng.integers(0, M, (B, C)).astype(np.int32)
    ci[:, 1::2] = ci[:, 0::2][:, :ci[:, 1::2].shape[1]]
    cv = rng.random((B, C)) < 0.85
    cv[0] = False
    sel = rng.integers(0, M, B).astype(np.int32)
    sel[rng.random(B) < 0.1] = M
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return dict(W=t(W), cls=t(cls), inv=x["inv"], cand_idx=t(ci),
                cand_cls=t(rng.integers(0, 4, (B, C)).astype(np.int32)),
                cand_valid=t(cv), Q=x["Q"], sel=t(sel),
                sel_cls=t(rng.integers(0, 4, B).astype(np.int32)),
                valid=t(rng.random(B) < 0.85))


def snapshot_timing_inputs(M: int, B: int, C: int, dev, seed: int = 0):
    """The complexity benchmark's inputs (benchmarks/complexity.py): rates
    [25, 50, 125], uniform W, classes 0..2, C random candidates all valid;
    and a batch to commit for queue_update."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ri = lambda hi, shape: torch.randint(0, hi, shape, generator=g, device=dev,
                                         dtype=torch.int32)
    return dict(W=torch.rand(M, generator=g, device=dev) * 100,
                cls=ri(3, (B, M)),
                inv=torch.tensor([25.0, 50.0, 125.0], device=dev),
                cand_idx=ri(M, (B, C)), cand_cls=ri(3, (B, C)),
                cand_valid=torch.ones((B, C), dtype=torch.bool, device=dev),
                Q=ri(50, (M, 3)), sel=ri(M, (B,)), sel_cls=ri(3, (B,)),
                valid=torch.ones(B, dtype=torch.bool, device=dev))


def snapshot_calls(x: dict):
    """name -> (public function, plain version, launch, args, outputs)."""
    from repro_torch import kernels as tk
    from repro_torch.kernels.pod_route import launch as pod_route_launch
    from repro_torch.kernels.queue_update import launch as queue_update_launch
    from repro_torch.kernels.weighted_argmin import launch as weighted_argmin_launch
    B, M = x["cls"].shape
    dev = x["W"].device
    out = lambda: (torch.empty(B, dtype=torch.int32, device=dev),
                   torch.empty(B, dtype=torch.float32, device=dev))
    return {
        "weighted_argmin": (tk.weighted_argmin, tk.weighted_argmin_ref,
                            weighted_argmin_launch,
                            (x["W"], x["cls"], x["inv"]), out()),
        "pod_route": (tk.pod_route, tk.pod_route_ref, pod_route_launch,
                      (x["W"], x["cand_idx"], x["cand_cls"], x["cand_valid"],
                       x["inv"]), out()),
        "queue_update": (tk.queue_update, tk.queue_update_ref,
                         queue_update_launch,
                         (x["Q"], x["sel"], x["sel_cls"], x["valid"], x["inv"]),
                         (torch.empty_like(x["Q"]),
                          torch.empty(M, dtype=torch.float32, device=dev)))}


def snapshot_bound(name: str, x: dict):
    """Least time for one call at these inputs: each input read once and
    each output written once (pod_route reads only the W and rate entries
    its candidates name), against the float32 operations."""
    B, M = x["cls"].shape
    inv_row = 12 if x["inv"].ndim == 2 else 0
    if name == "weighted_argmin":
        return bound_ms(nbytes(x["W"], x["cls"], x["inv"]) + 8 * B, B * M)
    if name == "pod_route":
        named = int(torch.unique(x["cand_idx"]).numel())
        return bound_ms(nbytes(x["cand_idx"], x["cand_cls"], x["cand_valid"])
                        + named * (x["W"].element_size() + inv_row)
                        + (0 if inv_row else 12) + 8 * B, x["cand_idx"].numel())
    return bound_ms(nbytes(x["Q"], x["sel"], x["sel_cls"], x["valid"], x["inv"])
                    + 16 * M, 5 * M + B)


def check_snapshot_kernels(dev) -> dict:
    """Each snapshot kernel against its plain version on tie-forcing
    batteries.  Returns the largest float difference seen, by kernel."""
    err = {}
    for M, B, C in SNAPSHOT_SHAPES:
        for hetero in (False, True):
            for seed in range(2):
                x = snapshot_inputs(M, B, C, hetero, seed, dev)
                cases = list(snapshot_calls(x).items())
                w16 = x["W"].to(torch.bfloat16)
                cases += [(n, (f, p, l, (w16,) + a[1:], o)) for n, (f, p, l, a, o)
                          in cases if n != "queue_update"]
                for name, (fn, plain, _, args, _) in cases:
                    got = fn(*args)
                    torch.cuda.synchronize()
                    want = plain(*args)
                    for i, (a, b) in enumerate(zip(got, want)):
                        if not torch.equal(a, b):
                            fail(f"{name} M={M} B={B} hetero={hetero} seed={seed} "
                                 f"W={args[0].dtype}: output {i} differs from "
                                 f"the plain version")
                        if a.is_floating_point():
                            d = (a - b).abs().nan_to_num(0.0)
                            err[name] = max(err.get(name, 0.0), float(d.max()))
                log(f"  snapshot kernels M={M:5d} B={B} C={C} "
                    f"{'hetero' if hetero else 'homo  '} seed={seed}: "
                    f"weighted_argmin (f32, bf16), pod_route (f32, bf16) and "
                    f"queue_update equal to their plain versions")
    return err


def time_snapshot_kernels(dev, quick: bool, floor) -> dict:
    """Each snapshot kernel at the complexity benchmark's inputs: device
    time behind a plain PyTorch kernel, beside its bound, its plain
    version's time and the launch floor (``launch_floor_ms``)."""
    iters = 200 if quick else 500
    floors = launch_floor_ms(floor, dev, iters)
    grids = " / ".join(f"{b} block{'s' * (b > 1)} of {t}" for b, t in FLOOR_GRIDS)
    log(f"  launch floor (griddepcontrol.wait + one store) behind a plain "
        f"PyTorch kernel, {grids} threads: {floor_text(floors)}")
    rows = {}
    for M, B, C in SNAPSHOT_SHAPES:
        x = snapshot_timing_inputs(M, B, C, dev)
        for name, (fn, plain, launch, args, outs) in snapshot_calls(x).items():
            k_ms = device_time_behind_ms(lambda: launch(*args, *outs), iters)
            p_ms = cuda_time_ms(lambda: plain(*args), 5 if quick else 20, warmup=2)
            b_ms, b_by = snapshot_bound(name, x)
            log(f"  {name} M={M} B={B}{f' C={C}' if name == 'pod_route' else ''}: "
                f"kernel {k_ms:.6f} ms  plain {p_ms:.6f} ms  bound {b_ms:.8f} ms "
                f"({b_by})  floor {floor_text(floors)}  "
                f"library n/a ({NO_LIBRARY[name]})")
            rows[(name, M)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                   bound_by=b_by, B=B, C=C, floor_ms=floors)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the simulator
# ---------------------------------------------------------------------------


def check_small_run_matches_cpu(dev):
    """At a small size, the CUDA path and the port's CPU path, fed the
    same draws (made on the CPU), must give the same sums bit for bit:
    every family, and JSQ-MaxWeight-Pod also with s_max < M (S < M
    scheduling rows), on `uniform` and on compose("slow_rack",
    "network_degraded") (per-server speeds and a per-class window: the
    [M, 3] operand, the speed gathers and the servable masks).  Each
    device runs ``simulate`` and ``simulate_with_telemetry`` on the same
    draws: the telemetry-off sums must agree across devices, the
    telemetry run's SimResult must equal the plain run's on each device,
    and the two devices' Telemetry must be equal too (``telemetry_close``)."""
    from repro_torch.core import (Cluster, Rates, SimConfig, TorchDraws, simulate,
                                  simulate_with_telemetry)
    from repro_torch.core.simulator import _family, _pod_for
    from repro_torch.telemetry import TelemetryConfig
    from repro_torch.scenarios import compose, realize

    def same(label, what, r0, r1):
        for name, a, b in zip(r0._fields, r0, r1):
            if not torch.equal(a.cpu(), b.cpu()) and not (
                    a.cpu().isnan().all() and b.cpu().isnan().all()):
                fail(f"{label}: {name} differs between {what} ({a} vs {b})")

    cl, rates = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
    cases = [(a, 64) for a in ("balanced_pandas", "balanced_pandas_pod",
                               "jsq_maxweight_pod", "jsq_maxweight",
                               "jsq_priority", "fcfs")]
    cases.append(("jsq_maxweight_pod", 8))
    for scenario in (None, compose("slow_rack", "network_degraded")):
        label = getattr(scenario, "name", "uniform")
        for algo, s_max in cases:
            cfg = SimConfig(T=600, warmup=150, s_max=s_max, route_mode="batched")
            pod = _pod_for(algo, None)
            scen, lam_cap = realize(scenario, cl, rates, cfg.T, device="cpu")
            a_max = cfg.resolve_a_max(0.9 * lam_cap)
            lam_t = torch.tensor(0.9 * lam_cap, dtype=torch.float32) * scen.lam_shape
            case = f"{algo} s_max={s_max} on {label}"

            def draws(run_dev):
                src = TorchDraws(torch.Generator().manual_seed(5), cl, rates, cfg,
                                 pod, a_max, lam_t, _family(algo), scen)

                def draw(t):
                    d = src(t)
                    return type(d)(*(None if v is None else v.to(run_dev) for v in d))
                return draw

            plain, tele = {}, {}
            for run_dev in ("cpu", dev):
                plain[run_dev] = simulate(algo, cl, rates, 0.9, 0, cfg, scenario=scenario,
                                          a_max=a_max, device=run_dev,
                                          draws=draws(run_dev))
                tele[run_dev] = simulate_with_telemetry(
                    algo, cl, rates, 0.9, 0, cfg, scenario=scenario, a_max=a_max,
                    telemetry=TelemetryConfig(n_windows=16), device=run_dev,
                    draws=draws(run_dev))
                same(case, f"the {run_dev} path's runs with telemetry on and off",
                     plain[run_dev], tele[run_dev][0])
            same(case, "CPU and CUDA paths", plain["cpu"], plain[dev])
            diff = telemetry_close(tele["cpu"][1], tele[dev][1])
            if diff:
                fail(f"{case}: telemetry {diff} differs between CPU and CUDA paths")
            log(f"  {case}: CUDA path equals the CPU path on a small run (M=20, "
                f"T=600, shared draws), with telemetry off and on")


def run_simulations(dev, quick: bool) -> dict:
    """The runs at full width, each with the launch counters zeroed just
    before it and read just after: (algo, cluster, load, T, warmup,
    scenario).  The uniform runs first, then the heterogeneous fleet,
    traffic and placement scenarios."""
    from repro_torch.core import Cluster, Rates, SimConfig, simulate
    from repro_torch.kernels import (LAUNCHES, MATRIX_LAUNCHES,
                                     reset_launch_counts)
    from repro_torch.scenarios import get_scenario, realize

    rates = Rates(*PAPER_RATES)
    paper, big = Cluster(M=500, K=10), Cluster(M=5000, K=50)
    placed = Cluster(M=100, K=10)     # the capacity LP at M=500 takes minutes
    scale = 20 if quick else 1
    runs = []
    for algo in ("balanced_pandas", "balanced_pandas_pod", "jsq_maxweight_pod"):
        # cut from T=40 000 (JSQ-MaxWeight-Pod: 20 000; M=5000: 10 000) to
        # make room for the telemetry and trace phases (PERF.md §4)
        T, warmup = (5_000, 1_250) if algo == "jsq_maxweight_pod" else (10_000, 2_500)
        runs += [(algo, paper, load, T, warmup, None) for load in (0.5, 0.9)]
        runs.append((algo, big, 0.9, 5_000, 1_250, None))
    # cut from T=10 000 to keep the whole smoke under ~450 s (PERF.md §4)
    runs += [(algo, paper, 0.5, 5_000, 1_250, None)
             for algo in ("jsq_maxweight", "jsq_priority")]
    runs.append(("fcfs", paper, 0.15, 5_000, 1_250, None))
    hetero = [(algo, paper, load, scenario)
              for algo in ("balanced_pandas", "balanced_pandas_pod")
              for scenario, load in (("slow_rack", 0.9), ("rack_outage", 0.5))]
    hetero += [("balanced_pandas_pod", paper, 0.9, "network_degraded"),
               ("balanced_pandas_pod", paper, 0.5, "mmpp_bursty"),
               ("jsq_maxweight_pod", paper, 0.9, "slow_rack"),
               ("fcfs", paper, 0.15, "rack_outage")]
    runs += [(algo, cl, load, 5_000, 1_250, scenario)
             for algo, cl, load, scenario in hetero]
    # T=10 000: at M=100 the backlog's swing at T=5 000 is ~5% of the
    # measured arrivals, the throughput gate's width (PERF.md §4)
    runs += [(algo, placed, 0.5, 10_000, 2_500, scenario)
             for scenario in ("zipf_hotspot", "hetero_storm")
             for algo in ("balanced_pandas_pod", "jsq_maxweight_pod")]
    kernel = {"balanced_pandas": "route_commit_full", "fcfs": None}
    launches = {"route_commit_full": 0, "route_commit_pod": 0}
    for algo, cl, load, T, warmup, scenario in runs:
        # --quick: T/20, but at least 5 000 slots, which the throughput gate
        # needs at load 0.5 (JSQ-MaxWeight-Pod's backlog is ~250 slots deep)
        T, warmup = max(T // scale, min(T, 5_000)), max(warmup // scale, min(warmup, 1_250))
        cfg = SimConfig(T=T, warmup=warmup, route_mode="batched")
        name = kernel.get(algo, "route_commit_pod")
        # BP hands route_commit the [M, 3] operand on every fleet that is
        # not the uniform one; batched JSQ routing keeps unit rates
        matrix = name is not None and algo.startswith("balanced_pandas") and \
            not get_scenario(scenario).fleet.uniform
        # the host's realization, capacity LP included; simulate's own
        # realization then finds the LP's edge in its cache
        t0 = time.perf_counter()
        lam = load * realize(scenario, cl, rates, T, device="cpu")[1]
        realize_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        r = simulate(algo, cl, rates, load, 1, cfg, scenario=scenario, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, at_matrix = dict(LAUNCHES), dict(MATRIX_LAUNCHES)
        if name is not None:
            launches[name] += counts[name]
        f = lambda x: float(x)
        v = lambda x: [round(float(y), 6) for y in x]
        thr = f(r.throughput) / f(r.arrival_rate_hat)
        log(f"  {algo:20s} {scenario or 'uniform'} M={cl.M} load={load} T={T}: "
            f"mean_completion_slots={f(r.mean_completion_slots):.4f} "
            f"throughput/arrivals={thr:.5f} locality={v(r.locality_fractions)} "
            f"routed={v(r.routed_fractions)} drift={f(r.drift):.4f} "
            f"clip={f(r.clip_fraction):.6f} "
            f"route_candidates={f(r.route_candidates_per_decision):.0f} "
            f"sched_candidates={f(r.sched_candidates_per_decision):.0f} "
            f"wall={wall:.2f}s slots/s={T / wall:.1f} "
            f"routed_tasks/s={lam * T / wall:.1f} launches={counts} "
            f"at_[M,3]={at_matrix} realize={realize_s:.3f}s")
        if name is not None and counts[name] != T:
            fail(f"{algo}: {name} launched {counts[name]} times in {T} slots")
        if name is not None and at_matrix[name] != (T if matrix else 0):
            fail(f"{algo} on {scenario}: {at_matrix[name]} of {T} launches at the "
                 f"[M, 3] operand, expected {T if matrix else 0}")
        other = sum(c for k, c in counts.items() if k != name)
        if other:
            fail(f"{algo}: unexpected launches {counts}")
        if not np.isfinite(f(r.mean_completion_slots)):
            fail(f"{algo}: mean completion is not finite")
        if f(r.clip_fraction) != 0.0:
            fail(f"{algo}: arrivals were clipped ({f(r.clip_fraction)})")
        if load <= 0.5 and abs(thr - 1.0) > 0.05:
            fail(f"{algo}: throughput {thr:.4f} of arrivals at load {load}")
    return launches


# ---------------------------------------------------------------------------
# Phase 3, the grid: simulate_grid and simulate_sweep
# ---------------------------------------------------------------------------


PAPER_LOADS = (0.3, 0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95)   # benchmarks/common.py PAPER
SWEEP_LOADS = (0.45, 0.7, 0.9)
ZIPF_SCENARIOS = ("zipf_hotspot", "adversarial_placement", "hetero_storm",
                  "cascade_flash")


def same_result(a, b) -> bool:
    """Two SimResults equal field by field to the bit (NaN where both are)."""
    return all(torch.equal(x.cpu(), y.cpu()) or (x.isnan().all() and y.isnan().all())
               for x, y in zip(a, b))


def cell_of(result, index):
    """One cell of a grid's SimResult (leaves with leading grid axes)."""
    return type(result)(*(x[index] if x.ndim >= len(index) else x for x in result))


def check_grid_equals_looped(dev) -> None:
    """(a) Bit identity on the card: simulate_grid of every algorithm at
    M=500 K=10 (2 seeds x loads 0.5 / 0.9, T=500, warmup 125), and
    simulate_sweep of BP and BP-Pod over uniform, rack_outage and
    mmpp_bursty: the two corner cells of each equal looped simulate runs
    given the grid's a_max, every SimResult field to the bit."""
    from repro_torch.core import (ALGORITHMS, Cluster, Rates, SimConfig, simulate,
                                  simulate_grid, simulate_sweep, sweep_grid)
    from repro_torch.scenarios import canonical_pad, realize

    cl, rates = Cluster(M=500, K=10), Rates(*PAPER_RATES)
    cfg = SimConfig(T=500, warmup=125, route_mode="batched")
    loads, seed0 = (0.5, 0.9), 11
    scen, cap = realize(None, cl, rates, cfg.T, device="cpu")
    a_max = cfg.resolve_a_max(float(np.max(np.asarray([l * cap for l in loads],
                                                      np.float32))),
                              float(scen.lam_shape.max()))
    t0 = time.perf_counter()
    for algo in ALGORITHMS:
        grid = simulate_grid(algo, cl, rates, loads, 2, cfg, seed0=seed0, device=dev)
        for k, l in ((0, 0), (1, 1)):
            one = simulate(algo, cl, rates, loads[l], seed0 + k, cfg, a_max=a_max,
                           device=dev)
            if not same_result(cell_of(grid, (k, l)), one):
                fail(f"simulate_grid {algo}: cell (seed {k}, load {loads[l]}) "
                     f"differs from the looped simulate run")
        log(f"  grid {algo:20s} M=500 2 seeds x loads {loads} T={cfg.T}: corner "
            f"cells equal looped simulate runs (a_max={a_max})")
    names = ("uniform", "rack_outage", "mmpp_bursty")
    pad = canonical_pad(cl)
    a_max = sweep_grid(cl, rates, cfg, loads, names, pad, device=dev)[3]
    for algo in ("balanced_pandas", "balanced_pandas_pod"):
        _, res, _ = simulate_sweep(algo, cl, rates, loads, 2, cfg, seed0=seed0,
                                   scenarios=names, pad=pad, device=dev)
        for s, k, l in ((0, 0, 0), (len(names) - 1, 1, 1)):
            one = simulate(algo, cl, rates, loads[l], seed0 + k, cfg,
                           scenario=names[s], pad=pad, a_max=a_max, device=dev)
            if not same_result(cell_of(res, (s, k, l)), one):
                fail(f"simulate_sweep {algo}: cell ({names[s]}, seed {k}, load "
                     f"{loads[l]}) differs from the looped simulate run")
        log(f"  sweep {algo:19s} M=500 {names} x 2 seeds x loads {loads}: corner "
            f"cells equal looped simulate runs (a_max={a_max})")
    log(f"  grid bit-identity checks took {time.perf_counter() - t0:.1f} s")


def run_grids(dev, quick: bool) -> dict:
    """(b) The grid entry points at full width, each run with the launch
    counters zeroed just before it and read just after: simulate_grid of
    BP, BP-Pod and JSQ-MaxWeight-Pod at M=500 over the PAPER preset's loads
    x 4 seeds (32 cells, T=10 000); simulate_sweep of BP and BP-Pod at
    M=500 over the registry's 11 scenarios with uniform placement x loads
    0.45 / 0.7 / 0.9 x 4 seeds (132 cells, T=5 000); and of BP-Pod at M=100
    over the 4 Zipf scenarios x the same loads x 2 seeds (24 cells, T=10
    000).  Gates: route_commit launched exactly T times a run (one launch a
    slot for every cell), at the [M, 3] operand in every BP sweep slot and
    in none of the uniform grids' slots, no other kernel; clip 0 and every
    mean finite in every cell; throughput over arrivals, averaged over the
    seeds, within 5% at every load <= 0.5.  Returns the launches."""
    from repro_torch.core import (Cluster, Rates, SimConfig, simulate_grid,
                                  simulate_sweep, sweep_grid)
    from repro_torch.kernels import LAUNCHES, MATRIX_LAUNCHES, reset_launch_counts
    from repro_torch.scenarios import SCENARIOS, realize

    rates = Rates(*PAPER_RATES)
    paper, placed = Cluster(M=500, K=10), Cluster(M=100, K=10)
    uniform_placed = [n for n in SCENARIOS
                      if n not in ZIPF_SCENARIOS + ("production_day",)]
    scale = 20 if quick else 1
    runs = [("grid", a, paper, PAPER_LOADS, 4, 5_000, 1_250, None)
            for a in ("balanced_pandas", "balanced_pandas_pod", "jsq_maxweight_pod")]
    runs += [("sweep", a, paper, SWEEP_LOADS, 4, 5_000, 1_250, uniform_placed)
             for a in ("balanced_pandas", "balanced_pandas_pod")]
    runs.append(("sweep", "balanced_pandas_pod", placed, SWEEP_LOADS, 2, 10_000, 2_500,
                 list(ZIPF_SCENARIOS)))
    launches = {"route_commit_full": 0, "route_commit_pod": 0}
    for kind, algo, cl, loads, seeds, T, warmup, names in runs:
        T, warmup = max(T // scale, min(T, 5_000)), max(warmup // scale, min(warmup, 1_250))
        cfg = SimConfig(T=T, warmup=warmup, route_mode="batched")
        name = "route_commit_full" if algo == "balanced_pandas" else "route_commit_pod"
        t0 = time.perf_counter()
        if kind == "grid":
            lam = np.asarray([[l * realize(None, cl, rates, T, device="cpu")[1]
                               for l in loads]])
        else:       # the realizations (LP included) are cached for the run
            lam = sweep_grid(cl, rates, cfg, loads, names, device=dev)[2].cpu().numpy()
        realize_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        if kind == "grid":
            r = simulate_grid(algo, cl, rates, loads, seeds, cfg, device=dev)
            r = type(r)(*(x[None] if x.ndim >= 2 else x for x in r))   # [1, K, L]
        else:
            _, r, _ = simulate_sweep(algo, cl, rates, loads, seeds, cfg,
                                     scenarios=names, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, at_matrix = dict(LAUNCHES), dict(MATRIX_LAUNCHES)
        launches[name] += counts[name]
        cells = lam.size * seeds
        label = (f"{kind} {algo} M={cl.M} "
                 f"{'uniform' if names is None else f'{len(names)} scenarios'} x "
                 f"{seeds} seeds x loads {loads} T={T}")
        log(f"  {label}: cells={cells} wall={wall:.2f}s slots/s={T / wall:.1f} "
            f"cell-slots/s={cells * T / wall:.1f} "
            f"routed_tasks/s={float(lam.sum()) * seeds * T / wall:.1f} "
            f"launches={counts} at_[M,3]={at_matrix} realize={realize_s:.3f}s")
        mean = r.mean_completion_slots.cpu().numpy()                # [S, K, L]
        thr = (r.throughput / r.arrival_rate_hat).cpu().numpy().mean(axis=1)
        for s, row in enumerate(names or ["uniform"]):
            log(f"    {row:22s} mean_completion_slots by load "
                f"{np.round(mean[s].mean(axis=0), 4).tolist()} throughput/arrivals "
                f"{np.round(thr[s], 5).tolist()}")
        matrix = kind == "sweep" and algo.startswith("balanced_pandas")
        if counts[name] != T:
            fail(f"{label}: {name} launched {counts[name]} times in {T} slots")
        if at_matrix[name] != (T if matrix else 0):
            fail(f"{label}: {at_matrix[name]} of {T} launches at the [M, 3] operand, "
                 f"expected {T if matrix else 0}")
        if sum(c for k, c in counts.items() if k != name):
            fail(f"{label}: unexpected launches {counts}")
        if not np.isfinite(mean).all():
            fail(f"{label}: a mean completion is not finite")
        if float(r.clip_fraction.max()) != 0.0:
            fail(f"{label}: arrivals were clipped ({float(r.clip_fraction.max())})")
        for l, load in enumerate(loads):
            if load <= 0.5 and np.abs(thr[:, l] - 1.0).max() > 0.05:
                fail(f"{label}: throughput {thr[:, l].tolist()} of arrivals at load {load}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4: complexity (paper §IV-C)
# ---------------------------------------------------------------------------


def complexity_probes() -> None:
    """Servers whose workload one routing decision reads: M for BP, the
    replicas plus d for BP-Pod (benchmarks/complexity.py's table)."""
    from repro_torch.core import Cluster, PodSpec, bp_candidates_per_route
    log(f"  {'M':>7} {'BP probes':>10} {'BP-Pod probes':>14} {'fraction':>9}")
    for M in (100, 500, 1000, 4000, 16000):
        cl = Cluster(M=M, K=10)
        full = bp_candidates_per_route(cl, None)
        pod = bp_candidates_per_route(cl, PodSpec(2, 6))
        log(f"  {M:>7} {full:>10} {pod:>14} {pod / full:>9.4f}")


def complexity_per_decision(dev, quick: bool) -> list:
    """Microseconds per routing decision, B=256 tasks a call, C=11: the
    kernel on the card (device time behind a plain PyTorch kernel) and the
    public function as a Python caller sees it (host wall clock)."""
    B, C = 256, 11
    iters = 100 if quick else 400
    rows = []
    log(f"  {'M':>6} | device us/decision: {'BP':>9} {'BP-Pod':>9} {'ratio':>7} "
        f"| call us/decision: {'BP':>9} {'BP-Pod':>9} {'ratio':>7}")
    for M in (128, 500, 512, 2048, 5000, 8192, 16000):
        calls = snapshot_calls(snapshot_timing_inputs(M, B, C, dev, seed=1))
        us = {}
        for name in ("weighted_argmin", "pod_route"):
            fn, plain, launch, args, outs = calls[name]
            got, want = fn(*args), plain(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"{name} M={M}: differs from the plain version")
            dev_ms = device_time_behind_ms(lambda: launch(*args, *outs), iters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) / iters * 1e3
            us[name] = (dev_ms * 1e3 / B, call_ms * 1e3 / B)
        (fd, fc), (pd, pc) = us["weighted_argmin"], us["pod_route"]
        log(f"  {M:>6} | {'':>20}{fd:>9.5f} {pd:>9.5f} {fd / pd:>7.3f} "
            f"| {'':>18}{fc:>9.5f} {pc:>9.5f} {fc / pc:>7.3f}")
        rows.append(dict(M=M, device_us=(fd, pd), call_us=(fc, pc)))
    return rows


def route_and_commit(route: str, Q, W, inv, cls, cand, slot, n: int):
    """The part of a snapshot routing tick from the routing kernel on:
    route the batch (weighted_argmin over cls, or pod_route over the
    candidates ``cand``), take each task's class at its server, and commit
    the first n tasks with queue_update.  Returns the next (Q, W)."""
    from repro_torch.kernels import pod_route, queue_update, weighted_argmin
    if route == "weighted_argmin":
        sel, _ = weighted_argmin(W, cls, inv)
        sel_cls = cls.gather(1, sel.long()[:, None])[:, 0]
    else:
        ci, cc, cv = cand
        sel, _ = pod_route(W, ci, cc, cv, inv)
        first = (ci == sel[:, None]).to(torch.int32).argmax(dim=1)
        sel_cls = cc.gather(1, first[:, None])[:, 0]
    return queue_update(Q, sel, sel_cls, slot < n, inv)


def tick_times(dev, quick: bool) -> None:
    """Device us of route_and_commit, the sequence the routing kernel and
    queue_update sit in on a routing tick (route -> class gather ->
    slot < n -> queue_update), 100 back to back behind the spin on one
    tick's inputs, B=256, at the ticks' two clusters; its Q and W must
    equal the same function's on the CPU, where it runs the plain versions.
    (A tick is 5-7 launches, and the card queues about a thousand: more
    ticks would stall the host behind the spin.)"""
    from repro_torch.core import (Cluster, PodSpec, Rates, locality_class,
                                  pod_candidates, safe_inv_rates, sample_locals)
    B, iters = 256, 50 if quick else 100
    for cl in (Cluster(M=500, K=10), Cluster(M=5000, K=50)):
        gen = torch.Generator(device=dev).manual_seed(3)
        inv = safe_inv_rates(Rates(0.01, 0.005, 0.002).as_array(dev))
        locals_ = sample_locals(gen, cl, B, device=dev)
        cls = locality_class(cl, locals_)
        ci, cc, cv = pod_candidates(gen, cl, locals_, cls, PodSpec(2, 6))
        args = dict(Q=torch.randint(0, 50, (cl.M, 3), generator=gen, device=dev,
                                    dtype=torch.int32),
                    W=torch.rand(cl.M, generator=gen, device=dev) * 100, inv=inv,
                    cls=cls, cand=(ci, cc.contiguous(), cv),
                    slot=torch.arange(B, device=dev), n=3 * B // 4)
        cpu = {k: v.cpu() if torch.is_tensor(v) else
               tuple(t.cpu() for t in v) if isinstance(v, tuple) else v
               for k, v in args.items()}
        for route in ("weighted_argmin", "pod_route"):
            ms = device_time_ms(lambda: route_and_commit(route, **args), iters)
            got = route_and_commit(route, **args)
            want = route_and_commit(route, **cpu)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
                fail(f"{route} -> queue_update M={cl.M}: differs from the plain versions")
            algo = "BP" if route == "weighted_argmin" else "BP-Pod"
            log(f"  tick {algo:6s} M={cl.M} B={B}: route -> class gather -> slot < n "
                f"-> queue_update {ms * 1e3:.4f} us device (Q and W equal to the "
                f"plain versions)")


def routing_ticks(dev, ticks: int = 200) -> dict:
    """Snapshot routing ticks of BP and BP-Pod: sample_locals ->
    locality_class -> weighted_argmin, or -> pod_candidates -> pod_route
    (sel_cls from the first slot that holds sel) -> queue_update.  After
    every tick Q.sum() must equal the valid arrivals so far and W must equal
    the workload of Q to the bit; each call launches its kernel once and
    route_commit not at all.  Returns the launches of these runs."""
    from repro_torch.core import (Cluster, PodSpec, Rates, locality_class,
                                  pod_candidates, safe_inv_rates, sample_locals)
    from repro_torch.kernels import LAUNCHES, encode, reset_launch_counts
    from repro_torch.kernels.ref import workload

    B, pod = 256, PodSpec(2, 6)
    launches = {"weighted_argmin": 0, "pod_route": 0, "queue_update": 0}
    for cl in (Cluster(M=500, K=10), Cluster(M=5000, K=50)):
        inv = safe_inv_rates(Rates(0.01, 0.005, 0.002).as_array(dev))
        finite = encode(inv, cl.M, flags=False)[:, :3]
        for route in ("weighted_argmin", "pod_route"):
            gen = torch.Generator(device=dev).manual_seed(7)
            rng = np.random.default_rng(7)
            slot = torch.arange(B, device=dev)
            Q = torch.zeros((cl.M, 3), dtype=torch.int32, device=dev)
            W = torch.zeros(cl.M, dtype=torch.float32, device=dev)
            arrived = 0
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(ticks):
                n = int(rng.integers(B // 2, B + 1))
                locals_ = sample_locals(gen, cl, B, device=dev)
                cls = locality_class(cl, locals_)
                cand = None
                if route == "pod_route":
                    ci, cc, cv = pod_candidates(gen, cl, locals_, cls, pod)
                    cand = (ci, cc.contiguous(), cv)
                Q, W = route_and_commit(route, Q, W, inv, cls, cand, slot, n)
                arrived += n
                if int(Q.sum()) != arrived:
                    fail(f"{route} M={cl.M}: Q holds {int(Q.sum())} tasks, "
                         f"{arrived} arrived")
                if not torch.equal(W, workload(Q, finite)):
                    fail(f"{route} M={cl.M}: W is not the workload of Q")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            want = {k: 0 for k in counts}
            want[route] = want["queue_update"] = ticks
            if counts != want:
                fail(f"{route} M={cl.M}: launches {counts}, expected {want}")
            for k in launches:
                launches[k] += counts[k]
            algo = "BP" if route == "weighted_argmin" else "BP-Pod"
            log(f"  {algo:6s} M={cl.M} B={B}: {ticks} ticks, {arrived} tasks "
                f"committed, busiest server {int(Q.sum(1).max())} tasks, "
                f"Q and W checked every tick, wall/tick {wall / ticks * 1e3:.4f} ms "
                f"(checks included), launches {counts}")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: telemetry
# ---------------------------------------------------------------------------


TELEMETRY_RUNS = (("balanced_pandas", 0.9, None), ("balanced_pandas_pod", 0.9, None),
                  ("jsq_maxweight_pod", 0.9, None), ("fcfs", 0.15, None),
                  ("balanced_pandas_pod", 0.9, "slow_rack"))
TELEMETRY_FLOAT = ("w_mean", "probe_regret")     # float reductions the card orders
# warmup 1 264 = 16 windows of 79 slots (the default config at T=5 000):
# the measured slots are whole windows, so the windows' sums from window 16
# on must equal the run's measured totals exactly
TELEMETRY_T, TELEMETRY_WARMUP, TELEMETRY_GRID_T = 5_000, 1_264, 1_000


def telemetry_close(a, b) -> str:
    """'' when two Telemetry are equal, every leaf to the bit but the float
    reductions TELEMETRY_FLOAT (1e-6 relative); else what differs."""
    from repro_torch.telemetry import WINDOW_SUMS, Telemetry

    for name, x, y in zip(Telemetry._fields, a, b):
        if (x is None) != (y is None):
            return name
        if x is None:
            continue
        x, y = x.cpu(), y.cpu()
        if name != "win":
            if not torch.equal(x, y):
                return name
            continue
        for c, ch in enumerate(WINDOW_SUMS):
            ok = (torch.allclose(x[..., c], y[..., c], rtol=1e-6, atol=0)
                  if ch in TELEMETRY_FLOAT else torch.equal(x[..., c], y[..., c]))
            if not ok:
                return f"win {ch}"
    return ""


def kernel_of(algo: str):
    """The route_commit variant a batched run of ``algo`` launches."""
    if algo == "fcfs":
        return None
    return "route_commit_full" if algo == "balanced_pandas" else "route_commit_pod"


def run_telemetry(dev) -> dict:
    """Phase 5 at the paper's width (M=500, K=10, batched, T=5 000, warmup
    1 264, the default TelemetryConfig): BP, BP-Pod and JSQ-MaxWeight-Pod at
    load 0.9, FCFS at 0.15, BP-Pod on slow_rack at 0.9.  Each configuration
    runs ``simulate`` (without telemetry) and ``simulate_with_telemetry``,
    the launch counters zeroed before each.  Gates: the telemetry run's
    SimResult bit-equal to the plain run's; route_commit launched T times a
    run (never for FCFS); every slot in a window, and the arrivals and
    completions of the windows past warmup (whole windows) equal to the
    run's measured totals; full BP's probe rank sum 0; no sojourn record
    dropped; the JSONL events valid.  Then a BP-Pod grid with telemetry
    over the PAPER loads x 4 seeds (32 cells, T=1 000): T launches, and its
    corner cells' telemetry equal to looped runs'.  Returns the
    launches."""
    from repro_torch.core import (Cluster, Rates, SimConfig, simulate,
                                  simulate_grid_with_telemetry, simulate_with_telemetry)
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.scenarios import realize
    from repro_torch.telemetry import (Telemetry, TelemetryConfig, WINDOW_SUMS,
                                       probe_summary, run_manifest, sojourn_percentiles,
                                       to_events, validate_events)

    cl, rates = Cluster(M=500, K=10), Rates(*PAPER_RATES)
    T, warmup = TELEMETRY_T, TELEMETRY_WARMUP
    tcfg = TelemetryConfig()
    if warmup % tcfg.window_len(T):
        fail(f"telemetry: warmup {warmup} is not a whole number of windows")
    ch = {n: i for i, n in enumerate(WINDOW_SUMS)}
    launches = {"route_commit_full": 0, "route_commit_pod": 0}

    def timed(fn):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k in launches:
            launches[k] += LAUNCHES[k]
        return out, wall, dict(LAUNCHES)

    for algo, load, scenario in TELEMETRY_RUNS:
        label = f"{algo} {scenario or 'uniform'} M=500 load={load} T={T}"
        cfg = SimConfig(T=T, warmup=warmup, route_mode="batched")
        kw = dict(scenario=scenario, device=dev)
        plain, wall0, _ = timed(lambda: simulate(algo, cl, rates, load, 1, cfg, **kw))
        torch.cuda.reset_peak_memory_stats()
        (res, tele), wall1, counts = timed(lambda: simulate_with_telemetry(
            algo, cl, rates, load, 1, cfg, telemetry=tcfg, **kw))
        peak = torch.cuda.max_memory_allocated() / 2**20
        name = kernel_of(algo)
        if not same_result(plain, res):
            fail(f"telemetry {label}: the SimResult differs from the run without it")
        if sum(counts.values()) != (0 if name is None else T) or (
                name is not None and counts[name] != T):
            fail(f"telemetry {label}: launches {counts}, expected {T} of {name}")
        w0 = warmup // tcfg.window_len(T)
        win = tele.win[w0:].sum(dim=0).cpu()
        arr, comp = (round(float(x) * (T - warmup))
                     for x in (res.arrival_rate_hat, res.throughput))
        if (float(win[ch["arrivals"]]), float(win[ch["completions"]]),
                float(tele.win[:, ch["slots"]].sum())) != (arr, comp, T):
            fail(f"telemetry {label}: windows hold arrivals / completions "
                 f"{win[ch['arrivals']]:.0f} / {win[ch['completions']]:.0f} past "
                 f"warmup, {float(tele.win[:, ch['slots']].sum()):.0f} slots; the run "
                 f"{arr} / {comp}, {T} slots")
        probe = probe_summary(tele)
        rank_sum = float(tele.win[:, ch["probe_rank"]].sum())
        if algo == "balanced_pandas" and (rank_sum != 0.0 or not probe["decisions"]):
            fail(f"telemetry {label}: full BP's probe rank sum is {rank_sum} over "
                 f"{probe['decisions']} decisions")
        if float(tele.sojourn_dropped) != 0.0:
            fail(f"telemetry {label}: {float(tele.sojourn_dropped)} sojourn records dropped")
        events = to_events(tele, tcfg, T, warmup, manifest=run_manifest(
            algo=algo, scenario=scenario or "uniform", load=load, T=T, warmup=warmup))
        errors = validate_events(events)
        if errors:
            fail(f"telemetry {label}: invalid events {errors[:3]}")
        pct = sojourn_percentiles(tele, tcfg)
        rank = "" if probe["mean_rank"] is None else (
            f" mean_rank={probe['mean_rank']:.4f} mean_regret={probe['mean_regret']:.4f}"
            f" over {probe['decisions']:.0f} decisions")
        log(f"  telemetry {label}: sojourn p50/p95/p99="
            f"{pct['p50']:.2f}/{pct['p95']:.2f}/{pct['p99']:.2f} n={pct['n']:.0f}{rank} "
            f"slots/s {T / wall1:.1f} with telemetry, {T / wall0:.1f} without "
            f"(x{wall1 / wall0:.2f} wall) launches={counts} peak_mem={peak:.1f} MiB "
            f"events={len(events)}")

    # the grid: one BP-Pod launch a slot for 32 cells, corners against looped runs
    T = TELEMETRY_GRID_T
    cfg = SimConfig(T=T, warmup=T // 4, route_mode="batched")
    torch.cuda.reset_peak_memory_stats()
    (res, tele), wall, counts = timed(lambda: simulate_grid_with_telemetry(
        "balanced_pandas_pod", cl, rates, PAPER_LOADS, 4, cfg, telemetry=tcfg, device=dev))
    peak = torch.cuda.max_memory_allocated() / 2**20
    if counts["route_commit_pod"] != T or sum(counts.values()) != T:
        fail(f"telemetry grid: launches {counts}, expected {T}")
    _, cap = realize(None, cl, rates, T, device="cpu")
    a_max = cfg.resolve_a_max(float(np.float32(max(PAPER_LOADS) * cap)))
    for k, l in ((0, 0), (3, len(PAPER_LOADS) - 1)):
        (_, one), _, _ = timed(lambda: simulate_with_telemetry(
            "balanced_pandas_pod", cl, rates, PAPER_LOADS[l], k, cfg, a_max=a_max,
            telemetry=tcfg, device=dev))
        diff = telemetry_close(Telemetry(*(None if x is None else x[k, l] for x in tele)),
                               one)
        if diff:
            fail(f"telemetry grid: cell (seed {k}, load {PAPER_LOADS[l]}) differs from "
                 f"its looped run in {diff}")
    log(f"  telemetry grid balanced_pandas_pod M=500 PAPER loads x 4 seeds (32 cells) "
        f"T={T}: wall={wall:.2f}s cell-slots/s={32 * T / wall:.1f} launches={counts} "
        f"peak_mem={peak:.1f} MiB; corner cells equal looped runs")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: trace replay
# ---------------------------------------------------------------------------


REPLAY_T = 10_000
REPLAY_TASKS = 17_100     # production_day(REPLAY_TASKS) at M=500, T=10 000: load ~0.45
TRACE_SIM_T = 5_000


def time_exp_f32(dev, scen) -> tuple:
    """(host ms, device ms) of one slot's size-law multiplier: the work of
    M=500 fresh tasks through ``_task_work`` with ``scen``'s size law, the
    float64 emulation of XLA's exp (``_exp_f32``) on the card."""
    from repro_torch.core.simulator import _task_work

    g = torch.Generator(device=dev).manual_seed(0)
    dur = torch.randint(1, 200, (1, 500), generator=g, device=dev, dtype=torch.int32)
    e = torch.randn((1, 500), generator=g, device=dev) * 0.7071067811865476
    fn = lambda: _task_work(dur, scen, e)
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    # ~60 launches a call: 12 calls stay under the ~1000 the card queues
    return (time.perf_counter() - t0) / 200 * 1e3, device_time_ms(fn, 12, warmup=5)


def run_trace(dev) -> dict:
    """Phase 6: ``production_day`` in the registry and simulated by BP-Pod
    at M=500 (load 0.45, T=5 000); then ``ReplayEngine`` of BP and BP-Pod at
    M=500 on production_day(REPLAY_TASKS) binned into T=10 000 slots, with
    telemetry (gates: route_commit once a padded slot, every task routed,
    the mean finite, throughput within 5% of arrivals, the windows' arrivals
    = the trace's tasks, valid events), a BP-Pod replay without telemetry
    beside the simulator on the same lowered scenario (tasks/s against
    routed tasks/s), and the size law's ``_exp_f32`` against a slot.
    Returns the launches."""
    from repro_torch.core import Cluster, Rates, SimConfig, simulate
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.scenarios import realize, scenario_names
    from repro_torch.telemetry import TelemetryConfig, validate_events
    from repro_torch.trace import ReplayEngine, production_day

    cl, rates = Cluster(M=500, K=10), Rates(*PAPER_RATES)
    launches = {"route_commit_full": 0, "route_commit_pod": 0}
    names = scenario_names()
    if names[-1] != "production_day" or len(names) != 16:
        fail(f"production_day is not the registry's 16th entry: {names}")
    T = TRACE_SIM_T
    cfg = SimConfig(T=T, warmup=T // 4, route_mode="batched")
    t0 = time.perf_counter()
    scen, cap = realize("production_day", cl, rates, T, device="cpu")
    realize_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    r = simulate("balanced_pandas_pod", cl, rates, 0.45, 1, cfg, scenario="production_day",
                 device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    launches["route_commit_pod"] += counts["route_commit_pod"]
    f = lambda x: float(x)
    log(f"  simulate balanced_pandas_pod production_day M=500 load=0.45 T={T}: "
        f"mean_completion_slots={f(r.mean_completion_slots):.4f} throughput/arrivals="
        f"{f(r.throughput) / f(r.arrival_rate_hat):.5f} clip={f(r.clip_fraction):.6f} "
        f"size_sigma={f(scen.size_sigma):.4f} lam_cap={cap:.4f} realize={realize_s:.1f}s "
        f"wall={wall:.2f}s slots/s={T / wall:.1f} launches={counts}")
    if counts["route_commit_pod"] != T or sum(counts.values()) != T:
        fail(f"production_day: launches {counts}, expected {T}")
    if not np.isfinite(f(r.mean_completion_slots)) or f(r.clip_fraction) != 0.0:
        fail("production_day: the mean is not finite or arrivals were clipped")

    T = REPLAY_T
    cfg = SimConfig(T=T, warmup=T // 4)
    log_ = production_day(n_tasks=REPLAY_TASKS)
    t0 = time.perf_counter()
    engines = {algo: ReplayEngine(log_, cl, rates, cfg=cfg, algo=algo,
                                  telemetry=TelemetryConfig(), device=dev)
               for algo in ("balanced_pandas", "balanced_pandas_pod")}
    build_s = time.perf_counter() - t0
    for algo, eng in engines.items():
        if not 0.40 < eng.load < 0.50:
            fail(f"replay: load {eng.load:.4f}, expected ~0.45")
        torch.cuda.synchronize()
        reset_launch_counts()
        res = eng.run(0)
        counts = dict(LAUNCHES)
        name = kernel_of(algo)
        launches[name] += counts[name]
        padded = eng.n_chunks * eng.chunk_slots
        r = res.result
        thr = f(r.throughput) / f(r.arrival_rate_hat)
        arrivals = float(res.telemetry.win[:, 7].sum())
        log(f"  replay {algo} M=500 T={T} tasks={res.routed_tasks} load={eng.load:.4f} "
            f"a_cap={eng.a_cap} chunks={eng.n_chunks}x{eng.chunk_slots} with telemetry: "
            f"tasks/s={res.tasks_per_s:.1f} wall={res.wall_s:.2f}s "
            f"mean_completion_slots={f(r.mean_completion_slots):.4f} "
            f"throughput/arrivals={thr:.5f} launches={counts} (engines built in "
            f"{build_s:.1f}s, the LP included)")
        if counts[name] != padded or sum(counts.values()) != padded:
            fail(f"replay {algo}: launches {counts}, expected {padded}")
        if res.routed_tasks != log_.n_tasks or arrivals != log_.n_tasks:
            fail(f"replay {algo}: {res.routed_tasks} routed, {arrivals} in the windows, "
                 f"of {log_.n_tasks}")
        if not np.isfinite(f(r.mean_completion_slots)) or abs(thr - 1.0) > 0.05:
            fail(f"replay {algo}: mean {f(r.mean_completion_slots)} throughput {thr}")
        errors = validate_events(eng.telemetry_events(res))
        if errors:
            fail(f"replay {algo}: invalid events {errors[:3]}")

    eng = ReplayEngine(log_, cl, rates, cfg=cfg, device=dev)          # BP-Pod, no telemetry
    torch.cuda.synchronize()
    reset_launch_counts()
    res = eng.run(0)
    launches["route_commit_pod"] += LAUNCHES["route_commit_pod"]
    sim_cfg = SimConfig(T=T, warmup=T // 4, route_mode="batched")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    s = simulate("balanced_pandas_pod", cl, rates, eng.load, 1, sim_cfg,
                 scenario=eng.scenario, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["route_commit_pod"] += LAUNCHES["route_commit_pod"]
    host_ms, dev_ms = time_exp_f32(dev, eng.scen)
    slot_ms = wall / T * 1e3
    log(f"  replay balanced_pandas_pod without telemetry: tasks/s={res.tasks_per_s:.1f} "
        f"slots/s={T / res.wall_s:.1f} mean_completion_slots="
        f"{f(res.result.mean_completion_slots):.4f}; simulate on the same lowered scenario: "
        f"routed tasks/s={eng.load * eng.lam_cap * T / wall:.1f} slots/s={T / wall:.1f} "
        f"mean_completion_slots={f(s.mean_completion_slots):.4f}; replay / simulator "
        f"tasks/s = {res.tasks_per_s / (eng.load * eng.lam_cap * T / wall):.3f}")
    log(f"  _exp_f32 (size law, 500 starts): {host_ms:.4f} ms host, {dev_ms:.6f} ms device "
        f"a call; {host_ms / slot_ms:.4f} of the simulator's {slot_ms:.4f} ms slot")
    return launches


def profile_run(label: str, run, slots: int) -> None:
    """torch.profiler over one call of ``run`` (``slots`` slots, warmed by
    a first call): wall per slot, device busy time per slot, the device's
    idle share, kernel launches per slot, route_commit's device time per
    slot and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    run()                                                         # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) * 1e-6
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    rc = sum(us for name, us in by_name.items() if "route_commit" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile {label}, {slots} slots: "
        f"wall/slot={wall / slots * 1e3:.4f} ms "
        f"device_busy/slot={busy / slots * 1e3:.4f} ms "
        f"idle_share={1 - busy / wall:.4f} "
        f"kernels/slot={len(kern) / slots:.1f} "
        f"route_commit_us/slot={rc / slots:.3f}")
    for name, us in top:
        log(f"    {us / slots:9.3f} us/slot  {name[:90]}")


def profile_slots(dev, slots: int = 400) -> None:
    """Where a slot's time goes on the card (a CUDA-graph-free, eager
    loop): BP, BP-Pod and JSQ-MaxWeight-Pod at load 0.9, M=500 and M=5000,
    on `uniform`, and at M=500 on rack_outage (one window: each slot reads
    ``speed_at`` and BP its [M, 3] inverse rates); then BP-Pod grids of 1,
    32 and 132 cells (seeds) at M=500, load 0.9, on `uniform`, each also
    timed without the profiler (cell-slots/s)."""
    from repro_torch.core import Cluster, Rates, SimConfig, simulate, simulate_grid

    rates = Rates(*PAPER_RATES)
    cfg = SimConfig(T=slots, warmup=0, route_mode="batched")
    algos = ("balanced_pandas", "balanced_pandas_pod", "jsq_maxweight_pod")
    cases = [(cl, algo, None) for cl in (Cluster(M=500, K=10), Cluster(M=5000, K=50))
             for algo in algos]
    cases += [(Cluster(M=500, K=10), algo, "rack_outage") for algo in algos]
    for cl, algo, scenario in cases:
        profile_run(f"{algo} {scenario or 'uniform'} M={cl.M} load=0.9",
                    lambda: simulate(algo, cl, rates, 0.9, 0, cfg, scenario=scenario,
                                     device=dev), slots)
    cl = Cluster(M=500, K=10)
    for N in (1, 32, 132):
        run = lambda: simulate_grid("balanced_pandas_pod", cl, rates, [0.9], N, cfg,
                                    device=dev)
        profile_run(f"grid balanced_pandas_pod uniform M=500 load=0.9 cells={N}",
                    run, slots)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"    unprofiled: wall/slot={wall / slots * 1e3:.4f} ms "
            f"cell-slots/s={N * slots / wall:.1f}")


def profile_telemetry(dev, slots: int = 400) -> None:
    """Telemetry's cost a slot: BP-Pod at M=500, load 0.9, on `uniform`,
    with the collectors on (the default TelemetryConfig), one cell and a
    grid of 32 (seeds), each also timed without the profiler, beside the
    same runs without telemetry; then the replay's slot: ReplayEngine
    (BP-Pod, M=500, telemetry off) over ``slots`` slots of a production
    day at phase 6's arrival rate (REPLAY_TASKS in 10 000 slots)."""
    from repro_torch.core import (Cluster, Rates, SimConfig, simulate_grid,
                                  simulate_grid_with_telemetry)
    from repro_torch.trace import ReplayEngine, production_day

    rates, cl = Rates(*PAPER_RATES), Cluster(M=500, K=10)
    cfg = SimConfig(T=slots, warmup=0, route_mode="batched")
    for N in (1, 32):
        for tele in (True, False):
            run = (lambda: simulate_grid_with_telemetry(
                "balanced_pandas_pod", cl, rates, [0.9], N, cfg, device=dev)) if tele else \
                (lambda: simulate_grid("balanced_pandas_pod", cl, rates, [0.9], N, cfg,
                                       device=dev))
            profile_run(f"{'telemetry' if tele else 'no telemetry'} grid balanced_pandas_pod "
                        f"uniform M=500 load=0.9 cells={N}", run, slots)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            log(f"    unprofiled: wall/slot={wall / slots * 1e3:.4f} ms "
                f"slots/s={slots / wall:.1f} cell-slots/s={N * slots / wall:.1f}")
    log_ = production_day(n_tasks=round(REPLAY_TASKS * slots / REPLAY_T))
    t0 = time.perf_counter()
    eng = ReplayEngine(log_, cl, rates, cfg=SimConfig(T=slots, warmup=0),
                       chunk_slots=slots, device=dev)
    log(f"  replay engine M=500 T={slots} tasks={log_.n_tasks} load={eng.load:.4f} built "
        f"in {time.perf_counter() - t0:.1f} s (the capacity LP included)")
    profile_run("replay balanced_pandas_pod M=500", lambda: eng.run(0), slots)


def sweep_route_commit(dev) -> None:
    """route_commit's device ms a launch at each valid-prefix length n of a
    coarse grid, 0 to B (M=500 B=22 and M=5000 B=90, C=11, homogeneous
    rates), so a launch splits into a fixed part, n chain steps and B - n
    tail rows.  It calls only the kernels' ``launch``, which has kept its
    signature since the first slice: copied into an earlier commit's
    tree, this script times that commit's kernels on the same inputs."""
    from repro_torch.kernels.route_commit import launch

    for M, B in ((500, 22), (5000, 90)):
        for n in sorted({0, 1, 2, 4, B // 4, B // 2, (3 * B) // 4, B - 2, B - 1, B}):
            x = kernel_inputs(M, B, 11, "homo", 0, dev, np.arange(B) < n)
            outs = (torch.empty((M, 3), dtype=torch.int32, device=dev),
                    torch.empty(M, device=dev),
                    torch.empty(B, dtype=torch.int32, device=dev),
                    torch.empty(B, dtype=torch.int32, device=dev),
                    torch.empty(B, device=dev))
            for variant in ("full", "pod"):
                kw = variant_args(x, variant)
                ms = device_time_ms(lambda: launch(x["Q"], x["valid"], x["inv"],
                                                   outs, **kw))
                step = f" ({ms * 1e3 / n:.4f} us a sequential step)" if n else ""
                log(f"  sweep route_commit_{variant} M={M} B={B} valid={n}: "
                    f"{ms:.6f} ms{step}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="short first run: fewer timing launches, T/20 "
                         "(at least 5 000 slots)")
    ap.add_argument("--profile", action="store_true",
                    help="only build and time: profile where a slot's time "
                         "goes, route_commit at every valid-prefix length, "
                         "the snapshot kernels, the complexity table and the "
                         "tick's route -> queue_update sequence")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names) + 1) as pool:     # one nvcc per source
        floor_lib = pool.submit(build.build, "launch_floor", verbose=True,
                                source=FLOOR_SOURCE)
        libs = list(pool.map(lambda n: build.build(n, verbose=True), names))
        libs.append(floor_lib.result())
    floor = load_floor(libs[-1])
    log(f"[1] built {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.profile:
        profile_slots(dev)
        profile_telemetry(dev)
        sweep_route_commit(dev)
        time_snapshot_kernels(dev, False, floor)
        complexity_per_decision(dev, False)
        tick_times(dev, False)
        return 0

    log("[2] kernels against their plain versions")
    rows = check_kernels(dev, args.quick)
    jsq_rows, jsq_err = check_jsq_operand(dev, args.quick)
    cell_rows, cell_err = check_batched_route_commit(dev, args.quick)
    err = check_snapshot_kernels(dev)
    snap = time_snapshot_kernels(dev, args.quick, floor)
    log("[3] simulator")
    check_small_run_matches_cpu(dev)
    launches = run_simulations(dev, args.quick)
    log("[3] the grid entry points: simulate_grid and simulate_sweep")
    check_grid_equals_looped(dev)
    for name, n in run_grids(dev, args.quick).items():
        launches[name] += n
    log("[4] complexity (paper §IV-C): probes per routing decision")
    complexity_probes()
    log("[4] time per routing decision, O(M) weighted_argmin against O(d) "
        "pod_route (ratio = BP / BP-Pod)")
    complexity_per_decision(dev, args.quick)
    log("[4] the tick's route -> queue_update sequence, device time")
    tick_times(dev, args.quick)
    log("[4] snapshot routing ticks")
    launches.update(routing_ticks(dev))
    log("[5] telemetry: the collectors on the card")
    for name, n in run_telemetry(dev).items():
        launches[name] += n
    log("[6] trace: production_day and ReplayEngine")
    for name, n in run_trace(dev).items():
        launches[name] += n

    kernels = []
    keep = ("ms", "plain_ms", "bound_ms", "us_per_step")
    for variant in ("full", "pod"):
        name = f"route_commit_{variant}"
        r = rows[(variant, 500, False, "homo")]
        by_shape = {f"M={M} valid={rows[(variant, M, lp, op)]['n_valid']}"
                    f"{'' if op == 'homo' else ' inv=[M,3] fleet'}": {
            k: rows[(variant, M, lp, op)][k] for k in keep + ("bound_by",)}
            for op in ("homo", "fleet") for M in (500, 5000) for lp in (False, True)}
        if variant == "pod":
            by_shape.update({f"JSQ M={M} B={B} C=3 valid={j['n_valid']}":
                             {k: j[k] for k in keep}
                             for (M, B, _), j in jsq_rows.items()})
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"], cell_err,
                            jsq_err if variant == "pod" else 0.0),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            shape=f"M=500 B={r['B']} valid={r['n_valid']}"
                  + ("" if variant == "full" else " C=11"),
            by_shape=by_shape, by_cells=cell_rows[variant]))
    for name in ("weighted_argmin", "pod_route", "queue_update"):
        r = snap[(name, 500)]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=err[name], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            floor_ms=r["floor_ms"],
            shape=f"M=500 B={r['B']}" + (f" C={r['C']}" if name == "pod_route" else ""),
            by_M={str(M): {k: snap[(name, M)][k] for k in ("ms", "plain_ms", "bound_ms")}
                  for M, _, _ in SNAPSHOT_SHAPES}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
