"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py            # the full check (one card)
    python3 chip_smoke.py --quick    # a short first run: build, kernels,
                                     # T/20 (at least 5 000 slots)
    python3 chip_smoke.py --profile  # only timings: the slot profile
                                     # (BP, BP-Pod, JSQ-MaxWeight-Pod, on
                                     # uniform and on rack_outage; BP-Pod
                                     # grids of 1, 32 and 132 cells; BP-Pod
                                     # with telemetry at 1 and 32 cells
                                     # beside without; the replay's slot;
                                     # the router's call, llama3-8b's
                                     # and deepseek-moe-16b's decode
                                     # call),
                                     # route_commit at every valid-prefix
                                     # length, the snapshot kernels, the
                                     # complexity table and the tick's
                                     # route -> queue_update sequence
                                     # (with the launch floor), and a
                                     # full-width llama3-8b train_step
    python3 chip_smoke.py --training # phases 1 and 8 only (with --profile:
                                     # only the train_step's profile)
    python3 chip_smoke.py --families # phases 1 and 9 only (with --profile:
                                     # only the deepseek-moe-16b decode's
                                     # profile)
    python3 chip_smoke.py --sharding # phases 1 and 10 only

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
  6. trace: production_day in the registry and simulated at M=100;
     ReplayEngine (BP, BP-Pod) at M=500, T=5 000 on a production day at
     load ~0.45: route_commit once a padded slot, every task routed,
     throughput within 5% of arrivals, valid events; replay tasks/s beside
     the simulator's routed tasks/s on the same lowered scenario, and the
     size law's ``_exp_f32`` against a slot.
  7. serving: ``PodRouter`` (pod, PodSpec(2, 6), and full) at M=500 / K=10
     and M=5000 / K=50, 100 batches of 256 requests, each retiring the one
     routed two before: after every batch the card's sel, sel_cls, Q and W
     equal a CPU router's fed the same draws, one route_commit launch a
     batch, probes 11 / M a decision, microseconds a decision; then
     ``decode_step`` at llama3-8b's width (2 layers, float32) on the card
     against the CPU; then llama3-8b (all 32 layers, bfloat16, random init
     on the card) serving the workload of examples/serve_pod_router.py
     under pod and full: all 48 requests complete with 6 tokens each,
     probes 11 / 16, one launch a submit, finite hidden states, and the
     engine's router equal to a CPU router fed the same draws after every
     submit and every complete; ticks, tokens/s, locality, p50 / p95,
     decode ms a call by batch size beside its bound, peak memory.
  8. training: llama3-8b at full width with its depth cut to 4 layers
     (bfloat16, remat on, SyntheticLM batches of 8 x 2048 tokens), 10
     ``train_step`` calls under float32 moments, float32 moments with 4
     microbatches, and int8 moments: step ms (median from step 3),
     tokens/s, peak memory, first and last loss, grad norm, the step's
     bound (model FLOPs at 989 TFLOP/s or its state's bytes at 3.35 TB/s);
     the loss finite and falling in each run.  Then one float32 step at 2
     layers, B=1, S=1024 on the card against the CPU from the same state
     (loss, grad norm and every gradient leaf within 1e-4), and
     ``scripts/train_resume_check.py`` in a process of its own
     (deterministic algorithms): the smoke-config Trainer crashed at step
     13 and resumed equal to 20 straight steps bit for bit, its last
     checkpoint restored byte for byte, and the shard balancer of
     examples/train_checkpoint_restart.py.
  9. the other model families: deepseek-moe-16b at full width (28 layers,
     bfloat16, random init on the card): a prefill of 2 x 512 tokens (ms,
     aux losses), then the engine of phase 7 under the pod policy on the
     example's workload with phase 7's gates, decode ms a call beside the
     all-expert bound (the dispatch runs every expert at C >= 8) and the
     active-parameter bound (6 routed + 2 shared experts a token);
     internvl2-2b, whisper-large-v3 (heads padded to 32), zamba2-2.7b and
     rwkv6-7b at full width and depth, one at a time: a prefill of 2 x 512
     tokens (vlm + 256 image tokens, encdec 512 encoder frames) and 8
     decode steps from a populated cache, finite; kimi-k2 at its smoke
     config likewise.  Then, float32 with TF32 off, each family at full
     width and 2 layers (zamba2 one group of 6 mamba layers and the shared
     block; whisper 2 + 2) on the card against the CPU: a forward of 64
     tokens and 4 decode steps within 1e-4; the prefill -> decode
     equivalence of rwkv6, zamba2 and deepseek-moe (capacity factor 16)
     within 1e-4; one train_step of the moe, hybrid and ssm smoke configs
     on the card against the CPU within 1e-4.
 10. sharding, launch and roofline: ``python -m repro_torch.launch.serve
     --arch llama3_8b`` (full width, the reference's defaults: 32 requests,
     8 replicas, 2 pods, pod policy, 8 new tokens) in a child process, its
     line parsed and its route_commit launches counted; ``launch.train``
     on the smoke config for 20 steps, the loss finite and falling; an
     nccl group of one rank and a (1, 1) mesh: phase 8's float32 parity
     step with params, moments and batch as DTensors at their specs against
     the plain step on the card, ring_allreduce_q8 and a one-stage
     pipeline_forward at axis size 1; the dry run of phase 8's cell on a
     one-device fake mesh, its argument bytes equal to the card's state and
     batch and its FLOPs to FlopCounterMode's count of a real step, its
     predicted peak beside the measured one; roofline.analytic beside
     train_bound and decode_bound; and the reference's dry-run cell
     (deepseek-moe-16b x train_4k) on the production (16, 16) mesh, traced
     in a child process beside the phase: per-device peak against 80 GB,
     wire bytes.
It prints the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 peak outside tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bfloat16 dense tensor-core peak
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


def phase3_slots(load: float) -> tuple:
    """(T, warmup) of a phase-3 run at ``load``: 5 000 slots where the
    throughput gate reads the run (load <= 0.5), 2 500 at load 0.9, which
    no throughput gate reads (cut from 5 000 for the training phase,
    PERF.md §4)."""
    return (5_000, 1_250) if load <= 0.5 else (2_500, 625)


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
        # make room for the telemetry, trace, serving and training phases
        # (PERF.md §4)
        runs += [(algo, paper, load, *phase3_slots(load), None) for load in (0.5, 0.9)]
        runs.append((algo, big, 0.9, *phase3_slots(0.9), None))
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
    runs += [(algo, cl, load, *phase3_slots(load), scenario)
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
    x 4 seeds (32 cells, T=5 000); simulate_sweep of BP and BP-Pod at
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
# warmup 640 = 16 windows of 40 slots (the default config at T=2 500):
# the measured slots are whole windows, so the windows' sums from window 16
# on must equal the run's measured totals exactly.  T cut from 5 000 to
# make room for the serving phase (PERF.md §4)
TELEMETRY_T, TELEMETRY_WARMUP, TELEMETRY_GRID_T = 2_500, 640, 1_000


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
    """Phase 5 at the paper's width (M=500, K=10, batched, T=2 500, warmup
    640, the default TelemetryConfig): BP, BP-Pod and JSQ-MaxWeight-Pod at
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


# cut from T=10 000 (17 100 tasks) for the families phase (PERF.md §4): the
# same load, 0.452 at M=500
REPLAY_T = 5_000
REPLAY_TASKS = 8_550      # production_day(REPLAY_TASKS) at M=500, T=5 000: load ~0.45
TRACE_SIM_T, TRACE_SIM_M = 5_000, 100


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
    at M=TRACE_SIM_M (load 0.45, T=5 000); then ``ReplayEngine`` of BP and BP-Pod at
    M=500 on production_day(REPLAY_TASKS) binned into T=REPLAY_T slots, with
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
    # the registry entry at M=100: its capacity LP took 38-61 s at M=500
    # (PERF.md §4); the replays below keep M=500
    small = Cluster(M=TRACE_SIM_M, K=10)
    launches = {"route_commit_full": 0, "route_commit_pod": 0}
    names = scenario_names()
    if names[-1] != "production_day" or len(names) != 16:
        fail(f"production_day is not the registry's 16th entry: {names}")
    T = TRACE_SIM_T
    cfg = SimConfig(T=T, warmup=T // 4, route_mode="batched")
    t0 = time.perf_counter()
    scen, cap = realize("production_day", small, rates, T, device="cpu")
    realize_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    r = simulate("balanced_pandas_pod", small, rates, 0.45, 1, cfg, scenario="production_day",
                 device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    launches["route_commit_pod"] += counts["route_commit_pod"]
    f = lambda x: float(x)
    log(f"  simulate balanced_pandas_pod production_day M={small.M} load=0.45 T={T}: "
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


SERVE_FLEETS = ((500, 10), (5000, 50))   # (M replicas, K pods)
# the complexity cell's B; 100 batches (200 before the training phase, PERF.md §4)
SERVE_B, SERVE_BATCHES, SERVE_WARM = 256, 100, 10


def route_fleet(dev, M: int, K: int, policy: str) -> int:
    """Phase 7, the router at fleet width: SERVE_BATCHES batches of SERVE_B
    requests (replica triples from ``sample_locals``), each batch retiring
    the one routed two batches before.  After every batch the card's sel,
    sel_cls, Q and W must equal, to the bit, those of a CPU router fed the
    same draws (the plain ``route_commit_ref``); one route_commit launch a
    batch; probes a decision 11 (pod) or M (full).  Prints microseconds a
    decision: host wall of a ``route`` call over B.  Returns the launches."""
    from repro_torch.core import Cluster, PodSpec, sample_locals
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.sched import (FleetTopology, PodRouter, SharedDraws, TorchRouterDraws,
                                   service_rates)

    fleet, rates = FleetTopology(n_replicas=M, n_pods=K), service_rates()
    shared = SharedDraws(TorchRouterDraws(M, dev, PodSpec(2, 6)))
    card = PodRouter(fleet, rates, policy=policy, device=dev, draws=shared)
    cpu = PodRouter(fleet, rates, policy=policy, device="cpu", draws=shared.echo("cpu"))
    gen = torch.Generator().manual_seed(M)
    homes = [sample_locals(gen, Cluster(M, K), SERVE_B).numpy()
             for _ in range(SERVE_BATCHES)]
    routed, walls, label = [], [], f"router {policy} M={M} K={K} B={SERVE_B}"
    torch.cuda.synchronize()
    reset_launch_counts()
    for i, h in enumerate(homes):
        t0 = time.perf_counter()
        sel = card.route(h)
        walls.append(time.perf_counter() - t0)
        if not (np.array_equal(cpu.route(h), sel)
                and np.array_equal(cpu.last_classes, card.last_classes)):
            fail(f"{label}: batch {i}: sel / sel_cls differ from the CPU router")
        routed.append((sel, card.last_classes))
        if i >= 2:
            for r in (card, cpu):
                r.complete(*routed[i - 2])
        if not (torch.equal(card.Q.cpu(), cpu.Q) and torch.equal(card.W.cpu(), cpu.W)):
            fail(f"{label}: batch {i}: Q / W differ from the CPU router")
    name = f"route_commit_{policy}"
    counts = dict(LAUNCHES)
    if counts[name] != SERVE_BATCHES or sum(counts.values()) != SERVE_BATCHES:
        fail(f"{label}: launches {counts}, expected {SERVE_BATCHES} of {name}")
    probes = card.stats.probes / card.stats.decisions
    if probes != (11 if policy == "pod" else M):
        fail(f"{label}: {probes} probes a decision")
    steady = np.array(walls[SERVE_WARM:])
    log(f"  {label}: {SERVE_BATCHES} batches equal to the CPU router after every batch "
        f"(sel, sel_cls, Q, W); launches={counts[name]}; probes/decision={probes:g}; "
        f"us/decision mean={steady.mean() / SERVE_B * 1e6:.4f} "
        f"median={np.median(steady) / SERVE_B * 1e6:.4f} (route call wall / B, batches "
        f"{SERVE_WARM}..{SERVE_BATCHES - 1}); routed by class "
        f"{card.stats.routed_by_class.tolist()}; Q total {int(card.Q.sum())}")
    return counts[name]


def to_device(tree, dev):
    return {k: to_device(v, dev) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.to(dev)


def tree_bytes(tree) -> int:
    return sum(tree_bytes(v) for v in tree.values()) if isinstance(tree, dict) \
        else tree.numel() * tree.element_size()


def decode_bound(cfg, params, B: int, S: int = 16):
    """(least ms, bytes) of one decode call of B rows against an S-slot
    cache: every weight the call uses read once (the layers, the final
    norm, the head, B rows of the embedding), the cache read and written
    once, over the memory rate; against 2 operations a weight a row at the
    bfloat16 peak (the bytes bound it at every B here)."""
    tok = params["embed"]["tok"]
    head = params["embed"].get("head", tok)
    used = tree_bytes(params["layers"]) + tree_bytes(params["final_ln"]) + tree_bytes(head)
    row = tok[0].numel() * tok.element_size()
    cache = 2 * 2 * cfg.n_layers * B * S * cfg.padded_kv_heads * cfg.resolved_head_dim \
        * tok.element_size()
    moved = used + B * row + cache
    ops = 2 * B * (tree_bytes(params["layers"]) + tree_bytes(head)) / tok.element_size()
    return max(moved / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3, moved


def check_decode_parity(dev, base_cfg) -> None:
    """Phase 7: ``decode_step`` on the card against the port's CPU path at
    llama3-8b's width with 2 layers in float32 (TF32 off): three steps of
    B=4 rows at staggered positions; hidden states within 1e-4 of the
    largest magnitude, greedy tokens equal on every row whose top two
    logits differ by more than 1e-3 of the larger."""
    from repro_torch.models import decode_step, init_cache, init_params, logits_fn

    cfg = base_cfg.replace(n_layers=2, dtype="float32")
    params = init_params(cfg, 7, device=dev)
    host = to_device(params, "cpu")
    B, S = 4, 16
    cache = {d: init_cache(cfg, B, S, device=d) for d in (dev, "cpu")}
    tok = torch.tensor([[11], [128000], [4096], [77]], dtype=torch.int32)
    pos = torch.tensor([0, 3, 7, 12], dtype=torch.int32)
    worst, compared = 0.0, 0
    for step in range(3):
        h_card, cache[dev] = decode_step(params, cfg, cache[dev], tok.to(dev), pos.to(dev))
        h_cpu, cache["cpu"] = decode_step(host, cfg, cache["cpu"], tok, pos)
        err = float((h_card.cpu() - h_cpu).abs().max() / h_cpu.abs().max())
        worst = max(worst, err)
        if not torch.isfinite(h_card).all() or err > 1e-4:
            fail(f"decode parity step {step}: hidden states {err:.3e} apart (> 1e-4)")
        l_card = logits_fn(params["embed"], h_card)[:, 0].cpu()
        l_cpu = logits_fn(host["embed"], h_cpu)[:, 0]
        top2 = l_cpu.topk(2, dim=-1).values
        apart = (top2[:, 0] - top2[:, 1]) > 1e-3 * top2[:, 0].abs()
        compared += int(apart.sum())
        if not torch.equal(l_card.argmax(-1)[apart], l_cpu.argmax(-1)[apart]):
            fail(f"decode parity step {step}: greedy tokens differ")
        tok = l_cpu.argmax(-1, keepdim=True).to(torch.int32)
        pos = pos + 1
    log(f"  decode parity llama3-8b width, 2 layers, float32, B={B}: card against CPU "
        f"over 3 steps: hidden max error {worst:.3e} of the largest magnitude (<= 1e-4); "
        f"greedy tokens equal on {compared} of {3 * B} rows (the others' top two logits "
        f"within 1e-3)")
    del params, host, cache
    torch.cuda.empty_cache()


SERVE_REPLICAS, SERVE_PODS, SERVE_PREFIXES = 16, 4, 8    # examples/serve_pod_router.py
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW, SERVE_EVERY = 48, 4, 6, 2


def serve_model(dev, cfg, params, policy: str, seed: int = 0, bounds=None) -> int:
    """Phases 7 and 9, the engine: the workload of examples/serve_pod_router.py
    (16 replicas in 4 pods, 8 prefixes on 3 replicas each, 48 requests of
    4-token prompts and max_new=6, one every 2 ticks) on the full-width
    model.  Gates: all 48 complete with 6 tokens each in [0, padded_vocab),
    probes a decision 11 (pod) or 16 (full), route_commit launched once a
    submit, every hidden state finite, and the engine's router equal to a
    CPU router fed the same draws (the plain ``route_commit_ref``) at the
    engine's own shapes: sel and sel_cls after every submit, Q and W after
    every submit and every complete.  ``bounds(B)`` gives the decode
    call's bounds, [(label, ms, bytes)] (``decode_bound`` unless given).
    Returns the launches."""
    from unittest import mock

    import repro_torch.serve.engine as engine_mod
    from repro_torch.core import PodSpec
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import decode_step
    from repro_torch.sched import (FleetTopology, PodRouter, SharedDraws, TorchRouterDraws,
                                   service_rates)
    from repro_torch.serve import Request, ServeEngine

    fleet, rates = FleetTopology(n_replicas=SERVE_REPLICAS, n_pods=SERVE_PODS), service_rates()
    label = f"serve {policy} {cfg.name} ({cfg.n_layers} layers, {cfg.dtype})"
    shared = SharedDraws(TorchRouterDraws(seed, dev, PodSpec(2, 6)))
    cpu = PodRouter(fleet, rates, policy=policy, device="cpu", draws=shared.echo("cpu"))
    checks = {"route": 0, "complete": 0}

    class CheckedRouter(PodRouter):
        """The engine's router on the card, with the CPU router in step."""

        def _same_state(self, what: str):
            if not (torch.equal(self.Q.cpu(), cpu.Q) and torch.equal(self.W.cpu(), cpu.W)):
                fail(f"{label}: after {what} {checks[what]}: Q / W differ from the CPU router")

        def route(self, locals_):
            sel = super().route(locals_)
            if not (np.array_equal(cpu.route(locals_), sel)
                    and np.array_equal(cpu.last_classes, self.last_classes)):
                fail(f"{label}: submit {checks['route']}: sel / sel_cls differ from the "
                     f"CPU router")
            self._same_state("route")
            checks["route"] += 1
            return sel

        def complete(self, replica_ids, classes):
            super().complete(replica_ids, classes)
            cpu.complete(replica_ids, classes)
            self._same_state("complete")
            checks["complete"] += 1

    decode_ms, nonfinite = {}, [0]

    def finite_decode_step(*a, **kw):
        h, cache = decode_step(*a, **kw)
        nonfinite[0] += int((~torch.isfinite(h)).sum())
        return h, cache

    router = CheckedRouter(fleet, rates, policy=policy, device=dev, draws=shared)
    rng = np.random.default_rng(seed)
    homes = {i: rng.choice(SERVE_REPLICAS, size=3, replace=False)
             for i in range(SERVE_PREFIXES)}
    eng = ServeEngine(cfg, params, fleet, router, homes, max_batch=4, seed=seed)
    decode = eng._decode

    def timed_decode(params, cache, tok, pos):
        """The engine's own decode, timed by batch size."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(params, cache, tok, pos)
        torch.cuda.synchronize()
        decode_ms.setdefault(tok.shape[0], []).append((time.perf_counter() - t0) * 1e3)
        return out
    eng._decode = timed_decode
    reqs = [Request(rid=i, prefix_id=int(rng.integers(0, SERVE_PREFIXES)),
                    prompt=rng.integers(0, cfg.vocab, size=SERVE_PROMPT),
                    max_new=SERVE_NEW, arrival=i * SERVE_EVERY)
            for i in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    submits = 0
    with mock.patch.object(engine_mod, "decode_step", finite_decode_step):
        for t in range(0, SERVE_REQUESTS * SERVE_EVERY, SERVE_EVERY):
            wave = [r for r in reqs if r.arrival == t]
            if wave:
                eng.tick = t
                eng.submit(wave)
                submits += 1
                eng.step()
        stats = eng.run(until_done=len(reqs), max_ticks=3000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    name = f"route_commit_{policy}"
    if counts[name] != submits or sum(counts.values()) != submits:
        fail(f"{label}: launches {counts}, expected {submits} of {name} (one a submit)")
    if checks != {"route": submits, "complete": len(reqs)}:
        fail(f"{label}: the CPU router checked {checks}, expected {submits} submits and "
             f"{len(reqs)} completes")
    if len(eng.done) != len(reqs) or any(
            len(r.generated) != SERVE_NEW or not all(0 <= t < cfg.padded_vocab
                                                    for t in r.generated)
            for r in eng.done):
        fail(f"{label}: {len(eng.done)} of {len(reqs)} done, or a bad token")
    want = 11 if policy == "pod" else SERVE_REPLICAS
    if stats.probes_per_decision != want:
        fail(f"{label}: {stats.probes_per_decision} probes a decision, expected {want}")
    if nonfinite[0]:
        fail(f"{label}: {nonfinite[0]} non-finite hidden values")
    tokens = sum(len(r.generated) for r in eng.done)
    bounds = bounds or (lambda B: [("bound", *decode_bound(cfg, params, B))])
    per_b = []
    for B in sorted(decode_ms):
        ms = np.array(decode_ms[B])
        bs = ", ".join(f"{name} {b_ms:.3f} ms, {moved / 1e9:.3f} GB"
                       for name, b_ms, moved in bounds(B))
        per_b.append(f"B={B}: {len(ms)} calls, mean {ms.mean():.3f} ms, median "
                     f"{np.median(ms):.3f} ms ({bs})")
    log(f"  {label}: {len(eng.done)} requests, {tokens} tokens in {eng.tick} ticks, "
        f"wall {wall:.2f}s (with the CPU router's checks), tokens/s={tokens / wall:.2f}; "
        f"locality {np.round(stats.locality, 4).tolist()}; completion ticks "
        f"p50={stats.latency_p50:.2f} p95={stats.latency_p95:.2f}; "
        f"probes/decision={stats.probes_per_decision:g}; launches={counts[name]} "
        f"({submits} submits); router equal to the CPU router after {checks['route']} "
        f"submits and {checks['complete']} completes (sel, sel_cls, Q, W); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"  {label}: decode a call: " + "; ".join(per_b))
    return counts[name]


def run_serving(dev) -> dict:
    """Phase 7: the router at fleet width, then full-width llama3-8b decode
    parity and serving.  Returns the launches."""
    from repro_torch.configs import get
    from repro_torch.models import init_params

    launches = {"route_commit_full": 0, "route_commit_pod": 0}
    for M, K in SERVE_FLEETS:
        for policy in ("pod", "full"):
            launches[f"route_commit_{policy}"] += route_fleet(dev, M, K, policy)
    cfg = get("llama3_8b")
    check_decode_parity(dev, cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = tree_bytes(params) // params["embed"]["tok"].element_size()
    log(f"  {cfg.name}: {n / 1e9:.3f} B parameters, {tree_bytes(params) / 1e9:.3f} GB in "
        f"{cfg.dtype}, random init on the card in {time.perf_counter() - t0:.2f}s")
    for policy in ("pod", "full"):
        launches[f"route_commit_{policy}"] += serve_model(dev, cfg, params, policy)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 8: training
# ---------------------------------------------------------------------------

# llama3-8b at full width, depth cut to 4 of 32 layers (PERF.md §4): the
# 32-layer state with float32 moments (~96 GB) does not fit one 80 GB card
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARM = 4, 8, 2048, 10, 3
TRAIN_RUNS = (("float32", 1), ("float32", 4), ("int8", 1))   # moments, microbatches
PARITY_LAYERS, PARITY_S = 2, 1024
RESUME_SCRIPT = Path(__file__).resolve().parent / "scripts" / "train_resume_check.py"


def train_config():
    """llama3-8b's CONFIG (bfloat16, remat on) at TRAIN_LAYERS layers."""
    from repro_torch.configs import get
    return get("llama3_8b").replace(n_layers=TRAIN_LAYERS)


def train_batches(steps: int, vocab: int, S: int, B: int, seed: int = 0) -> list:
    from repro_torch.data import PipelineConfig, SyntheticLM
    pipe = SyntheticLM(PipelineConfig(vocab=vocab, seq_len=S, global_batch=B, seed=seed))
    return [pipe.next_batch() for _ in range(steps)]


def tree_nbytes(tree) -> int:
    from repro_torch import pytree
    return sum(t.numel() * t.element_size() for t in pytree.leaves(tree))


def train_bound(cfg, state, B: int, S: int):
    """(least ms, "operations" or "bytes", model FLOPs, bytes) of one
    train_step of B x S tokens.  Operations: 6 x the matmul parameters
    (each layer's attention and MLP weights and the output head; the
    embedding is a gather) x tokens, plus attention as the port computes
    it, masked blocks included: 4 B Hp S^2 hd a layer in the forward and 10
    in the backward (s recomputed, dp, dq, dk, dv); remat's recompute is
    not counted.  Bytes: the state (params and moments) read once and
    written once, the batch read once.  The larger of the two times at
    989 TFLOP/s (dense bfloat16) and 3.35 TB/s."""
    p = state.params
    head = p["embed"].get("head", p["embed"]["tok"])
    mm = sum(t.numel() for part in ("attn", "mlp")
             for t in p["layers"][part].values()) + head.numel()
    flops = 6 * mm * B * S + 14 * B * cfg.padded_heads * S * S \
        * cfg.resolved_head_dim * cfg.n_layers
    moved = 2 * tree_nbytes(state) + 2 * B * S * 4
    ops_ms, bytes_ms = flops / BF16_OPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), \
        flops, moved


def train_full_width(dev, cfg, batches: list, moment_dtype: str, microbatches: int) -> dict:
    """Phase 8, one run: ``init_train_state`` on the card, then a
    ``train_step`` a batch, each timed on the host clock between
    synchronisations.  Gates: every loss finite, the last below the
    first."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, train_step

    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100, moment_dtype=moment_dtype)
    label = (f"train {cfg.name} {cfg.n_layers} layers {cfg.dtype} B={TRAIN_B} S={TRAIN_S}, "
             f"{moment_dtype} moments, microbatches={microbatches}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    state = init_train_state(cfg, ocfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b_ms, b_by, flops, moved = train_bound(cfg, state, TRAIN_B, TRAIN_S)
    ms, losses, gnorms = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, b, cfg=cfg, opt_cfg=ocfg, microbatches=microbatches)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = float(np.median(ms[TRAIN_WARM:]))
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()) or not losses[-1] < losses[0]:
        fail(f"{label}: losses {losses}, grad norms {gnorms}: not finite or not falling")
    tok_s = TRAIN_B * TRAIN_S / med * 1e3
    log(f"  {label}: init {init_s:.2f}s; step ms median {med:.2f} (steps {TRAIN_WARM}.."
        f"{len(ms) - 1}; all {', '.join(f'{x:.1f}' for x in ms)}); tokens/s {tok_s:.1f}; "
        f"bound {b_ms:.2f} ms by {b_by} ({flops / 1e12:.2f} TFLOP, {moved / 1e9:.2f} GB), "
        f"share {b_ms / med:.4f}; peak memory {peak:.3f} GiB ({before:.3f} GiB allocated "
        f"before the run, {tree_nbytes(state) / 2 ** 30:.3f} GiB of state); loss "
        f"{losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; grad norm {gnorms[0]:.4f} -> {gnorms[-1]:.4f}")
    del state
    torch.cuda.empty_cache()
    return {"moments": moment_dtype, "microbatches": microbatches, "step_ms": med,
            "tokens_per_s": tok_s, "bound_ms": b_ms, "bound_by": b_by,
            "peak_gib": peak, "first_loss": losses[0], "last_loss": losses[-1],
            "grad_norm": gnorms[-1], "init_s": init_s}


def check_train_parity(dev, cfg) -> None:
    """Phase 8: one ``train_step`` on the card against the port's CPU path
    from the same state, at llama3-8b's width with PARITY_LAYERS layers in
    float32 (TF32 off), B=1, S=PARITY_S.  Loss and grad norm within 1e-4
    relative; every gradient leaf within 1e-4 of its largest magnitude,
    read from the first moment after the step (m = (1 - b1) * clip * g,
    so the comparison is the gradients')."""
    from repro_torch import pytree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, train_step

    c = cfg.replace(n_layers=PARITY_LAYERS, dtype="float32")
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    card = init_train_state(c, ocfg, 1, device=dev)
    host = pytree.tree_map(lambda t: t.cpu(), card)
    b = train_batches(1, c.vocab, PARITY_S, 1)[0]
    t0 = time.perf_counter()
    card, m_card = train_step(card, b, cfg=c, opt_cfg=ocfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host, m_cpu = train_step(host, b, cfg=c, opt_cfg=ocfg)
    t2 = time.perf_counter()
    errs = {k: abs(float(m_card[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
            for k in ("loss", "grad_norm")}
    worst, where = 0.0, ""
    paths, leaves, _ = pytree.flatten_with_paths(host.opt.m)
    for p, a, h in zip(paths, pytree.leaves(card.opt.m), leaves):
        e = float((a.cpu() - h).abs().max() / h.abs().max().clamp_min(1e-30))
        if e > worst:
            worst, where = e, p
    if max(errs.values()) > 1e-4 or worst > 1e-4:
        fail(f"train parity: loss / grad norm {errs}, worst gradient leaf {where} {worst:.3e} "
             f"(> 1e-4)")
    log(f"  train parity {c.name} width, {PARITY_LAYERS} layers, float32, B=1 S={PARITY_S}: "
        f"card against CPU from the same state: loss {float(m_card['loss']):.6f} "
        f"({errs['loss']:.3e} apart), grad norm {float(m_card['grad_norm']):.6f} "
        f"({errs['grad_norm']:.3e}), every gradient leaf within {worst:.3e} of its largest "
        f"magnitude ({where}) (all <= 1e-4); card {t1 - t0:.2f}s, CPU {t2 - t1:.2f}s")
    del card, host
    torch.cuda.empty_cache()


def check_train_resume() -> dict:
    """Phase 8: ``scripts/train_resume_check.py`` in a process of its own
    (CUBLAS_WORKSPACE_CONFIG must be set before cuBLAS starts; it sets
    torch.use_deterministic_algorithms): the smoke-config Trainer's crash
    at step 13 and resume from step 12 equal to 20 straight steps bit for
    bit, the port's last checkpoint restored byte for byte, and the shard
    balancer's straggler starved."""
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        r = subprocess.run([sys.executable, str(RESUME_SCRIPT), d], capture_output=True,
                           text=True, timeout=600, env=env)
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        fail(f"train resume check exit {r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
    res = json.loads(lines[-1])
    rs, bal = res["resume"], res["balance"]
    log(f"  trainer llama3-8b smoke on {rs['device']}, deterministic: 20 straight steps against "
        f"a crash at 13 and a resume from step {rs['start_step']}: losses equal bit for bit "
        f"({rs['resumed_losses_equal']}); loss {rs['first_loss']:.4f} -> {rs['last_loss']:.4f}; "
        f"step ms median {rs['step_ms_median']:.2f}; the port's step-20 checkpoint "
        f"({rs['codec']}) restored, {rs['leaves_byte_equal']} of {rs['leaves']} leaves "
        f"byte-equal; {rs['seconds']:.1f}s")
    log(f"  shard balancer (examples/train_checkpoint_restart.py phase 3): shards "
        f"{bal['shards']}, straggler {bal['straggler']} against a healthy mean "
        f"{bal['healthy_mean']:.2f}, probes/decision {bal['probes_per_decision']:.2f}")
    return res


def run_training(dev) -> dict:
    """Phase 8: llama3-8b at full width (TRAIN_LAYERS layers) under the
    three optimizer settings, the float32 parity, the resume check."""
    cfg = train_config()
    t0 = time.perf_counter()
    batches = train_batches(TRAIN_STEPS, cfg.vocab, TRAIN_S, TRAIN_B)
    log(f"  SyntheticLM(vocab={cfg.vocab}, seq_len={TRAIN_S}, global_batch={TRAIN_B}): "
        f"{TRAIN_STEPS} batches in {time.perf_counter() - t0:.2f}s on the host")
    runs = [train_full_width(dev, cfg, batches, md, mb) for md, mb in TRAIN_RUNS]
    check_train_parity(dev, cfg)
    resume = check_train_resume()
    summary = {"runs": runs, "resume": resume["resume"]["resumed_losses_equal"]}
    log(f"  training summary: {json.dumps(summary)}")
    return summary


# ---------------------------------------------------------------------------
# Phase 9: the moe, vlm, encdec, hybrid and ssm families
# ---------------------------------------------------------------------------

FAM_B, FAM_S, FAM_DECODE = 2, 512, 8           # prefill rows and tokens; decode steps
FULL_FAMILIES = ("internvl2_2b", "whisper_large_v3", "zamba2_2_7b", "rwkv6_7b")
# card against CPU at full width, float32: the depth each runs at
PARITY_DEPTHS = {"deepseek_moe_16b": dict(n_layers=2), "internvl2_2b": dict(n_layers=2),
                 "whisper_large_v3": dict(n_layers=2, n_enc_layers=2),
                 "zamba2_2_7b": dict(n_layers=6), "rwkv6_7b": dict(n_layers=2)}
PARITY_FAM_S, PARITY_FAM_STEPS = 64, 4
EQUIV_ARCHS, EQUIV_S = ("rwkv6_7b", "zamba2_2_7b", "deepseek_moe_16b"), 16
TRAIN_FAMILIES = ("deepseek_moe_16b", "zamba2_2_7b", "rwkv6_7b")


def family_batch(cfg, B: int, S: int, dev, seed: int = 0) -> dict:
    """tokens [B, S] and the embeddings the family reads (vlm: its image
    tokens; encdec: S encoder frames), scaled 0.02 as the reference's
    tests draw them, on ``dev``."""
    gen = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, dtype=torch.int32)}
    if cfg.family == "vlm":
        b["img_embeds"] = torch.randn((B, cfg.n_img_tokens, cfg.d_model), generator=gen) * 0.02
    if cfg.family == "encdec":
        b["enc_embeds"] = torch.randn((B, S, cfg.d_model), generator=gen) * 0.02
    return {k: v.to(dev) for k, v in b.items()}


def populated_cache(cfg, B: int, S: int, dev, seed: int = 0):
    """A cache of S positions whose every field holds random values (the
    recurrent states scaled 0.3), drawn on the host: the same on any
    device."""
    from repro_torch.models import init_cache

    gen = torch.Generator().manual_seed(seed)
    cache = init_cache(cfg, B, S, device="cpu")
    return type(cache)(*(
        (torch.randn(t.shape, generator=gen) * (0.3 if n in ("ssm", "wkv") else 1.0)
         ).to(dtype=t.dtype, device=dev) if t.numel() else t.to(dev)
        for n, t in zip(cache._fields, cache)))


def prefill_tokens(cfg) -> int:
    """FAM_S text tokens, or more where the image tokens come first: the
    flash attention's q_block (512) must divide a sequence longer than it,
    in the reference too, so vlm's 256 image tokens take 768 text tokens
    (1 024 positions)."""
    n = FAM_S + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    return FAM_S + (-n % cfg.q_block if n > cfg.q_block else 0)


def prefill_and_decode(dev, cfg, params, label: str) -> dict:
    """One prefill ``forward`` of FAM_B x prefill_tokens(cfg) (timed after a first
    call), then FAM_DECODE greedy ``decode_step`` calls from a populated
    cache at the prefill's length, each timed between synchronisations.  Gates:
    finite hidden states of the right shapes."""
    from repro_torch.models import decode_step, forward, logits_fn

    S = prefill_tokens(cfg)
    batch = family_batch(cfg, FAM_B, S, dev)
    S_out = S + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    with torch.no_grad():
        forward(params, cfg, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, aux = forward(params, cfg, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if h.shape != (FAM_B, S_out, cfg.d_model) or not torch.isfinite(h).all():
            fail(f"{label}: prefill hidden {tuple(h.shape)} or not finite")
        cache = populated_cache(cfg, FAM_B, S_out + FAM_DECODE, dev)
        pos = torch.full((FAM_B,), S_out, dtype=torch.int32, device=dev)
        tok = batch["tokens"][:, -1:]
        ms = []
        for _ in range(FAM_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hd, cache = decode_step(params, cfg, cache, tok, pos)
            tok = logits_fn(params["embed"], hd)[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if hd.shape != (FAM_B, 1, cfg.d_model) or not torch.isfinite(hd).all():
                fail(f"{label}: decode hidden {tuple(hd.shape)} or not finite")
            pos = pos + 1
    return {"prefill_ms": prefill_ms, "decode_ms": ms, "lb_loss": float(aux["lb_loss"]),
            "z_loss": float(aux["z_loss"]), "S": S}


def moe_active_bound(cfg, params, B: int, S: int = 16):
    """(least ms, bytes) of a decode call that reads only the experts its
    B tokens route to: every weight but the routed experts', at most
    min(E, top-k x B) routed experts a layer, the head, B embedding rows
    and the cache, over the memory rate."""
    moe = params["layers"]["moe"]
    routed = sum(tree_bytes(moe[k]) for k in ("w1", "w3", "w2"))
    _, all_bytes = decode_bound(cfg, params, B, S)
    moved = all_bytes - routed + routed * min(cfg.n_experts, cfg.experts_per_token * B) \
        / cfg.n_experts
    return moved / HBM_BYTES_PER_S * 1e3, moved


def run_moe_serving(dev) -> dict:
    """Phase 9, deepseek-moe-16b at full width (all 28 layers, bfloat16,
    random init on the card): a prefill, then the engine under the pod
    policy on the example's workload, with phase 7's gates; decode ms a
    call beside the all-expert bound (the reference's dispatch runs every
    expert at C >= 8) and the active-parameter bound.  Returns the
    launches."""
    from repro_torch.configs import get
    from repro_torch.models import init_params

    from repro_torch import pytree

    cfg = get("deepseek_moe_16b")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(params))
    log(f"  {cfg.name}: {n / 1e9:.3f} B parameters, {tree_bytes(params) / 1e9:.3f} GB "
        f"(bfloat16, the routers float32), random init on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    r = prefill_and_decode(dev, cfg, params, cfg.name)
    log(f"  {cfg.name} prefill B={FAM_B} S={FAM_S}: {r['prefill_ms']:.2f} ms; aux lb_loss "
        f"{r['lb_loss']:.6f} z_loss {r['z_loss']:.6f}; decode B={FAM_B} from a populated "
        f"cache: median {np.median(r['decode_ms']):.2f} ms a step")

    def bounds(B):
        return [("all-expert bound", *decode_bound(cfg, params, B)),
                ("active-parameter bound", *moe_active_bound(cfg, params, B))]

    launches = serve_model(dev, cfg, params, "pod", bounds=bounds)
    log(f"  {cfg.name}: {time.perf_counter() - t0:.1f}s in all")
    del params
    torch.cuda.empty_cache()
    return {"route_commit_pod": launches}


def run_full_families(dev) -> None:
    """Phase 9: internvl2-2b, whisper-large-v3, zamba2-2.7b and rwkv6-7b
    at full width and depth (bfloat16, random init on the card), one at a
    time: a prefill and FAM_DECODE decode steps; then kimi-k2 at its
    smoke config."""
    from repro_torch.configs import get
    from repro_torch.models import init_params

    for name in FULL_FAMILIES + ("kimi_k2_1t_a32b",):
        cfg = get(name, smoke=name == "kimi_k2_1t_a32b")
        t0 = time.perf_counter()
        params = init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        r = prefill_and_decode(dev, cfg, params, cfg.name)
        extra = {"vlm": f" + {cfg.n_img_tokens} image tokens",
                 "encdec": f" + {r['S']} encoder frames"}.get(cfg.family, "")
        enc = f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else ""
        log(f"  {cfg.name} ({cfg.family}, {cfg.n_layers} layers{enc}, "
            f"{tree_bytes(params) / 1e9:.3f} GB): init {init_s:.2f}s; prefill B={FAM_B} "
            f"S={r['S']}{extra}: {r['prefill_ms']:.2f} ms; decode {FAM_DECODE} steps: median "
            f"{np.median(r['decode_ms']):.2f} ms a step (all "
            f"{', '.join(f'{x:.1f}' for x in r['decode_ms'])}); finite"
            + (f"; aux lb_loss {r['lb_loss']:.6f}" if cfg.family == "moe" else "")
            + f"; {time.perf_counter() - t0:.1f}s in all")
        del params
        torch.cuda.empty_cache()


def check_family_parity(dev) -> None:
    """Phase 9: each family at full width and PARITY_DEPTHS depth, float32
    (TF32 off), the card against the CPU from the same parameters: a
    ``forward`` of 2 x PARITY_FAM_S tokens and PARITY_FAM_STEPS
    ``decode_step`` calls from the same populated cache; hidden states
    (and the MoE aux losses) within 1e-4 of the largest magnitude."""
    from repro_torch.configs import get
    from repro_torch.models import decode_step, forward, init_params

    for name, depth in PARITY_DEPTHS.items():
        cfg = get(name).replace(dtype="float32", **depth)
        t0 = time.perf_counter()
        params = init_params(cfg, 7, device=dev)
        host = to_device(params, "cpu")
        errs = {}
        with torch.no_grad():
            b = family_batch(cfg, 2, PARITY_FAM_S, "cpu", seed=1)
            h_card, a_card = forward(params, cfg, to_device(b, dev))
            h_cpu, a_cpu = forward(host, cfg, b)
            errs["forward"] = float((h_card.cpu() - h_cpu).abs().max() / h_cpu.abs().max())
            if cfg.family == "moe":
                errs["aux"] = max(abs(float(a_card[k]) - float(a_cpu[k])) / abs(float(a_cpu[k]))
                                  for k in a_cpu)
            S_out = h_cpu.shape[1]
            cpu_cache = populated_cache(cfg, 2, S_out + PARITY_FAM_STEPS, "cpu", 2)
            card_cache = populated_cache(cfg, 2, S_out + PARITY_FAM_STEPS, dev, 2)
            pos = torch.tensor([S_out, S_out - 9], dtype=torch.int32)
            tok = b["tokens"][:, -1:]
            for step in range(PARITY_FAM_STEPS):
                hc, card_cache = decode_step(params, cfg, card_cache, tok.to(dev), pos.to(dev))
                hh, cpu_cache = decode_step(host, cfg, cpu_cache, tok, pos)
                errs[f"decode {step}"] = float((hc.cpu() - hh).abs().max() / hh.abs().max())
                tok, pos = (tok * 7 + 3) % cfg.vocab, pos + 1
        worst = max(errs.values())
        if not torch.isfinite(h_card).all() or worst > 1e-4:
            fail(f"family parity {name}: {errs} (> 1e-4)")
        log(f"  parity {cfg.name} ({cfg.family}) full width, {depth}, float32: card against "
            f"CPU, forward S={PARITY_FAM_S} {errs['forward']:.3e}"
            + (f", aux {errs['aux']:.3e}" if "aux" in errs else "")
            + f", {PARITY_FAM_STEPS} decode steps <= "
            f"{max(v for k, v in errs.items() if k.startswith('decode')):.3e} of the largest "
            f"magnitude (<= 1e-4); {time.perf_counter() - t0:.1f}s")
        del params, host
        torch.cuda.empty_cache()


def check_prefill_decode_equivalence(dev) -> None:
    """Phase 9, the reference's property (tests/test_models.py:64-86) on
    the card: a float32 ``forward`` over EQUIV_S tokens equals EQUIV_S
    ``decode_step`` calls from an empty cache, within 1e-4 of the largest
    magnitude, at full width (2 layers; zamba2 one group of 6 mamba layers
    and the shared block), remat off, capacity factor 16 (no drop)."""
    from repro_torch.configs import get
    from repro_torch.models import decode_step, forward, init_cache, init_params

    for name in EQUIV_ARCHS:
        t0 = time.perf_counter()
        cfg = get(name).replace(remat=False, dtype="float32", capacity_factor=16.0,
                                **PARITY_DEPTHS[name])
        params = init_params(cfg, 2, device=dev)
        tokens = family_batch(cfg, 2, EQUIV_S, dev, seed=3)["tokens"]
        with torch.no_grad():
            h_fwd, _ = forward(params, cfg, {"tokens": tokens})
            cache = init_cache(cfg, 2, EQUIV_S, device=dev)
            hs = []
            for t in range(EQUIV_S):
                h, cache = decode_step(params, cfg, cache, tokens[:, t:t + 1],
                                       torch.full((2,), t, dtype=torch.int32, device=dev))
                hs.append(h[:, 0])
        err = float((torch.stack(hs, 1) - h_fwd).abs().max() / h_fwd.abs().max())
        if not err < 1e-4:
            fail(f"prefill -> decode {name}: {err:.3e} apart (>= 1e-4)")
        log(f"  prefill -> decode {cfg.name} full width, {PARITY_DEPTHS[name]}, float32: "
            f"forward over {EQUIV_S} tokens against {EQUIV_S} decode steps {err:.3e} "
            f"(< 1e-4); {time.perf_counter() - t0:.1f}s")
        del params
        torch.cuda.empty_cache()


def check_family_train_parity(dev) -> None:
    """Phase 9: one float32 ``train_step`` of the moe, hybrid and ssm
    families at smoke width, the card against the CPU from the same
    state: loss, grad norm and every gradient leaf (read from the first
    moment) within 1e-4, as phase 8's parity."""
    from repro_torch import pytree
    from repro_torch.configs import get
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, train_step

    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    for name in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = get(name, smoke=True).replace(dtype="float32")
        card = init_train_state(cfg, ocfg, 1, device=dev)
        host = pytree.tree_map(lambda t: t.cpu(), card)
        b = train_batches(1, cfg.vocab, 64, 4)[0]
        card, m_card = train_step(card, b, cfg=cfg, opt_cfg=ocfg)
        host, m_cpu = train_step(host, b, cfg=cfg, opt_cfg=ocfg)
        keys = ("loss", "grad_norm", "lb_loss", "z_loss")
        errs = {k: abs(float(m_card[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-30)
                for k in keys if float(m_cpu[k]) != 0.0}
        worst, where = 0.0, ""
        paths, leaves, _ = pytree.flatten_with_paths(host.opt.m)
        for p, a, h in zip(paths, pytree.leaves(card.opt.m), leaves):
            e = float((a.cpu() - h).abs().max() / h.abs().max().clamp_min(1e-30))
            if e > worst:
                worst, where = e, p
        if max(errs.values()) > 1e-4 or worst > 1e-4:
            fail(f"train parity {name}: {errs}, worst gradient leaf {where} {worst:.3e}")
        log(f"  train parity {cfg.name} ({cfg.family}) smoke width, float32: loss "
            f"{float(m_card['loss']):.6f}, {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
            f"apart; every gradient leaf within {worst:.3e} ({where}) (all <= 1e-4); "
            f"{time.perf_counter() - t0:.1f}s")


def run_families(dev) -> dict:
    """Phase 9: deepseek-moe-16b served at full width, the other families
    at full width and depth, card-CPU parity, prefill -> decode
    equivalence and the train steps.  Returns the launches."""
    launches = run_moe_serving(dev)
    run_full_families(dev)
    check_family_parity(dev)
    check_prefill_decode_equivalence(dev)
    check_family_train_parity(dev)
    return launches


# ---------------------------------------------------------------------------
# Phase 10: sharding, launch and roofline
# ---------------------------------------------------------------------------

SRC = Path(__file__).resolve().parent / "src"
# runs ``python -m repro_torch.launch.serve`` (runpy, as -m does) with the
# launch counters zeroed before and printed after
SERVE_CHILD = r"""
import json, runpy, sys
from repro_torch.kernels import LAUNCHES, reset_launch_counts
sys.argv = ["repro_torch.launch.serve"] + sys.argv[1:]
reset_launch_counts()
runpy.run_module("repro_torch.launch.serve", run_name="__main__", alter_sys=True)
print("LAUNCHES " + json.dumps(LAUNCHES))
"""
SERVE_LINE = (r"\[serve\] (\d+) requests done; mean completion ([0-9.]+) ticks \(p95 (\d+)\); "
              r"locality \[([0-9., ]+)\]; probes/decision ([0-9.]+) \((\w+)\)")
DRYRUN_CELL = ("deepseek_moe_16b", "train_4k", "pod")      # tests/test_distributed.py:66
DRYRUN_CHILD = r"""
import json, sys, tempfile
from repro_torch.launch.dryrun import run_cell
with tempfile.TemporaryDirectory() as d:
    rec = run_cell(sys.argv[1], sys.argv[2], sys.argv[3], d)
print("DRYRUN " + json.dumps(rec))
"""
H100_HBM_BYTES = 80e9


def child(args: list, timeout: float) -> tuple:
    """(stdout, seconds) of a child Python process with the port on its
    path; a non-zero exit fails the phase."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                       timeout=timeout, env=env)
    if r.returncode != 0:
        fail(f"{' '.join(args[:3])} exit {r.returncode}: {r.stdout[-2000:]} {r.stderr[-3000:]}")
    return r.stdout, time.perf_counter() - t0


def run_launchers() -> dict:
    """Phase 10 (a, b): ``python -m repro_torch.launch.serve --arch
    llama3_8b`` at full width with the reference's defaults (32 requests,
    8 replicas, 2 pods, pod policy, 8 new tokens), and ``launch.train``
    on the smoke config for 20 steps, each in a child process on the
    card.  Returns the serve child's route_commit launches."""
    import re

    out, secs = child(["-c", SERVE_CHILD, "--arch", "llama3_8b"], 600)
    m = re.search(SERVE_LINE, out)
    counts = [l for l in out.splitlines() if l.startswith("LAUNCHES ")]
    if not m or not counts or int(m.group(1)) != 32 or m.group(6) != "pod":
        fail(f"launch.serve: no line of 32 requests under pod: {out[-2000:]}")
    launches = json.loads(counts[-1][len("LAUNCHES "):])
    if launches["route_commit_pod"] < 1 or launches["route_commit_full"]:
        fail(f"launch.serve: route_commit launches {launches}")
    log(f"  python -m repro_torch.launch.serve --arch llama3_8b (full width, 32 layers, "
        f"bfloat16; 32 requests, 8 replicas, 2 pods, pod, max_new 8): {m.group(0)}; "
        f"route_commit_pod launched {launches['route_commit_pod']} times; {secs:.1f}s")
    with tempfile.TemporaryDirectory() as d:
        out, secs = child(["-m", "repro_torch.launch.train", "--arch", "llama3_8b", "--smoke",
                           "--steps", "20", "--ckpt-dir", d], 600)
    first = re.search(r"\[trainer\] step\s+0 loss ([0-9.naif]+)", out)
    last = re.search(r"\[train\] done: final loss ([0-9.naif]+), mean step (\d+) ms", out)
    if not first or not last:
        fail(f"launch.train: no loss lines: {out[-2000:]}")
    l0, l1 = float(first.group(1)), float(last.group(1))
    if not (np.isfinite(l0) and np.isfinite(l1) and l1 < l0):
        fail(f"launch.train: loss {l0} -> {l1}: not finite or not falling")
    log(f"  python -m repro_torch.launch.train --arch llama3_8b --smoke --steps 20: loss "
        f"{l0:.4f} -> {l1:.4f}, mean step {last.group(2)} ms; {secs:.1f}s")
    return {"route_commit_pod": launches["route_commit_pod"]}


def leaf_gaps(a_tree, b_tree) -> dict:
    """{path: (max |a - b|, max |b|)} over two trees' leaves (a's DTensor
    leaves as full tensors), on the host."""
    from repro_torch import pytree
    out = {}
    paths, leaves, _ = pytree.flatten_with_paths(a_tree)
    for p, a, b in zip(paths, leaves, pytree.leaves(b_tree)):
        a = (a.full_tensor() if hasattr(a, "full_tensor") else a).detach().float().cpu()
        b = b.detach().float().cpu()
        out[p] = (float((a - b).abs().max()), float(b.abs().max()))
    return out


def check_sharded_step(dev) -> None:
    """Phase 10 (c): an nccl group of one rank and a (1, 1) ("data",
    "model") mesh on the card; phase 8's float32 parity step (llama3-8b
    width, PARITY_LAYERS layers, B=1, S=PARITY_S) with params, moments and
    batch as DTensors placed by param_pspecs / opt_pspecs through
    sanitize_spec and param_specs given, against the plain step on the card
    from the same state.  Gates: loss and grad norm within 1e-5, every
    moment leaf within 1e-5 of its largest magnitude, every parameter
    within 2 lr (Adam's first update moves by up to 2 lr where |g| ~ eps;
    the entries more than 1e-5 apart are counted).  Then ring_allreduce_q8
    and a one-stage pipeline_forward at axis size 1."""
    import torch.distributed as dist

    from repro_torch import pytree
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import param_pspecs
    from repro_torch.models.sharding import logical_pspec, set_rules, use_mesh
    from repro_torch.optim import AdamWConfig, opt_pspecs
    from repro_torch.train import (TrainState, init_train_state, pipeline_forward,
                                   ring_allreduce_q8, train_step)

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        set_rules(mesh_axes=("data", "model"))
        c = train_config().replace(n_layers=PARITY_LAYERS, dtype="float32")
        ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in train_batches(1, c.vocab, PARITY_S, 1)[0].items()}
        state = init_train_state(c, ocfg, 1, device=dev)
        host0 = pytree.tree_map(lambda t: t.cpu(), state)
        t0 = time.perf_counter()
        plain, m_plain = train_step(state, b, cfg=c, opt_cfg=ocfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain_host = pytree.tree_map(lambda t: t.cpu(), plain)
        metrics_plain = {k: float(v) for k, v in m_plain.items()}
        del state, plain, m_plain
        torch.cuda.empty_cache()
        specs = TrainState(params=param_pspecs(c), opt=opt_pspecs(param_pspecs(c), ocfg))
        sharded = S.shard_tree(pytree.tree_map(lambda t: t.to(dev), host0), specs, mesh)
        sb = S.shard_tree(b, {k: logical_pspec("batch", None) for k in b}, mesh)
        t2 = time.perf_counter()
        new, m = train_step(sharded, sb, cfg=c, opt_cfg=ocfg, param_specs=param_pspecs(c))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        placed = {str(t.placements) for t in pytree.leaves(new.params)}
        metrics = {k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
                   for k, v in m.items()}
        errs = {k: abs(metrics[k] - metrics_plain[k]) / max(abs(metrics_plain[k]), 1e-30)
                for k in ("loss", "grad_norm")}
        gaps = leaf_gaps(new, plain_host)
        del new, sharded
        torch.cuda.empty_cache()
        worst_moment = max((d / max(s, 1e-30), p) for p, (d, s) in gaps.items()
                           if not p.startswith(".params"))
        worst_param = max((d, p) for p, (d, s) in gaps.items() if p.startswith(".params"))
        if max(errs.values()) > 1e-5 or worst_moment[0] > 1e-5 or worst_param[0] > 2 * ocfg.lr:
            fail(f"sharded step: loss / grad norm {errs}, worst moment {worst_moment}, "
                 f"worst parameter {worst_param}")
        log(f"  sharded train_step on a (1, 1) nccl mesh ({c.name} width, {PARITY_LAYERS} "
            f"layers, float32, B=1 S={PARITY_S}; placements {sorted(placed)}) against the "
            f"plain step on the card from the same state: loss {metrics['loss']:.6f} "
            f"({errs['loss']:.3e} apart), grad norm {metrics['grad_norm']:.6f} "
            f"({errs['grad_norm']:.3e}); worst moment leaf {worst_moment[1]} "
            f"{worst_moment[0]:.3e} of its largest magnitude; worst parameter "
            f"{worst_param[1]} {worst_param[0]:.3e} apart (lr {ocfg.lr}); plain "
            f"{t1 - t0:.2f}s, sharded {t3 - t2:.2f}s")

        x = torch.randn(4096, device=dev)
        with use_mesh(mesh):
            if ring_allreduce_q8(x, "data") is not x:
                fail("ring_allreduce_q8 at axis size 1 did not return its input")
        gen = torch.Generator(device=dev).manual_seed(0)
        W = torch.randn(8, 256, 256, device=dev, generator=gen) * 0.05
        bias = torch.randn(8, 256, device=dev, generator=gen) * 0.1
        h0 = torch.randn(64, 256, device=dev, generator=gen)

        def layer(p, h):
            return torch.tanh(h @ p["w"] + p["b"])

        out = pipeline_forward(layer, {"w": W, "b": bias}, h0, mesh=mesh, axis="data",
                               n_micro=4)
        ref = h0
        for i in range(8):
            ref = layer({"w": W[i], "b": bias[i]}, ref)
        gap = float((out - ref).abs().max())
        if gap > 1e-5:
            fail(f"one-stage pipeline_forward {gap} from the layer loop")
        log(f"  ring_allreduce_q8 over an axis of 1 returned its input; a one-stage "
            f"pipeline_forward (8 layers of 256, B=64, 4 microbatches) within {gap:.3e} "
            f"of the layer loop")
    finally:
        dist.destroy_process_group()


def analytic_ms(cc) -> tuple:
    """(ms, bound by) of an analytic CellCost at the H100's peaks."""
    ops, moved = cc.flops_computed / BF16_OPS_PER_S * 1e3, cc.hbm_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops, moved), ("operations" if ops >= moved else "bytes")


def check_dryrun(dev) -> None:
    """Phase 10 (d): the dry run against the card.  Phase 8's training cell
    (llama3-8b at TRAIN_LAYERS layers, B=TRAIN_B, S=TRAIN_S, float32
    moments, one microbatch) traced on a one-device fake mesh: its argument
    bytes must be the real state's and batch's on the card, exactly, and
    its FLOPs FlopCounterMode's count of one real step on the card; its
    predicted peak beside the measured one.  roofline.analytic's cell cost
    beside the smoke's own train_bound and decode_bound."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import pytree
    from repro_torch.configs import get
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import use_mesh
    from repro_torch.roofline import analytic
    from repro_torch.train import init_train_state, train_step

    cfg = train_config().replace(train_microbatches=1)
    shape = ShapeSpec("phase8", TRAIN_S, TRAIN_B, "train")
    t0 = time.perf_counter()
    D.fake_world(1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        S.rules_for(cfg, shape, mesh)
        with use_mesh(mesh):
            rec = D.trace_cell(cfg, shape, mesh)
    finally:
        dist.destroy_process_group()
    t1 = time.perf_counter()
    ocfg = S.opt_config_for(cfg)
    state = init_train_state(cfg, ocfg, 0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in train_batches(1, cfg.vocab, TRAIN_S, TRAIN_B)[0].items()}
    real = D.local_bytes(state) + D.local_bytes(batch)
    mem = rec["memory"]
    if mem["argument_size_in_bytes"] != real:
        fail(f"dry run argument bytes {mem['argument_size_in_bytes']} != the card's {real}")
    b_ms, b_by, b_flops, b_moved = train_bound(cfg, state, TRAIN_B, TRAIN_S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        state, _ = train_step(state, batch, cfg=cfg, opt_cfg=ocfg, microbatches=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counted = fc.get_total_flops()
    if rec["cost"]["flops"] != counted:
        fail(f"dry run FLOPs {rec['cost']['flops']} != FlopCounterMode's {counted} on the card")
    cc = analytic.cell_cost(cfg, shape)
    a_ms, a_by = analytic_ms(cc)
    log(f"  dry run of phase 8's cell ({cfg.name}, {cfg.n_layers} layers, B={TRAIN_B} "
        f"S={TRAIN_S}, float32 moments, one microbatch) on a one-device fake mesh, traced "
        f"at 1 and 2 layers in {t1 - t0:.1f}s: argument bytes {mem['argument_size_in_bytes']} "
        f"= the card's state and batch {real}; FLOPs {rec['cost']['flops']:.6e} = "
        f"FlopCounterMode on the card {counted:.6e}; predicted peak "
        f"{mem['peak_memory_in_bytes'] / 2 ** 30:.3f} GiB against the card's "
        f"max_memory_allocated {peak / 2 ** 30:.3f} GiB ({before / 2 ** 30:.3f} GiB "
        f"allocated before the step)")
    log(f"  analytic.cell_cost of that cell: {cc.flops_computed:.6e} FLOPs computed "
        f"({cc.flops_useful:.6e} useful), {cc.hbm_bytes / 1e9:.3f} GB of HBM traffic: "
        f"{a_ms:.2f} ms by {a_by} at 989 TFLOP/s / 3.35 TB/s, against train_bound "
        f"{b_ms:.2f} ms by {b_by} ({b_flops:.6e} FLOPs, {b_moved / 1e9:.3f} GB): the "
        f"analytic model counts remat's extra forward and {cfg.train_microbatches + 3} "
        f"reads of the params and activation traffic; train_bound does not")
    del state, batch
    torch.cuda.empty_cache()
    full = get("llama3_8b")
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import init_params
    with FakeTensorMode():
        fake = init_params(full, 0, device="cpu")
    for B in (1, 8):
        d_ms, d_moved = decode_bound(full, fake, B)
        dc = analytic.cell_cost(full, ShapeSpec(f"decode{B}", 16, B, "decode"))
        e_ms, e_by = analytic_ms(dc)
        log(f"  decode {full.name} B={B}, a 16-slot cache: analytic {e_ms:.3f} ms by {e_by} "
            f"({dc.hbm_bytes / 1e9:.3f} GB, {dc.flops_computed:.4e} FLOPs) against "
            f"decode_bound {d_ms:.3f} ms ({d_moved / 1e9:.3f} GB): the analytic model adds "
            f"activation traffic (8 bf16 vectors a layer) and reads every weight")


def report_production_cell(out: str, secs: float) -> None:
    """Phase 10 (d): the reference's dry-run cell on the production
    (16, 16) mesh, as the child process traced it."""
    lines = [l for l in out.splitlines() if l.startswith("DRYRUN ")]
    if not lines:
        fail(f"dry run {DRYRUN_CELL}: no record: {out[-2000:]}")
    r = json.loads(lines[-1][len("DRYRUN "):])
    m, col = r["memory"], r["collectives"]
    if "skipped" in r or m["argument_size_in_bytes"] <= 0 or col["total_wire_bytes"] <= 0 \
            or col["unknown_trip_conditions"] != 0:
        fail(f"dry run {DRYRUN_CELL}: {r}")
    log(f"  dry run {' x '.join(DRYRUN_CELL)} on the production (16, 16) mesh, rank 0 of "
        f"{r['n_devices']} (a child process on the host, beside the phase; trace "
        f"{r['timings']['trace_s']:.1f}s, {secs:.1f}s in all): arguments "
        f"{m['argument_size_in_bytes'] / 1e9:.3f} GB, peak {m['peak_memory_in_bytes'] / 1e9:.3f} "
        f"GB a device against one H100's 80 GB ({m['peak_memory_in_bytes'] / H100_HBM_BYTES:.3f}); "
        f"{r['cost']['flops']:.4e} FLOPs a device; collective wire bytes "
        f"{col['total_wire_bytes'] / 1e9:.3f} GB a device "
        f"({ {k: int(v) for k, v in col['counts'].items() if v} }); gathers "
        f"{r['notes']['gathers']}")


def run_sharding(dev) -> dict:
    """Phase 10: the launchers, the sharded step on a one-rank nccl mesh,
    the ring and the pipeline at axis size 1, the dry run against the
    card; the production-mesh dry-run cell traces in a child process
    meanwhile (it needs the host only).  Returns the launches."""
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD, *DRYRUN_CELL],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        launches = run_launchers()
        check_sharded_step(dev)
        check_dryrun(dev)
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"dry run {DRYRUN_CELL} exit {proc.returncode}: {err[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    report_production_cell(out, time.perf_counter() - t0)
    return launches


def profile_training(dev) -> None:
    """Where a full-width train_step's time and memory go, for float32 and
    int8 moments (microbatches 1): the gradients (forward and backward,
    ``train_step``'s own ``_grads``) and the update (``apply_update``)
    timed apart between synchronisations, each one's peak memory above
    what was allocated before it, then one whole step under
    torch.profiler."""
    from repro_torch.optim import AdamWConfig, apply_update
    from repro_torch.train import init_train_state, train_step
    from repro_torch.train.train_step import _grads, _on

    cfg = train_config()
    b = train_batches(1, cfg.vocab, TRAIN_S, TRAIN_B)[0]
    for moments in ("float32", "int8"):
        ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100, moment_dtype=moments)
        box = [init_train_state(cfg, ocfg, 0, device=dev)]
        batch = _on(b, dev)
        parts = {}
        for rep in range(3):                      # the last of three counts
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            grads, _ = _grads(box[0].params, cfg, batch, 1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            parts["grads"] = ((t1 - t0) * 1e3, (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                              base / 2 ** 30)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            params, opt, _ = apply_update(box[0].params, grads, box[0].opt, ocfg)
            torch.cuda.synchronize()
            parts["update"] = ((time.perf_counter() - t1) * 1e3,
                               (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                               base / 2 ** 30)
            box[0] = box[0]._replace(params=params, opt=opt)
            del grads, params, opt
        log(f"  train_step parts {cfg.name} {cfg.n_layers} layers, {moments} moments: state "
            f"{tree_nbytes(box[0]) / 2 ** 30:.3f} GiB; " + "; ".join(
                f"{k} {ms:.2f} ms, peak {gib:.3f} GiB above the {start:.3f} GiB allocated "
                f"at its start" for k, (ms, gib, start) in parts.items()))

        def run():
            box[0], m = train_step(box[0], b, cfg=cfg, opt_cfg=ocfg)
            float(m["loss"])
        profile_run(f"train_step {cfg.name} {cfg.n_layers} layers B={TRAIN_B} S={TRAIN_S} "
                    f"{moments} moments (bound "
                    f"{train_bound(cfg, box[0], TRAIN_B, TRAIN_S)[0]:.2f} ms)", run, 1,
                    unit="step")
        del box
        torch.cuda.empty_cache()


def profile_run(label: str, run, slots: int, unit: str = "slot") -> None:
    """torch.profiler over one call of ``run`` (``slots`` slots, or other
    ``unit``s, warmed by a first call): wall per slot, device busy time per
    slot, the device's idle share, kernel launches per slot, route_commit's
    device time per slot and the top kernels."""
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
    log(f"  profile {label}, {slots} {unit}s: "
        f"wall/{unit}={wall / slots * 1e3:.4f} ms "
        f"device_busy/{unit}={busy / slots * 1e3:.4f} ms "
        f"idle_share={1 - busy / wall:.4f} "
        f"kernels/{unit}={len(kern) / slots:.1f} "
        f"route_commit_us/{unit}={rc / slots:.3f}")
    for name, us in top:
        log(f"    {us / slots:9.3f} us/{unit}  {name[:90]}")



def profile_serving(dev, calls: int = 50, decodes: int = 10) -> None:
    """Where the serving path's time goes: ``calls`` route calls of
    SERVE_B requests (pod and full, at each of SERVE_FLEETS), each under
    torch.profiler (wall, device busy, idle share, kernels a call, top
    kernels), and ``decodes`` llama3-8b decode calls (``profile_decode``)."""
    from repro_torch.core import Cluster, sample_locals
    from repro_torch.sched import FleetTopology, PodRouter, service_rates

    for M, K in SERVE_FLEETS:
        gen = torch.Generator().manual_seed(M)
        homes = [sample_locals(gen, Cluster(M, K), SERVE_B).numpy() for _ in range(calls)]
        for policy in ("pod", "full"):
            router = PodRouter(FleetTopology(n_replicas=M, n_pods=K), service_rates(),
                               policy=policy, device=dev)
            profile_run(f"router {policy} M={M} K={K} B={SERVE_B}",
                        lambda: [router.route(h) for h in homes], calls, unit="call")
    profile_decode(dev, "llama3_8b", decodes)


def profile_decode(dev, name: str, decodes: int = 10) -> None:
    """``decodes`` decode calls of ``name`` at full width (bfloat16:
    decode_step, logits, argmax) at B=1 and B=4 against a 16-slot cache,
    under torch.profiler, beside the call's bound (a MoE model's: all
    experts read, and the active parameters')."""
    from repro_torch.configs import get
    from repro_torch.models import decode_step, init_cache, init_params, logits_fn

    cfg = get(name)
    params = init_params(cfg, 0, device=dev)
    for B in (1, 4):
        cache = init_cache(cfg, B, 16, device=dev)
        tok = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
        pos = torch.full((B,), 5, dtype=torch.int32, device=dev)

        def run():
            for _ in range(decodes):
                h, _ = decode_step(params, cfg, cache, tok, pos)
                torch.argmax(logits_fn(params["embed"], h)[:, 0], dim=-1)
        bound = f"bound {decode_bound(cfg, params, B)[0]:.3f} ms"
        if cfg.family == "moe":
            bound += f", active-parameter bound {moe_active_bound(cfg, params, B)[0]:.3f} ms"
        profile_run(f"decode {cfg.name} B={B} ({bound})", run, decodes, unit="call")
    del params
    torch.cuda.empty_cache()

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
    day at phase 6's arrival rate (REPLAY_TASKS in REPLAY_T slots)."""
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
                         "goes (and a route call's and a decode call's), "
                         "route_commit at every valid-prefix length, "
                         "the snapshot kernels, the complexity table and the "
                         "tick's route -> queue_update sequence")
    ap.add_argument("--training", action="store_true",
                    help="only phases 1 and 8 (with --profile: only the "
                         "training step's profile)")
    ap.add_argument("--sharding", action="store_true",
                    help="only phases 1 and 10 (sharding, launch and roofline)")
    ap.add_argument("--families", action="store_true",
                    help="only phases 1 and 9 (the moe, vlm, encdec, hybrid "
                         "and ssm families; with --profile: only the "
                         "deepseek-moe-16b decode's profile)")
    args = ap.parse_args()
    start = time.perf_counter()

    def stage(msg: str) -> None:
        log(f"{msg} (at {time.perf_counter() - start:.0f} s)")

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
    if args.sharding:
        stage("[10] sharding, launch and roofline")
        run_sharding(dev)
        stage("phases 1 and 10 passed")
        return 0
    if args.families:
        if args.profile:
            profile_decode(dev, "deepseek_moe_16b")
        else:
            stage("[9] families: deepseek-moe-16b served, the others at full width, parity")
            run_families(dev)
        return 0
    if args.training:
        if args.profile:
            profile_training(dev)
        else:
            stage("[8] training: llama3-8b at full width, parity, resume")
            run_training(dev)
        return 0
    if args.profile:
        profile_training(dev)
        profile_slots(dev)
        profile_telemetry(dev)
        profile_serving(dev)
        profile_decode(dev, "deepseek_moe_16b")
        sweep_route_commit(dev)
        time_snapshot_kernels(dev, False, floor)
        complexity_per_decision(dev, False)
        tick_times(dev, False)
        return 0

    stage("[2] kernels against their plain versions")
    rows = check_kernels(dev, args.quick)
    jsq_rows, jsq_err = check_jsq_operand(dev, args.quick)
    cell_rows, cell_err = check_batched_route_commit(dev, args.quick)
    err = check_snapshot_kernels(dev)
    snap = time_snapshot_kernels(dev, args.quick, floor)
    stage("[3] simulator")
    check_small_run_matches_cpu(dev)
    launches = run_simulations(dev, args.quick)
    stage("[3] the grid entry points: simulate_grid and simulate_sweep")
    check_grid_equals_looped(dev)
    for name, n in run_grids(dev, args.quick).items():
        launches[name] += n
    stage("[4] complexity (paper §IV-C): probes per routing decision")
    complexity_probes()
    stage("[4] time per routing decision, O(M) weighted_argmin against O(d) "
        "pod_route (ratio = BP / BP-Pod)")
    complexity_per_decision(dev, args.quick)
    stage("[4] the tick's route -> queue_update sequence, device time")
    tick_times(dev, args.quick)
    stage("[4] snapshot routing ticks")
    launches.update(routing_ticks(dev))
    stage("[5] telemetry: the collectors on the card")
    for name, n in run_telemetry(dev).items():
        launches[name] += n
    stage("[6] trace: production_day and ReplayEngine")
    for name, n in run_trace(dev).items():
        launches[name] += n
    stage("[7] serving: PodRouter at fleet width, llama3-8b decode parity and ServeEngine")
    for name, n in run_serving(dev).items():
        launches[name] += n
    stage("[8] training: llama3-8b at full width, card-CPU parity, Trainer resume")
    run_training(dev)
    stage("[9] families: deepseek-moe-16b served at full width through PodRouter and "
          "ServeEngine, internvl2 / whisper / zamba2 / rwkv6 at full width, kimi-k2 at "
          "smoke width, card-CPU parity, prefill -> decode, train steps")
    for name, n in run_families(dev).items():
        launches[name] += n
    stage("[10] sharding, launch and roofline: the launchers, a sharded step, the dry run")
    for name, n in run_sharding(dev).items():
        launches[name] += n
    stage("every phase passed")

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
