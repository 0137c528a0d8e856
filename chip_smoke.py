"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py            # the full check (one card)
    python3 chip_smoke.py --quick    # a short first run: build, kernels, T/20

Phases (any failure exits non-zero; the result lines print only at the end):
  1. device and build: the card's name, count and power limit; nvcc builds
     every kernel of the main path from src/repro_torch/kernels/csrc/.
  2. kernels against their plain PyTorch versions on the card, at the main
     path's shapes, with homogeneous and heterogeneous (dead-entry) rates
     and tie-forcing queues; outputs must be equal to the bit.  Each is timed
     with CUDA events beside its bound and its plain version's time.
  3. the simulator on the card: the port's own CPU path and its CUDA path,
     fed the same draws, must give bit-identical sums at a small size; then
     Balanced-Pandas and BP-Pod at paper scale (M=500) and at M=5000.  The
     launch counters are zeroed just before each run and read just after:
     route_commit must launch once per slot.
It prints the kernels' JSON line, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 peak outside tensor cores
CU_SOURCE = "src/repro_torch/kernels/csrc/route_commit.cu"
REPLACES = {"route_commit_full": "src/repro/kernels/route_commit.py:93",
            "route_commit_pod": "src/repro/kernels/route_commit.py:176"}


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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(M: int, B: int, C: int, hetero: bool, seed: int, dev):
    """Tie-forcing inputs: few distinct queue lengths, lattice or pooled
    rates, and (hetero) dead servers and dead rate columns."""
    rng = np.random.default_rng(seed)
    if hetero:
        pool = np.exp(rng.uniform(np.log(1e-2), np.log(1e2), (4, 3)))
        inv = pool[rng.integers(4, size=M)].astype(np.float32)
        inv[rng.choice(M, size=max(1, M // 8), replace=False)] = np.inf
        inv[rng.random(M) < 0.2, rng.integers(3)] = np.inf
    else:
        inv = np.array([100.0, 200.0, 500.0], np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return dict(
        Q=t(rng.integers(0, 4, (M, 3)).astype(np.int32)),
        valid=t(np.arange(B) < max(1, (3 * B) // 4)),
        inv=t(inv),
        cls=t(rng.integers(0, 3, (B, M)).astype(np.int32)),
        prio=t(rng.permutation(M).astype(np.int32)),
        cand_idx=t(rng.integers(0, M, (B, C)).astype(np.int32)),
        cand_cls=t(np.tile(np.array([0] * 3 + [1] * 2 + [2] * (C - 5), np.int32),
                           (B, 1))),
        cand_valid=t(rng.random((B, C)) < 0.9))


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
    nbytes = sum(t.numel() * t.element_size() for t in ins) + out_bytes
    cand = M if variant == "full" else x["cand_idx"].shape[1]
    ops = 5 * M + 2 * B * cand          # W0, then one add + multiply a score
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev, quick: bool) -> dict:
    from repro_torch.kernels import route_commit, route_commit_ref
    from repro_torch.kernels.route_commit import launch

    shapes = [(500, 22, 11), (5000, 90, 11)]
    rows, err = {}, {}
    for M, B, C in shapes:
        for variant in ("full", "pod"):
            for hetero in (False, True):
                for seed in range(3):
                    x = kernel_inputs(M, B, C, hetero, seed, dev)
                    kw = variant_args(x, variant)
                    got = route_commit(x["Q"], x["valid"], x["inv"], **kw)
                    torch.cuda.synchronize()
                    want = route_commit_ref(x["Q"], x["valid"], x["inv"], **kw)
                    for name, a, b in zip(("Q", "W", "sel", "sel_cls", "val"),
                                          got, want):
                        if not torch.equal(a, b):
                            fail(f"route_commit_{variant} M={M} B={B} "
                                 f"hetero={hetero} seed={seed}: {name} differs "
                                 f"from the plain version")
                        if a.is_floating_point() and a.numel():
                            d = (a - b).abs().nan_to_num(0.0)
                            err[(variant, M)] = max(err.get((variant, M), 0.0),
                                                    float(d.max()))
                    log(f"  route_commit_{variant:4s} M={M:5d} B={B:3d} "
                        f"{'hetero' if hetero else 'homo  '} seed={seed}: "
                        f"equal to the plain version")
            # time at the main path's operand (homogeneous [3] rates): the
            # kernel alone into preallocated outputs, then the whole wrapper
            x = kernel_inputs(M, B, C, False, 0, dev)
            kw = variant_args(x, variant)
            outs = tuple(torch.empty_like(o) for o in got)
            iters = 200 if quick else 2000
            k_ms = cuda_time_ms(lambda: launch(x["Q"], x["valid"], x["inv"],
                                               outs, **kw), iters)
            w_ms = cuda_time_ms(lambda: route_commit(x["Q"], x["valid"],
                                                     x["inv"], **kw), iters)
            p_ms = cuda_time_ms(lambda: route_commit_ref(x["Q"], x["valid"],
                                                         x["inv"], **kw),
                                5 if quick else 20, warmup=2)
            b_ms, b_by = bound(x, variant)
            log(f"  route_commit_{variant} M={M} B={B}"
                f"{'' if variant == 'full' else f' C={C}'}: kernel {k_ms:.6f} ms"
                f"  wrapper {w_ms:.6f} ms"
                f"  plain {p_ms:.6f} ms  bound {b_ms:.8f} ms ({b_by})"
                f"  library n/a")
            rows[(variant, M)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                      bound_by=b_by, max_abs_err=err[(variant, M)], B=B)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the simulator
# ---------------------------------------------------------------------------


def check_small_run_matches_cpu(dev):
    """At a small size, the CUDA path and the port's CPU path, fed the
    same draws (made on the CPU), must give the same sums bit for bit."""
    from repro_torch.core import Cluster, Rates, SimConfig, TorchDraws, simulate
    from repro_torch.core.simulator import SlotDraws, _pod_for

    cl, rates = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
    cfg = SimConfig(T=600, warmup=150, route_mode="batched")
    for algo in ("balanced_pandas", "balanced_pandas_pod"):
        pod = _pod_for(algo, None)
        a_max = cfg.resolve_a_max(0.9 * rates.alpha * cl.M)
        results = []
        lam_t = torch.full((cfg.T,), 0.9 * rates.alpha * cl.M)
        for run_dev in ("cpu", dev):
            src = TorchDraws(torch.Generator().manual_seed(5), cl, rates, cfg,
                             pod, a_max, lam_t)

            def draw(t, src=src, run_dev=run_dev):
                return SlotDraws(*(None if v is None else v.to(run_dev)
                                   for v in src(t)))
            results.append(simulate(algo, cl, rates, 0.9, 0, cfg, a_max=a_max,
                                    device=run_dev, draws=draw))
        for name, a, b in zip(results[0]._fields, *results):
            if not torch.equal(a.cpu(), b.cpu()) and not (
                    a.isnan().all() and b.cpu().isnan().all()):
                fail(f"{algo}: {name} differs between CPU and CUDA paths "
                     f"({a} vs {b})")
        log(f"  {algo}: CUDA path equals the CPU path on a small run "
            f"(M=20, T=600, shared draws)")


def run_simulations(dev, quick: bool) -> dict:
    from repro_torch.core import Cluster, Rates, SimConfig, simulate
    from repro_torch.kernels import LAUNCHES, reset_launch_counts

    paper = (Cluster(M=500, K=10), Rates(0.01, 0.005, 0.002))
    big = (Cluster(M=5000, K=50), Rates(0.01, 0.005, 0.002))
    scale = 20 if quick else 1
    runs = [(paper, load, 40_000 // scale, 10_000 // scale)
            for load in (0.5, 0.9)]
    runs.append((big, 0.9, 10_000 // scale, 2_500 // scale))
    launches = {"route_commit_full": 0, "route_commit_pod": 0}
    for (cl, rates), load, T, warmup in runs:
        cfg = SimConfig(T=T, warmup=warmup, route_mode="batched")
        for algo in ("balanced_pandas", "balanced_pandas_pod"):
            name = ("route_commit_full" if algo == "balanced_pandas"
                    else "route_commit_pod")
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            r = simulate(algo, cl, rates, load, 1, cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            launches[name] += counts[name]
            f = lambda x: float(x)
            v = lambda x: [round(float(y), 6) for y in x]
            lam = load * cl.M * rates.alpha
            thr = f(r.throughput) / f(r.arrival_rate_hat)
            log(f"  {algo:20s} M={cl.M} load={load} T={T}: "
                f"mean_completion_slots={f(r.mean_completion_slots):.4f} "
                f"throughput/arrivals={thr:.5f} locality={v(r.locality_fractions)} "
                f"routed={v(r.routed_fractions)} drift={f(r.drift):.4f} "
                f"clip={f(r.clip_fraction):.6f} "
                f"route_candidates={f(r.route_candidates_per_decision):.0f} "
                f"wall={wall:.2f}s slots/s={T / wall:.1f} "
                f"routed_tasks/s={lam * T / wall:.1f} launches={counts}")
            if counts[name] != T:
                fail(f"{algo}: {name} launched {counts[name]} times in {T} slots")
            other = sum(c for k, c in counts.items() if k != name)
            if other:
                fail(f"{algo}: unexpected launches {counts}")
            if not np.isfinite(f(r.mean_completion_slots)):
                fail(f"{algo}: mean completion is not finite")
            if f(r.clip_fraction) != 0.0:
                fail(f"{algo}: arrivals were clipped ({f(r.clip_fraction)})")
            if load == 0.5 and abs(thr - 1.0) > 0.05:
                fail(f"{algo}: throughput {thr:.4f} of arrivals at load 0.5")
    return launches


def profile_slots(dev, slots: int = 400) -> None:
    """Where a slot's time goes on the card: torch.profiler over ``slots``
    slots of each algorithm at paper scale, load 0.9 (a CUDA-graph-free,
    eager loop).  Prints wall per slot, device busy time per slot, the
    device's idle share, kernel launches per slot and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import Cluster, Rates, SimConfig, simulate

    cl, rates = Cluster(M=500, K=10), Rates(0.01, 0.005, 0.002)
    cfg = SimConfig(T=slots, warmup=0, route_mode="batched")
    for algo in ("balanced_pandas", "balanced_pandas_pod"):
        simulate(algo, cl, rates, 0.9, 0, cfg, device=dev)      # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            simulate(algo, cl, rates, 0.9, 0, cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) * 1e-6
        by_name: dict = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"  profile {algo} M=500 load=0.9, {slots} slots: "
            f"wall/slot={wall / slots * 1e3:.4f} ms "
            f"device_busy/slot={busy / slots * 1e3:.4f} ms "
            f"idle_share={1 - busy / wall:.4f} "
            f"kernels/slot={len(kern) / slots:.1f}")
        for name, us in top:
            log(f"    {us / slots:9.3f} us/slot  {name[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="short first run: fewer timing launches, T/20")
    ap.add_argument("--profile", action="store_true",
                    help="only build and profile where a slot's time goes")
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
    lib = build.build("route_commit", verbose=True)
    log(f"[1] built {lib.name} in {time.perf_counter() - t0:.1f} s")
    if args.profile:
        profile_slots(dev)
        return 0

    log("[2] kernels against their plain versions")
    rows = check_kernels(dev, args.quick)
    log("[3] simulator")
    check_small_run_matches_cpu(dev)
    launches = run_simulations(dev, args.quick)

    kernels = []
    for variant in ("full", "pod"):
        name = f"route_commit_{variant}"
        r = rows[(variant, 500)]
        kernels.append(dict(
            name=name, route="cuda", source=CU_SOURCE,
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(rows[(variant, M)]["max_abs_err"]
                            for M in (500, 5000)),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            shape=f"M=500 B={r['B']}" + ("" if variant == "full" else " C=11"),
            ms_m5000=rows[(variant, 5000)]["ms"],
            plain_ms_m5000=rows[(variant, 5000)]["plain_ms"],
            bound_ms_m5000=rows[(variant, 5000)]["bound_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
