"""The benchmark's run: find a cell's files by name, set it up, measure the
window, trace it if asked, compare its answers with the plain reference,
and print the result line.

Everything that belongs to one configuration, traffic mix, driver or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

    portbench/configs/<config>.json    a deployment (the entry's ``file``)
    portbench/traffic/<traffic>.json   the traffic mix and its ``driver``
    portbench/drivers/<driver>.py      ``prepare(config, traffic, seed, device)``
    portbench/metrics/<metric>.py      ``read(trace)``: a number or None

A driver's object runs timed ``call(i)``s (synchronised, returning the work
done), each answering ``cells`` questions; turns work over seconds into its
end-to-end metrics; reports the slot steps and the routing work of a call
for the readers; and ``check``s one timed call against the reference,
answer by answer and gap by gap, under the driver's ``LIMITS``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "repro")      # the JAX package and its stack


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(spec: dict, workload: str, root: Path = ROOT) -> tuple:
    """(workload entry, configuration, traffic, driver module, {metric:
    reader}) of ``workload``, each found by its name."""
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                         f"portbench_driver_{traffic['driver']}")
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py",
                                      f"portbench_metric_{m['name']}")
               for m in spec["per_layer"] if workload in m.get("workloads", [workload])}
    return entry, config, traffic, driver, readers


def banned_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(BANNED))


def window(run, seconds: float, profile=None) -> dict:
    """Back-to-back timed calls for ``seconds``: a call is started only
    while the longest call so far still ends inside the window, so every
    counted call is whole.  With ``profile`` (a profiler factory), the
    first call runs under it, inside the benchmark's span."""
    from portbench import trace as tr
    calls, prof, i = [], None, 0
    t0 = time.perf_counter()
    while True:
        longest = max((b - a for a, b, _ in calls), default=0.0)
        if calls and time.perf_counter() + longest > t0 + seconds:
            break
        a = time.perf_counter()
        if profile is not None and i == 0:
            import torch
            with profile() as prof:
                with torch.profiler.record_function(tr.SPAN):
                    work = run.call(i)
        else:
            work = run.call(i)
        calls.append((a, time.perf_counter(), work))
        log(f"call {i}: {calls[-1][1] - a:.3f} s")
        i += 1
    return {"calls": calls, "prof": prof}


def measure(config, traffic, driver, readers, units: dict, seed: int, seconds: float,
            trace: bool, device, started: float) -> dict:
    """One run of a cell: set-up, window, optional trace, comparison.
    Returns the result object (without the JAX check, which the caller
    makes once the run is over)."""
    import torch
    from portbench import trace as tr

    run = driver.prepare(config, traffic, seed, device)
    setup_s = time.perf_counter() - started
    log(f"set-up {setup_s:.3f} s")
    profile = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profile = lambda: torch.profiler.profile(activities=acts)
    w = window(run, seconds, profile)
    calls = w["calls"]
    cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    metrics, extra = {}, {}
    if trace:
        t0 = time.perf_counter()
        t = tr.from_profile(w["prof"], run.slot_steps(1), run.route_commit_work(0))
        for m in readers:
            v = readers[m].read(t)
            if v is not None:
                metrics[m] = v
        extra = {"busy_s": t.busy_s(), "window_s": t.window_s}
        breakdown = t.breakdown()
        log(f"trace of {len(t.device)} device and {len(t.host)} host operations "
            f"read in {time.perf_counter() - t0:.1f} s")
    else:
        work = sum(c[2] for c in calls)
        for k, v in run.end_to_end(work, calls[-1][1] - calls[0][0]).items():
            metrics[k] = v
        metrics["setup_s"] = setup_s
    del w
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gaps = run.check(np.random.default_rng([seed, 0xC0FFEE]))
    log(f"reference compared in {time.perf_counter() - t0:.1f} s")
    checks = {k: {"value": max(v), "limit": driver.LIMITS[k]} for k, v in gaps.items()}
    # an answer fails when any of its gaps is over that gap's limit (or NaN)
    bad = [any(not g <= driver.LIMITS[k] for k, g in zip(gaps, row))
           for row in zip(*gaps.values())]
    out = {
        "correct": not any(bad),
        "attempted": len(calls) * run.cells,
        "failed": sum(bad),
        "metrics": {k: {"value": v, "unit": units.get(k, "")} for k, v in metrics.items()},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak, **extra},
    }
    if trace:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(args, started: float) -> int:
    spec = load_spec()
    entry, config, traffic, driver, readers = find(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: the cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    out = measure(config, traffic, driver, readers, units, args.seed, args.seconds,
                  bool(args.trace), "cuda:0", started)
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
