"""The program's host spans in a traced window (``repro_torch.spans``,
recorded on the profiler's clock beside the device's operations): the
device's idle time inside a layer's spans, and the spans' own time.

The names are the program's, copied here so that a reader runs without
importing it; ``portbench/test_portbench_spans.py`` holds them to the
program's ``SPANS``.  Every reader returns None where the window holds
none of its spans, as in a program that records none, or no operation of
the device.
"""

DRAWS = ("sim.draws",)
STEP = ("sim.step.service", "sim.step.schedule", "sim.step.accumulate",
        "sim.step.telemetry", "sim.scenario.speed")
ROUTE = ("sim.step.route",)
GRID = ("sim.grid.realize", "sim.grid.cells", "sim.grid.summarize")
NAMES = DRAWS + STEP + ROUTE + GRID


def intervals(trace, names) -> list:
    """The host spans named ``names``, clipped to the window: (start, end)
    in us, by start; none in a trace without device operations."""
    if not trace.device:
        return []
    lo, hi = trace.window
    out = [(max(a, lo), min(b, hi)) for n, a, b in trace.host if n in names]
    return sorted((a, b) for a, b in out if b > a)


def union(ivs) -> list:
    """Sorted disjoint [start, end] covering the sorted intervals ``ivs``."""
    out = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(xs, ys) -> float:
    """The length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_s(trace, names):
    """Seconds of the device's idle time inside the union of the spans
    ``names``; None without such a span."""
    ivs = intervals(trace, names)
    if not ivs:
        return None
    return overlap_us(trace.gaps(), union(ivs)) * 1e-6


def idle_share(trace, names):
    """``idle_s`` over the window (share)."""
    s = idle_s(trace, names)
    return None if s is None or trace.window_s <= 0 else s / trace.window_s


def span_ms(trace, names):
    """The summed duration of the spans ``names`` in the window (ms)."""
    ivs = intervals(trace, names)
    return sum(b - a for a, b in ivs) * 1e-3 if ivs else None
