"""Reduction of a ``torch.profiler`` trace of the traced window to what the
per-layer readers and the result's ``breakdown`` need.

A ``Trace`` holds plain intervals in microseconds: the window (the
benchmark's own span around the traced call), every device operation in it
(kernels, copies and fills), and the host operations, which say what the
host was doing while the device idled.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

SPAN = "portbench.call"
_NAME = 160               # characters of an operation's name in the breakdown
_NOT_KERNELS = ("Memcpy", "Memset")


class Trace(NamedTuple):
    window: tuple            # (start, end) of the traced span, us
    device: list             # [(name, start, end)] device operations, by start
    host: list               # [(name, start, end)] host operations, by start
    slot_steps: int          # slot steps the span ran
    route_commit: dict       # the traced call's routing work (driver.route_commit_work)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self) -> list:
        """Device operations that are kernels (not copies or fills)."""
        return [e for e in self.device if not e[0].startswith(_NOT_KERNELS)]

    def busy(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window: sorted disjoint (start, end)."""
        lo, hi = self.window
        out = []
        for _, a, b in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def gaps(self) -> list:
        """The device's idle intervals inside the window."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy() for x in iv] + [hi]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        time by the innermost host operation open when each gap began."""
        ops = defaultdict(float)
        for name, a, b in self.device:
            ops[name] += (b - a) * 1e-6
        idle = defaultdict(float)
        starts = [e[1] for e in self.host]
        for a, b in self.gaps():
            idle[self._host_at(a, starts)] += (b - a) * 1e-6
        rank = lambda d: [[k[:_NAME], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}

    def _host_at(self, t: float, starts: list) -> str:
        i = bisect.bisect_right(starts, t) - 1
        # the latest-starting operation still open at t is the innermost
        for name, a, b in reversed(self.host[max(0, i - 64):i + 1]):
            if a <= t <= b:
                return name
        return "host (no operation)"


def from_profile(prof, slot_steps: int, route_commit: dict) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile`` whose window is
    the benchmark's ``SPAN``.  Reads the profiler's raw events, which costs
    a fraction of building its per-event Python objects."""
    window, device, host = None, [], []
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns() * 1e-3
        b = a + e.duration_ns() * 1e-3
        if name == SPAN:            # the host's span, and its copy on the device's timeline
            if "CUDA" not in str(e.device_type()):
                window = (a, b)
        elif "CUDA" in str(e.device_type()):
            device.append((name, a, b))
        elif not name.startswith("cuda"):       # runtime calls sit inside ops
            host.append((name, a, b))
    if window is None:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return Trace(window, device, host, slot_steps, route_commit)
