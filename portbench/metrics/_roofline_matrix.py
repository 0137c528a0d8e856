"""The frozen bound of routing launches whose cells each read their own
[M, 3] inverse rates, and the kernel's roofline share against it.

``bounds.route_commit``'s count of a Pod launch (``portbench/bounds.py``),
except that every cell that routes reads its float32 [M, 3] inverse rates
(12 M bytes) where the [3] vector is read once a launch."""
import numpy as np

from portbench import bounds


def route_commit_pod(M: int, B: int, C: int, live) -> float:
    """Least seconds of a run of Pod routing launches, one a slot, over
    cells of M servers with B arrival slots and C candidates each; ``live``
    [slots, cells] the arrivals each cell routes in each slot.  Per cell
    that routes: the int32 [M, 3] queues in and out, the [B] mask, the
    float32 [M] workloads and its [M, 3] inverse rates; per live arrival
    three outputs and its candidates' index and validity; the int32
    candidate classes up to the widest cell's live rows.  Operations: the
    workloads (5 a server) and a multiply and an add a scored candidate."""
    live = np.asarray(live, np.int64)
    rows, cells = live.sum(axis=1), (live > 0).sum(axis=1)
    per_cell = 12 * M + B + 12 * M + 4 * M + 12 * M
    nbytes = cells * per_cell + 12 * rows + 5 * rows * C + 4 * live.max(axis=1) * C
    return float(bounds.bound_s(nbytes, cells * 5 * M + 2 * rows * C).sum())


def share(trace, kernel: str):
    """The bound over ``kernel``'s profiled time in the window (%); None
    unless the traced call routed with it at the [M, 3] operand."""
    work = trace.route_commit
    if work.get("kernel") != kernel or not work.get("matrix"):
        return None
    lo, hi = trace.window
    times = [b - a for name, a, b in trace.kernels() if kernel in name and lo <= a <= hi]
    if not times:
        return None
    least = route_commit_pod(work["M"], work["B"], work["C"], work["live"])
    return 100.0 * least / (sum(times) * 1e-6)
