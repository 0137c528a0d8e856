"""The routing kernel's roofline share over a traced window: the frozen
bound of the traced call's routing work (its live arrivals, slot by slot)
over the kernel's profiled device time, in percent.  None where the kernel
did not run or the cell routes with the other variant."""
from portbench import bounds


def share(trace, kernel: str):
    work = trace.route_commit
    if work.get("kernel") != kernel:
        return None
    lo, hi = trace.window
    times = [b - a for name, a, b in trace.kernels() if kernel in name and lo <= a <= hi]
    if not times:
        return None
    least = bounds.route_commit(work["M"], work["B"], work["C"], work["live"])
    return 100.0 * least / (sum(times) * 1e-6)
