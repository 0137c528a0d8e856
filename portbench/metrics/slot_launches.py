"""slot_launches: device kernels in the traced window over its slot steps
(kernels/slot).  The slot loop's launches are host time on the main path:
fewer a slot is what capturing the loop has to show."""


def read(trace):
    lo, hi = trace.window
    n = sum(1 for _, a, _ in trace.kernels() if lo <= a <= hi)
    return n / trace.slot_steps if trace.slot_steps and n else None
