"""eager_slot_share.sim: the traced call's slot steps that ran eagerly over
its slot steps (share).  An eager step records one ``sim.step.service``
span; a step the program replays as a CUDA graph records none.  0.0 where
the device ran and no step span was recorded; None without device
operations."""

SPAN = "sim.step.service"


def read(trace):
    if not trace.device or not trace.slot_steps:
        return None
    lo, hi = trace.window
    n = sum(1 for name, a, _ in trace.host if name == SPAN and lo <= a <= hi)
    return n / trace.slot_steps
