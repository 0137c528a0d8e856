"""step_idle_share.sim: the device's idle time inside the program's slot
step spans (service, scheduling, accumulators, telemetry, a scenario's
speeds) over the traced window (share)."""
from portbench.metrics._spans import STEP, idle_share


def read(trace):
    return idle_share(trace, STEP)
