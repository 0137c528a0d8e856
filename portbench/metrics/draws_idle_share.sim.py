"""draws_idle_share.sim: the device's idle time inside the program's
``sim.draws`` spans (a slot's draws: the cells' block fills, their stack,
full BP's class grid) over the traced window (share)."""
from portbench.metrics._spans import DRAWS, idle_share


def read(trace):
    return idle_share(trace, DRAWS)
