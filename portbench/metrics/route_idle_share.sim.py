"""route_idle_share.sim: the device's idle time inside the program's
``sim.step.route`` spans (a slot's arrival batch and its routing, the
``route_commit`` wrapper and launch among it) over the traced window
(share)."""
from portbench.metrics._spans import ROUTE, idle_share


def read(trace):
    return idle_share(trace, ROUTE)
