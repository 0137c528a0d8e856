"""route_commit_pod_roofline.sim: route_commit_pod's share of its roofline
in a simulation grid (%), from the device trace and the frozen bound."""
from portbench.metrics._roofline import share


def read(trace):
    return share(trace, "route_commit_pod")
