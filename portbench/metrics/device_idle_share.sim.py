"""device_idle_share.sim: 1 - the union of the device operations'
intervals over the traced window (share).  How far the host holds the card
back in a simulation grid."""


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s() / trace.window_s
