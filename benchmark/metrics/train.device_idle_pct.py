"""The device's idle share of the training's profiled slice (%): 1 - the union
of its device ops' intervals over the slice's wall time."""


def read(trace):
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.wall_s)
