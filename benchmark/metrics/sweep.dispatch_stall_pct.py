"""The share of the sweep's profiled slice (%) in which the device runs
nothing while the program launches its work: the innermost open program
span is ``sweep/body``, ``sweep/gather`` or a ``classify/*`` span
(``spans.py``), so the launches do not keep up with the device."""

import spans


def read(trace):
    return spans.stall_pct(
        trace, lambda name: name in ("sweep/body", "sweep/gather") or name.startswith("classify/"))
