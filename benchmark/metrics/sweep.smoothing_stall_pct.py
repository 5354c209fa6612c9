"""The share of the sweep's profiled slice (%) in which the device runs
nothing while the program smooths: the innermost open program span is a
``smoothing/*`` span (``spans.py``): the run-table launches, their
read-back, the host's min-length filter and its overflow fallback."""

import spans


def read(trace):
    return spans.stall_pct(trace, lambda name: name.startswith("smoothing/"))
