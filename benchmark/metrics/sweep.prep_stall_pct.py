"""The share of the sweep's profiled slice (%) in which the device runs
nothing while the program readies its input: the innermost open program
span is ``sweep/decode``, ``sweep/prepare``, ``sweep/batch`` or
``sweep/upload`` (``spans.py``).  Staging the next bucket batch while the
current one runs would shrink it."""

import spans

READS = ("sweep/decode", "sweep/prepare", "sweep/batch", "sweep/upload")


def read(trace):
    return spans.stall_pct(trace, lambda name: name in READS)
