"""Attention's share of its roofline (%): the operations of the slice's
attention products (``q k^T`` and the weights times ``v`` of every block of
every clip the program classified, ``counts/ast.py``) at the dense peak of
the configuration's precision, over the device time of the attention
kernels ``F.scaled_dot_product_attention`` launched, found by name (flash,
memory-efficient or cuDNN attention); None where there are none."""

from counts import ast, peaks

NAMES = ("flash", "fmha", "attention", "sdpa")


def read(trace):
    clips = trace.work.get("clips")
    kernels = [e for e in trace.device if any(n in e["name"].lower() for n in NAMES)]
    if not clips or not kernels:
        return None
    seconds = sum(float(e["dur"]) for e in kernels) / 1e6
    floor = clips * ast.attention_flops(trace.config["model"]) / peaks.FLOPS[trace.config["precision"]]
    return 100.0 * floor / seconds
