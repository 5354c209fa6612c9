"""The fbank kernel's share of its roofline (%): the least time the
features need (``counts/fbank.py``: the larger of their operations over
the TF32 tensor peak and their bytes over HBM's bandwidth) over the
kernel's device time, for the launches of the sweep's profiled slice."""

from counts import fbank, peaks
from reference import fbank as ref_fbank


def read(trace):
    kernels = [e for e in trace.device if "fbank_kernel" in e["name"]]
    launch = trace.work.get("fbank_launch")
    if not kernels or not launch or len(kernels) != trace.work.get("fbank_launches"):
        return None
    feat = trace.config["features"]
    nnz = fbank.mel_nonzero(ref_fbank.mel_banks(feat))
    by_ops, by_bytes = fbank.launch_bounds(feat, launch["rows"], launch["samples"],
                                           launch["frames"], nnz, peaks.FLOPS["tf32"],
                                           peaks.HBM_BYTES)
    seconds = sum(float(e["dur"]) for e in kernels) / 1e6
    return 100.0 * len(kernels) * max(by_ops, by_bytes) / seconds
