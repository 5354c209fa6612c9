"""The training step's share of the card's peak (%): each sample's
forward pass, weight gradients and input gradients (all but the stem's),
counted as direct convolution from the shapes (``counts/resnet.py``), over
the slice's wall time, against float32's peak outside the tensor cores
(TF32 is off)."""

from counts import peaks, resnet


def read(trace):
    samples = trace.work.get("samples")
    if not samples or not trace.device:
        return None
    feat = trace.config["features"]
    per_sample = resnet.train_flops(trace.config["model"], feat["window"], feat["num_filters"])
    rate = peaks.FLOPS["tf32" if trace.config["train"]["tf32"] else trace.config["precision"]]
    return 100.0 * samples * per_sample / trace.wall_s / rate
