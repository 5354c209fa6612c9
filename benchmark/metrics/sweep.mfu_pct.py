"""The sweep's share of the card's peak (%): the operations of the
network's fully convolutional form for each output frame of the slice
(``counts/resnet.py``: no implementation of the same outputs needs fewer),
over the slice's wall time, against the dense peak of the configuration's
precision (``counts/peaks.py``)."""

from counts import peaks, resnet


def read(trace):
    frames = trace.work.get("frames")
    if not frames or not trace.device:
        return None
    feat = trace.config["features"]
    per_frame = resnet.fully_conv_flops_per_frame(trace.config["model"], feat["window"],
                                                  feat["num_filters"])
    return 100.0 * frames * per_frame / trace.wall_s / peaks.FLOPS[trace.config["precision"]]
