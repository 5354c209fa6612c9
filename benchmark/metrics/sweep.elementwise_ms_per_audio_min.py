"""Device milliseconds of the kinds the port's ``kernel_kind`` calls
elementwise (BatchNorm, ReLU, pads, bias adds, casts, fills, gathers: the
ops that are not convs, layout transposes, splices, copies or the fbank
kernel), per audio minute of the sweep's profiled slice."""

from harness import kernel_kind


def read(trace):
    audio_s = trace.work.get("audio_s")
    if not audio_s or not trace.device:
        return None
    ms = sum(ms for name, (_, ms) in trace.device_ms_by_name().items()
             if kernel_kind(name) == "elementwise")
    return ms / (audio_s / 60.0)
