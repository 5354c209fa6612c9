"""Device milliseconds of the ops the program launches inside its
``classify/track`` spans (each bucket row's frame mask, cast, pad and the
shared stem's whole-track convs), per audio minute of the sweep's profiled
slice (``spans.py``)."""

import spans


def read(trace):
    return spans.device_ms_per_audio_min(trace, "classify/track")
