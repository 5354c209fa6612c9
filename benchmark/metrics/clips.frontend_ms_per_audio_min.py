"""Device milliseconds of the ops the program launches inside its
``classify/clips`` spans (each bucket batch's frame mask, normalisation,
cast and clip cut; each batch's patch embedding, tokens and positions),
per audio minute of the clips sweep's profiled slice (``spans.py``)."""

import spans


def read(trace):
    return spans.device_ms_per_audio_min(trace, "classify/clips")
