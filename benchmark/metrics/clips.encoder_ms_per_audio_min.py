"""Device milliseconds of the ops the program launches inside its
``classify/encoder`` spans (the transformer blocks and the final norm of
each batch of clips), per audio minute of the clips sweep's profiled slice
(``spans.py``)."""

import spans


def read(trace):
    return spans.device_ms_per_audio_min(trace, "classify/encoder")
