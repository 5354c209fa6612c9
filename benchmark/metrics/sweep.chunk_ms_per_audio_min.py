"""Device milliseconds of the ops the program launches inside its
``classify/chunk`` spans (each chunk's windows: the shared stem's bands,
splices, strided tail and the head, and the splice of the chunks), per
audio minute of the sweep's profiled slice (``spans.py``)."""

import spans


def read(trace):
    return spans.device_ms_per_audio_min(trace, "classify/chunk")
