"""Host milliseconds a step inside the program's ``train/forward``,
``train/backward`` and ``train/optimizer`` regions (its own
``record_function`` annotations), over the training slice's steps."""

REGIONS = ("train/forward", "train/backward", "train/optimizer")


def read(trace):
    steps = trace.work.get("steps")
    spans = [e for r in REGIONS for e in trace.host_spans(r) if e.get("cat") == "user_annotation"]
    if not steps or not spans:
        return None
    return sum(float(e["dur"]) for e in spans) / 1e3 / steps
