"""The clips sweep's share of the card's peak (%): the operations of every
clip the program classified in the slice (its ``clips`` counter, times
``counts/ast.py``'s count of one clip: the patch conv, the linears and
attention's two products), over the slice's wall time, against the dense
peak of the configuration's precision (``counts/peaks.py``)."""

from counts import ast, peaks


def read(trace):
    clips = trace.work.get("clips")
    if not clips or not trace.device:
        return None
    per_clip = ast.clip_flops(trace.config["model"])
    return 100.0 * clips * per_clip / trace.wall_s / peaks.FLOPS[trace.config["precision"]]
