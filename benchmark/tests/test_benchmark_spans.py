"""The readers of the program's spans (``spans.py`` and the five metrics
over it) on synthetic chrome-trace events, on a real CPU trace of the
port's spans, and on the card: spans and kernels share one clock."""

import json
import random

import pytest
import torch
from conftest import BENCH

import harness
import spans

STALLS = ("sweep.prep_stall_pct", "sweep.dispatch_stall_pct", "sweep.smoothing_stall_pct")
DEVICE = ("sweep.track_ms_per_audio_min", "sweep.chunk_ms_per_audio_min")


def _reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py", f"bench_metric_{name}").read


def _span(name, a, b, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "pid": 1, "tid": 1}


def _launch(corr, at):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at, "dur": 1.0,
            "pid": 1, "tid": 1, "args": {"correlation": corr}}


def _kernel(corr, a, b, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": a, "dur": b - a, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def _trace(events, wall_us, audio_s=60.0):
    device = [e for e in events if e.get("cat") in harness.DEVICE_CATEGORIES]
    return harness.Trace(events=events, device=device, wall_s=wall_us / 1e6,
                         work={"audio_s": audio_s}, config={}, traffic={})


def _meeting():
    """One meeting's spans inside the driver's, and three kernels: the
    track's launched at 47 and run at 62-80 (while the chunk's span is
    open), the chunk's launched at 65 and run at 80-88, a smoothing
    kernel launched at 92 and run at 93-94."""
    return [
        _span("bench/pipeline", 0, 90), _span("bench/smoothing", 90, 100),
        _span("sweep/prepare", 0, 20), _span("sweep/batch", 20, 30),
        _span("sweep/upload", 30, 40), _span("sweep/body", 40, 88),
        _span("classify/track", 45, 60), _span("classify/chunk", 60, 85),
        _span("smoothing/runs", 90, 93), _span("smoothing/readback", 93, 96),
        _span("smoothing/filter", 96, 100),
        _span("aten::copy_", 32, 38, cat="cpu_op"),
        _launch(1, 47), _kernel(1, 62, 80), _launch(2, 65), _kernel(2, 80, 88),
        _launch(3, 92), _kernel(3, 93, 94),
    ]


def test_idle_is_put_down_to_the_innermost_span():
    tr = _trace(_meeting(), 100)
    assert spans.idle_intervals(tr) == [(0, 62), (88, 93), (94, 100)]
    assert spans.idle_us_by_span(tr, spans.program_spans(tr)) == {
        "sweep/prepare": 20, "sweep/batch": 10, "sweep/upload": 10, "sweep/body": 5,
        "classify/track": 15, "classify/chunk": 2, "smoothing/runs": 3,
        "smoothing/readback": 2, "smoothing/filter": 4}
    assert _reader("sweep.prep_stall_pct")(tr) == pytest.approx(40.0)
    assert _reader("sweep.dispatch_stall_pct")(tr) == pytest.approx(22.0)
    assert _reader("sweep.smoothing_stall_pct")(tr) == pytest.approx(9.0)


def test_a_span_that_started_later_is_the_innermost_where_two_overlap():
    pieces = spans.innermost([(0, 10, "sweep/body"), (2, 6, "sweep/gather"),
                              (4, 8, "classify/chunk")])
    assert pieces == [(0, 2, "sweep/body"), (2, 4, "sweep/gather"), (4, 8, "classify/chunk"),
                      (8, 10, "sweep/body")]


def test_kernels_are_put_down_by_the_correlation_of_their_launch():
    tr = _trace(_meeting(), 100, audio_s=30.0)
    assert spans.device_ms_by_span(tr, spans.program_spans(tr)) == pytest.approx(
        {"classify/track": 0.018, "classify/chunk": 0.008, "smoothing/runs": 0.001})
    assert _reader("sweep.track_ms_per_audio_min")(tr) == pytest.approx(0.036)
    assert _reader("sweep.chunk_ms_per_audio_min")(tr) == pytest.approx(0.016)


def _random_slice(rng):
    """Meetings of the program's spans, laid end to end inside the driver's
    and closed by a synchronize, with kernels launched under random spans and run one at a time, as
    on one stream, each after a random delay."""
    events, t, corr, free = [], 0.0, 0, 0.0
    for _ in range(rng.randint(1, 4)):
        m0 = t
        for name in ("sweep/prepare", "sweep/batch", "sweep/upload", "sweep/body",
                     "sweep/batch", "sweep/upload", "sweep/body", "sweep/gather",
                     "smoothing/runs", "smoothing/readback", "smoothing/filter"):
            d = rng.uniform(1, 30)
            events.append(_span(name, t, t + d))
            if name == "sweep/body":
                events += [_span("classify/track", t + 0.1 * d, t + 0.4 * d),
                           _span("classify/chunk", t + 0.4 * d, t + 0.9 * d)]
            for _ in range(rng.randint(0, 4)):
                corr += 1
                at = rng.uniform(t, t + d)
                start = max(free, at + rng.uniform(0, 40))
                free = start + rng.uniform(0.5, 20)
                events += [_launch(corr, at), _kernel(corr, start, free)]
            t += d
        events.append(_span("bench/pipeline", m0, t))
    # The slice ends in a synchronize that waits for the last kernel.
    events.append(_span("cudaDeviceSynchronize", t, max(t, free), cat="cuda_runtime"))
    return events, max(t, free)


@pytest.mark.parametrize("seed", range(8))
def test_the_three_stalls_sum_to_at_most_the_device_idle_share(seed):
    events, end = _random_slice(random.Random(seed))
    tr = _trace(events, end * random.Random(seed).uniform(1.0, 1.2))
    stalls = [_reader(n)(tr) for n in STALLS]
    idle = _reader("sweep.device_idle_pct")(tr)
    assert all(s is not None and s >= 0 for s in stalls)
    assert sum(stalls) <= idle + 1e-9
    busy_ms = tr.busy_s() * 1e3
    per_min = tr.work["audio_s"] / 60.0
    assert sum(_reader(n)(tr) for n in DEVICE) * per_min <= busy_ms + 1e-9


def test_a_trace_without_the_programs_spans_reads_none():
    parent = [e for e in _meeting() if not e["name"].startswith(spans.PROGRAM_PREFIXES)]
    tr = _trace(parent, 100)
    assert [_reader(n)(tr) for n in STALLS + DEVICE] == [None] * 5
    # Nor without device ops (a CPU run), where no device metric exists.
    cpu = _trace([e for e in _meeting() if e["cat"] not in harness.DEVICE_CATEGORIES], 100)
    assert [_reader(n)(cpu) for n in STALLS + DEVICE] == [None] * 5


def _profiled(body, device, tmp_path):
    """The events of a chrome trace of ``body`` under the harness's
    profiler settings."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        body()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_the_ports_spans_are_what_the_readers_find(tmp_path):
    from laughter_detection_icsi_tpu_torch.utils.profiling import annotate

    def body():
        with torch.profiler.record_function("bench/pipeline"):
            with annotate("sweep/body"):
                with annotate("classify/track"):
                    torch.ones(256).cumsum(0)

    events = _profiled(body, torch.device("cpu"), tmp_path)
    found = spans.program_spans(_trace(events, 1e6))
    assert [name for *_, name in found] == ["sweep/body", "classify/track"]
    (outer_a, outer_b, _), (inner_a, inner_b, _) = found
    assert outer_a <= inner_a and inner_b <= outer_b


@pytest.mark.cuda
def test_a_kernel_launched_in_a_span_runs_inside_it_on_the_trace(card, tmp_path):
    """A kernel launched and synchronised inside a span lies within the
    span's interval in the exported trace: spans and device ops share one
    clock."""
    from laughter_detection_icsi_tpu_torch.utils.profiling import annotate

    x = torch.randn(4096, 4096, device=card)
    torch.cuda.synchronize(card)

    def body():
        with annotate("sweep/body"):
            (x @ x).relu_()
            torch.cuda.synchronize(card)

    events = _profiled(body, card, tmp_path)
    tr = _trace(events, 1e6)
    ((a, b, _),) = spans.program_spans(tr)
    kernels = [e for e in tr.device if e["cat"] == "kernel"]
    assert len(kernels) >= 2
    for k in kernels:
        assert a <= float(k["ts"]) and float(k["ts"]) + float(k["dur"]) <= b, (k["name"], a, b)
    assert set(spans.device_ms_by_span(tr, [(a, b, "sweep/body")])) == {"sweep/body"}
