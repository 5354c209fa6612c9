"""The port's spans (``utils/profiling.annotate``) in the multichannel
sweep, the classify step and the smoothing: where they open, how often,
that they cost nothing and change nothing when no profiler records, and
that an exported graph holds none of them."""

import json

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu_torch import export, inference
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.ops import smoothing
from laughter_detection_icsi_tpu_torch.parallel.sharded_inference import ShardedPipeline
from laughter_detection_icsi_tpu_torch.utils import profiling

#: Two 256-frame buckets of two 128-frame chunks for a 5 s meeting.
SETTINGS = dict(chunk=128, bucket_frames=256)
CHANNELS, SECONDS = 3, 5
THRESHOLDS, MIN_LENGTHS = (0.3, 0.5, 0.7), (0.0, 0.1)
PREFIXES = ("sweep/", "classify/", "smoothing/")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return zoo.build("ResNetBigger", dropout_rate=0.0, linear_layer_size=24,
                     filter_sizes=(8, 8, 8, 8)).eval()


@pytest.fixture(scope="module")
def meeting():
    rng = np.random.default_rng(7)
    return [(rng.standard_normal(16000 * SECONDS) * 3000).astype(np.int16)
            for _ in range(CHANNELS)]


def _sweep(model, meeting, **settings):
    """One meeting through the multichannel pipeline and every channel's
    smoothing, as ``cli/sweep`` runs it: (probs [C, t], each channel's
    events)."""
    pipe = ShardedPipeline(model, settings=inference.InferenceSettings(**SETTINGS, **settings),
                           device="cpu")
    probs, ts = pipe.probs_for_waveforms_device(meeting)
    events = [smoothing.instances_from_device_probs(row[:ts[i]], THRESHOLDS, MIN_LENGTHS)
              for i, row in pipe.local_channels(probs, len(ts))]
    return probs, events


def _spans(trace_dir):
    """The program's spans of the Chrome trace in ``trace_dir``, by name:
    [(start, end)] in time order."""
    (path,) = trace_dir.glob("trace_*.json")
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIXES):
            out.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + e["dur"]))
    return {k: sorted(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def traced(model, meeting, tmp_path_factory):
    trace_dir = tmp_path_factory.mktemp("trace")
    with profiling.trace(str(trace_dir)):
        probs, events = _sweep(model, meeting)
    return probs, events, _spans(trace_dir)


def test_each_stage_is_one_span_where_its_work_happens(traced):
    probs, _, spans = traced
    buckets, chunks = 2, 2
    assert probs.shape == (CHANNELS, 500)
    assert {k: len(v) for k, v in spans.items()} == {
        "sweep/prepare": 1,
        "sweep/batch": buckets, "sweep/upload": buckets, "sweep/body": buckets,
        "classify/track": buckets * CHANNELS, "classify/chunk": buckets * CHANNELS * chunks,
        "sweep/gather": 2,  # the bucket pieces' concatenation, then the shards'
        "smoothing/runs": CHANNELS, "smoothing/readback": CHANNELS,
        "smoothing/filter": CHANNELS,
    }
    # The classify spans nest in their bucket's body, the upload precedes it.
    for (b0, b1), (u0, u1) in zip(spans["sweep/body"], spans["sweep/upload"]):
        assert u1 <= b0
        inside = [s for s in spans["classify/track"] + spans["classify/chunk"] if b0 <= s[0]]
        assert sum(s[1] <= b1 for s in inside) == CHANNELS * (1 + chunks)


def test_a_batch_span_closes_before_its_batch_is_consumed(traced):
    _, _, spans = traced
    batches, bodies = spans["sweep/batch"], spans["sweep/body"]
    for k, ((_, batch_end), (body_start, body_end)) in enumerate(zip(batches, bodies)):
        assert batch_end <= body_start
        if k + 1 < len(batches):  # the next batch is built after this body
            assert body_end <= batches[k + 1][0]


def test_outputs_are_bit_equal_traced_and_untraced(model, meeting, traced):
    probs, events, _ = traced
    again, again_events = _sweep(model, meeting)
    assert torch.equal(probs, again)
    assert events == again_events


def test_a_meeting_read_from_files_adds_one_decode_span(model, meeting, tmp_path):
    paths = []
    for i, pcm in enumerate(meeting):
        paths.append(str(tmp_path / f"chan{i}.wav"))
        audio.write_wav(paths[-1], pcm, 16000)
    pipe = ShardedPipeline(model, settings=inference.InferenceSettings(**SETTINGS), device="cpu")
    with profiling.trace(str(tmp_path / "trace")):
        (probs, _), _ = pipe.probs_for_meeting_device(paths)
    spans = _spans(tmp_path / "trace")
    assert [len(spans[n]) for n in ("sweep/decode", "sweep/prepare", "sweep/body")] == [1, 1, 2]
    assert spans["sweep/decode"][0][1] <= spans["sweep/prepare"][0][0]
    assert torch.equal(probs, pipe.probs_for_waveforms_device(meeting)[0])


def test_an_overflowing_threshold_is_one_fallback_span(tmp_path):
    probs = torch.tensor([0.9, 0.1, 0.9, 0.1, 0.9, 0.9])
    with profiling.trace(str(tmp_path)):
        got = smoothing.instances_from_device_probs(probs, (0.5, 0.95), (0.0,), max_events=2)
    spans = _spans(tmp_path)
    assert [len(spans[f"smoothing/{n}"]) for n in ("runs", "readback", "fallback", "filter")] \
        == [1, 1, 1, 1]
    assert got == smoothing.get_laughter_instances(probs.numpy(), (0.5, 0.95), (0.0,))


def test_annotate_records_nothing_outside_a_profiler(model, meeting, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _sweep(model, meeting)
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("probe/inner") as span:
            assert span.name == "probe/inner"
    assert calls == ["probe/inner"]


@pytest.mark.parametrize("shared_stem", [True, False])
def test_an_exported_bucket_graph_holds_no_profiler_op(model, shared_stem):
    pipe = inference.LaughterPipeline(
        model, settings=inference.InferenceSettings(**SETTINGS, shared_stem=shared_stem),
        device="cpu")
    exported, _ = export.export_bucket_pipeline(pipe)
    targets = [str(n.target) for n in exported.program.graph_module.graph.nodes]
    assert any("fbank" in t for t in targets)
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
