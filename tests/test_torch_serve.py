"""The port's streaming server CLI (laughter_detection_icsi_tpu_torch.cli.serve)
on the CPU: NDJSON events out of PCM in, equal to the port's offline
pipeline on the same audio, and to the JAX package's cli/serve.py on the
same checkpoint (full-width resnet_base, numpy-seeded weights)."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from laughter_detection_icsi_tpu.train import checkpoint as jax_ckpt
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.cli import serve
from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib
from tests.fixtures.torch_weights import few_torch_threads, numpy_weights  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
# Small buckets: a bucket costs the same whatever audio it holds, and
# every serve run also warms one up.
SIZES = ["--chunk", "256", "--bucket_frames", "256", "--device", "cpu"]
SECONDS = 4


def _threshold(probs, margin):
    """A threshold near the 70th percentile of ``probs`` more than
    ``margin`` from every probability, so rounding cannot flip a frame."""
    srt = np.sort(probs.astype(np.float64))
    i = int(0.7 * len(srt))
    j = i + int(np.argmax(np.diff(srt[i : i + 20])))
    thr = round(float(srt[j] + srt[j + 1]) / 2, 7)
    assert np.min(np.abs(srt - thr)) > margin
    return thr


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    preset = MODEL_MAP["resnet_base"]
    dims = dict(linear_layer_size=preset.linear_layer_size, filter_sizes=preset.filter_sizes)
    _, params, state = numpy_weights(preset.model, seed=12, head_gain=0.2, **dims)
    jax_ckpt.save_checkpoint(str(root / "ck"), params, state, is_best=True)
    ckpt = str(root / "ck" / "best.ckpt.npz")
    model = zoo.build(preset.model, dropout_rate=0.0, **dims)
    model.load_state_dict(ckpt_lib.load_checkpoint(ckpt)["state_dict"], strict=True)

    t = np.arange(16000 * SECONDS) / 16000  # noise under a slow envelope
    envelope = 0.3 * (0.05 + np.sin(2 * np.pi * 0.4 * t) ** 2)
    wave = (np.random.default_rng(3).standard_normal(len(t)) * envelope).astype(np.float32)
    wav = str(root / "in.wav")
    audio.write_wav(wav, wave, 16000)
    pipe = tinf.LaughterPipeline(
        model, settings=tinf.InferenceSettings(chunk=256, bucket_frames=256), device="cpu"
    )
    probs, _ = pipe.probs_for_file(wav)
    thr = _threshold(probs, 1e-4)
    inst, _ = pipe.segment_file(wav, thresholds=[thr], min_lengths=[0.1])
    events = [(round(s, 3), round(e, 3)) for s, e in inst[(thr, 0.1)]]
    assert events
    return dict(root=root, ckpt=ckpt, wav=wav, thr=thr, probs=probs, events=events, pipe=pipe)


def _lines(text):
    return [json.loads(line) for line in text.splitlines()]


def _events(lines, channel=None):
    return [(l["start"], l["end"]) for l in lines
            if l["type"] == "event" and (channel is None or l["channel"] == channel)]


def test_file_replay_matches_offline(served, tmp_path, capsys):
    probs_path = tmp_path / "probs.npy"
    rc = serve.main(["--model_path", served["ckpt"], "--input", served["wav"],
                     "--threshold", str(served["thr"]), "--min_length", "0.1",
                     "--chunk_ms", "173", "--save_probs", str(probs_path), *SIZES])
    assert rc == 0
    lines = _lines(capsys.readouterr().out)
    assert [lines[0]["type"], lines[-1]["type"]] == ["ready", "done"]
    assert lines[0]["device"] == "cpu" and lines[0]["bucket_latency_s"] == 2.56
    assert _events(lines) == served["events"]
    assert lines[-1] == {"type": "done", "seconds": float(SECONDS), "events": len(served["events"])}
    np.testing.assert_array_equal(np.load(probs_path)[0], served["probs"])


def test_stdin_short_reads_stay_frame_aligned(served, capsys, monkeypatch):
    """Reads that split a sample, and None (no bytes yet, not EOF), keep
    the stream aligned: the events and seconds of the aligned run."""
    data = audio.read_int16(served["wav"])[0].astype("<i2").tobytes()

    class ShortReader:
        def __init__(self):
            self.pos, self.calls = 0, 0

        def read(self, size):
            if self.pos >= len(data):
                return b""
            self.calls += 1
            if self.calls % 3 == 0:
                return None
            take = min(size, len(data) - self.pos)
            if self.calls % 2 and take > 1 and take % 2 == 0:
                take -= 1  # an odd byte count splits a sample
            self.pos += take
            return data[self.pos - take : self.pos]

    monkeypatch.setattr(serve.sys, "stdin", types.SimpleNamespace(buffer=ShortReader()))
    rc = serve.main(["--model_path", served["ckpt"], "--threshold", str(served["thr"]),
                     "--min_length", "0.1", *SIZES])
    assert rc == 0
    lines = _lines(capsys.readouterr().out)
    assert _events(lines) == served["events"]
    assert lines[-1]["seconds"] == float(SECONDS)


def test_stdin_two_channels_subprocess(served):
    """Interleaved s16le with --channels 2 through the process boundary:
    each channel's events are its offline events."""
    ch0 = audio.read_int16(served["wav"])[0]
    ch1 = np.roll(ch0, 160)
    want1 = tinf.LaughterPipeline(
        served["pipe"].model, settings=served["pipe"].settings, device="cpu"
    ).segment_file  # channel 1's offline events, from its own file
    path1 = str(served["root"] / "ch1.wav")
    audio.write_wav(path1, ch1, 16000)
    events1 = [(round(s, 3), round(e, 3))
               for s, e in want1(path1, [served["thr"]], [0.1])[0][(served["thr"], 0.1)]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # as few_torch_threads sets for this process
    res = subprocess.run(
        [sys.executable, "-m", "laughter_detection_icsi_tpu_torch.cli.serve",
         "--model_path", served["ckpt"], "--channels", "2",
         "--threshold", str(served["thr"]), "--min_length", "0.1", *SIZES],
        input=np.stack([ch0, ch1], axis=1).astype("<i2").tobytes(),
        env=env, cwd=REPO, capture_output=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:].decode()
    lines = _lines(res.stdout.decode())
    assert lines[0]["type"] == "ready" and lines[0]["channels"] == 2
    assert _events(lines, channel=0) == served["events"]
    assert _events(lines, channel=1) == events1
    assert lines[-1]["events"] == len(served["events"]) + len(events1)


def test_flag_guards():
    for argv, msg in (
        (["--channels", "0"], "--channels must be >= 1"),
        (["--bucket_frames", "0"], "--bucket_frames must be >= 1"),
        (["--chunk", "-4"], "--chunk must be >= 1"),
        (["--input", "x.wav", "--channels", "2"], "file replay analyzes ONE channel"),
    ):
        with pytest.raises(SystemExit, match=msg):
            serve.main(["--model_path", "/nonexistent", *argv])
    # bf16 is ported: the flag passes and the missing checkpoint stops the run.
    with pytest.raises(SystemExit, match="not found"):
        serve.main(["--model_path", "/nonexistent", "--precision", "bfloat16", "--device", "cpu"])


def test_broken_pipe_exits_141(tmp_path, monkeypatch):
    """A consumer that closed the pipe ends the server with 141, quietly."""
    sink = open(tmp_path / "sink", "w")

    class Closed:
        def write(self, _):
            raise BrokenPipeError

        def flush(self):
            pass

        def fileno(self):
            return sink.fileno()

    monkeypatch.setattr(serve.sys, "stdout", Closed())
    with pytest.raises(SystemExit) as e:
        serve._emit({"type": "ready"})
    sink.close()
    assert e.value.code == 141


def test_events_match_jax_serve(served, capsys, monkeypatch):
    """JAX's cli/serve.py on the same checkpoint and file: the same events
    (the threshold sits more than 1e-4 from every probability)."""
    from cli import serve as jax_serve

    monkeypatch.setenv("LAD_JAX_CACHE_DIR", "off")
    args = ["--model_path", served["ckpt"], "--input", served["wav"],
            "--threshold", str(served["thr"]), "--min_length", "0.1",
            "--chunk", "256", "--bucket_frames", "256"]
    assert jax_serve.main(args) == 0
    want = _lines(capsys.readouterr().out)
    assert serve.main(args + ["--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    assert _events(got) == _events(want) == served["events"]
    assert got[-1] == want[-1]
