"""The port's corpus sweep CLI (cli/sweep.py) end to end on the CPU, scored
by both evaluators.

One ``--analyse`` sweep (module-scoped) over the synthetic corpus's
Btr001: 2 channels x 20 s of int16 WAV, full-width ``resnet_base`` (the
``--config`` preset forces it) on numpy-seeded weights, the reference's
29 x 3 grid.  Checked: the TextGrid layout; each TextGrid equals the port's
smoothing of ``ShardedPipeline.probs_for_meeting`` of the same files
(exactly: the same numbers through the same smoothing); the port's
``sum_stats.csv`` equals the JAX package's ``analyse(force=True)`` of a
copy of the output dir (rtol 1e-12, NaN where NaN); the selection errors.
"""

import contextlib
import io
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from laughter_detection_icsi_tpu.eval.analyse import analyse as jax_analyse
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.cli import sweep
from laughter_detection_icsi_tpu_torch.config import MODEL_MAP, parse_float_list
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.eval import textgrid as tg
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.ops import smoothing
from laughter_detection_icsi_tpu_torch.parallel import ShardedPipeline
from laughter_detection_icsi_tpu_torch.train import checkpoint
from laughter_detection_icsi_tpu_torch.train.checkpoint import state_dict_from_jax
from tests.fixtures.torch_weights import few_torch_threads, numpy_weights  # noqa: F401

PRESET = MODEL_MAP["resnet_base"]
WIDTHS = dict(linear_layer_size=PRESET.linear_layer_size, filter_sizes=PRESET.filter_sizes)
SIZES = ["--chunk", "512", "--bucket_frames", "1024"]


def _wave(seconds: int, seed: int) -> np.ndarray:
    """Int16 audio under a slow envelope, so frames differ."""
    r = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000
    w = 0.3 * r.standard_normal(len(t)) * (0.05 + 0.6 * np.sin(2 * np.pi * 0.4 * t) ** 2)
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def swept(synthetic_corpus, tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sweep")
    paths = []
    for c, chan in enumerate(("chan0", "chan1")):
        d = root / "audio" / "Btr001"
        d.mkdir(parents=True, exist_ok=True)
        paths.append(str(d / f"{chan}.wav"))
        audio.write_wav(paths[-1], _wave(20, seed=c), 16000)
    _, params, state = numpy_weights(PRESET.model, seed=5, head_gain=0.05, **WIDTHS)
    model = zoo.build(PRESET.model, dropout_rate=0.0, **WIDTHS)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    ckpt = checkpoint.save_checkpoint(str(root / "ck"), model.state_dict())
    argv = [
        "--audio_dir", str(root / "audio"), "--transcript_dir", str(synthetic_corpus.transcript_dir),
        "--output_dir", str(root / "preds"), "--split", "all", "--meetings", "Btr001",
        "--model_path", ckpt, "--device", "cpu", *SIZES, "--analyse",
    ]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sweep.main(argv)
    assert rc == 0
    pipe = ShardedPipeline(model, settings=tinf.InferenceSettings(chunk=512, bucket_frames=1024),
                           device="cpu")
    probs, durations = pipe.probs_for_meeting(paths)
    return dict(root=root, out=root / "preds", stdout=out.getvalue(), argv=argv, probs=probs,
                durations=durations, transcripts=synthetic_corpus.transcript_dir, paths=paths)


def test_layout_is_the_evaluators(swept):
    split = swept["out"] / "all"
    grids = sorted(split.rglob("*.TextGrid"))
    thresholds = parse_float_list(sweep.DEFAULT_THRESHOLDS)
    min_lengths = parse_float_list(sweep.DEFAULT_MIN_LENGTHS)
    assert len(thresholds) == 29 and len(min_lengths) == 3
    want = {("Btr001", f"t_{t}", f"l_{m}", f"{c}.TextGrid")
            for t in thresholds for m in min_lengths for c in ("chan0", "chan1")}
    assert {g.relative_to(split).parts for g in grids} == want
    assert (swept["out"] / "all_sum_stats.csv").is_file()
    assert (swept["out"] / "all_eval_df_per_meeting.csv").is_file()
    assert "swept 0.0111 h of audio (40.000 audio-s) in " in swept["stdout"]
    assert "best F1 = " in swept["stdout"] and "AP(min_len=0.2) = " in swept["stdout"]


def test_textgrids_equal_the_smoothing_of_the_pipeline(swept):
    thresholds = parse_float_list(sweep.DEFAULT_THRESHOLDS)
    min_lengths = parse_float_list(sweep.DEFAULT_MIN_LENGTHS)
    n_events = 0
    for chan, probs, duration in zip(("chan0", "chan1"), swept["probs"], swept["durations"]):
        assert probs.shape == (2000,) and np.isfinite(probs).all()
        want = smoothing.instances_from_device_probs(
            torch.from_numpy(probs), thresholds, min_lengths, fps=len(probs) / duration)
        for (thr, ml), insts in want.items():
            grid = swept["out"] / "all" / "Btr001" / f"t_{thr}" / f"l_{ml}" / f"{chan}.TextGrid"
            assert tg.read_laughter_intervals(str(grid)) == insts, (chan, thr, ml)
            n_events += len(insts)
    assert n_events > 0


def test_sum_stats_equal_the_jax_evaluators(swept, tmp_path):
    copy = tmp_path / "preds"
    shutil.copytree(swept["out"] / "all", copy / "all")
    want = jax_analyse(str(copy / "all"), transcript_dir=str(swept["transcripts"]), force=True)
    got = pd.read_csv(swept["out"] / "all_sum_stats.csv")
    assert len(got) == 87 and np.isfinite(got["precision"]).all()
    pd.testing.assert_frame_equal(got, want, rtol=1e-12)
    pd.testing.assert_frame_equal(
        pd.read_csv(swept["out"] / "all_eval_df_per_meeting.csv"),
        pd.read_csv(copy / "all_eval_df_per_meeting.csv"), rtol=1e-12)


def test_selection_fingerprint_equals_jax(swept):
    from cli import sweep as jax_cli

    resolved = [("Btr001", ["chan0", "chan1"], swept["paths"])]
    assert sweep.selection_fingerprint(resolved) == jax_cli.selection_fingerprint(resolved)
    assert sweep.selection_fingerprint(resolved).startswith("Btr001:chan0=320000/16000/pcm")


@pytest.mark.parametrize("flags, message", [
    (["--split", "dev", "--meetings", "Btr001"], "no meetings selected"),
    (["--split", "all", "--meetings", "Bxx999"], "unknown meetings: Bxx999"),
])
def test_selection_errors_exit(swept, flags, message):
    argv = list(swept["argv"])
    for flag, value in zip(flags[::2], flags[1::2]):
        argv[argv.index(flag) + 1] = value
    with pytest.raises(SystemExit, match=message):
        sweep.main(argv)


def test_trace_writes_a_chrome_trace(tmp_path):
    # --trace_dir's context: a torch.profiler trace of the block, with an
    # annotated region, written as Chrome trace JSON.
    import json

    from laughter_detection_icsi_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("sweep-region"):
            torch.ones(64).cumsum(0)
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "sweep-region" in names
    with profiling.trace(None):  # off: nothing written, the block still runs
        pass
    meter = profiling.ThroughputMeter()
    meter.start()
    assert meter.stop(10.0) > 0 and meter.audio_seconds == 10.0
