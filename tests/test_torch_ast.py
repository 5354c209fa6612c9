"""The Audio Spectrogram Transformer on the port's clips mode, on the CPU,
held against the plain reference ``benchmark/reference/ast.py`` (AST has no
JAX twin).

Narrow models (width 64, 2 blocks, 4 heads; 128 bins), so every test is
small: the port's module against the reference's at 60 + 2 tokens; the
clips mode end to end over two short channels through ``ShardedPipeline``
(one shorter than a clip); the AST features' plain featurizer against the
reference's Kaldi fbank; the block -> frame mapping and the zero log-mel
at both ends of a track; the spans; and the refusals (streaming,
``fused_conv``, ``cli/train``, export), with the segment and sweep CLIs
under ``--config ast_audioset``.
"""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu_torch import export, host_prep, inference
from laughter_detection_icsi_tpu_torch.cli import export_model, segment_laughter, sweep
from laughter_detection_icsi_tpu_torch.cli import train as train_cli
from laughter_detection_icsi_tpu_torch.config import AST_FEAT, AST_NORM_MEAN, AST_NORM_STD
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.models import ast as ast_lib
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.ops import fbank as tfb
from laughter_detection_icsi_tpu_torch.parallel.sharded_inference import (
    ShardedPipeline, ShardedStreamingSession)
from laughter_detection_icsi_tpu_torch.utils import profiling
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CONFIG = json.loads((BENCH / "configs" / "ast_audioset_bf16.json").read_text())
NARROW = dict(dim=64, depth=2, heads=4, mlp=256)
CLIP, HOP, BUCKET, CLIP_BATCH = 64, 10, 100, 8  # a 64-frame clip a 10-frame block
LAUGH = ast_lib.LAUGHTER_CLASS


@pytest.fixture(scope="module")
def ref():
    """``benchmark/reference/ast.py``, loaded by its path (it imports the
    benchmark's ``reference.precision``)."""
    if str(BENCH) not in sys.path:
        sys.path.append(str(BENCH))
    spec = importlib.util.spec_from_file_location("bench_reference_ast",
                                                  BENCH / "reference" / "ast.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _model_cfg(tdim: int) -> dict:
    return {**CONFIG["model"], **NARROW, "tdim": tdim}


def _model(tdim: int = CLIP, seed: int = 0) -> ast_lib.ASTModel:
    m = ast_lib.ASTModel(fdim=128, tdim=tdim, **NARROW)
    m.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # a laughter row that moves: logits of a few units
        m.mlp_head[1].weight[LAUGH] *= 40.0
    return m.eval()


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _settings(**kw) -> inference.InferenceSettings:
    return inference.InferenceSettings(mode="clips", clip_frames=CLIP, hop_frames=HOP,
                                       bucket_frames=BUCKET, clip_batch=CLIP_BATCH, **kw)


def _pcm(seconds: float, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    w = 0.3 * r.standard_normal(n) * (0.05 + 0.6 * np.sin(2 * np.pi * 0.7 * t) ** 2)
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


def _clip_geometry() -> dict:
    return {"clip_frames": CLIP, "hop_frames": HOP}


def _reference_logits(ref, p, pcm, tdim=CLIP):
    """The reference's logits of every block of one channel: [blocks, 527]."""
    feats = ref.fbank(pcm, CONFIG["features"])
    blocks = range(-(-feats.shape[0] // HOP))
    clips = ref.clips_at(feats, blocks, _clip_geometry(), CONFIG["normalisation"])
    return ref.logits(p, clips, _model_cfg(tdim)), feats.shape[0]


def test_port_module_equals_the_reference(ref):
    model = _model()
    p = _params(model)
    assert {k: tuple(v.shape) for k, v in p.items()} == ref.param_shapes(_model_cfg(CLIP))
    assert ast_lib.patch_grid(128, CLIP, 10, 10) == (12, 5)  # 60 patches + 2 tokens
    x = torch.randn(3, CLIP, 128, generator=torch.Generator().manual_seed(1)) * 2
    with torch.no_grad():
        got = model(x)
    torch.testing.assert_close(got, ref.logits(p, x, _model_cfg(CLIP)), atol=1e-5, rtol=0)
    assert got.shape == (3, 527) and got[:, LAUGH].std() > 0.1


def test_published_sizes_and_the_preset():
    model = zoo.build("AST", dropout_rate=0.0, linear_layer_size=768, filter_sizes=(), seed=3)
    assert model.grid == (12, 101) and model.v.pos_embed.shape == (1, 1214, 768)
    assert sum(p.numel() for p in model.parameters()) == 86_594_063
    with pytest.raises(ValueError, match="width 768"):
        zoo.build("AST", linear_layer_size=48, filter_sizes=(64, 32, 16, 16))


def test_ast_features_equal_the_references_fbank(ref):
    pcm = _pcm(2.3, seed=4)
    got = tfb.fbank(torch.from_numpy(pcm.astype(np.float32) / 32768.0), AST_FEAT)
    want = ref.fbank(pcm, CONFIG["features"])
    assert got.shape == want.shape == (host_prep.num_frames(len(pcm), AST_FEAT), 128)
    torch.testing.assert_close(got.double(), want, atol=2e-4, rtol=1e-4)
    for key in ("num_filters", "frame_shift_samples", "frame_length_samples", "fft_size"):
        assert CONFIG["features"][key] == getattr(AST_FEAT, key)
    assert CONFIG["normalisation"] == {"mean": AST_NORM_MEAN, "std": AST_NORM_STD}


@pytest.fixture(scope="module")
def meeting():
    """A 3 s channel (298 frames, three buckets) and a 0.5 s one (48
    frames: shorter than one 64-frame clip)."""
    return [_pcm(3.0, seed=0), _pcm(0.5, seed=1)]


def _sweep(model, waves, **kw):
    pipe = ShardedPipeline(model, feat_cfg=AST_FEAT, settings=_settings(**kw), device="cpu")
    pipe.logit_sink = []
    probs, ts = pipe.probs_for_waveforms_device(waves)
    return pipe, probs, ts


def test_clips_mode_end_to_end_against_the_reference(ref, meeting):
    model = _model()
    waves = meeting
    pipe, probs, ts = _sweep(model, waves)
    assert ts == [298, 48] and probs.shape == (2, 298)
    logits = torch.cat(pipe.logit_sink, dim=1)  # [rows, blocks, 527], bucket after bucket
    assert logits.shape == (2, 30, 527)
    for c, pcm in enumerate(waves):
        want, t = _reference_logits(ref, _params(model), pcm)
        n = want.shape[0]
        torch.testing.assert_close(logits[c, :n], want, atol=1e-4, rtol=0)
        want_probs = torch.sigmoid(want[:, LAUGH]).repeat_interleave(HOP)[:t]
        torch.testing.assert_close(probs[c, :t], want_probs, atol=2e-5, rtol=0)
        # Every frame of a block is its clip's probability, exactly.
        own = torch.sigmoid(logits[c, :n, LAUGH].float()).repeat_interleave(HOP)[:t]
        assert torch.equal(probs[c, :t], own)


def test_single_channel_pipeline_equals_the_batch(meeting):
    model = _model()
    _, probs, ts = _sweep(model, [meeting[0]])
    pipe = inference.LaughterPipeline(model, feat_cfg=AST_FEAT, settings=_settings(),
                                      device="cpu")
    torch.testing.assert_close(pipe.probs_for_waveform_device(meeting[0]), probs[0, :ts[0]],
                               atol=1e-6, rtol=0)


def test_blocks_cover_their_frames_and_the_track_ends_are_zero_log_mel(ref, meeting):
    model = _model()
    seen = []
    embed = model.embed
    model.embed = lambda x: (seen.append(x.clone()), embed(x))[1]
    before = (inference.clips_classified, inference.clip_padded_frames)
    _, probs, ts = _sweep(model, [meeting[0]])
    clips = torch.cat(seen)  # [blocks, CLIP, 128], bucket after bucket
    t = ts[0]
    assert clips.shape == (30, CLIP, 128)
    context = (CLIP - HOP) // 2
    zero = np.float32((0.0 - AST_NORM_MEAN) / (2 * AST_NORM_STD))
    assert torch.all(clips[0, :context] == torch.tensor(zero))  # before the track
    assert not torch.any(clips[0, context] == torch.tensor(zero))
    last = (t - 1) // HOP  # the last block; its clip runs past frame t
    past = t - (last * HOP - context)
    assert torch.all(clips[last, past:] == torch.tensor(zero))
    assert not torch.any(clips[last, past - 1] == torch.tensor(zero))
    feats = ref.fbank(meeting[0], CONFIG["features"])[:t]
    want = ref.clips_at(feats, range(30), _clip_geometry(), CONFIG["normalisation"])
    torch.testing.assert_close(clips, want, atol=3e-5, rtol=0)
    # Bucket k's buffer starts at frame k * BUCKET - context of the track.
    assert host_prep.clip_bounds(t, 0, _settings()) == (context, min(context + t, BUCKET + 2 * context))
    assert host_prep.clip_bounds(t, 2, _settings()) == (0, context + t - 2 * BUCKET)
    starts = np.arange(30) * HOP - context
    inside = np.clip(np.minimum(t, starts + CLIP) - np.maximum(0, starts), 0, None)
    assert inference.clips_classified - before[0] == 30
    assert inference.clip_padded_frames - before[1] == int((CLIP - inside).sum())


def test_spans_of_the_clips_step(meeting, tmp_path):
    model = _model()
    with profiling.trace(str(tmp_path)):
        _sweep(model, meeting)
    (path,) = tmp_path.glob("trace_*.json")
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith(("sweep/", "classify/")):
            spans.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + e["dur"]))
    buckets, batches = 3, -(-2 * BUCKET // HOP // CLIP_BATCH)  # 3 batches of 8 a bucket
    counts = {k: len(v) for k, v in spans.items()}
    assert counts["classify/encoder"] == buckets * batches
    assert counts["classify/clips"] == buckets * (1 + batches)
    assert counts["classify/head"] == buckets * (1 + batches)
    assert counts["sweep/body"] == buckets and "classify/track" not in counts
    for name in ("classify/clips", "classify/encoder", "classify/head"):
        assert all(any(b0 <= a and z <= b1 for b0, b1 in spans["sweep/body"])
                   for a, z in spans[name])


def test_settings_and_paths_that_refuse_clips():
    with pytest.raises(ValueError, match="multiple of hop_frames"):
        inference.InferenceSettings(mode="clips", bucket_frames=150)
    with pytest.raises(ValueError, match="even count"):
        inference.InferenceSettings(mode="clips", clip_frames=1023, bucket_frames=1000)
    with pytest.raises(ValueError, match="shared_stem"):
        inference.InferenceSettings(mode="clips", bucket_frames=1000, shared_stem=True)
    assert inference.settings_from_flags(device="cpu", mode="clips").bucket_frames == 1000
    model = _model()
    pipe = inference.LaughterPipeline(model, feat_cfg=AST_FEAT, settings=_settings(),
                                      device="cpu")
    with pytest.raises(ValueError, match="requires mode='windows'"):
        inference.StreamingSession(pipe)
    sharded = ShardedPipeline(model, feat_cfg=AST_FEAT, settings=_settings(), device="cpu")
    with pytest.raises(ValueError, match="requires mode='windows'"):
        ShardedStreamingSession(sharded, 2)
    with pytest.raises(ValueError, match="cannot run in mode='fused_conv'"):
        inference.LaughterPipeline(model, feat_cfg=AST_FEAT, device="cpu",
                                   settings=inference.InferenceSettings(mode="fused_conv"))
    resnet = zoo.build("ResNetBigger", dropout_rate=0.0, linear_layer_size=24,
                       filter_sizes=(8, 8, 8, 8))
    with pytest.raises(ValueError, match="cannot run in mode='clips'"):
        inference.LaughterPipeline(resnet, feat_cfg=AST_FEAT, settings=_settings(), device="cpu")
    with pytest.raises(ValueError, match="takes 64 x 128 clips"):
        inference.LaughterPipeline(model, feat_cfg=AST_FEAT, device="cpu",
                                   settings=inference.InferenceSettings(mode="clips",
                                                                        bucket_frames=1000))
    with pytest.raises(ValueError, match="cannot run in mode='windows'"):
        export.export_window_classifier(model, device="cpu")


def test_train_and_export_clis_refuse_ast(capsys, tmp_path):
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--config", "ast_audioset", "--checkpoint_dir", str(tmp_path / "ck"),
                        "--data_root", str(tmp_path),
                        "--device", "cpu"])
    assert e.value.code == 2
    assert ("--config ast_audioset: cli/train runs mode 'windows', and this preset (AST) "
            "runs in mode 'clips'") in capsys.readouterr().err
    with pytest.raises(SystemExit, match=r"cli/export_model runs mode 'windows', and this "
                                         r"preset \(AST\) runs in mode 'clips'"):
        export_model.main(["--config", "ast_audioset", "--random_init", "--out",
                           str(tmp_path / "x.pt2"), "--device", "cpu"])


@pytest.fixture
def narrow_ast(monkeypatch):
    """``--config ast_audioset`` builds a narrow AST at the preset's 1,024
    x 128 clips (width 32, one block)."""
    def narrow(dropout_rate=0.0, linear_layer_size=None, filter_sizes=None):
        return ast_lib.ASTModel(dim=32, depth=1, heads=2, mlp=64)

    monkeypatch.setitem(zoo.MODEL_REGISTRY, "AST", narrow)


def test_segment_cli_runs_the_preset(narrow_ast, tmp_path):
    wav = tmp_path / "x.wav"
    audio.write_wav(str(wav), _pcm(3.0, seed=5), 16000)
    assert "ast_audioset" in segment_laughter.build_parser().format_help()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = segment_laughter.main(["--config", "ast_audioset", "--random_init",
                                    "--input_audio_file", str(wav), "--thresholds", "0.0,0.5",
                                    "--min_lengths", "0.0", "--save_to_audio_files", "False",
                                    "--device", "cpu"])
    assert rc == 0
    assert "Found 1 laughs for threshold 0.0 and min_length 0.0." in out.getvalue()
    with pytest.raises(SystemExit, match="cannot run in mode='windows'"):
        segment_laughter.main(["--config", "ast_audioset", "--random_init", "--mode", "windows",
                               "--input_audio_file", str(wav), "--device", "cpu"])


def test_sweep_cli_runs_the_preset(narrow_ast, synthetic_corpus, tmp_path):
    for c in ("chan0", "chan1"):
        d = tmp_path / "audio" / "Btr001"
        d.mkdir(parents=True, exist_ok=True)
        audio.write_wav(str(d / f"{c}.wav"), _pcm(4.0, seed=len(c)), 16000)
    assert "ast_audioset" in sweep.build_parser().format_help()
    argv = ["--audio_dir", str(tmp_path / "audio"),
            "--transcript_dir", str(synthetic_corpus.transcript_dir),
            "--output_dir", str(tmp_path / "preds"), "--split", "all", "--meetings", "Btr001",
            "--config", "ast_audioset", "--random_init", "--thresholds", "0.0,0.5",
            "--min_lengths", "0.0", "--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert sweep.main(argv) == 0
    grids = sorted((tmp_path / "preds" / "all" / "Btr001").rglob("*.TextGrid"))
    assert len(grids) == 4
    with pytest.raises(SystemExit, match="--model_path is required"):
        sweep.main([a for a in argv if a != "--random_init"])
