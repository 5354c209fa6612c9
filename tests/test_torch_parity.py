"""The port's parity CLI (laughter_detection_icsi_tpu_torch/cli/parity.py)
on the CPU against the goldens the JAX package's ``cli/parity.py`` wrote
from ``tests/fixtures/parity_inputs.py`` (committed in
``tests/fixtures/parity_goldens/``), and the port twins of the JAX CLI's
negative cases (tests/test_parity_cli.py).

Tolerances: probabilities 1e-5; features atol 2e-4 + rtol 1e-4
(tests/test_fbank_pallas.py); analyse rows exact; the 4-step loss curve
1e-3 (float32 multi-step runs of two frameworks part by ~4e-4 by the third
loss: Adam's first step turns rounding noise into lr-sized moves).  The
checks run at chunk and bucket 256, where the goldens were written at
512 / 1024: the probabilities do not depend on the bucket geometry.
"""

import json
import math
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from laughter_detection_icsi_tpu_torch import inference
from laughter_detection_icsi_tpu_torch.cli import parity
from laughter_detection_icsi_tpu_torch.cli import sweep as sweep_cli
from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
from laughter_detection_icsi_tpu_torch.data import audio as audio_io
from laughter_detection_icsi_tpu_torch.data.feature_cache import compute_track_features
from laughter_detection_icsi_tpu_torch.eval import textgrid as tg
from laughter_detection_icsi_tpu_torch.eval.analyse import write_csv
from tests.fixtures import parity_inputs
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401

GOLDENS = Path(__file__).resolve().parent / "fixtures" / "parity_goldens"
CPU = ["--device", "cpu", "--chunk", "256", "--bucket_frames", "256"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return parity_inputs.write_parity_inputs(tmp_path_factory.mktemp("parity_inputs"))


def _run(argv, tmp_path) -> tuple:
    out = tmp_path / "report.json"
    rc = parity.main(argv + ["--out", str(out)])
    return rc, json.loads(out.read_text())


def test_committed_goldens_are_not_vacuous():
    """The drill's goldens hold laughter at the manifest's (0.5, 0.2),
    sum-stats rows with finite precision, and no probability within
    MARGIN of a threshold of the grid (instance counts compare exactly)."""
    manifest = json.loads((GOLDENS / "manifest.json").read_text())
    assert manifest["thresholds"] == list(parity_inputs.GRID_THRESHOLDS)
    grids = sorted((GOLDENS / "textgrids").glob("*.TextGrid"))
    assert len(grids) == len(parity_inputs.CHANNELS)
    assert all(tg.read_laughter_intervals(str(g)) for g in grids)
    rows = parity._read_table(GOLDENS / "sum_stats.csv")
    assert rows and all(math.isfinite(parity._number(r["precision"])) for r in rows)
    probs = [np.load(p) for p in sorted((GOLDENS / "probs").glob("*.npy"))]
    assert parity_inputs.check_margin(probs) > parity_inputs.MARGIN


def test_port_passes_the_committed_jax_goldens(inputs, tmp_path):
    rc, report = _run(
        inputs.argv(GOLDENS) + CPU
        + ["--prob_atol", "1e-5", "--metric_atol", "0", "--loss_atol", "1e-3"], tmp_path)
    assert rc == 0, report
    assert report["n_pass"] == 5 and report["n_fail"] == 0 and report["n_skipped"] == 0
    configs = report["configs"]
    assert configs["probs"]["max_abs_diff"] <= 1e-5
    assert configs["analyse"]["max_metric_diff"] == 0.0
    assert configs["analyse"]["rows"] == 4
    assert configs["loss_curve"]["max_loss_diff"] <= 1e-3
    assert configs["textgrids"]["max_boundary_diff_s"] == 0.0
    # The features at the tolerance of the fbank tests, element by element
    # (the CLI's check is one absolute bound).
    for chan in parity_inputs.CHANNELS:
        wave, _ = audio_io.read(str(inputs.audio_dir / parity_inputs.MEETING / f"{chan}.wav"))
        want = np.load(GOLDENS / "features" / f"{parity_inputs.MEETING}__{chan}.npy")
        got = compute_track_features(wave, bucket_frames=1024, device="cpu")
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def _goldens_with(tmp_path, *names) -> Path:
    """A goldens dir holding the committed manifest and the named files."""
    g = tmp_path / "goldens"
    g.mkdir()
    shutil.copy(GOLDENS / "manifest.json", g)
    for name in names:
        (g / name).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(GOLDENS / name, g / name)
    return g


def test_perturbed_golden_fails(inputs, tmp_path):
    name = f"probs/{parity_inputs.MEETING}__chan0.npy"
    g = _goldens_with(tmp_path, name)
    np.save(g / name, np.clip(np.load(g / name) + 0.05, 0, 1))
    rc, report = _run(inputs.argv(g) + CPU + ["--configs", "probs"], tmp_path)
    assert rc == 1
    assert report["configs"]["probs"]["status"] == "fail"
    assert report["configs"]["probs"]["max_abs_diff"] > 0.04


def test_missing_goldens_skip_not_fail(inputs, tmp_path):
    empty = tmp_path / "empty_goldens"
    empty.mkdir()
    (empty / "manifest.json").write_text("{}")
    rc, report = _run(["--goldens", str(empty), "--audio_dir", str(inputs.audio_dir)] + CPU,
                      tmp_path)
    assert rc == 0
    assert report["n_skipped"] == 5 and report["pass"] is True


def test_missing_audio_fails_naming_the_stem(inputs, tmp_path):
    g = _goldens_with(tmp_path)
    (g / "probs").mkdir()
    np.save(g / "probs" / "Zzz999__chanZ.npy", np.asarray([0.5], np.float32))
    rc, report = _run(inputs.argv(g) + CPU + ["--configs", "probs"], tmp_path)
    assert rc == 1
    probs = report["configs"]["probs"]
    assert probs["status"] == "fail"
    assert probs["missing_audio"] == ["Zzz999__chanZ"]
    assert "partial comparison" in probs["reason"]


def test_analyse_join_tolerates_float_repr_noise(inputs, monkeypatch, tmp_path):
    """Grid keys with float-repr noise (0.30000000000000004) still join;
    our rows here are the golden's own, so only the join is under test."""
    g = _goldens_with(tmp_path)
    rows = parity._read_table(GOLDENS / "sum_stats.csv")
    cols = list(rows[0])
    noisy = [[parity._number(r[c]) + (1e-12 if c in ("threshold", "min_len") else 0.0)
              for c in cols] for r in rows]
    write_csv(g / "sum_stats.csv", cols, noisy)
    assert (g / "sum_stats.csv").read_text() != (GOLDENS / "sum_stats.csv").read_text()
    monkeypatch.setattr(parity, "_run_sweep_stats", lambda *a, **k: GOLDENS / "sum_stats.csv")
    rc, report = _run(inputs.argv(g) + CPU + ["--configs", "analyse"], tmp_path)
    assert rc == 0
    assert report["configs"]["analyse"]["status"] == "pass"
    assert report["configs"]["analyse"]["rows"] == len(rows)


def test_analyse_fails_on_headered_empty_golden(inputs, monkeypatch, tmp_path):
    gdir = tmp_path / "g3"
    gdir.mkdir()
    write_csv(gdir / "sum_stats.csv", ["threshold", "min_len", "precision", "recall"], [])
    ours = tmp_path / "ours.csv"
    write_csv(ours, ["threshold", "min_len", "precision", "recall"], [[0.5, 0.2, 0.5, 0.5]])
    monkeypatch.setattr(parity, "_run_sweep_stats", lambda *a, **k: ours)
    args = parity.build_parser().parse_args(inputs.argv(gdir) + CPU)
    r = parity._check_analyse(args, gdir, {}, 1e-3, tmp_path)
    assert r["status"] == "fail"
    assert "no data rows" in r["reason"]


def test_analyse_nan_agrees_only_on_both_sides(inputs, monkeypatch, tmp_path):
    cols = ["threshold", "min_len", "precision", "recall"]
    gdir = tmp_path / "g4"
    gdir.mkdir()
    write_csv(gdir / "sum_stats.csv", cols, [[0.5, 0.2, 1.0, math.nan]])
    args = parity.build_parser().parse_args(inputs.argv(gdir) + CPU)
    for recall, status in ((math.nan, "pass"), (0.25, "fail")):
        ours = tmp_path / f"ours_{status}.csv"
        f1 = 2 * recall / (1 + recall)
        write_csv(ours, cols + ["f1"], [[0.5, 0.2, 1.0, recall, f1]])
        monkeypatch.setattr(parity, "_run_sweep_stats", lambda *a, _o=ours, **k: _o)
        r = parity._check_analyse(args, gdir, {}, 1e-3, tmp_path)
        assert r["status"] == status, r
    assert "NaN on one side only" in r["reason"]


def test_features_check_rejects_wrong_sample_rate(tmp_path):
    gdir = tmp_path / "g"
    (gdir / "features").mkdir(parents=True)
    np.save(gdir / "features" / "m__c.npy", np.zeros((10, 44), np.float32))
    wav = tmp_path / "m" / "c.wav"
    wav.parent.mkdir()
    audio_io.write_wav(str(wav), np.zeros(8000, np.float32), 8000)
    r = parity._check_features(gdir, {"m__c": str(wav)}, atol=1e-3, device="cpu")
    assert r["status"] == "fail"
    assert "8000 Hz" in r["reason"] and "16000" in r["reason"]


def test_write_goldens_rejects_wrong_sample_rate(tmp_path):
    bad_dir = tmp_path / "bad_audio" / "Xxx000"
    bad_dir.mkdir(parents=True)
    audio_io.write_wav(str(bad_dir / "chanA.wav"), np.zeros(44100, np.float32), 44100)
    with pytest.raises(SystemExit, match="44100 Hz"):
        parity.main(["--goldens", str(tmp_path / "g2"), "--audio_dir",
                     str(tmp_path / "bad_audio"), "--write_goldens", "--device", "cpu"])


def test_rejects_unknown_config_colliding_stems_and_a_missing_card(inputs, monkeypatch, tmp_path):
    twin = tmp_path / "audio" / "M"
    twin.mkdir(parents=True)
    audio_io.write_wav(str(twin / "chan0.wav"), np.zeros(160, np.float32), 16000)
    audio_io.write_sphere(str(twin / "chan0.sph"), np.zeros(160, np.float32), 16000)
    with pytest.raises(SystemExit, match="audio stems collide"):
        parity._audio_files(str(tmp_path / "audio"))
    # --device cuda without a card refuses: no fallback to the CPU.
    monkeypatch.setattr(inference.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity.main(inputs.argv(GOLDENS) + ["--device", "cuda"])


def test_parity_is_float32_on_the_card(monkeypatch, tmp_path):
    """The pipeline and the sweep run in float32 on ``cuda``, where the
    other CLIs default to bfloat16 (their probabilities would sit ~0.05
    from float32 goldens)."""
    assert inference.settings_from_flags(device="cuda").precision == "bfloat16"
    monkeypatch.setattr(inference, "LaughterPipeline",
                        lambda model, feat_cfg, settings, device: SimpleNamespace(
                            feat_cfg=feat_cfg, settings=settings, device=device))
    args = parity.build_parser().parse_args(
        ["--goldens", "g", "--audio_dir", "a", "--model_path", "m", "--transcript_dir", "t"])
    assert args.device == "cuda"
    preset = MODEL_MAP[args.config]
    pipe = parity._pipeline(args, preset, model=None)
    assert pipe.settings.precision == "float32" and pipe.device == "cuda"
    assert pipe.feat_cfg is preset.feat
    assert pipe.settings.bucket_frames == 6144  # the card's defaults

    seen = []

    def fake_sweep(argv):
        seen.extend(argv)
        out = Path(argv[argv.index("--output_dir") + 1])
        out.mkdir(parents=True)
        (out / "all_sum_stats.csv").write_text("threshold,min_len,precision,recall,f1\n")
        return 0

    monkeypatch.setattr(sweep_cli, "main", fake_sweep)
    parity._run_sweep_stats(args, {"split": "all"}, tmp_path)
    assert seen[seen.index("--precision") + 1] == "float32"
    assert seen[seen.index("--device") + 1] == "cuda"
