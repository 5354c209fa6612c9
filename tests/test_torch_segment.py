"""The port's smoothing, audio decode and segment CLI against the JAX
package's, on the same numpy-seeded weights and inputs (CPU, small sizes:
128-window chunks, 256-frame buckets, a few seconds of audio).

Tolerance: exact.  Smoothing sees identical probabilities; the CLI test
first picks thresholds no closer than 1e-4 to any probability, so the
float32 rounding differences between the two pipelines (within 1e-5)
cannot flip a decision.
"""

import dataclasses
import filecmp
import os

import numpy as np
import torch

from laughter_detection_icsi_tpu import inference as jinf
from laughter_detection_icsi_tpu.data import audio as jaudio
from laughter_detection_icsi_tpu.ops import smoothing as jsm
from laughter_detection_icsi_tpu.train import checkpoint as jckpt
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.data import audio as taudio
from laughter_detection_icsi_tpu_torch.ops import smoothing as tsm
from tests.fixtures.torch_weights import both_models

SIZES = dict(chunk=128, bucket_frames=256)


def _speechlike(n, seed):
    """Int16 audio whose frames differ: noise under a slow envelope plus a
    gated frequency sweep (so the probabilities spread out)."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    env = 0.05 + 0.6 * np.sin(2 * np.pi * 0.7 * t) ** 2
    tone = np.sin(2 * np.pi * (200 + 300 * np.sin(2 * np.pi * 0.3 * t)) * t)
    w = 0.3 * r.standard_normal(n) * env + 0.3 * tone * (np.sin(2 * np.pi * 1.3 * t) > 0)
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)




def _probs_with_runs(rng, n=6000):
    """Probabilities with runs of every length, values past both ends of
    [0, 1], and values bit-equal to float32 thresholds."""
    p = rng.random(n).astype(np.float32)
    p[rng.random(n) < 0.3] = np.float32(0.5)
    p[::97] = 1.5
    p[::89] = -0.25
    p[::53] = 0.0
    return p


def test_smoothing_matches_jax(rng):
    probs = _probs_with_runs(rng)
    thresholds = [0.0, 0.3, 0.5, 0.9, 1.0]
    min_lengths = [0.0, 0.02, 0.2]
    for max_events in (2048, 8):  # 8: the busy thresholds overflow to the host scan
        got = tsm.instances_from_device_probs(
            torch.from_numpy(probs), thresholds, min_lengths, fps=100.0,
            max_events=max_events,
        )
        want = jsm.instances_from_device_probs(
            jsm.jnp.asarray(probs), thresholds, min_lengths, fps=100.0,
            max_events=max_events,
        )
        assert got == want
        assert got == jsm.get_laughter_instances(probs, thresholds, min_lengths)
    assert tsm.get_laughter_instances(probs, thresholds, min_lengths) == got


def test_run_tables_match_jax(rng):
    probs = _probs_with_runs(rng, 3000)
    thr = np.asarray([0.0, 0.5, 0.95], np.float32)
    for max_events in (4, 400, 3000):
        got = tsm.laughter_runs(torch.from_numpy(probs), torch.from_numpy(thr), max_events)
        want = jsm.laughter_runs(jsm.jnp.asarray(probs), jsm.jnp.asarray(thr), max_events)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_empty_probs_smoothing():
    got = tsm.instances_from_device_probs(torch.zeros(0), [0.5, 0.7], [0.2])
    assert got == jsm.get_laughter_instances(np.zeros(0, np.float32), [0.5, 0.7], [0.2])


def test_audio_decode_matches_jax(tmp_path):
    pcm = _speechlike(16000 + 123, seed=11)
    for name, write in (
        ("a.sph", lambda p: jaudio.write_sphere_shorten(p, pcm, 16000)),
        ("b.sph", lambda p: jaudio.write_sphere(p, pcm, 16000, big_endian=True)),
        ("c.wav", lambda p: jaudio.write_wav(p, pcm, 16000)),
    ):
        path = str(tmp_path / name)
        write(path)
        assert dataclasses.asdict(taudio.info(path)) == dataclasses.asdict(jaudio.info(path))
        got, want = taudio.read_int16(path)[0], jaudio.read_int16(path)[0]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(taudio.read(path, 0.1, 0.5)[0],
                                      jaudio.read(path, 0.1, 0.5)[0])


def _pick_thresholds(probs, quantiles=(0.35, 0.65)):
    """Thresholds midway between neighbouring probabilities, so no prob
    lies within 1e-4 of one (float32 rounding cannot flip a decision)."""
    s = np.sort(probs.astype(np.float64))
    out = []
    for q in quantiles:
        i = int(q * (len(s) - 1))
        j = i + int(np.argmax(np.diff(s[i : i + 20])))
        out.append(round(float(s[j] + s[j + 1]) / 2, 6))
    for thr in out:
        assert np.min(np.abs(s - thr)) > 1e-4, thr
    return out


def test_cli_matches_jax_cli(tmp_path, capsys, monkeypatch):
    # Full-width resnet_base, the preset both CLIs default to.
    from cli import segment_laughter as jcli
    from laughter_detection_icsi_tpu.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.cli import segment_laughter as tcli

    monkeypatch.setenv("LAD_JAX_CACHE_DIR", "off")  # no compile cache on disk
    preset = MODEL_MAP["resnet_base"]
    jmodel, params, state, tmodel = both_models(
        preset.model, seed=7, head_gain=0.03,
        linear_layer_size=preset.linear_layer_size, filter_sizes=preset.filter_sizes,
    )
    ckpt = jckpt.save_checkpoint(str(tmp_path / "ckpt"), params, state)
    wav = str(tmp_path / "meeting.wav")
    jaudio.write_wav(wav, _speechlike(16000 * 3, seed=3), 16000)
    port = tinf.LaughterPipeline(tmodel, settings=tinf.InferenceSettings(**SIZES),
                                 device="cpu")
    thresholds = _pick_thresholds(port.probs_for_file(wav)[0])
    min_lengths = [0.0, 0.05]

    def run(main, out, *extra):
        main([
            "--model_path", ckpt, "--input_audio_file", wav,
            "--output_dir", str(out), "--save_to_textgrid", "True",
            "--thresholds", ",".join(map(str, thresholds)),
            "--min_lengths", ",".join(map(str, min_lengths)),
            "--chunk", "128", "--bucket_frames", "256", *extra,
        ])
        return [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("Found")]

    found_j = run(jcli.main, tmp_path / "jax")
    found_t = run(tcli.main, tmp_path / "port", "--device", "cpu")
    assert found_t == found_j and len(found_j) == 4
    assert any(not ln.startswith("Found 0 ") for ln in found_j)
    files = []
    for root, _dirs, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(root, n), tmp_path / "jax") for n in names]
    port_files = []
    for root, _dirs, names in os.walk(tmp_path / "port"):
        port_files += [os.path.relpath(os.path.join(root, n), tmp_path / "port") for n in names]
    assert sorted(files) == sorted(port_files)
    assert any(f.endswith(".TextGrid") for f in files)
    for rel in files:  # TextGrids and cut wavs, byte for byte
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "port" / rel,
                           shallow=False), rel
    # ... and the pipelines' instance dicts are identical.
    jpipe = jinf.LaughterPipeline(
        jmodel, params, state, settings=jinf.InferenceSettings(**SIZES)
    )
    want, _ = jpipe.segment_file(wav, thresholds, min_lengths)
    got, _ = port.segment_file(wav, thresholds, min_lengths)
    assert got == want
