"""The plain reference agrees with the port's CPU path at small widths:
the check that the reference itself computes the published model."""

import json

import numpy as np
import pytest
import torch
from conftest import BENCH

import traffic
import weights
from reference import fbank as ref_fbank
from reference import resnet
from reference import smoothing as ref_smoothing
from reference import train as ref_train

CONFIG = json.loads((BENCH / "configs" / "resnet_base_bf16.json").read_text())
TRAIN = json.loads((BENCH / "configs" / "resnet_base_f32.json").read_text())
NARROW = [8, 8, 8, 16]


def _pcm(seconds=6, seed=5):
    tr = json.loads((BENCH / "traffic" / "sweep_6ch_600s.json").read_text())
    tr.update(meeting_seconds=seconds, channels=1, pool_meetings=1, offset_max_seconds=1)
    return traffic.meeting_pool(tr, seed)[0][0]


def _port_model(cfg, p):
    from laughter_detection_icsi_tpu_torch.models import zoo

    m = cfg["model"]
    model = zoo.build(m["architecture"], dropout_rate=m["dropout_rate"],
                      linear_layer_size=m["linear_layer_size"], filter_sizes=m["filter_sizes"])
    model.load_state_dict(weights.port_state_dict(p), strict=True)
    return model


def test_fbank_matches_the_ports_plain_featurizer():
    from laughter_detection_icsi_tpu_torch.config import FEAT
    from laughter_detection_icsi_tpu_torch.ops import fbank as port_fbank

    pcm = _pcm(3)[:47_913]  # a length off the frame grid: both edges mirror
    ref = ref_fbank.fbank(pcm, CONFIG["features"])
    port = port_fbank.fbank(torch.from_numpy(pcm.astype(np.float32) / 32768.0), FEAT)
    assert ref.shape == port.shape
    assert torch.allclose(ref.float(), port, atol=2e-3, rtol=1e-4)


def test_mel_banks_match_the_ports():
    from laughter_detection_icsi_tpu_torch.config import FEAT
    from laughter_detection_icsi_tpu_torch.ops import fbank as port_fbank

    assert np.allclose(ref_fbank.mel_banks(CONFIG["features"]), port_fbank._mel_banks(FEAT),
                       atol=1e-6)


@pytest.mark.parametrize("filters", [NARROW, [16, 8, 8, 16]])
def test_eval_network_matches_the_port(filters):
    cfg = {**CONFIG, "precision": "float32", "model": {**CONFIG["model"], "filter_sizes": filters}}
    p = weights.initial(cfg, 3, "cpu")
    x = torch.randn(6, 1, 100, 44) * 3 - 6
    want = _port_model(cfg, p).eval()(x)
    got = resnet.forward(p, x, cfg["model"])
    assert torch.allclose(got, want, atol=1e-5)


def test_sweep_probabilities_match_the_ports_pipeline_at_every_frame():
    """Features with the frame mask and zero tail, windows at every frame,
    the network: the whole chain a sweep's check recomputes."""
    from laughter_detection_icsi_tpu_torch.inference import InferenceSettings, LaughterPipeline

    cfg = {**CONFIG, "precision": "float32", "model": {**CONFIG["model"], "filter_sizes": NARROW},
           "weights": {**CONFIG["weights"], "calibration_windows": 16}}
    pcm = _pcm(6)
    feats = ref_fbank.fbank(pcm, cfg["features"]).float()
    p = weights.calibrated(cfg, 7, ref_fbank.windows_at(feats, np.arange(0, 400, 25), 100))
    pipe = LaughterPipeline(_port_model(cfg, p), settings=InferenceSettings(chunk=128,
                            bucket_frames=256), device="cpu")
    port = pipe.probs_for_waveform(pcm)
    frames = np.arange(feats.shape[0])
    ref = resnet.probs_in_blocks(p, ref_fbank.windows_at(feats, frames, 100),
                                 {**cfg["model"], "dropout_rate": 0.0})
    assert port.shape == ref.shape
    assert np.abs(port - ref.numpy()).max() < 1e-4


def test_train_steps_match_the_ports_trainer():
    """Train-mode BatchNorm, dropout from the stated per-step generators,
    BCE, clipping and Adam: three steps from the same leaves.  The first
    step's loss and gradient agree to float32 rounding; later steps part a
    little more, as Adam's normalized step turns rounding into lr-sized
    moves."""
    from laughter_detection_icsi_tpu_torch.models import zoo  # noqa: F401
    from laughter_detection_icsi_tpu_torch.train.loop import Trainer
    from laughter_detection_icsi_tpu_torch.train.optim import Adam

    cfg = {**TRAIN, "model": {**TRAIN["model"], "filter_sizes": NARROW}}
    p0 = weights.initial(cfg, 11, "cpu")
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.normal(-6, 2, (8, 1, 100, 44)).astype(np.float32)),
                torch.from_numpy((rng.random(8) < 0.5).astype(np.float32))) for _ in range(3)]
    ref = ref_train.train_steps(p0, batches, cfg["model"], cfg["train"], seed=2**31 + 5)
    trainer = Trainer(_port_model(cfg, p0), optimizer=Adam(), device="cpu")
    opt = trainer.init()
    losses = []
    for step, (x, y) in enumerate(batches):
        opt, m = trainer.train_batch(opt, {"inputs": x[:, 0], "is_laugh": y},
                                     trainer.generator(2**31 + 5, step))
        losses.append(float(m["loss"]))
        if step == 0:
            norms = {k: float(g.norm()) for k, g in ref["grad1"].items()}
            median = float(np.median(list(norms.values())))
            # The biases a train-mode BatchNorm follows: nought to rounding.
            moved = {k for k, n in norms.items() if n >= 1e-3 * median}
            assert len(moved) < len(norms)
            for k in moved:
                g = ref["grad1"][k]
                assert torch.allclose(opt.mu[k] / 0.1, g, atol=1e-3 * float(g.abs().max()), rtol=0), k
    assert abs(losses[0] - ref["losses"][0]) < 1e-6
    assert np.allclose(losses, ref["losses"], rtol=2e-3)
    after = trainer.model.state_dict()
    leaves = [k for k in ref["after"] if k in moved or resnet.is_running(k)]
    got = {k: float((after[k] - p0[k]).norm()) for k in leaves}
    want = {k: float((ref["after"][k] - p0[k]).norm()) for k in leaves}
    median = float(np.median(list(want.values())))
    # Each leaf's change alike, against the larger of its own and the
    # median leaf's (its elements may part by a step or two of lr where
    # their gradient is near nought; a wrong dropout draw or update reads
    # tenths).
    for k in leaves:
        assert abs(got[k] - want[k]) <= 2e-2 * max(want[k], median), k


def test_smoothing_matches_the_ports_host_smoothing():
    from laughter_detection_icsi_tpu_torch.ops import smoothing

    rng = np.random.default_rng(1)
    probs = np.clip(np.convolve(rng.random(3000), np.ones(25) / 25, "same") * 1.3 - 0.1, -0.1, 1.1)
    thr = [round(0.05 * i, 2) for i in range(19)] + [0.97, 1.0]
    mins = [0.0, 0.1, 0.2]
    want = smoothing.get_laughter_instances(probs.astype(np.float32), thr, mins, fps=100.0)
    got = ref_smoothing.events(probs, thr, mins, fps=100.0)
    assert got == want
    assert sum(map(len, got.values())) > 50
