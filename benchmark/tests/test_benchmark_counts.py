"""The operation and byte counts kept with the benchmark, against counts
taken independently from the reference model's layers."""

import json

import numpy as np
import pytest
import torch
from conftest import BENCH
from torch.utils.flop_counter import FlopCounterMode

import weights
from counts import fbank as fbank_counts
from counts import resnet as counts
from reference import fbank as ref_fbank
from reference import resnet

CONFIG = json.loads((BENCH / "configs" / "resnet_base_f32.json").read_text())
WIDTHS = [CONFIG["model"]["filter_sizes"], [8, 8, 8, 16]]


def _model(filters):
    return {**CONFIG["model"], "filter_sizes": filters}


def _hooked(filters, batch=2):
    """Per layer: (name, input, weight, output) seen by the reference's hook."""
    cfg = {**CONFIG, "model": _model(filters)}
    p = weights.initial(cfg, 0, "cpu")
    seen = []
    x = torch.randn(batch, 1, 100, 44)
    with torch.no_grad():
        resnet.forward(p, x, cfg["model"], on_layer=lambda *a: seen.append(a))
    return seen, p, x, cfg


@pytest.mark.parametrize("filters", WIDTHS)
def test_forward_count_matches_the_layers_as_they_ran(filters):
    seen, *_ = _hooked(filters, batch=1)
    by_hook = sum(2 * y.numel() * w[0].numel() for _, _, w, y in seen)
    assert counts.forward_flops(_model(filters), 100, 44) == by_hook


@pytest.mark.parametrize("filters", WIDTHS)
def test_train_count_matches_torchs_flop_counter(filters):
    _, p, x, cfg = _hooked(filters, batch=2)
    params = {k: v.clone().requires_grad_(not resnet.is_running(k)) for k, v in p.items()}
    with FlopCounterMode(display=False) as fc:
        probs = resnet.forward(params, x, {**cfg["model"], "dropout_rate": 0.0}, train=True)
        probs.sum().backward()
    # Two samples; the stem's input needs no gradient, so the counter
    # counts none, as the count leaves it out.
    assert counts.train_flops(cfg["model"], 100, 44) * x.shape[0] == fc.get_total_flops()


@pytest.mark.parametrize("filters", WIDTHS)
def test_fully_conv_count_is_each_layers_work_once_a_frame(filters):
    seen, *_ = _hooked(filters, batch=1)
    per_frame = sum((2 * y.numel() * w[0].numel()) // (y.shape[2] if y.ndim == 4 else 1)
                    for _, _, w, y in seen)
    assert counts.fully_conv_flops_per_frame(_model(filters), 100, 44) == per_frame


def test_published_widths_give_the_counts_the_metrics_use():
    m = CONFIG["model"]
    assert counts.forward_flops(m, 100, 44) == 1_416_661_568
    assert counts.train_flops(m, 100, 44) == 4_244_915_904
    assert counts.fully_conv_flops_per_frame(m, 100, 44) == 15_525_952


def test_fbank_bytes_are_the_input_read_once_and_the_features_written_once():
    feat = CONFIG["features"]
    banks = ref_fbank.mel_banks(feat)
    nnz = fbank_counts.mel_nonzero(banks)
    assert 0 < nnz < banks.size
    rows, frames = 6, 6243
    samples = (frames - 1) * feat["frame_shift_samples"] + feat["frame_length_samples"]
    by_ops, by_bytes = fbank_counts.launch_bounds(feat, rows, samples, frames, nnz, 1.0, 1.0)
    assert by_bytes == rows * 4 * (samples + frames * feat["num_filters"])
    per_frame = fbank_counts.flops_per_frame(feat, nnz)
    assert by_ops == rows * frames * per_frame
    # A real FFT of 512 points needs fewer operations than the dense DFT.
    assert per_frame < 2 * 2 * 400 * 257
    assert np.isclose(by_bytes / 3.35e12 * 1e6, 9.13, atol=0.01)
