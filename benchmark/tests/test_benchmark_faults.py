"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program, with the card check
skipped and the cell cut to a CPU test's size."""

import itertools

import pytest
import torch
from bench_small import small
from conftest import ROOT

import harness

SWEEP, TRAIN = "resnet_base_bf16.sweep_6ch_600s", "resnet_base_f32.train_b32"


def _run(cell):
    result, checks = harness.run_cell(ROOT, cell, 2147483801, 0.2, False, 0.0,
                                      device=torch.device("cpu"), tweak=small)
    return result, {k: v > limit for k, (v, limit) in checks.items()}


def _answer_altered(mp):
    """Every bucket's probabilities flipped where the classifier produces
    them."""
    from laughter_detection_icsi_tpu_torch.parallel import sharded_inference

    real = sharded_inference.classify_bucket

    def altered(*a, **kw):
        out = 1.0 - real(*a, **kw)
        return out

    mp.setattr(sharded_inference, "classify_bucket", altered)


def _half_the_rows(mp):
    """Only the first half of a bucket batch's rows computed; the rest
    repeat them."""
    from laughter_detection_icsi_tpu_torch.parallel.sharded_inference import ShardedPipeline

    real = ShardedPipeline._shard_bodies

    def half(self, waves, valid):
        outs = real(self, [w[: max(1, len(w) // 2)] for w in waves], valid)
        return [o.repeat(-(-len(w) // len(o)), 1)[: len(w)] for o, w in zip(outs, waves)]

    mp.setattr(ShardedPipeline, "_shard_bodies", half)


def _event_dropped(mp):
    """The smoothing's last event of every list left out."""
    from laughter_detection_icsi_tpu_torch.ops import smoothing

    real = smoothing.instances_from_device_probs
    mp.setattr(smoothing, "instances_from_device_probs",
               lambda *a, **kw: {k: v[:-1] for k, v in real(*a, **kw).items()})


def _state_unchanged(mp):
    """The optimizer step returns the state it was given and moves nothing."""
    from laughter_detection_icsi_tpu_torch.train.optim import Adam

    mp.setattr(Adam, "update", lambda self, grads, state, params: state)


def _half_batch(mp):
    """The loss of half of each batch, the mean over the rest."""
    from laughter_detection_icsi_tpu_torch.train.loop import Trainer, bce_loss

    mp.setattr(Trainer, "_loss", lambda self, probs, y: bce_loss(probs[: len(y) // 2],
                                                                 y[: len(y) // 2]))


def _state_unchanged_after_the_first_steps(mp):
    """From the step after the first ones on (the window's), the optimizer
    step returns the state it was given: a replayed step gone stale."""
    from laughter_detection_icsi_tpu_torch.train.optim import Adam

    real, calls = Adam.update, itertools.count()
    mp.setattr(Adam, "update", lambda self, grads, state, params: (
        real(self, grads, state, params) if next(calls) < 3 else state))


def _stale_batch_after_the_first_steps(mp):
    """From the step after the first ones on, every step gathers the rows
    that step gathered: a batch buffer that is never refilled."""
    from laughter_detection_icsi_tpu_torch.data.dataset import ResidentLadDataset

    real, calls, kept = ResidentLadDataset.gather, itertools.count(), []

    def stale(self, idx):
        if next(calls) < 3:
            return real(self, idx)
        if not kept:
            kept.append(real(self, idx))
        return kept[0]

    mp.setattr(ResidentLadDataset, "gather", stale)


@pytest.mark.parametrize("cell,fault,caught_by", [
    (SWEEP, _answer_altered, "logit_gap_mean"),
    (SWEEP, _half_the_rows, "logit_gap_mean"),
    (SWEEP, _event_dropped, "event_mismatches"),
    (TRAIN, _state_unchanged, "change_gap"),
    (TRAIN, _half_batch, "post_grad_gap"),
    (TRAIN, _half_batch, "loss_gap"),
    (TRAIN, _state_unchanged_after_the_first_steps, "post_change_gap"),
    (TRAIN, _stale_batch_after_the_first_steps, "post_loss_gap"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault, caught_by):
    fault(monkeypatch)
    result, failed = _run(cell)
    assert result["correct"] is False
    assert failed[caught_by]
