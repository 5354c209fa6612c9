"""The port's shared-stem window inference (models/shared_stem.py) against
its own naive window batch and against the JAX package, on the same
numpy-seeded weights.

Tolerances: shared stem within 1e-6 of the port's own naive window batch
(the two compute the same sums on different tensor shapes, so the CPU conv
kernels may order them differently); within 1e-5 of the JAX forward
(float32 convs summed in another order than XLA's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.models import shared_stem as jss
from laughter_detection_icsi_tpu.ops import windows as jwin
from laughter_detection_icsi_tpu_torch.models import shared_stem as tss
from laughter_detection_icsi_tpu_torch.ops import windows as twin
from tests.fixtures.torch_weights import SMALL, both_models

STEM_CASES = [("ResNetBigger", SMALL), ("ResNetNoBN", dict(linear_layer_size=48))]


def _track_inputs(name, kw, rng):
    jmodel, params, state, tmodel = both_models(name, seed=2, **kw)
    feats = rng.standard_normal((300, 44)).astype(np.float32)
    return jmodel, params, state, tmodel, feats


@pytest.mark.parametrize("name,kw", STEM_CASES, ids=[c[0] for c in STEM_CASES])
@pytest.mark.parametrize("stage2", [False, True], ids=["track1", "track2"])
def test_shared_stem_matches_naive_and_jax(rng, name, kw, stage2):
    jmodel, params, state, tmodel, feats = _track_inputs(name, kw, rng)
    ft = torch.from_numpy(feats)
    count = 16
    with torch.inference_mode():
        track1 = tss.stem_track(tmodel, ft)
        track2 = tss.stem_track2(tmodel, track1) if stage2 else None
        for start in (0, 7, 300 - 100 - count):  # includes track-edge windows
            if stage2:
                got = tss.chunk_probs_from_track2(tmodel, track1, track2, ft, start, count)
            else:
                got = tss.chunk_probs_from_track(tmodel, track1, ft, start, count)
            naive = tmodel(twin.extract_windows(ft, start, count)[:, None])
            np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=0, atol=1e-6)
            wins = jwin.extract_windows(jnp.asarray(feats), jnp.asarray(start), count)
            want, _ = jmodel.apply(params, state, wins[:, None], train=False)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_stem_tracks_match_jax(rng):
    jmodel, params, state, tmodel, feats = _track_inputs("ResNetBigger", SMALL, rng)
    with torch.inference_mode():
        t1 = tss.stem_track(tmodel, torch.from_numpy(feats))
        t2 = tss.stem_track2(tmodel, t1)
    j1 = jss.stem_track(params, state, jnp.asarray(feats))
    j2 = jss.stem_track2(params, state, j1)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-5, atol=1e-5)


def test_shared_stem_guards_match_jax():
    for window in (99, 24, 26, 100, 10, 11):
        assert tss.supports_track2(window) == jss.supports_track2(window)
        for model in ("ResNetBigger", "MLPModel"):
            assert tss.resolve_shared_stem(None, model, window) == (
                jss.resolve_shared_stem(None, model, window)
            )
    with pytest.raises(ValueError, match="ResNet-family"):
        tss.resolve_shared_stem(True, "MLPModel", 100)
    with pytest.raises(ValueError, match="supports_track2"):
        tss.chunk_probs_from_track2(None, None, None, torch.zeros(1, 44), 0, 1, window=99)


@pytest.mark.parametrize("window", [100, 99], ids=["track2", "track1"])
def test_channels_last_weights_keep_the_classify_step_nhwc(rng, window, monkeypatch):
    """The card's bf16 layout, on the CPU in float32 at the preset's
    widths: with channels-last conv weights every conv of a classify step
    writes NHWC, the tracks are permuted views of NHWC memory, and the
    gathers, pads and splices hand each conv an NHWC input (all but the
    bottom band's stride-2 shortcut, which reads a crop).  The
    probabilities equal the NCHW step's within the naive batch's 1e-6: the
    CPU's NHWC convs sum in another order."""
    import copy

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.models import layers as L

    *_, tmodel, feats = _track_inputs("ResNetBigger", dict(linear_layer_size=48), rng)
    nhwc = copy.deepcopy(tmodel).to(memory_format=torch.channels_last)
    settings = inference.InferenceSettings(chunk=16, bucket_frames=16, window=window)
    ft = torch.from_numpy(feats[: 16 + window - 1])
    seen = []
    real = L.conv_bn_act

    def spy(x, conv, *a, **k):
        y = real(x, conv, *a, **k)
        seen.append((x.is_contiguous(memory_format=torch.channels_last),
                     y.is_contiguous(memory_format=torch.channels_last)))
        return y

    with torch.inference_mode():
        want = inference.classify_bucket(tmodel, ft, 90, settings, use_shared_stem=True)
        monkeypatch.setattr(L, "conv_bn_act", spy)
        got = inference.classify_bucket(nhwc, ft, 90, settings, use_shared_stem=True)
        assert len(seen) == (40 if window == 100 else 30)
        track = tss.stem_track(nhwc, ft)
    assert all(out for _, out in seen)
    assert sum(not x for x, _ in seen) == (1 if window == 100 else 0)
    assert track.shape == (ft.shape[0], 64, 44) and track.stride() == (44 * 64, 1, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
