"""The port's fully-convolutional (fused_conv) inference against the JAX
package's, on the same numpy-seeded weights (CPU, small sizes).

Tolerances: the track functions within atol 1e-5 / rtol 1e-4 of JAX's
(tests/test_fully_conv.py:96); the blocked track against the whole track
inside the port, on the cases JAX pins bit for bit
(tests/test_fully_conv.py:160), within 1e-6 (see BLOCKED_BOUND).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu import inference as jinf
from laughter_detection_icsi_tpu.models import fully_conv as jfc
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.models import fully_conv as tfc
from tests.fixtures.torch_weights import few_torch_threads, SMALL, both_models  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
#: The blocked track against the whole track inside the port.  JAX pins
#: them bit for bit on XLA's CPU convs; here the CPU's conv and matmul
#: kernels are chosen by shape, and the [n_blocks, 1, 1220, 44] batch, the
#: [1, 1, T, 44] track and the head's [T, 24] product at other T sum in
#: other orders.  Measured: 0 for the narrow plan at window 100, 8.9e-8 at
#: window 64, 4.5e-13 for ResNetNoBN at full width.
BLOCKED_BOUND = 1e-6


@pytest.fixture(scope="module")
def nets():
    return {
        "ResNetBigger": both_models("ResNetBigger", seed=3, head_gain=6.0, **SMALL),
        "ResNetNoBN": both_models("ResNetNoBN", seed=4, head_gain=6.0, linear_layer_size=48),
    }


@pytest.fixture(scope="module")
def jax_fns():
    return {
        "whole": jax.jit(jfc.fully_conv_probs, static_argnames="window"),
        "blocked": jax.jit(jfc.fully_conv_probs_blocked, static_argnames=("window", "block")),
    }


def _feats(t_in, seed=0):
    return (np.random.default_rng(seed).standard_normal((t_in, 44)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("arch", ["ResNetBigger", "ResNetNoBN"])
@pytest.mark.parametrize("t_in", [160, 900, 2500])
def test_track_functions_match_jax(nets, jax_fns, arch, t_in):
    _, params, state, model = nets[arch]
    feats = _feats(t_in, seed=t_in)
    x = torch.from_numpy(feats)
    with torch.inference_mode():
        whole = tfc.fully_conv_probs(model, x).numpy()
        blocked = tfc.fully_conv_probs_blocked(model, x).numpy()
    want_whole = np.asarray(jax_fns["whole"](params, state, jnp.asarray(feats)))
    want_blocked = np.asarray(jax_fns["blocked"](params, state, jnp.asarray(feats)))
    assert whole.shape == blocked.shape == (t_in,)
    np.testing.assert_allclose(whole, want_whole, **TOL)
    np.testing.assert_allclose(blocked, want_blocked, **TOL)


@pytest.mark.parametrize("arch", ["ResNetBigger", "ResNetNoBN"])
def test_blocked_equals_whole_track(nets, arch):
    """JAX's pinned cases (track length, block): every output row of the
    blocked path, track edges and ragged ends included, equals the whole
    track's; the tracks at or under 784 frames take the whole-track
    path."""
    model = nets[arch][3]
    for t_in, block in ((1500, 256), (790, 300), (700, 1024), (100, 256)):
        x = torch.from_numpy(_feats(t_in, seed=t_in + 1))
        with torch.inference_mode():
            a = tfc.fully_conv_probs(model, x)
            b = tfc.fully_conv_probs_blocked(model, x, block=block)
        torch.testing.assert_close(b, a, rtol=0, atol=BLOCKED_BOUND)


@pytest.mark.parametrize("max_blocks", [1, 3])
def test_blocked_groups_equal_one_batch(nets, max_blocks):
    """Dispatching the blocks in groups (10 blocks of 256 rows in groups of
    1 or 3, the last ragged) gives the one-batch result: each block's rows
    are computed from its own halo, whatever else shares the batch (held
    at BLOCKED_BOUND: the CPU's conv kernels are chosen by batch size)."""
    model = nets["ResNetBigger"][3]
    x = torch.from_numpy(_feats(2500, seed=11))
    with torch.inference_mode():
        one = tfc.fully_conv_probs_blocked(model, x, block=256, max_blocks=10)
        got = tfc.fully_conv_probs_blocked(model, x, block=256, max_blocks=max_blocks)
    torch.testing.assert_close(got, one, rtol=0, atol=BLOCKED_BOUND)
    with pytest.raises(ValueError, match="max_blocks"):
        tfc.fully_conv_probs_blocked(model, x, max_blocks=0)


def test_blocked_honors_window(nets):
    """Window 64 gives 2 pooled rows (window 100 gives 3): blocked equals
    whole for it too, and the head keeps every output frame."""
    model = both_models("ResNetBigger", seed=8, linear_layer_size=16, filter_sizes=(8, 8, 8, 8))[3]
    x = torch.from_numpy(_feats(900, seed=2))
    with torch.inference_mode():
        a = tfc.fully_conv_probs(model, x, window=64)
        b = tfc.fully_conv_probs_blocked(model, x, window=64, block=256)
    assert a.shape == (900,)
    torch.testing.assert_close(b, a, rtol=0, atol=BLOCKED_BOUND)


def test_geometry_guards_raise(nets):
    model = nets["ResNetBigger"][3]
    x = torch.from_numpy(_feats(900))
    with pytest.raises(NotImplementedError, match="window"):
        tfc.fully_conv_probs_blocked(model, x, window=16)
    with pytest.raises(NotImplementedError, match="window|frequency"):
        tfc.fully_conv_probs(model, x, window=16)
    with pytest.raises(NotImplementedError, match="frequency"):  # Wf 2 pooled columns
        tfc.fully_conv_probs(model, torch.zeros(900, 88))
    with pytest.raises(NotImplementedError, match="frequency"):
        tfc.fully_conv_probs_blocked(model, torch.zeros(1800, 88))


def _wave(n, dtype, seed=9):
    w = np.clip(np.random.default_rng(seed).standard_normal(n) * 0.2, -1, 1)
    return (w * 32767).astype(np.int16) if dtype == "int16" else w.astype(np.float32)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_pipeline_fused_conv_matches_jax(nets, dtype):
    """mode='fused_conv' at bucket 256: 1,000 frames round up to a
    1,024-frame whole track (blocked), one featurizer call."""
    jmodel, params, state, model = nets["ResNetBigger"]
    wave = _wave(16000 * 10 + 33, dtype)
    want = jinf.LaughterPipeline(
        jmodel, params, state,
        settings=jinf.InferenceSettings(bucket_frames=256, mode="fused_conv"),
    ).probs_for_waveform(wave)
    pipe = tinf.LaughterPipeline(
        model, settings=tinf.InferenceSettings(bucket_frames=256, mode="fused_conv"),
        device="cpu",
    )
    got = pipe.probs_for_waveform(wave)
    assert got.shape == want.shape == (1000,)
    np.testing.assert_allclose(got, want, **TOL)
    assert pipe.probs_for_waveform(np.zeros(0, np.int16)).shape == (0,)


def test_fused_conv_refuses_packed_codec():
    with pytest.raises(ValueError, match="packed"):
        tinf.InferenceSettings(mode="fused_conv", transfer_codec="packed")
