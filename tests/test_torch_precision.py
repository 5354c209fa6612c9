"""bfloat16 in the port against the JAX package's bf16, on the CPU.

Inference: the port's bf16 pipelines (shared stem, naive windows,
fused_conv, ``ShardedPipeline`` rows, ``StreamingSession``) against JAX
bf16 pipelines on the same weights and PCM: within 2e-2 of JAX, and within
0.05 of the port's float32 (JAX tests/test_inference.py:162-182).  The
model is the narrow ResNetBigger of the other port tests with its
BatchNorm statistics calibrated on the test audio's windows and the head
at gain 0.35 (``calibrated_models``; probabilities spread with std 0.09).
With random statistics the activations grow to ~70 and JAX's own bf16
moves 0.05-0.06 from its float32 (measured), and so it does at head gain
0.5 on windows (0.054): there the 0.05 bound would test the weights, not
the port.  Here JAX's own bf16 is 0.036 (windows) and 0.027 (fused_conv)
from its float32, the port's the same, and the two bf16 pipelines are at
most two bf16 steps (0.0078) apart (measured): both frameworks round the
same chain of ops (layer by layer, the stages agree but for ~1 value in
3,000 a rounding step apart).

Training: ``Trainer(compute_dtype='bfloat16')`` against JAX
``build_step_fns(compute_dtype='bfloat16')``, with float32 masters, moments
and BatchNorm statistics.  The losses at JAX's mixed-precision tolerance
(tests/test_mixed_precision.py:121-128: rtol 2e-2).  After one Adam step at
lr 1e-3 any two runs from one init lie within ~2e-3, so the parameters'
rtol 5e-2 / atol 5e-3 says nothing of the gradients: the backward is held
by itself.  At the reference init (``jax_side``) the bf16 gradients are held
to JAX's bf16 ones as a share of max(1, max|g|) (as chip_smoke.py holds the
float32 ones), and the step to JAX's Adam applied to the port's own bf16
gradients.  There the float32 gradient below the head nearly vanishes and
what bf16 leaves is rounding noise in both frameworks, so that check holds
the head.  Every conv and linear weight is held on the calibrated weights,
where each layer has a gradient, by the cosine of its gradient with JAX's:
there JAX's own float32 gradients sit at a least cosine of 0.72-0.88 with
its bf16 ones (train-mode BatchNorm's backward subtracts nearly equal bf16
and float32 terms), so no elementwise bound exists.  The readings behind
these bounds: ``python -m tests.fixtures.bf16_readings``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from laughter_detection_icsi_tpu import inference as jinf
from laughter_detection_icsi_tpu.parallel import ShardedPipeline as JaxSharded
from laughter_detection_icsi_tpu.parallel import make_mesh
from laughter_detection_icsi_tpu.train import Adam as JAdam
from laughter_detection_icsi_tpu.train import Trainer as JTrainer
from laughter_detection_icsi_tpu.train.loop import build_step_fns
from laughter_detection_icsi_tpu_torch import host_prep as thp
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.config import FEAT
from laughter_detection_icsi_tpu_torch.models import layers as L
from laughter_detection_icsi_tpu_torch.ops import fbank as tfb
from laughter_detection_icsi_tpu_torch.parallel import sharded_inference as tsi
from laughter_detection_icsi_tpu_torch.train import (
    Adam, Trainer, clip_by_global_norm, global_norm)
from tests.fixtures.torch_weights import SMALL, calibrated_models, few_torch_threads  # noqa: F401
from tests.test_torch_train import (  # noqa: F401
    ARCH, UPDATE_TOL, flat, jax_side, make_batches, port_trainer)

SIZES = dict(chunk=128, bucket_frames=256)
N_SAMPLES = 16000 * 6 + 777  # 605 frames: three 256-frame buckets, the last partial
JAX_TOL, F32_TOL = 2e-2, 0.05
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-2, 5e-2, 5e-3
#: bf16 gradients against JAX's bf16 at the reference init, as a share of
#: max(1, max|g|).  Readings (tests/fixtures/bf16_readings.py) on five
#: batches (seeds 21, 101, 5, 7, 9):
#: 4.9e-4 to 2.4e-3 (max|g| 0.12-0.37, linear2.bias); float32 gradients read
#: the same, as bf16 rounds the head's gradient below it; the port's bf16
#: gradients scaled by 0.9 read 1.2e-2 to 3.9e-2, zero gradients >= 0.12.
BF16_GRAD_TOL = 5e-3
#: Cosine of each conv and linear weight's bf16 gradient with JAX's, on
#: numpy-seeded weights.  Readings (tests/fixtures/bf16_readings.py) over
#: weight seeds 1, 2, 3, 5 x batch
#: seeds 4, 9, 21 (23 leaves each): at least 0.696, median 0.84-0.95;
#: JAX's own float32 against its bf16 at least 0.716; a zero gradient reads
#: 0 and a sign-flipped one < 0.
BF16_GRAD_COS = 0.5


def _wave(n=N_SAMPLES, seed=11):
    w = np.clip(np.random.default_rng(seed).standard_normal(n) * 0.2, -1, 1)
    return (w * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def models():
    padded, _ = thp.host_pad_waveform(_wave())
    feats = tfb.fbank(torch.from_numpy(padded.astype(np.float32) / 32768),
                      thp.snip_cfg(FEAT))
    starts = torch.arange(0, feats.shape[0] - 100, 4)
    windows = feats[starts[:, None] + torch.arange(100)][:, None]
    return calibrated_models("ResNetBigger", windows, seed=5, head_gain=0.35, **SMALL)


@pytest.fixture(scope="module")
def jax_pipes(models):
    jmodel, params, state, _ = models
    return {(mode, prec): jinf.LaughterPipeline(
                jmodel, params, state,
                settings=jinf.InferenceSettings(**SIZES, mode=mode, precision=prec))
            for mode in ("windows", "fused_conv") for prec in ("float32", "bfloat16")}


def _port(models, **kw):
    return tinf.LaughterPipeline(models[3], settings=tinf.InferenceSettings(**SIZES, **kw),
                                 device="cpu")


def test_settings_default_to_bf16_on_the_card_as_jax_on_an_accelerator():
    assert tinf.settings_from_flags().precision == "bfloat16"
    assert tinf.settings_from_flags(device="cuda:0").precision == "bfloat16"
    assert tinf.settings_from_flags(device="cpu").precision == "float32"
    assert jinf.settings_from_flags().precision == "float32"  # JAX on the CPU
    assert tinf.settings_from_flags(precision="float32").precision == "float32"
    assert tinf.InferenceSettings(precision="bfloat16").precision == "bfloat16"
    with pytest.raises(ValueError, match="unknown precision"):
        tinf.InferenceSettings(precision="bf16")


def test_bf16_pipeline_copies_the_model(models):
    pipe = _port(models, precision="bfloat16")
    caller = models[3]
    assert all(p.dtype == torch.float32 for p in caller.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in caller.buffers())
    assert pipe.model is not caller
    for k, v in pipe.model.state_dict().items():
        want = torch.int64 if k.endswith("num_batches_tracked") else torch.bfloat16
        assert v.dtype == want, k
    assert _port(models).model is caller  # float32 classifies with the caller's model


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "naive"])
def test_windows_bf16_matches_jax(models, jax_pipes, shared):
    wave = _wave()
    got = _port(models, precision="bfloat16", shared_stem=shared).probs_for_waveform(wave)
    want = jax_pipes[("windows", "bfloat16")].probs_for_waveform(wave)
    f32 = _port(models, shared_stem=shared).probs_for_waveform(wave)
    assert got.dtype == np.float32 and got.shape == want.shape == (605,)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(got, f32, rtol=0, atol=F32_TOL)
    assert np.abs(got - f32).max() > 0  # it did run in bf16


def test_shared_stem_and_naive_agree_in_bf16(models):
    wave = _wave()
    shared = _port(models, precision="bfloat16", shared_stem=True).probs_for_waveform(wave)
    naive = _port(models, precision="bfloat16", shared_stem=False).probs_for_waveform(wave)
    np.testing.assert_allclose(shared, naive, rtol=0, atol=JAX_TOL)


def test_fused_conv_bf16_matches_jax(models, jax_pipes):
    wave = _wave()
    got = _port(models, precision="bfloat16", mode="fused_conv").probs_for_waveform(wave)
    want = jax_pipes[("fused_conv", "bfloat16")].probs_for_waveform(wave)
    f32 = _port(models, mode="fused_conv").probs_for_waveform(wave)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(got, f32, rtol=0, atol=F32_TOL)


def test_sharded_rows_bf16_match_jax_and_the_single_channel(models):
    jmodel, params, state, _ = models
    waves = [_wave(16000 * 2, 1), _wave(16000 + 800, 2), _wave(N_SAMPLES, 3)]
    spipe = tsi.ShardedPipeline(models[3], device="cpu",
                                settings=tinf.InferenceSettings(**SIZES, precision="bfloat16"))
    got = spipe.probs_for_waveforms(waves)
    want = JaxSharded(model=jmodel, params=params, state=state, mesh=make_mesh(8),
                      settings=jinf.InferenceSettings(**SIZES, precision="bfloat16"),
                      ).probs_for_waveforms(waves)
    single = _port(models, precision="bfloat16")
    for g, w, wave in zip(got, want, waves):
        np.testing.assert_allclose(g, w, rtol=0, atol=JAX_TOL)
        assert np.array_equal(g, single.probs_for_waveform(wave))


def test_streaming_bf16_equals_offline(models, jax_pipes):
    pipe = _port(models, precision="bfloat16")
    wave = _wave()
    sess = tinf.StreamingSession(pipe)
    out = [sess.feed(wave[i : i + 4000]) for i in range(0, len(wave), 4000)]
    got = np.concatenate(out + [sess.finish()])
    assert np.array_equal(got, pipe.probs_for_waveform(wave))
    np.testing.assert_allclose(
        got, jax_pipes[("windows", "bfloat16")].probs_for_waveform(wave), rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("mode", ["windows", "fused_conv"])
def test_bias_after_the_rounded_conv_is_what_holds_jax(models, jax_pipes, mode, monkeypatch):
    """``layers.conv_bias`` adds a conv's bias after the bf16 product is
    rounded, as XLA rounds the JAX package's conv then add.  With the
    library's fused bias (added in the conv's float32 accumulator) the port
    moves 2-4x further from JAX's bf16 (0.0195 on windows, 0.0234 on
    fused_conv, past the 2e-2 bound; 0.0156 and 0.0234 at full width),
    against 0.0059-0.0078 with the separate add
    (tests/fixtures/bf16_readings.py)."""
    wave = _wave()
    want = jax_pipes[(mode, "bfloat16")].probs_for_waveform(wave)

    def gap():
        got = _port(models, precision="bfloat16", mode=mode).probs_for_waveform(wave)
        return float(np.abs(got - want).max())

    rounded = gap()
    monkeypatch.setattr(L, "conv_bias", lambda x, w, b, **kw: F.conv2d(x, w, b, **kw))
    fused = gap()
    assert rounded < JAX_TOL / 2
    assert fused > 2 * rounded, (fused, rounded)


def test_bf16_layers_keep_their_dtype(models):
    """Nothing in the eval layers re-promotes bf16 activations: the BN fold,
    the pools, the head and the convs with and without a bias."""
    m = tinf.cast_model_bf16(models[3]).eval()
    x = torch.randn(3, 1, 100, 44).bfloat16()
    assert m(x).dtype == torch.bfloat16
    scale, bias = L.bn_eval_affine(m.bn1)
    assert scale.dtype == bias.dtype == torch.bfloat16
    y = L.conv2d(x, m.conv1)
    assert y.dtype == L.avg_pool2d(y, 4).dtype == L.batch_norm(y, m.bn1).dtype == torch.bfloat16
    blk = m.block1[0]
    assert L.conv2d(y, blk.conv1).dtype == torch.bfloat16  # with a bias


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_bf16(jax_side):
    return JTrainer(model=jax_side["model"], optimizer=JAdam(), compute_dtype="bfloat16")


def _masters_are_f32(trainer, opt):
    for k, v in trainer.model.state_dict().items():
        want = torch.int64 if k.endswith("num_batches_tracked") else torch.float32
        assert v.dtype == want, k
    for tree in (opt.mu, opt.nu):
        assert all(v.dtype == torch.float32 for v in tree.values())


def _close_to_jax(port, params, state):
    want = flat(params, state)
    for k, v in port.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


_JAX_GRAD_FNS = {}  # id(model) -> (model, jitted value_and_grad): one compile a model


def _jax_bf16_grads(model, params, state, batch):
    """JAX's train-mode loss and gradients behind its bf16 boundary."""
    if id(model) not in _JAX_GRAD_FNS:
        loss_fn = build_step_fns(model, JAdam(), compute_dtype="bfloat16")[0]
        _JAX_GRAD_FNS[id(model)] = (model, jax.jit(jax.value_and_grad(loss_fn, has_aux=True)))
    (loss, _), grads = _JAX_GRAD_FNS[id(model)][1](
        params, state, jnp.asarray(batch["inputs"])[:, None], jnp.asarray(batch["is_laugh"]), None)
    return float(loss), flat(grads)


@pytest.mark.parametrize("seed", [21, 9])
def test_bf16_gradients_match_jax(jax_side, seed):
    batch = make_batches(seed, 1)[0]
    jloss, jgrads = _jax_bf16_grads(jax_side["model"], jax_side["params"], jax_side["state"],
                                    batch)
    port = port_trainer(jax_side, compute_dtype="bfloat16")
    x, y = port._prep(batch)
    loss, _, grads = port.loss_and_grads(x, y)
    assert float(loss) == pytest.approx(jloss, rel=LOSS_RTOL)
    assert set(grads) == set(jgrads)
    assert all(g.dtype == torch.float32 for g in grads.values())
    scale = max(1.0, max(float(np.abs(g).max()) for g in jgrads.values()))
    err = {k: float(np.abs(g.numpy() - jgrads[k]).max()) / scale for k, g in grads.items()}
    worst = max(err, key=err.get)
    assert err[worst] <= BF16_GRAD_TOL, (worst, err[worst])
    f32 = port_trainer(jax_side).loss_and_grads(x, y)[2]
    assert any(not torch.equal(grads[k], f32[k]) for k in grads)  # it ran in bf16


@pytest.mark.parametrize("seed", [21, 4])
def test_bf16_weight_gradients_follow_jax_in_every_layer(models, seed):
    jmodel, params, state, tmodel = models
    batch = make_batches(seed, 1)[0]
    jloss, jgrads = _jax_bf16_grads(jmodel, params, state, batch)
    port = Trainer(copy.deepcopy(tmodel), device="cpu", compute_dtype="bfloat16")
    x, y = port._prep(batch)
    loss, _, grads = port.loss_and_grads(x, y)
    assert float(loss) == pytest.approx(jloss, rel=LOSS_RTOL)
    weights = [k for k, g in jgrads.items() if g.ndim >= 2]
    assert len(weights) == 23  # every conv, shortcut and linear weight
    for k in weights:
        g, jg = grads[k].double().flatten(), torch.tensor(jgrads[k]).double().flatten()
        cos = float(g @ jg / (g.norm() * jg.norm()))
        assert cos >= BF16_GRAD_COS, (k, cos)


def test_bf16_step_matches_jax(jax_side, jax_bf16):
    batch = make_batches(21, 1)[0]
    p, s, _, jm = jax_bf16.train_batch(jax_side["params"], jax_side["state"],
                                       jax_bf16.optimizer.init(jax_side["params"]), batch,
                                       jax.random.PRNGKey(0))
    port = port_trainer(jax_side, compute_dtype="bfloat16")
    start = {k: v.detach().numpy().copy() for k, v in port.params.items()}
    x, y = port._prep(batch)
    grads = port_trainer(jax_side, compute_dtype="bfloat16").loss_and_grads(x, y)[2]
    opt, m = port.train_batch(port.init(), batch)
    assert m["loss"].dtype == torch.float32
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    _masters_are_f32(port, opt)
    _close_to_jax(port, p, s)
    # The step is JAX's Adam on the port's own bf16 gradients.
    redo, _ = JAdam().update({k: g.numpy() for k, g in grads.items()},
                             JAdam().init(start), start)
    for k, v in port.params.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(redo[k]), atol=UPDATE_TOL,
                                   rtol=0, err_msg=k)
    f32 = port_trainer(jax_side).eval_batch(batch)["loss"]
    ev = port.eval_batch(batch)
    jev = jax_bf16.eval_batch(p, s, batch)
    assert float(ev["loss"]) == pytest.approx(float(jev["loss"]), rel=LOSS_RTOL)
    assert float(port_trainer(jax_side, compute_dtype="bfloat16").eval_batch(batch)["loss"]) \
        == pytest.approx(float(f32), rel=5e-2)


class _Rows:
    """Rows resident as tensors: what ``train_batch_resident`` gathers."""

    def __init__(self, x, y):
        self.x, self.y = torch.from_numpy(x), torch.from_numpy(y)

    def gather(self, idx):
        return self.x[idx], None, self.y[idx]


def test_bf16_k_resident_steps_match_jax(jax_side, jax_bf16):
    r = np.random.default_rng(3)
    feats = (r.standard_normal((40, 100, 44)) * 0.5).astype(np.float32)
    labels = r.integers(0, 2, 40).astype(np.float32)
    idx_mat = np.stack([r.integers(0, 40, 8) for _ in range(3)])
    p, s, o, jm = jax_bf16._train_k_steps_resident(
        jax_side["params"], jax_side["state"], jax_bf16.optimizer.init(jax_side["params"]),
        jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(idx_mat, jnp.int32),
        jax.random.PRNGKey(0), 0)
    port = port_trainer(jax_side, compute_dtype="bfloat16")
    opt, m = port.train_k_steps_resident(port.init(), _Rows(feats, labels), idx_mat, 0, 0)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=LOSS_RTOL)
    assert int(opt.step) == 3
    _masters_are_f32(port, opt)
    _close_to_jax(port, p, s)


def test_bn_running_stats_accumulate_in_f32_under_bf16():
    """The port's counterpart of JAX's test of the same name: with bf16
    activations and bf16 affine parameters, the running statistics move in
    float32 and converge to the batch's (a bf16-grid update stalls ~0.03
    short), and the normalization stays bf16."""
    bn = torch.nn.BatchNorm1d(4)
    bn.weight.data, bn.bias.data = bn.weight.data.bfloat16(), bn.bias.data.bfloat16()
    bn.running_mean.fill_(1.0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.9 + rng.standard_normal((64, 4)) * 1e-3).astype(np.float32)).bfloat16()
    target = x.float().mean(dim=0).numpy()
    for _ in range(150):
        y = L.batch_norm(x, bn, train=True)
        assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(), target, atol=2e-3)


def test_bf16_trainer_moves_bn_stats_in_f32(jax_side):
    batches = make_batches(22, 3)
    runs = {}
    for cd in (None, "bfloat16"):
        t = port_trainer(jax_side, compute_dtype=cd)
        opt = t.init()
        for b in batches:
            opt, _ = t.train_batch(opt, b)
        runs[cd] = t.model.state_dict()
    for k, v in runs["bfloat16"].items():
        if k.endswith(("running_mean", "running_var")):
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), runs[None][k].numpy(), rtol=6e-2, atol=6e-3,
                                       err_msg=k)


def test_optimizer_keeps_each_leaf_dtype():
    r = np.random.default_rng(1)
    grads = {"bf": torch.from_numpy(r.standard_normal((3, 3)) * 5).bfloat16(),
             "f16": torch.from_numpy(r.standard_normal(5) * 5).half(),
             "f32": torch.from_numpy((r.standard_normal(4) * 5).astype(np.float32))}
    assert global_norm(grads).dtype == torch.float32
    out = clip_by_global_norm(grads, 1.0)
    for k in grads:
        assert out[k].dtype == grads[k].dtype, k
    params = {k: torch.zeros_like(g) for k, g in grads.items()}
    state = Adam().init(params)
    state = Adam().update(grads, state, params)
    for k in grads:
        assert params[k].dtype == state.mu[k].dtype == state.nu[k].dtype == grads[k].dtype, k
    assert state.step.dtype == torch.int32


def test_bad_compute_dtype_is_refused(jax_side):
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        port_trainer(jax_side, compute_dtype="bf16")
    assert port_trainer(jax_side, compute_dtype="bfloat16").precision == "bfloat16"
