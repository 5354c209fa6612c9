"""The readings behind the bf16 bounds of tests/test_torch_precision.py,
on the CPU: run ``JAX_PLATFORMS=cpu python -m tests.fixtures.bf16_readings``
from the repo root (~2 min).

1. ``layers.conv_bias``: the port's bf16 probabilities against JAX's bf16
   with the bias added after the rounded conv and with the library's fused
   bias, on the narrow calibrated model and at full width.
2. bf16 gradients at the reference init against JAX's bf16, as a share of
   max(1, max|g|): the port's, the port's float32 ones and the port's
   scaled by 0.9.
3. The least cosine of a conv or linear weight's bf16 gradient with JAX's
   on numpy-seeded weights: the port's, and JAX's own float32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from laughter_detection_icsi_tpu import inference as jinf
from laughter_detection_icsi_tpu import models as jmodels
from laughter_detection_icsi_tpu.models.layers import reference_init as jax_reference_init
from laughter_detection_icsi_tpu.train import Adam as JAdam
from laughter_detection_icsi_tpu.train.loop import build_step_fns
from laughter_detection_icsi_tpu_torch import host_prep as thp
from laughter_detection_icsi_tpu_torch import inference as tinf
from laughter_detection_icsi_tpu_torch.config import FEAT
from laughter_detection_icsi_tpu_torch.models import layers as L
from laughter_detection_icsi_tpu_torch.ops import fbank as tfb
from laughter_detection_icsi_tpu_torch.train import Trainer
from tests.fixtures.torch_weights import SMALL, both_models, calibrated_models
from tests.test_torch_precision import N_SAMPLES, SIZES, _wave
from tests.test_torch_train import ARCH, flat, make_batches, port_trainer

FULL = dict(linear_layer_size=48, filter_sizes=(64, 32, 16, 16))


def _windows(wave):
    padded, _ = thp.host_pad_waveform(wave)
    feats = tfb.fbank(torch.from_numpy(padded.astype(np.float32) / 32768), thp.snip_cfg(FEAT))
    starts = torch.arange(0, feats.shape[0] - 100, 4)
    return feats[starts[:, None] + torch.arange(100)][:, None]


def conv_bias_gaps():
    separate, fused = L.conv_bias, lambda x, w, b, **kw: F.conv2d(x, w, b, **kw)
    for label, arch, wave in (("narrow", SMALL, _wave()), ("full", FULL, _wave(16000 * 3 + 777))):
        jm, params, state, tm = calibrated_models("ResNetBigger", _windows(wave), seed=5,
                                                  head_gain=0.35, **arch)
        for mode in ("windows", "fused_conv"):
            want = jinf.LaughterPipeline(jm, params, state, settings=jinf.InferenceSettings(
                **SIZES, mode=mode, precision="bfloat16")).probs_for_waveform(wave)
            gaps = {}
            for name, fn in (("separate", separate), ("fused", fused)):
                L.conv_bias = fn
                try:
                    got = tinf.LaughterPipeline(tm, device="cpu", settings=tinf.InferenceSettings(
                        **SIZES, mode=mode, precision="bfloat16")).probs_for_waveform(wave)
                finally:
                    L.conv_bias = separate
                gaps[name] = float(np.abs(got - want).max())
            print(f"conv_bias {label} {mode}: port vs JAX bf16 {gaps['separate']:.4g} with the "
                  f"separate add, {gaps['fused']:.4g} with the fused bias", flush=True)


def _jax_grad_fn(model):
    loss_fn = build_step_fns(model, JAdam(), compute_dtype="bfloat16")[0]
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port_grads(trainer, batch):
    x, y = trainer._prep(batch)
    return {k: g.numpy() for k, g in trainer.loss_and_grads(x, y)[2].items()}


def reference_init_gaps():
    jm = jmodels.build("ResNetBigger", dropout_rate=0.0, **ARCH)
    params, state = jm.init(jax.random.PRNGKey(3))
    params = jax_reference_init(params, jax.random.PRNGKey(4))
    side = dict(model=jm, params=params, state=state)
    grad = _jax_grad_fn(jm)
    for seed in (21, 101, 5, 7, 9):
        batch = make_batches(seed, 1)[0]
        _, jg = grad(params, state, jnp.asarray(batch["inputs"])[:, None],
                     jnp.asarray(batch["is_laugh"]), None)
        jg = flat(jg)
        scale = max(1.0, max(float(np.abs(g).max()) for g in jg.values()))

        def err(g):
            return max(float(np.abs(g[k] - jg[k]).max()) for k in jg) / scale

        bf = _port_grads(port_trainer(side, compute_dtype="bfloat16"), batch)
        f32 = _port_grads(port_trainer(side), batch)
        print(f"reference init, batch {seed}: max|g| {max(np.abs(g).max() for g in jg.values()):.3g}; "
              f"port bf16 {err(bf):.3g}, port float32 {err(f32):.3g}, port bf16 x 0.9 "
              f"{err({k: 0.9 * g for k, g in bf.items()}):.3g} of max(1, max|g|)", flush=True)


def weight_cosines():
    def cos(u, v):
        u, v = u.ravel().astype(np.float64), v.ravel().astype(np.float64)
        return float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v)))

    for wseed in (1, 2, 3, 5):
        jm, params, state, tm = both_models("ResNetBigger", wseed, 0.35, **SMALL)
        grad_bf = _jax_grad_fn(jm)
        grad_f32 = jax.jit(jax.value_and_grad(build_step_fns(jm, JAdam())[0], has_aux=True))
        for bseed in (4, 9, 21):
            batch = make_batches(bseed, 1)[0]
            args = (params, state, jnp.asarray(batch["inputs"])[:, None],
                    jnp.asarray(batch["is_laugh"]), None)
            jb, jf = flat(grad_bf(*args)[1]), flat(grad_f32(*args)[1])
            pb = _port_grads(Trainer(copy.deepcopy(tm), device="cpu", compute_dtype="bfloat16"),
                             batch)
            weights = [k for k, g in jb.items() if g.ndim >= 2]
            port = {k: cos(pb[k], jb[k]) for k in weights}
            worst = min(port, key=port.get)
            print(f"weights seed {wseed}, batch {bseed}: least cosine with JAX bf16: port bf16 "
                  f"{port[worst]:.3f} ({worst}; median {np.median(list(port.values())):.3f}), JAX "
                  f"float32 {min(cos(jf[k], jb[k]) for k in weights):.3f} over {len(weights)} "
                  f"weights", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    conv_bias_gaps()
    reference_init_gaps()
    weight_cosines()
