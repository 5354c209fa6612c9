"""The model's weights, made on the device from the seed, handed to both the
program and the reference.

Convs and linears are uniform in +-1/sqrt(fan_in) (the JAX training
package's initializer); every BatchNorm's affine weight is uniform in the
configuration's ``bn_weight_range`` and its bias normal with
``bn_bias_std``, so the BN expression is exercised.  The running statistics
are set away from 0 and 1: for inference, calibrated to the statistics of
the traffic's own windows layer by layer (as a trained checkpoint's are;
random statistics grow the activations through the stack), then moved by
a seeded jitter; for training, drawn around 0 and 1.  For inference the
last layer is scaled so that the logits of the calibration windows have
the configured spread and mean, and a bfloat16 configuration gets weights
that bfloat16 holds exactly, so both sides compute from the same numbers.
All draws come from one generator on the device, in a few large calls.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from reference import resnet


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def initial(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf (float32, on ``device``) before any calibration."""
    shapes = resnet.param_shapes(cfg["model"])
    w = cfg["weights"]
    gen = _generator(seed, device)
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    total = sum(sizes.values())
    uniform = torch.rand(total, generator=gen, device=device)
    normal = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        u = uniform[at:at + sizes[k]].reshape(shape)
        z = normal[at:at + sizes[k]].reshape(shape)
        at += sizes[k]
        module, leaf = k.rsplit(".", 1)
        is_bn = f"{module}.running_mean" in shapes
        if not is_bn:
            fan_in = math.prod(shapes[f"{module}.weight"][1:])
            out[k] = (2.0 * u - 1.0) / math.sqrt(fan_in)
            if len(shape) == 4 and shape[2] > 1 and "time_tap_spread" in w:
                # The taps of a kernel along time share one draw, up to a
                # seeded spread: filters that are smooth in time.
                mean = out[k].mean(dim=2, keepdim=True)
                out[k] = mean + w["time_tap_spread"] * (out[k] - mean)
        elif leaf == "weight":
            lo, hi = w["bn_weight_range"]
            out[k] = lo + (hi - lo) * u
        elif leaf == "bias":
            out[k] = w["bn_bias_std"] * z
        elif leaf == "running_mean":
            out[k] = w["running_mean_jitter"] * z
        else:
            lo, hi = w["running_var_range"]
            out[k] = lo + (hi - lo) * u
    return out


def calibrated(cfg: dict, seed: int, windows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inference weights: ``initial``, then each BatchNorm's statistics set
    to those of its input over ``windows`` ([B, 1, window, F] float32, on
    the device) in one train-mode pass at momentum 1, then jittered (mean
    by ``running_mean_jitter`` standard deviations, variance by a factor in
    ``running_var_range``), then the last layer scaled to the configured
    logit spread and mean; rounded to bfloat16 values where the
    configuration runs in bfloat16."""
    w = cfg["weights"]
    device = windows.device
    p = initial(cfg, seed, device)
    gen = _generator(seed + 1, device)
    model = {**cfg["model"], "dropout_rate": 0.0}
    with torch.no_grad():
        resnet.forward(p, windows, model, train=True, momentum=1.0)
        lo, hi = w["running_var_range"]
        for k in [k for k in p if k.endswith("running_var")]:
            mean_k = k.replace("running_var", "running_mean")
            var = p[k].clamp_min(1e-3 * float(p[k].median()) + 1e-12)
            u = torch.rand(var.shape, generator=gen, device=device)
            z = torch.randn(var.shape, generator=gen, device=device)
            p[mean_k] = p[mean_k] + w["running_mean_jitter"] * var.sqrt() * z
            p[k] = var * (lo + (hi - lo) * u)
        logit = torch.logit(resnet.probs_in_blocks(p, windows, model).double(), eps=1e-12)
        gain = w["head_logit_std"] / float(logit.std())
        p["linear2.weight"] = p["linear2.weight"] * gain
        p["linear2.bias"] = p["linear2.bias"] * gain + (w["head_logit_mean"] - gain * float(logit.mean()))
    if cfg["precision"] == "bfloat16":
        p = {k: v.to(torch.bfloat16).float() for k, v in p.items()}
    return p


def port_state_dict(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves as the port's ``state_dict`` holds them (with BatchNorm's
    ``num_batches_tracked``), on the host."""
    sd = {k: v.detach().float().cpu().clone() for k, v in p.items()}
    for k in [k for k in p if k.endswith("running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.zeros((), dtype=torch.long)
    return sd
