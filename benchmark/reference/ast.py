"""The Audio Spectrogram Transformer as a laughter tagger, in plain PyTorch:
the plain reference of the clips cells.

What the published code computes for one clip (https://github.com/
YuanGongND/ast: ``src/dataloader.py``'s features and normalisation,
``src/models/ast_models.py`` ``ASTModel`` on timm's DeiT ``Block``), with
the sizes of the configuration's ``features``, ``clips`` and ``model``
groups:

- features: ``torchaudio.compliance.kaldi.fbank`` in float64.  Frames fit
  inside the audio (``snip_edges``): ``T = 1 + (n - length) // shift``,
  frame ``t`` at sample ``t * shift``; per frame the mean removed,
  preemphasis (each sample minus ``coeff`` times the one before it, the
  first minus ``coeff`` times itself), a Hann window ``0.5 - 0.5 cos(2 pi
  i / (length - 1))``, zeros to the FFT size; the power spectrum; a bank of
  triangular filters evenly spaced on Kaldi's mel scale ``1127 ln(1 + f /
  700)`` from ``low_hz`` to Nyquist plus ``high_hz`` (0: Nyquist) over the
  bins below Nyquist (``reference/fbank.mel_banks``); the natural log,
  floored at ``energy_floor``.  16-bit PCM is scaled by 1 / 32768;
- a clip: block ``k`` of a track (its output frames ``[k hop, (k + 1)
  hop)``) reads frames ``[k hop - context, k hop - context + clip_frames)``
  with ``context = (clip_frames - hop) / 2``; frames outside the track are
  log-mel 0 (the published ``ZeroPad2d``, before normalisation); then
  ``(x - mean) / (2 std)``;
- the model: ``[B, T, F] -> [B, 1, F, T]``, a ``patch``-sized conv at
  strides ``(fstride, tstride)``, its ``f x t`` grid flattened row-major,
  the ``cls`` and ``dist`` tokens first, the position embedding added;
  ``depth`` blocks ``x += proj(softmax(q k^T / sqrt(head_dim)) v)`` on
  ``LN(x)`` and ``x += fc2(GELU(fc1(LN(x))))`` (exact GELU, LN eps 1e-6);
  the final LN, the mean of the two tokens, ``LayerNorm`` (eps 1e-5) and
  the linear head: ``[B, label_dim]`` logits.

Departures from the published code:

- dropout and drop-path are 0 (their values at evaluation) and left out;
- the dataloader subtracts the file's mean from the waveform before the
  fbank: under the per-frame mean removal that changes nothing, and a
  meeting is not one file-sized clip, so it is left out;
- the dataloader pads (or cuts) a file's features at their end to 1,024
  frames; a meeting's clips are cut around their blocks instead, with zero
  log-mel on both sides of the track;
- training's frequency and time masking, mixup and noise are left out;
- attention is written out, as timm's ``Attention`` writes it, in float32
  with TF32 off (``reference/precision.float32``).

Parameters are a flat dict of tensors under the published ``state_dict``
names (``v.cls_token``, ``v.patch_embed.proj.weight``,
``v.blocks.0.attn.qkv.weight``, ..., ``mlp_head.1.bias``).  Nothing here
imports JAX or the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference.fbank import mel_banks
from reference.precision import float32

LN_EPS = 1e-6
HEAD_LN_EPS = 1e-5


def patch_grid(model: dict):
    """(frequency, time) patches of a clip."""
    k = model["patch"]
    return ((model["fdim"] - k) // model["fstride"] + 1, (model["tdim"] - k) // model["tstride"] + 1)


def param_shapes(model: dict) -> Dict[str, tuple]:
    """Every leaf of the published ``state_dict`` and its shape."""
    d, m, k = model["dim"], model["mlp"], model["patch"]
    f, t = patch_grid(model)
    s: Dict[str, tuple] = {"v.cls_token": (1, 1, d), "v.dist_token": (1, 1, d),
                           "v.pos_embed": (1, f * t + 2, d),
                           "v.patch_embed.proj.weight": (d, 1, k, k),
                           "v.patch_embed.proj.bias": (d,)}
    for i in range(model["depth"]):
        b = f"v.blocks.{i}."
        s.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                  b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
                  b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                  b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                  b + "mlp.fc1.weight": (m, d), b + "mlp.fc1.bias": (m,),
                  b + "mlp.fc2.weight": (d, m), b + "mlp.fc2.bias": (d,)})
    s.update({"v.norm.weight": (d,), "v.norm.bias": (d,),
              "mlp_head.0.weight": (d,), "mlp_head.0.bias": (d,),
              "mlp_head.1.weight": (model["label_dim"], d),
              "mlp_head.1.bias": (model["label_dim"],)})
    return s


def num_frames(n: int, feat: dict) -> int:
    length, shift = feat["frame_length_samples"], feat["frame_shift_samples"]
    return 0 if n < length else 1 + (n - length) // shift


def fbank(pcm, feat: dict, device="cpu", block: int = 8192) -> torch.Tensor:
    """One channel of int16 (or float in [-1, 1]) PCM -> [T, num_filters]
    float64 log-mel on ``device``, ``block`` frames at a time."""
    x = torch.as_tensor(np.asarray(pcm)).to(device)
    x = x.double() / 32768.0 if x.dtype == torch.int16 else x.double()
    shift, length, nfft = feat["frame_shift_samples"], feat["frame_length_samples"], feat["fft_size"]
    t = num_frames(x.shape[0], feat)
    i = torch.arange(length, device=device)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * i.double() / (length - 1))
    banks = torch.from_numpy(mel_banks(feat)).to(device)
    out = [torch.zeros((0, feat["num_filters"]), dtype=torch.float64, device=device)]
    for lo in range(0, t, block):
        starts = torch.arange(lo, min(lo + block, t), device=device) * shift
        frames = x[starts[:, None] + i[None, :]]
        frames = frames - frames.mean(dim=1, keepdim=True)
        prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = (frames - feat["preemph_coeff"] * prev) * window
        power = torch.fft.rfft(frames, n=nfft).abs() ** 2
        out.append(torch.log(torch.clamp(power @ banks, min=feat["energy_floor"])))
    return torch.cat(out)


def clips_at(feats: torch.Tensor, blocks: Sequence[int], clips: dict, norm: dict) -> torch.Tensor:
    """The normalised clip of each block of a track's features [T, F]:
    [len(blocks), clip_frames, F] float32, frames outside the track log-mel
    0 before the normalisation."""
    t, f = feats.shape
    clip, hop = clips["clip_frames"], clips["hop_frames"]
    context = (clip - hop) // 2
    padded = torch.cat([feats.new_zeros((context, f)), feats, feats.new_zeros((clip, f))])
    idx = torch.as_tensor(np.asarray(blocks), device=feats.device)[:, None] * hop + torch.arange(
        clip, device=feats.device)[None, :]
    x = padded[idx]
    return ((x - norm["mean"]) / (2.0 * norm["std"])).float()


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
            quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """[B, tdim, fdim] clips -> [B, label_dim] logits.  ``quant``, when
    given, rounds the inputs of every product (the patch conv, each linear,
    q, k, v and the attention weights) and every weight: a lower-precision
    control."""
    q = quant or (lambda t: t)
    d, heads = model["dim"], model["heads"]

    def linear(name, h):
        return F.linear(q(h), q(p[name + ".weight"]), p[name + ".bias"])

    def ln(name, h, eps=LN_EPS):
        return F.layer_norm(h, (d,), p[name + ".weight"], p[name + ".bias"], eps)

    h = F.conv2d(q(x.unsqueeze(1).transpose(2, 3)), q(p["v.patch_embed.proj.weight"]),
                 p["v.patch_embed.proj.bias"], stride=(model["fstride"], model["tstride"]))
    h = h.flatten(2).transpose(1, 2)
    b = h.shape[0]
    h = torch.cat([p["v.cls_token"].expand(b, -1, -1), p["v.dist_token"].expand(b, -1, -1), h], 1)
    h = h + p["v.pos_embed"]
    n, hd = h.shape[1], d // heads
    for i in range(model["depth"]):
        pre = f"v.blocks.{i}."
        qkv = linear(pre + "attn.qkv", ln(pre + "norm1", h))
        qkv = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q(qkv[0]) @ q(qkv[1]).transpose(-2, -1)) * hd ** -0.5
        a = (q(attn.softmax(dim=-1)) @ q(qkv[2])).transpose(1, 2).reshape(b, n, d)
        h = h + linear(pre + "attn.proj", a)
        h = h + linear(pre + "mlp.fc2", F.gelu(linear(pre + "mlp.fc1", ln(pre + "norm2", h))))
    h = ln("v.norm", h)
    h = (h[:, 0] + h[:, 1]) / 2
    return linear("mlp_head.1", ln("mlp_head.0", h, HEAD_LN_EPS))


def logits(p: Dict[str, torch.Tensor], clips: torch.Tensor, model: dict, block: int = 8,
           **kw) -> torch.Tensor:
    """Logits of many clips, ``block`` at a time, in float32 with TF32 off."""
    with torch.no_grad(), float32():
        return torch.cat([forward(p, clips[i:i + block], model, **kw)
                          for i in range(0, clips.shape[0], block)])
