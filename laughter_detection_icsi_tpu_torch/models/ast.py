"""The Audio Spectrogram Transformer (AST) as an ``nn.Module``: an AudioSet
tagger whose "Laughter" class (index 16) gives a laughter probability.

Gong, Chung and Glass, "AST: Audio Spectrogram Transformer", Interspeech
2021 (arXiv:2104.01778); the published ``src/models/ast_models.py``
``ASTModel`` on timm's DeiT-base-distilled blocks, at its AudioSet setting
(base384, ``fstride = tstride = 10``, ``input_fdim`` 128, ``input_tdim``
1024, 527 classes).  The JAX package has no twin of it: the port's AST is
held against ``benchmark/reference/ast.py``.

- Tokens: a clip's normalised log-mel ``[B, tdim, fdim]`` turns to ``[B, 1,
  fdim, tdim]`` (frequency on H), a ``Conv2d(1, dim, 16, stride=(fstride,
  tstride))`` cuts it into an ``f x t`` grid of patch tokens (12 x 101 =
  1,212 at the published sizes), taken row-major; the ``cls`` and
  ``dist`` tokens go first and a learned position embedding is added.
- ``depth`` pre-norm blocks: ``x += proj(MHSA(LN(x)))`` (qkv one biased
  linear, ``heads`` heads, scale ``head_dim ** -0.5``, through
  ``F.scaled_dot_product_attention``: the flash path on the card in
  bfloat16), then ``x += fc2(GELU(fc1(LN(x))))`` (exact GELU); LayerNorm's
  eps is 1e-6 (timm's ``VisionTransformer``).
- Head: the final LayerNorm, the mean of the ``cls`` and ``dist`` tokens,
  ``LayerNorm(dim)`` (torch's eps 1e-5) and ``Linear(dim, label_dim)``.

The parameters carry the published ``state_dict`` names (``v.cls_token``,
``v.patch_embed.proj.weight``, ``v.blocks.0.attn.qkv.weight``, ...,
``mlp_head.1.bias``).  ``forward`` is :meth:`head` of :meth:`encode` of
:meth:`embed`; the clips mode of ``inference.py`` calls the three in turn,
each inside a span of its own.  Dropout and drop-path are 0 (the published
model's values at evaluation), so the module has no train-mode behaviour
of its own; the port does not train it (``cli/train`` refuses it).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

#: The row of AudioSet's 527-way head that is "Laughter" (``/m/01j3sz``,
#: index 16 of the published ``class_labels_indices.csv``).
LAUGHTER_CLASS = 16

LN_EPS = 1e-6  # timm's DeiT blocks and final norm
HEAD_LN_EPS = 1e-5  # mlp_head's LayerNorm: torch's default


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, fstride: int, tstride: int, patch: int = 16):
        super().__init__()
        self.proj = nn.Conv2d(1, dim, kernel_size=(patch, patch), stride=(fstride, tstride))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _Vit(nn.Module):
    """The published model's ``v``: patch embedding, tokens, blocks, norm."""

    def __init__(self, n_patches: int, dim: int, depth: int, heads: int, mlp: int,
                 fstride: int, tstride: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 2, dim))
        self.patch_embed = PatchEmbed(dim, fstride, tstride)
        self.blocks = nn.ModuleList(Block(dim, heads, mlp) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


def patch_grid(fdim: int, tdim: int, fstride: int, tstride: int, patch: int = 16):
    """(frequency, time) patches of a ``fdim x tdim`` clip."""
    return (fdim - patch) // fstride + 1, (tdim - patch) // tstride + 1


class ASTModel(nn.Module):
    """AST over ``[B, tdim, fdim]`` normalised log-mel clips -> ``[B,
    label_dim]`` logits.  ``fdim``/``tdim`` fix the position embedding's
    grid, so every clip has ``tdim`` frames."""

    def __init__(self, fdim: int = 128, tdim: int = 1024, fstride: int = 10, tstride: int = 10,
                 dim: int = 768, depth: int = 12, heads: int = 12, mlp: int = 3072,
                 label_dim: int = 527):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} does not split into {heads} heads")
        self.name = "AST"
        self.dropout_rate = 0.0
        self.fdim, self.tdim, self.label_dim = fdim, tdim, label_dim
        self.grid = patch_grid(fdim, tdim, fstride, tstride)
        self.v = _Vit(self.grid[0] * self.grid[1], dim, depth, heads, mlp, fstride, tstride)
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=HEAD_LN_EPS),
                                      nn.Linear(dim, label_dim))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, tdim, fdim]`` clips -> ``[B, 2 + patches, dim]`` tokens with
        their positions."""
        if x.shape[1:] != (self.tdim, self.fdim):
            raise ValueError(f"AST takes [B, {self.tdim}, {self.fdim}] clips, got "
                             f"{tuple(x.shape)}")
        v = self.v
        x = v.patch_embed.proj(x.unsqueeze(1).transpose(2, 3)).flatten(2).transpose(1, 2)
        b = x.shape[0]
        x = torch.cat([v.cls_token.expand(b, -1, -1), v.dist_token.expand(b, -1, -1), x], dim=1)
        return x + v.pos_embed

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks and the final norm."""
        for blk in self.v.blocks:
            x = blk(x)
        return self.v.norm(x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Encoded tokens -> ``[B, label_dim]`` logits."""
        return self.mlp_head((x[:, 0] + x[:, 1]) / 2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del generator  # no dropout: the published model's rates at evaluation
        return self.head(self.encode(self.embed(x)))

    def init_weights(self, generator: torch.Generator) -> None:
        """timm's initialisation, drawn from ``generator`` (a CPU one):
        every linear trunc-normal(0.02) with zero bias, LayerNorm 1 and 0,
        the tokens and the position embedding trunc-normal(0.02), and the
        patch convolution torch's default (uniform in +-1/sqrt(fan_in),
        the published model's freshly made ``Conv2d``)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, nn.LayerNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
            for p in (self.v.cls_token, self.v.dist_token, self.v.pos_embed):
                nn.init.trunc_normal_(p, std=0.02, generator=generator)
            conv = self.v.patch_embed.proj
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            conv.weight.uniform_(-bound, bound, generator=generator)
            conv.bias.uniform_(-bound, bound, generator=generator)
