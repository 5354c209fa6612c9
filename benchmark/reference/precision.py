"""The precision the reference computes in, and the lower ones of its controls."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32(tf32: bool = False):
    """float32 convs and matmuls inside the block: full float32 (TF32 off),
    or with ``tf32`` the TF32 tensor-core path, the precision below it.
    The previous settings come back on exit."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    prev = (conv.fp32_precision, mm.fp32_precision)
    conv.fp32_precision = mm.fp32_precision = "tf32" if tf32 else "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = prev


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale that maps its
    largest magnitude to 448, and back to its dtype: the step below
    bfloat16."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
