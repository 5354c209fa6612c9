"""Optimizer: torch-exact Adam with global-norm gradient clipping.

The port of the JAX package's ``train/optim.py``.  The reference trains
with ``optim.Adam(model.parameters())`` at its defaults (its LR-decay
schedule writes a dead attribute, so training is plain Adam at lr 1e-3;
reference train.py:336,346-349) and ``clip_grad_norm_(..., 1.0)`` before
every optimizer step (reference train.py:291-295).

The update is JAX's expression, ``p - lr * (m / bc1) / (sqrt(v / bc2) +
eps)`` with ``bc = 1 - b ** step`` in float32 — not ``torch.optim.Adam``,
which rounds differently — so the two packages' parameters agree to 1e-6
after a step from the same state.  The moments live in an explicit
:class:`AdamState` keyed like the module's ``state_dict`` (and like JAX's
flattened trees), which checkpoints carry; the parameters are updated in
place, as a torch module owns them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Optional

import torch

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar: optimizer steps taken
    mu: Tensors  # first moment, by parameter name
    nu: Tensors  # second moment, by parameter name


@dataclasses.dataclass(frozen=True)
class Adam:
    """torch.optim.Adam semantics (moments, bias correction, eps after the
    sqrt) with the global-norm clip folded into :meth:`update`."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: Optional[float] = 1.0  # reference train.py:292

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        """Zero moments shaped and placed like ``params``, at step 0."""
        device = next(iter(params.values())).device
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Mapping[str, torch.Tensor]) -> AdamState:
        """One step: clips ``grads`` (when ``max_grad_norm`` is set), moves
        the moments, writes the new values into ``params`` in place, and
        returns the new state.  Nothing here reads a value back to the
        host."""
        if self.max_grad_norm is not None:
            grads = clip_by_global_norm(grads, self.max_grad_norm)
        step = state.step + 1
        t = step.to(torch.float32)  # the powers in float32, as JAX's, on the device
        bc1, bc2 = 1.0 - torch.pow(self.b1, t), 1.0 - torch.pow(self.b2, t)
        mu, nu = {}, {}
        for k, p in params.items():
            g = grads[k]
            m = self.b1 * state.mu[k] + (1.0 - self.b1) * g
            v = self.b2 * state.nu[k] + (1.0 - self.b2) * (g * g)
            mhat = m / bc1.to(m.dtype)
            vhat = v / bc2.to(v.dtype)
            p.copy_(p - self.lr * mhat / (torch.sqrt(vhat) + self.eps))
            mu[k], nu[k] = m, v
        return AdamState(step=step, mu=mu, nu=nu)


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every value, in float32 (a device
    scalar)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors.values()))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float) -> Tensors:
    """``torch.nn.utils.clip_grad_norm_`` semantics: scale every gradient by
    ``max_norm / (total_norm + 1e-6)`` when that is below 1."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-6), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}
