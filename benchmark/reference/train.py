"""The training step in plain PyTorch: the plain reference of a train cell.

One step is the train-mode forward of ``reference.resnet`` (BatchNorm by
batch statistics, its running statistics moved; dropout), the mean binary
cross-entropy of the probabilities (torch's ``BCELoss``), the gradients by
autograd, a clip of their global norm to ``max_grad_norm`` (scale
``max_norm / (norm + 1e-6)`` where that is below 1), and Adam's update in
the expression of the JAX training package: ``p - lr * (m / (1 - b1^t)) /
(sqrt(v / (1 - b2^t)) + eps)``.

Dropout's draws: step ``s`` of a run seeded ``seed`` draws from a
generator on the device seeded with numpy's ``SeedSequence([seed,
s]).generate_state(1, uint64)[0] >> 1``, the rule the trained program
states for its steps so that a resumed run draws what an uninterrupted one
does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference import resnet
from reference.precision import float32


def step_generator(seed: int, step: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def train_steps(p0: Dict[str, torch.Tensor], batches: Sequence, model: dict, optim: dict,
                seed: int, tf32: bool = False, moments: Optional[tuple] = None,
                step0: int = 0) -> Dict[str, object]:
    """Run ``len(batches)`` steps from the leaves ``p0`` (left as they are)
    on ``(x [B, 1, W, F], y [B])`` batches.  ``moments``, ``(m, v, t)``,
    starts Adam from its moments after ``t`` steps (default: nought, at
    step 0); the first step draws its dropout as global step ``step0``.
    Returns the losses, the first step's clipped gradients and every leaf
    after the first step and after the last."""
    names = [k for k in p0 if not resnet.is_running(k)]
    params = {k: p0[k].detach().clone().float().requires_grad_() for k in names}
    running = {k: v.detach().clone().float() for k, v in p0.items() if resnet.is_running(k)}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v = {k: torch.zeros_like(v) for k, v in params.items()}
        t0 = 0
    else:
        m = {k: moments[0][k].detach().clone().float() for k in names}
        v = {k: moments[1][k].detach().clone().float() for k in names}
        t0 = int(moments[2])
    b1, b2, lr, eps = optim["b1"], optim["b2"], optim["lr"], optim["eps"]
    losses: List[float] = []
    grad1 = first = None
    with float32(tf32):
        for s, (x, y) in enumerate(batches):
            gen = step_generator(seed, step0 + s, x.device)
            probs = resnet.forward({**params, **running}, x, model, train=True, generator=gen)
            loss = F.binary_cross_entropy(probs, y)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = min(1.0, optim["max_grad_norm"] / (float(norm) + 1e-6))
            grads = {k: g * scale for k, g in zip(names, grads)}
            if grad1 is None:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
            t = t0 + s + 1
            with torch.no_grad():
                for k in names:
                    m[k] = b1 * m[k] + (1.0 - b1) * grads[k]
                    v[k] = b2 * v[k] + (1.0 - b2) * grads[k] ** 2
                    step = lr * (m[k] / (1.0 - b1 ** t)) / (torch.sqrt(v[k] / (1.0 - b2 ** t)) + eps)
                    params[k] -= step
            losses.append(loss.item())
            if s == 0:
                first = {k: t.detach().clone() for k, t in {**params, **running}.items()}
    after = {k: t.detach() for k, t in params.items()}
    after.update(running)
    return {"losses": losses, "grad1": grad1, "after1": first, "after": after}
