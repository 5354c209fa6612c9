"""Data-parallel training over the processes of a ``torch.distributed`` group.

The port of the JAX package's ``parallel/data_parallel.py``: parameters
and the Adam state replicated, one device per process, the global batch
split into contiguous blocks of rows in rank order, and a step that is
numerically the one-process step on the global batch.  BatchNorm uses the
global batch's statistics and dropout the global batch's mask
(``models.layers.data_parallel_scope``); each process's loss is its rows'
BCE sum over the global batch size, so the gradients summed over the
processes are the global mean loss's.  The gradients and the step's metric
counts go through one sum ``all_reduce`` a step, flattened into one
buffer; Adam then runs the same on every process.

The step body is :class:`train.Trainer`'s: this class overrides only the
three hooks where a data-parallel step differs (``_scope``, ``_loss``,
``_reduce``) and where its rows come from (``_prep``), as JAX shares
``build_step_fns`` between its two trainers.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from laughter_detection_icsi_tpu_torch.models.layers import data_parallel_scope
from laughter_detection_icsi_tpu_torch.parallel import distributed, mesh
from laughter_detection_icsi_tpu_torch.train.loop import Tensors, Trainer, metric_counts, \
    metrics_from_counts


@dataclasses.dataclass
class DataParallelTrainer(Trainer):
    """:class:`train.Trainer`'s interface over the default process group.

    A host batch is the global batch in a run of one process and this
    process's rows of it in a run of several (JAX :53-58): every process
    passes the same number of rows.  A resident marker (``{'resident',
    'idx'}``) names global rows, which the (sharded) resident dataset
    gathers; each process then takes its block.  The parameters and
    BatchNorm buffers are broadcast from process 0 when the trainer is
    made, so every process starts from the same model.  No gradient
    accumulation, as in JAX: every step applies."""

    def __post_init__(self):
        if self.grad_accum != 1:
            raise ValueError("--gradient_accumulation_steps requires single-device mode")
        super().__post_init__()
        self.rank, self.world = mesh.world()
        if self.world > 1:
            distributed.broadcast_tensors([*self.model.parameters(), *self.model.buffers()])

    def _prep(self, batch):
        x, y = super()._prep(batch)
        if batch.get("resident") is not None:
            # Every process gathered the global batch: keep this one's block.
            lo, hi = mesh.row_block(len(y), self.rank, self.world)
            return x[lo:hi], y[lo:hi]
        return x, y

    def _scope(self):
        return data_parallel_scope()

    def _loss(self, probs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # This process's rows' BCE sum over the global batch size: the sum
        # over the processes is the global batch's mean.
        return super()._loss(probs, y) * (1.0 / self.world)

    def _reduce(self, grads: Tensors, loss: torch.Tensor, probs: torch.Tensor,
                y: torch.Tensor):
        """One sum ``all_reduce`` of the gradients, the loss and the metric
        counts, flattened into one float32 buffer."""
        if self.world == 1:
            return super()._reduce(grads, loss, probs, y)
        parts = [g.reshape(-1) for g in grads.values()]
        tail = torch.cat([loss.reshape(1).float(), metric_counts(probs, y)])
        flat = torch.cat([*parts, tail])
        dist.all_reduce(flat)
        pieces = flat.split([p.numel() for p in parts] + [tail.numel()])
        reduced = {k: piece.view_as(g) for (k, g), piece in zip(grads.items(), pieces)}
        metrics = metrics_from_counts(pieces[-1][1:], probs.shape[0] * self.world)
        metrics["loss"] = pieces[-1][0]
        return reduced, metrics
