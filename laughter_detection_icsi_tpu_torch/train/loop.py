"""Training: the train and eval steps, gradient accumulation, the epoch loop.

The port of the JAX package's ``train/loop.py`` (reference train.py:150-415).
One train step is forward, BCE loss, backward, global-norm clip and the
Adam update, with BatchNorm's running statistics updated by the forward;
the host loop feeds batches and reads scalar metrics back only at log
points (losses stay on the device in between).

Where the JAX package is functional, the port keeps torch's idiom: the
``nn.Module`` owns the parameters and the BatchNorm buffers and the steps
update them in place; the Adam state is explicit (``train/optim.py``).  So
what JAX's loop does by keeping an old ``state`` value — rolling BatchNorm
back to the last optimizer-apply boundary when a gradient-accumulation
group is dropped — the :class:`Trainer` does with a copy of the buffers
taken when a group starts.

Parity notes (the JAX package's):
- loss: torch ``BCELoss`` on sigmoid outputs, mean, logs clamped at -100;
  its backward is the one JAX's custom VJP copies;
- clip 1.0 and Adam lr 1e-3 every ``grad_accum`` batches;
- metrics at threshold 0.5; precision 1.0 with no positive prediction,
  recall 1.0 with no positive target (PARITY.md #13);
- checkpoint every ``log_frequency`` steps, best on the lowest val loss;
  accumulation groups never span epochs (PARITY.md #22).

Dropout draws from a ``torch.Generator`` seeded from (run seed, global
step) (:func:`step_generator`), so a resumed run draws what an
uninterrupted one draws: JAX's ``fold_in(key, step)`` contract.  The bits
differ from JAX's threefry, so comparisons with JAX run at dropout 0.

Batches come from the host (numpy, ``data.LadDataset``) or from a split
resident on the device (``data.ResidentLadDataset``): its
``{'resident', 'idx'}`` markers are gathered on the device, and
``TrainLoop(steps_per_dispatch=K)`` hands K consecutive ones to one
``Trainer.train_k_steps_resident`` call, which gives the numbers of K
single steps.  The K steps run in order from the host; a CUDA graph of
them is ROADMAP item 11.

``Trainer(compute_dtype='bfloat16')`` is JAX's mixed-precision recipe (its
``build_step_fns`` ``apply_model`` boundary): the parameters are cast to
bf16 inside the autograd graph from the float32 masters, so gradients
arrive in float32 on the masters; the input is cast after ``_prep`` and
the probabilities come back as float32.  In train mode the BatchNorm
buffers stay float32 and move in place (statistics reduced in float32,
``models/layers.py``); in eval mode they are cast too.  The loss, metrics,
gradients, Adam moments and checkpoints stay float32.  Not
``torch.autocast``: it keeps BatchNorm, pooling and reductions in float32
and casts op by op, which is not the JAX package's rounding chain.

Several processes train one model with ``parallel.DataParallelTrainer``
(a :class:`Trainer` whose step reduces over a process group); the loop
then votes on preemption (``sync_preempt``) and only the coordinator
writes (``write_artifacts``).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from laughter_detection_icsi_tpu_torch.inference import precision_scope, resolve_device
from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib
from laughter_detection_icsi_tpu_torch.train.optim import Adam, AdamState
from laughter_detection_icsi_tpu_torch.utils.profiling import annotate

Tensors = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# Loss and metrics
# --------------------------------------------------------------------------- #


def bce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``torch.nn.BCELoss`` (mean): logs clamped at -100 in the forward; the
    backward ``(p - y) / max(p (1 - p), 1e-12) / N`` stays finite when a
    sigmoid saturates to exactly 0 or 1."""
    return F.binary_cross_entropy(probs, targets)


def batch_metrics(probs: torch.Tensor, targets: torch.Tensor) -> Tensors:
    """Accuracy, precision and recall at 0.5 as device scalars (reference
    train.py:203-224).  Precision is 1.0 with no positive prediction, as the
    reference's special case; recall is 1.0 with no positive target, where
    the reference's is NaN (PARITY.md #13)."""
    return metrics_from_counts(metric_counts(probs, targets), probs.shape[0])


def metric_counts(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[correct, true positives, predicted positives, actual positives] at
    0.5, as one float32 tensor: sums, so a batch split over processes adds
    up to the whole batch's."""
    preds = (probs > 0.5).float()
    targets = targets.float()
    return torch.stack([torch.sum((preds == targets).float()), torch.sum(preds * targets),
                        torch.sum(preds), torch.sum(targets)])


def metrics_from_counts(counts: torch.Tensor, n: int) -> Tensors:
    """:func:`batch_metrics` from :func:`metric_counts` of ``n`` rows."""
    correct, tp, pred_pos, actual_pos = counts.unbind()
    one = torch.ones((), device=counts.device)
    return {
        "acc": correct / n,
        "precision": torch.where(pred_pos == 0, one, tp / torch.clamp(pred_pos, min=1.0)),
        "recall": torch.where(actual_pos == 0, one, tp / torch.clamp(actual_pos, min=1.0)),
    }


def step_generator(seed: int, step: int, device: Union[str, torch.device]) -> torch.Generator:
    """The dropout generator of global step ``step`` in a run seeded
    ``seed``: a pure function of the two (the pair is hashed by numpy's
    ``SeedSequence``), on ``device``."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


# --------------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Trainer:
    """The train and eval steps for one model and optimizer, on ``device``
    (default ``cuda``; no fallback to the CPU).  The model moves there and
    its parameters and BatchNorm buffers are updated in place.

    Batches are dicts with 'inputs' [B, T, F] float (numpy or a tensor) and
    'is_laugh' [B] (the LadDataset contract, reference datasets.py:23-68);
    the channel axis is added inside the step.
    """

    model: nn.Module
    optimizer: Adam = dataclasses.field(default_factory=Adam)
    grad_accum: int = 1
    #: 'bfloat16' rounds the feature batches to bf16 on the host (half the
    #: upload bytes); they are float32 again on the device.
    transfer_dtype: Optional[str] = None
    #: 'bfloat16' runs the forward and backward in bf16 with float32
    #: masters (see the module docstring).
    compute_dtype: Optional[str] = None
    device: Union[None, str, torch.device] = None

    def __post_init__(self):
        for name in ("transfer_dtype", "compute_dtype"):
            if getattr(self, name) not in (None, "float32", "bfloat16"):
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; "
                                 "use 'bfloat16' or 'float32'/None")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")
        self.device = resolve_device(self.device)
        self.model.to(self.device)
        self._acc_grads: Optional[Tensors] = None
        self._accum_count = 0
        #: BatchNorm buffers as they were when the pending group started.
        self._boundary: Optional[Tensors] = None

    # ------------------------------------------------------------------ #

    @property
    def params(self) -> Tensors:
        return dict(self.model.named_parameters())

    def init(self) -> AdamState:
        """A fresh Adam state for the model's parameters."""
        return self.optimizer.init(self.params)

    def _prep(self, batch):
        if batch.get("resident") is not None:  # a ResidentLadDataset marker
            x, _lens, y = batch["resident"].gather(batch["idx"])
            return x[:, None, :, :], y
        inputs = batch["inputs"]
        if isinstance(inputs, torch.Tensor) and inputs.device.type == self.device.type:
            # Already on the device (a resident dataset's gathered batch):
            # nothing crosses the link, so no transfer rounding.
            x = inputs.float()[:, None, :, :]
        else:
            if not isinstance(inputs, torch.Tensor):
                inputs = torch.from_numpy(np.ascontiguousarray(inputs, dtype=np.float32))
            if self.transfer_dtype == "bfloat16":
                inputs = inputs.to(torch.bfloat16)
            x = inputs.to(self.device).float()[:, None, :, :]
        labels = batch["is_laugh"]
        if not isinstance(labels, torch.Tensor):
            labels = torch.from_numpy(np.asarray(labels, dtype=np.float32))
        return x, labels.to(self.device).float()

    @property
    def precision(self) -> str:
        return self.compute_dtype or "float32"

    def _forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """The model behind the precision boundary: float32 in, float32
        out, bf16 strictly inside when ``compute_dtype='bfloat16'`` (JAX
        ``apply_model``).  The casts of the parameters are part of the
        autograd graph, so their gradients reach the float32 masters."""
        if self.precision == "float32":
            return self.model(x, generator=generator)
        dtype = torch.bfloat16
        cast = {k: p.to(dtype) for k, p in self.model.named_parameters()}
        if not self.model.training:
            # Eval mode moves no statistic: the buffers are cast as well,
            # as the inference pipeline's bf16 copy has them.
            cast.update({k: b.to(dtype) for k, b in self.model.named_buffers()
                         if b.is_floating_point()})
        probs = torch.func.functional_call(self.model, cast, (x.to(dtype),),
                                           {"generator": generator})
        return probs.float()

    def loss_and_grads(self, x: torch.Tensor, y: torch.Tensor,
                       generator: Optional[torch.Generator] = None):
        """Train-mode forward (BatchNorm buffers move) and backward on
        device batches: (loss, probs, grads by parameter name).  The two
        halves are named regions ('train/forward', 'train/backward') in a
        profiler trace."""
        self.model.train()
        names, params = zip(*self.model.named_parameters())
        with precision_scope(self.precision), self._scope():
            with annotate("train/forward"):
                probs = self._forward(x, generator)
                loss = self._loss(probs, y)
            with annotate("train/backward"):
                grads = torch.autograd.grad(loss, params)
        return loss.detach(), probs.detach(), dict(zip(names, grads))

    # The three places where a data-parallel step differs from this one
    # (parallel.DataParallelTrainer overrides them); the step body is the
    # same for both.

    def _scope(self):
        """The context the train-mode forward and backward run in."""
        return contextlib.nullcontext()

    def _loss(self, probs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The loss this process differentiates: the batch's mean BCE."""
        return bce_loss(probs, y)

    def _reduce(self, grads: Tensors, loss: torch.Tensor, probs: torch.Tensor,
                y: torch.Tensor):
        """(gradients, metrics) of the whole batch from this process's
        share of it; on one device, what it computed."""
        metrics = batch_metrics(probs, y)
        metrics["loss"] = loss
        return grads, metrics

    def _update(self, grads: Tensors, opt_state: AdamState) -> AdamState:
        with annotate("train/optimizer"):
            return self.optimizer.update(grads, opt_state, self.params)

    def train_batch(self, opt_state: AdamState, batch,
                    generator: Optional[torch.Generator] = None):
        """One batch: returns (opt_state, metrics).  With ``grad_accum`` > 1
        the parameters change only every ``grad_accum`` calls (reference
        train.py:288-295)."""
        x, y = self._prep(batch)
        if self.grad_accum == 1:
            loss, probs, grads = self.loss_and_grads(x, y, generator)
            grads, metrics = self._reduce(grads, loss, probs, y)
            return self._update(grads, opt_state), metrics
        loss, probs = self.grad_step(x, y, generator)
        if self._accum_count >= self.grad_accum:
            opt_state = self.apply_grads(opt_state)
        metrics = batch_metrics(probs, y)
        metrics["loss"] = loss
        return opt_state, metrics

    def grad_step(self, x: torch.Tensor, y: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
        """One accumulation micro-step: adds grads / grad_accum into the
        pending group.  Returns (loss, probs)."""
        if self._accum_count == 0:
            self._boundary = self._buffers()
            self._acc_grads = {k: torch.zeros_like(p) for k, p in self.params.items()}
        loss, probs, grads = self.loss_and_grads(x, y, generator)
        scale = 1.0 / self.grad_accum
        with torch.no_grad():
            self._acc_grads = {k: a + grads[k] * scale for k, a in self._acc_grads.items()}
        self._accum_count += 1
        return loss, probs

    def apply_grads(self, opt_state: AdamState) -> AdamState:
        """The optimizer step on the pending group's gradient; the group
        closes."""
        opt_state = self._update(self._acc_grads, opt_state)
        self._acc_grads, self._accum_count, self._boundary = None, 0, None
        return opt_state

    @property
    def pending_micro_steps(self) -> int:
        """Micro-batches accumulated since the last optimizer apply (0 at an
        apply boundary)."""
        return self._accum_count

    def drop_pending_group(self) -> None:
        """Discard a partly accumulated group, and roll the BatchNorm
        buffers back to where they were when it started (the dropped
        micro-batches are replayed on resume)."""
        if self._boundary is not None:
            self._load_buffers(self._boundary)
        self._acc_grads, self._accum_count, self._boundary = None, 0, None

    def flush_pending_group(self, opt_state: AdamState) -> AdamState:
        """Apply a partial group now (epoch end: groups never span epochs).
        The gradient keeps its 1/grad_accum scale, so a k-of-n tail group
        takes a k/n-sized step.  A no-op at an apply boundary."""
        return self.apply_grads(opt_state) if self._accum_count else opt_state

    def boundary_state_dict(self) -> Tensors:
        """The model's state dict as of the last apply boundary: mid-group
        the parameters have not moved but the BatchNorm buffers have."""
        sd = self.model.state_dict()
        if self._boundary is not None:
            sd.update(self._boundary)
        return sd

    @contextlib.contextmanager
    def at_boundary(self):
        """The model with its buffers at the last apply boundary inside the
        block (validation mid-group), as they are after it."""
        if self._boundary is None:
            yield
            return
        live = self._buffers()
        self._load_buffers(self._boundary)
        try:
            yield
        finally:
            self._load_buffers(live)

    def _buffers(self) -> Tensors:
        return {k: b.detach().clone() for k, b in self.model.named_buffers()}

    def _load_buffers(self, buffers: Tensors) -> None:
        with torch.no_grad():
            for k, b in self.model.named_buffers():
                b.copy_(buffers[k])

    def generator(self, seed: int, step: int) -> Optional[torch.Generator]:
        """The dropout generator of global step ``step`` (:func:`step_generator`);
        None for a model without dropout."""
        if getattr(self.model, "dropout_rate", 0.0) > 0.0:
            return step_generator(seed, step, self.device)
        return None

    def train_batch_resident(self, opt_state: AdamState, resident, idx, seed: int, step: int):
        """One step on rows ``idx`` of a ``data.ResidentLadDataset``: the
        batch is gathered on the device, then the step is
        :meth:`train_batch`'s, its dropout drawn from ``step_generator(seed,
        step)`` as the epoch loop draws a streamed step's, so streamed and
        resident epochs take the same steps.  Returns (opt_state, metrics)."""
        return self.train_batch(opt_state, {"resident": resident, "idx": idx},
                                self.generator(seed, step))

    def train_k_steps_resident(self, opt_state: AdamState, resident, idx_mat, seed: int,
                               step0: int):
        """K optimizer steps from one call: row k of the [K, B] index
        matrix is global step ``step0 + k``.  The matrix crosses the link
        once and the steps run in order, each :meth:`train_batch_resident`,
        so the numbers are those of K single steps.  Returns (opt_state,
        metrics), each metric stacked [K] in step order.  Requires
        ``grad_accum == 1``: an accumulation group is host state a K-step
        call cannot carry."""
        if self.grad_accum != 1:
            raise ValueError(
                f"train_k_steps_resident requires grad_accum == 1 (got {self.grad_accum})")
        idx_mat = torch.as_tensor(np.asarray(idx_mat), dtype=torch.int64)
        if idx_mat.ndim != 2:
            raise ValueError(f"idx_mat must be [K, B]; got {tuple(idx_mat.shape)}")
        idx_mat = idx_mat.to(self.device)
        steps = []
        for k in range(idx_mat.shape[0]):
            opt_state, m = self.train_batch_resident(opt_state, resident, idx_mat[k], seed,
                                                     step0 + k)
            steps.append(m)
        return opt_state, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    # ------------------------------------------------------------------ #

    def eval_batch(self, batch) -> Tensors:
        """Eval-mode metrics and loss of one batch, as device scalars."""
        x, y = self._prep(batch)
        self.model.eval()
        with torch.no_grad(), precision_scope(self.precision):
            probs = self._forward(x)
            return self._reduce({}, self._loss(probs, y), probs, y)[1]

    def eval_batches(self, batches: Iterable) -> Dict[str, float]:
        """Mean metrics over a set of batches (reference train.py:178-201)."""
        return mean_eval_metrics(self.eval_batch, batches)


def mean_eval_metrics(eval_batch_fn: Callable, batches: Iterable) -> Dict[str, float]:
    """The unweighted mean of per-batch metrics; {} for no batches (callers
    read that as 'no validation').  One device-to-host transfer a batch."""
    acc: Dict[str, float] = {}
    n = 0
    for batch in batches:
        m = eval_batch_fn(batch)
        vals = torch.stack([v.float() for v in m.values()]).cpu().tolist()
        for k, v in zip(m, vals):
            acc[k] = acc.get(k, 0.0) + v
        n += 1
    return {k: v / max(n, 1) for k, v in acc.items()}


# --------------------------------------------------------------------------- #
# Metrics on disk and the epoch driver
# --------------------------------------------------------------------------- #


def update_metrics_on_disk(metrics_rows: List[Dict[str, Any]], path: str) -> None:
    """Append-merge metric rows into a CSV keyed by global_step (reference
    train.py:488-504), published atomically (tmp + ``os.replace``)."""
    existing: Dict[str, Dict[str, Any]] = {}
    fieldnames: List[str] = []
    if os.path.isfile(path):
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            fieldnames = list(reader.fieldnames or [])
            for row in reader:
                existing[row["global_step"]] = row
    for row in metrics_rows:
        row = {k: str(v) for k, v in row.items()}
        existing[row["global_step"]] = row
        for k in row:
            if k not in fieldnames:
                fieldnames.append(k)
    rows = sorted(existing.values(), key=lambda r: int(float(r["global_step"])))
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)
    os.replace(tmp, path)


@dataclasses.dataclass
class TrainLoop:
    """Epoch runner: online validation, metric logging, checkpointing
    (reference train.py:150-167, 170-415)."""

    trainer: Trainer
    checkpoint_dir: Optional[str]
    log_frequency: int = 900  # reference config.py:13
    val_batches_per_log: int = 10
    #: where flush_metrics persists metric rows; set, the preemption path
    #: flushes them too.
    metrics_path: Optional[str] = None
    #: False writes no checkpoint and no metrics (and keeps no rows):
    #: multi-process, only the coordinator writes.
    write_artifacts: bool = True
    #: multi-process: called at voting step boundaries with this process's
    #: local preemption flag; returns the disjunction over the processes, so
    #: all stop at the same boundary (parallel.distributed.
    #: make_preemption_sync).  None keeps the local flag.
    sync_preempt: Optional[Callable[[bool], bool]] = None
    #: multi-process vote cadence: a vote waits for a host round trip, so
    #: processes vote when ``global_step % preempt_vote_every == 0`` (the
    #: step counter is the same on every process) and once at every epoch's
    #: end, and a signal between votes waits for the next one.
    preempt_vote_every: int = 10
    #: up to K consecutive batches of one resident dataset (same size) go to
    #: one Trainer.train_k_steps_resident call; 1 = a call a step.
    steps_per_dispatch: int = 1

    global_step: int = 0
    epoch: int = 0
    #: steps already trained inside the current epoch (0 at its start),
    #: checkpointed so a mid-epoch save resumes exactly: the epoch's batch
    #: order is a pure function of its seed, and the resume skips these.
    epoch_step: int = 0
    best_val_loss: float = float("inf")
    metrics_rows: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    #: the stop decision: once True, run_epoch saves and returns at the next
    #: step boundary.  Multi-process it is set only from a vote, so it is
    #: the same on every process when run_epoch returns.
    preempted: bool = dataclasses.field(default=False, init=False)
    #: the raw signal, set by the handler (possibly during a vote, which it
    #: then joins the next one of).
    _preempt_pending: bool = dataclasses.field(default=False, init=False)

    def install_preemption_handler(self, signals=None) -> None:
        """Checkpoint on SIGTERM / SIGINT: the handler sets a flag; run_epoch
        finishes the step in flight, saves ``last`` with its position in the
        epoch, flushes the metrics and returns, and a resumed run continues
        where it stopped (interrupted + resumed equals uninterrupted).  A
        second signal restores the default handlers, and a second SIGINT
        raises KeyboardInterrupt, so Ctrl-C still breaks a hung step."""
        import signal as signal_mod

        if signals is None:
            signals = (signal_mod.SIGTERM, signal_mod.SIGINT)

        def _handler(signum, frame):
            if self._preempt_pending:  # the second signal: stop being graceful
                for s in signals:
                    signal_mod.signal(s, signal_mod.SIG_DFL)
                if signum == signal_mod.SIGINT:
                    raise KeyboardInterrupt
            self._preempt_pending = True
            if self.sync_preempt is None:
                # One process: the signal is the decision.  Several leave
                # it to the vote, so that all stop at one boundary.
                self.preempted = True

        for s in signals:
            signal_mod.signal(s, _handler)

    def resume_if_possible(self, opt_state: AdamState) -> AdamState:
        """Resume from ``last`` in checkpoint_dir when there is one: the
        model's weights and buffers, the counters and the Adam state (which
        the reference drops; restored here deliberately).  Returns the Adam
        state to go on with."""
        path = ckpt_lib.find_resume_checkpoint(self.checkpoint_dir)
        if path is None:
            return opt_state
        loaded = ckpt_lib.load_checkpoint(path)
        self.trainer.model.load_state_dict(loaded["state_dict"], strict=True)
        self.epoch = int(loaded["epoch"] or 0)
        self.global_step = int(loaded["global_step"] or 0)
        self.epoch_step = int(loaded.get("epoch_step") or 0)
        best = loaded["best_val_loss"]
        self.best_val_loss = float(best if best is not None else np.inf)
        opt = loaded["opt_state"]
        if opt is None:
            return opt_state
        dev = self.trainer.device
        return AdamState(step=opt.step.to(dev),
                         mu={k: v.to(dev) for k, v in opt.mu.items()},
                         nu={k: v.to(dev) for k, v in opt.nu.items()})

    def save(self, opt_state: AdamState, is_best: bool = False) -> None:
        """Write ``last`` with the counters as they stand."""
        self._save(opt_state, is_best)

    def _save(self, opt_state: AdamState, is_best: bool, step_offset: int = 0) -> None:
        """Write a checkpoint of the last apply boundary: ``step_offset``
        micro-batches past it (a save mid-group), the counters are recorded
        that many steps back and the buffers as they were there."""
        if not self.write_artifacts:
            return
        ckpt_lib.save_checkpoint(
            self.checkpoint_dir, self.trainer.boundary_state_dict(), opt_state=opt_state,
            epoch=self.epoch, global_step=self.global_step - step_offset,
            best_val_loss=self.best_val_loss, is_best=is_best,
            epoch_step=self.epoch_step - step_offset,
        )

    def _dispatch_group_limit(self) -> int:
        """The largest K-step group that starts at the current global_step
        without passing a log point or (multi-process) a vote: both fire at
        ``global_step % cadence == 0`` after the increment, so a group of
        exactly the remaining distance ends on it."""
        k = self.steps_per_dispatch
        if k <= 1:
            return 1
        if self.log_frequency:
            k = min(k, self.log_frequency - (self.global_step % self.log_frequency))
        if self.sync_preempt is not None:
            v = max(1, self.preempt_vote_every)
            k = min(k, v - (self.global_step % v))
        return max(k, 1)

    def run_epoch(self, opt_state: AdamState, train_batches: Iterable,
                  val_batches_fn: Optional[Callable[[int], List]] = None,
                  seed: Optional[int] = None, verbose: bool = True):
        """One pass over ``train_batches``; ``val_batches_fn(n)`` gives n
        validation batches for the online eval every ``log_frequency``
        steps; dropout draws from :func:`step_generator` (``seed``, default
        the epoch number).  With ``steps_per_dispatch`` = K > 1, up to K
        consecutive resident markers of one dataset and one size go to one
        ``train_k_steps_resident`` call (a group ends at a log point).
        Returns (opt_state, mean train loss)."""
        trainer = self.trainer
        if seed is None:
            seed = self.epoch
        # The running loss sum stays on the device: a float() per step
        # would wait for the device every batch.
        loss_sum: Optional[torch.Tensor] = None
        num_batches = 0
        stale = trainer.pending_micro_steps
        if stale:
            # An exception left a previous epoch mid-group: entry must be
            # an apply boundary, or the stale micro-gradients would fold
            # into this epoch's first apply.  Roll back as preemption does.
            self.global_step -= stale
            self.epoch_step = max(self.epoch_step - stale, 0)
            trainer.drop_pending_group()
        skip = self.epoch_step  # a mid-epoch resume: already-trained batches
        # The loss accounting at the last apply boundary, for the rollback.
        loss_at_boundary: Optional[torch.Tensor] = None
        nb_at_boundary = 0
        if self.steps_per_dispatch > 1:
            # Refused loudly rather than run one step a call: a user who
            # set K must not believe the steps were grouped.
            if getattr(trainer, "grad_accum", 1) != 1:
                raise ValueError(
                    "steps_per_dispatch > 1 requires grad_accum == 1 (accumulation "
                    "groups are host state a K-step call cannot carry)")
            if not hasattr(trainer, "train_k_steps_resident"):
                raise ValueError(
                    f"trainer {type(trainer).__name__} has no train_k_steps_resident; "
                    "steps_per_dispatch > 1 needs it")
        t0 = time.perf_counter()
        it = iter(train_batches)
        no_pending = object()  # None is a real (placeholder) batch
        pending_next = no_pending
        max_group_n = 1  # the largest K-step group formed this epoch
        while True:
            if pending_next is not no_pending:
                batch, pending_next = pending_next, no_pending
            else:
                try:
                    batch = next(it)
                except StopIteration:
                    break
            if skip > 0:
                skip -= 1  # a trained batch (or a None placeholder) passes
                continue
            if batch is None:
                raise RuntimeError(
                    "skip placeholder (None) beyond epoch_step: the batch source's "
                    "skip_assembly disagrees with the loop's resume position")
            group_n = 1
            if isinstance(batch, dict) and batch.get("resident") is not None:
                # Consecutive markers of the same resident dataset and size,
                # up to the limit (which ends a group on a log point, so the
                # per-step logic below holds at every group's end).
                group = [batch]
                limit = self._dispatch_group_limit()
                while len(group) < limit:
                    try:
                        nxt = next(it)
                    except StopIteration:
                        break
                    if (isinstance(nxt, dict) and nxt.get("resident") is batch["resident"]
                            and len(nxt["idx"]) == len(batch["idx"])):
                        group.append(nxt)
                    else:
                        pending_next = nxt  # the epoch's partial last batch, etc.
                        break
                if len(group) > 1:
                    idx_mat = np.stack([np.asarray(g["idx"]) for g in group])
                    opt_state, k_metrics = trainer.train_k_steps_resident(
                        opt_state, batch["resident"], idx_mat, seed, self.global_step)
                    group_n = len(group)
                    # The epoch mean needs the group's loss sum; a log point
                    # (at a group's end) reports the last step's metrics.
                    loss_inc = k_metrics["loss"].sum()
                    metrics = {k: v[-1] for k, v in k_metrics.items()}
                else:
                    opt_state, metrics = trainer.train_batch_resident(
                        opt_state, batch["resident"], batch["idx"], seed, self.global_step)
                    loss_inc = metrics["loss"]
            else:
                opt_state, metrics = trainer.train_batch(
                    opt_state, batch, trainer.generator(seed, self.global_step))
                loss_inc = metrics["loss"]
            loss_sum = loss_inc if loss_sum is None else loss_sum + loss_inc
            max_group_n = max(max_group_n, group_n)
            num_batches += group_n
            self.global_step += group_n
            self.epoch_step += group_n
            pending = trainer.pending_micro_steps
            if pending == 0:
                loss_at_boundary, nb_at_boundary = loss_sum, num_batches
            if self.log_frequency and self.global_step % self.log_frequency == 0:
                m = dict(zip(metrics, torch.stack(list(metrics.values())).cpu().tolist()))
                row = {"global_step": self.global_step, "epoch": self.epoch,
                       "train_loss": m["loss"], "train_acc": m["acc"],
                       "train_precision": m["precision"], "train_recall": m["recall"]}
                is_best = False
                if val_batches_fn is not None:
                    # Validate the model the checkpoint records: mid-group,
                    # the buffers at the apply boundary.
                    with trainer.at_boundary():
                        val = trainer.eval_batches(val_batches_fn(self.val_batches_per_log))
                    row.update({f"val_{k}": v for k, v in val.items()})
                    is_best = bool(val) and val["loss"] < self.best_val_loss
                    if is_best:
                        self.best_val_loss = val["loss"]
                self.metrics_rows.append(row)
                self._save(opt_state, is_best, step_offset=pending)
                self.flush_metrics()  # rows persist with their checkpoint
                if verbose:
                    msg = " ".join(f"{k}={v:.4f}" for k, v in row.items() if k != "global_step")
                    print(f"step {self.global_step}: {msg}", flush=True)
            # Multi-process, the processes agree before acting, and only at
            # a voting boundary: one that stopped alone would leave the
            # others waiting in the next step's collectives.
            local_flag = self._preempt_pending or self.preempted
            if self.sync_preempt is None:
                act = local_flag
            elif self.global_step % max(1, self.preempt_vote_every) == 0:
                act = self.sync_preempt(local_flag)
            else:
                act = False
            self.preempted = self.preempted or act
            if act:
                # Save at the step boundary and return without finishing the
                # epoch.  A partial group's micro-batches have not touched
                # the parameters: roll the counters, the buffers and the loss
                # accounting back to the apply boundary, so the resumed run
                # replays them.
                if pending:
                    self.global_step -= pending
                    self.epoch_step -= pending
                    trainer.drop_pending_group()
                    loss_sum, num_batches = loss_at_boundary, nb_at_boundary
                self._save(opt_state, is_best=False)
                self.flush_metrics()
                if verbose:
                    print(f"preempted at step {self.global_step}; checkpoint saved", flush=True)
                return opt_state, float(loss_sum) / num_batches if num_batches else 0.0
        if skip > 0:
            raise RuntimeError(
                f"mid-epoch resume: checkpoint records epoch_step={self.epoch_step} "
                f"already-trained batches, but the batch source yielded only "
                f"{self.epoch_step - skip}: the batch partition changed since the "
                "checkpoint (different batch size or dataset?); restart the epoch "
                "from scratch or restore the original configuration")
        # Groups never span epochs (PARITY.md #22): a tail group applies here.
        opt_state = trainer.flush_pending_group(opt_state)
        self.epoch += 1
        self.epoch_step = 0
        if self.sync_preempt is not None and self.sync_preempt(
                self._preempt_pending or self.preempted):
            # The epoch-end vote, unconditional (every process gets here
            # after the same batches): a signal after the last in-epoch
            # vote must not leave run_epoch agreed by nobody.  The epoch is
            # complete, so the save is the next epoch's clean start.
            self.preempted = True
            self._save(opt_state, is_best=False)
            self.flush_metrics()
            if verbose:
                print(f"preempted at epoch boundary {self.epoch}; checkpoint saved", flush=True)
        if (self.steps_per_dispatch > 1 and num_batches > 1 and max_group_n == 1
                and not getattr(self, "_warned_degenerate_groups", False)):
            # Groups form only from consecutive markers of ONE resident
            # object; streamed batches, or a fresh marker object per batch,
            # run a call a step.  Said once per TrainLoop.
            self._warned_degenerate_groups = True
            warnings.warn(
                f"steps_per_dispatch={self.steps_per_dispatch} but no K-step group formed "
                "this epoch: grouping requires consecutive batches that share ONE resident "
                "object (ResidentLadDataset.index_batches); streamed host batches run one "
                "step a call", RuntimeWarning, stacklevel=2)
        mean_loss = float(loss_sum) / num_batches if num_batches else 0.0
        if verbose:
            dt = time.perf_counter() - t0
            print(f"epoch {self.epoch}: {num_batches} batches in {dt:.1f}s "
                  f"({num_batches / max(dt, 1e-9):.1f} it/s)", flush=True)
        return opt_state, mean_loss

    def flush_metrics(self, path: Optional[str] = None) -> None:
        if not self.write_artifacts:
            self.metrics_rows = []
            return
        path = path or self.metrics_path
        if self.metrics_rows and path:
            update_metrics_on_disk(self.metrics_rows, path)
            self.metrics_rows = []
