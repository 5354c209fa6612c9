"""Training: the program's epoch loop over a split resident on the card.

Set-up builds one ``TrainLoop`` over one ``Trainer`` (the model from the
cell's weights, ``train/optim.Adam`` at the configuration's settings, the
cuDNN flags ``cli/train`` sets on the card) and one ``ResidentLadDataset``
of the traffic's rows, and drives its first steps through
``TrainLoop.run_epoch``, one call a step, on batches of distinct rows; it
keeps the loss of each, the first gradient as the optimizer holds it
(Adam's first moment after one step over ``1 - b1``), and every leaf after
the first step and after the last.  The same loop then trains through the
window: one ``run_epoch`` call an epoch of the benchmark's shuffle, its
batches stopped at ``--seconds``, ending in a ``torch.cuda.synchronize()``.
Once the window has closed, the same loop takes one more step, on the
next batch of the shuffle, from the state the window left; the leaves and
Adam's moments before and after it are kept.

The check holds both against the reference.  The first steps: the
reference follows them from the same weights, rows and dropout draws.  The
step after the window: the reference takes it from the program's own
state (its leaves, Adam's moments and step count), since no two float32
runs of hundreds of steps agree; the gradient the optimizer got is worked
out from the moments, ``(m' - b1 m) / (1 - b1)``.  Each number is a gap of
the reference's reading: losses relative; by leaf, the gap of norms of the
gradient, of each parameter's change and of each BatchNorm statistic's
change, against the larger of the leaf's reference norm and the median
leaf's.  Leaves whose reference gradient is under a thousandth of the
median leaf's (the conv and linear biases that a train-mode BatchNorm
follows, nought to rounding) move by round-off alone under Adam and are
left out of the gradient and change numbers.  The cell's workload file
names the numbers compared and their limits; :func:`readings` gives them
all.
"""

from __future__ import annotations

import itertools
import time
import types
from typing import Optional

import numpy as np
import torch

import traffic
import weights
from harness import log
from reference import resnet as ref_resnet
from reference import train as ref_train


class SeededSplit:
    """The traffic's rows in the shape ``ResidentLadDataset`` assembles a
    split from: a length, the window, the bin count, and ``_assemble(idx)``."""

    def __init__(self, feats: np.ndarray, labels: np.ndarray):
        self.feats, self.labels = feats, labels
        self.window_frames = feats.shape[1]
        self.cache = types.SimpleNamespace(cfg=types.SimpleNamespace(num_filters=feats.shape[2]))

    def __len__(self) -> int:
        return len(self.labels)

    def _assemble(self, idx):
        return {"inputs": self.feats[idx], "input_lens": np.full(len(idx), self.window_frames,
                                                                    dtype=np.int32),
                "is_laugh": self.labels[idx]}


def until(batches, deadline: float):
    """The batches until the host clock passes ``deadline``."""
    for b in batches:
        if time.perf_counter() >= deadline:
            return
        yield b


def leaves(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def build(job):
    """The program's loop, trainer and resident split over the cell's
    weights, driven through its first steps: (state, records), the records
    being what the check compares and what it needs to recompute them."""
    from laughter_detection_icsi_tpu_torch.data.dataset import ResidentLadDataset
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.train.loop import TrainLoop, Trainer
    from laughter_detection_icsi_tpu_torch.train.optim import Adam

    cfg, tr = job.cell.config, job.cell.traffic
    opt_cfg, m = cfg["train"], cfg["model"]
    if job.device.type == "cuda":
        torch.backends.cudnn.deterministic = opt_cfg["cudnn_deterministic"]
        torch.backends.cudnn.benchmark = opt_cfg["cudnn_benchmark"]
    feats, labels = traffic.train_split(tr, job.seed)
    p0 = weights.initial(cfg, job.seed, job.device)
    model = zoo.build(m["architecture"], dropout_rate=m["dropout_rate"],
                      linear_layer_size=m["linear_layer_size"], filter_sizes=m["filter_sizes"])
    model.load_state_dict(weights.port_state_dict(p0), strict=True)
    optimizer = Adam(lr=opt_cfg["lr"], b1=opt_cfg["b1"], b2=opt_cfg["b2"], eps=opt_cfg["eps"],
                     max_grad_norm=opt_cfg["max_grad_norm"])
    trainer = Trainer(model=model, optimizer=optimizer, grad_accum=opt_cfg["grad_accum"],
                      device=job.device)
    loop = TrainLoop(trainer, checkpoint_dir=None, log_frequency=cfg["log_frequency"],
                     steps_per_dispatch=opt_cfg["steps_per_dispatch"], write_artifacts=False)
    resident = ResidentLadDataset(SeededSplit(feats, labels), device=job.device)
    log("split resident")
    epochs = traffic.batch_orders(len(labels), tr["batch_size"], job.seed)
    state = types.SimpleNamespace(loop=loop, resident=resident, epochs=epochs, epoch=next(epochs),
                                  opt=trainer.init())
    # The first steps: each through the window's call and feed.
    rec = types.SimpleNamespace(p0=p0, rows=[], losses=[], feats=feats, labels=labels)
    for s in range(tr["first_steps"]):
        idx = next(state.epoch)
        rec.rows.append(idx)
        state.opt, loss = loop.run_epoch(state.opt, markers(resident, [idx]), seed=job.seed,
                                         verbose=False)
        rec.losses.append(loss)
        if s == 0:
            rec.grad1 = {k: (mu / (1.0 - optimizer.b1)).clone() for k, mu in state.opt.mu.items()}
            rec.after1 = leaves(model)
    rec.after = leaves(model)
    job.synchronize()
    log("first steps done")
    return state, rec


def markers(resident, idxs):
    return ({"resident": resident, "idx": idx} for idx in idxs)


def post_step(job, state, rec):
    """One step of the loop after the window, on the next batch of the
    shuffle, from the state the window left: the records the check of that
    step needs (the leaves and Adam's moments before it, the dropout's step
    index, the loss, the gradient the optimizer got and the leaves after)."""
    loop, opt = state.loop, state.opt
    model, b1 = loop.trainer.model, loop.trainer.optimizer.b1
    idx = next(state.epoch, None)
    if idx is None:
        state.epoch = next(state.epochs)
        idx = next(state.epoch)
    post = types.SimpleNamespace(p0=leaves(model), feats=rec.feats, labels=rec.labels,
                                 rows=[idx], step0=loop.global_step,
                                 moments=({k: m.clone() for k, m in opt.mu.items()},
                                          {k: v.clone() for k, v in opt.nu.items()},
                                          int(opt.step)))
    state.opt, loss = loop.run_epoch(opt, markers(state.resident, [idx]), seed=job.seed,
                                     verbose=False)
    post.losses = [loss]
    post.grad1 = {k: ((mu.double() - b1 * post.moments[0][k].double()) / (1.0 - b1)).float()
                  for k, mu in state.opt.mu.items()}
    post.after1 = post.after = leaves(model)
    job.synchronize()
    return post


def run(job) -> dict:
    tr = job.cell.traffic
    batch = tr["batch_size"]
    state, rec = build(job)
    loop = state.loop
    opened = time.perf_counter()
    out = {"e2e": {"setup_s": opened - job.started}}
    if job.trace:
        def slice_():
            state.opt, _ = loop.run_epoch(
                state.opt, markers(state.resident, itertools.islice(state.epoch, tr["trace_steps"])),
                seed=job.seed, verbose=False)
            return {"steps": tr["trace_steps"], "samples": tr["trace_steps"] * batch}
        out["trace"] = job.profiled(slice_)
        steps, failed = tr["trace_steps"], 0
    else:
        deadline = opened + job.seconds
        mean_losses = []
        start_step = loop.global_step
        while time.perf_counter() < deadline:
            before, t0 = loop.global_step, time.perf_counter()
            state.opt, mean = loop.run_epoch(state.opt, markers(state.resident,
                                                                until(state.epoch, deadline)),
                                             seed=job.seed, verbose=False)
            mean_losses.append(mean)
            log(f"epoch: {loop.global_step - before} steps in {time.perf_counter() - t0:.4f} s")
            state.epoch = next(state.epochs)
        job.synchronize()
        window = time.perf_counter() - opened
        steps = loop.global_step - start_step
        out["e2e"]["train_samples_per_s"] = steps * batch / window
        failed = 0 if all(np.isfinite(mean_losses)) else steps
        print(f"window: {steps} steps of {batch} in {window:.4f} s", flush=True)
    rec.post = post_step(job, state, rec)
    out["memory_peak_bytes"] = job.memory_peak()
    out["attempted"] = steps
    out["failed"] = failed
    del state, loop
    if job.device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = compare(job, rec)
    out["records"] = rec
    log("checked")
    return out


def first_batches(job, rec):
    """The batches of ``rec.rows``, from the traffic's rows (the
    reference's own gather)."""
    return [(torch.from_numpy(rec.feats[i]).to(job.device)[:, None],
             torch.from_numpy(rec.labels[i]).to(job.device)) for i in rec.rows]


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """Each leaf's gap of norms, against the larger of its reference norm
    and the median leaf's."""
    g = {k: float(torch.linalg.vector_norm(got[k].double())) for k in names}
    w = {k: float(torch.linalg.vector_norm(want[k].double())) for k in names}
    median = float(np.median(list(w.values())))
    return {k: abs(g[k] - w[k]) / max(w[k], median) for k in names}


def reference_of(job, rec, post: bool, **kw) -> dict:
    """The reference's run of the first steps, or of the step after the
    window from the state ``rec`` kept (``kw``: ``tf32``, or other
    batches for a fault)."""
    cfg = job.cell.config
    batches = kw.pop("batches", None) or first_batches(job, rec)
    if post:
        kw.update(moments=rec.moments, step0=rec.step0)
    return ref_train.train_steps(rec.p0, batches, cfg["model"], cfg["train"], job.seed, **kw)


def gaps(rec, ref: dict, details: Optional[dict] = None) -> dict:
    """Every reading of ``rec`` against the reference's run ``ref`` from
    the same state: the first step's loss; the first gradient and the
    change of the parameters after the last step by their worst and their
    median leaf; each BatchNorm statistic's change after the first step by
    the worst leaf."""
    p0 = rec.p0
    steps = [abs(a - b) / abs(b) for a, b in zip(rec.losses, ref["losses"])]
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref["grad1"].items()}
    median = float(np.median(list(norms.values())))
    moved = [k for k, n in norms.items() if n >= 1e-3 * median]
    running = [k for k in p0 if ref_resnet.is_running(k)]
    change = lambda leaves_: {k: leaves_[k].double() - p0[k].double() for k in leaves_}
    grad = leaf_gaps({k: rec.grad1[k] for k in moved}, ref["grad1"], moved)
    bn1 = leaf_gaps(change(rec.after1), change(ref["after1"]), running)
    moved_n = leaf_gaps(change(rec.after), change(ref["after"]), moved)
    if details is not None:
        details.update(loss_gap_by_step=steps, grad_gap_by_leaf=grad, bn1_gap_by_leaf=bn1,
                       change_gap_by_leaf=moved_n, left_out=sorted(set(norms) - set(moved)))
    return {"loss_gap": steps[0],
            "grad_gap": float(np.median(list(grad.values()))),
            "grad_gap_worst": max(grad.values()),
            "bn_stats_gap": max(bn1.values()),
            "change_gap": float(np.median(list(moved_n.values()))),
            "change_gap_worst": max(moved_n.values())}


def readings(job, rec, refs=None, details=None) -> dict:
    """Every number the check can compare: the first steps' (``gaps``)
    and, where ``rec`` has a ``post`` step, that step's, prefixed
    ``post_``.  ``refs``, a pair, replaces the reference's runs (the first
    steps', the post step's); ``details``, a dict, receives the per-leaf
    readings."""
    post = getattr(rec, "post", None)
    first_ref, post_ref = refs or (reference_of(job, rec, False),
                                   None if post is None else reference_of(job, post, True))
    d1 = d2 = None
    if details is not None:
        d1, d2 = details.setdefault("first", {}), details.setdefault("post", {})
    out = gaps(rec, first_ref, d1)
    if post is not None:
        out.update({f"post_{k}": v for k, v in gaps(post, post_ref, d2).items()})
    return out


def compare(job, rec) -> dict:
    """The numbers the cell's workload file names, each with its limit."""
    numbers = readings(job, rec)
    return {k: (numbers[k], limit) for k, limit in job.cell.check["limits"].items()}
