"""One process of tests/test_torch_distributed.py's two-process Gloo group on
the CPU: it runs the port's data-parallel paths and writes what they give.

    python -m tests.fixtures.torch_dist_worker RANK WORLD INIT_FILE SPEC.json OUT.npz

``SPEC.json`` names the weights and batches the test process wrote (numpy
``.npz``), the feature cache and rows of a resident split, and a meeting's
channel files.  The worker
imports neither JAX nor the JAX package (tests/test_torch_import.py checks),
and every collective it waits in times out after 60 s.
"""

from __future__ import annotations

import datetime
import json
import sys

import numpy as np
import torch

from laughter_detection_icsi_tpu_torch.data import dataset as tds
from laughter_detection_icsi_tpu_torch.data.feature_cache import FeatureCache
from laughter_detection_icsi_tpu_torch.inference import InferenceSettings
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.parallel import (
    DataParallelTrainer, ShardedPipeline, ShardedStreamingSession, distributed, mesh)
from laughter_detection_icsi_tpu_torch.train import TrainLoop

ARCH = dict(linear_layer_size=24, filter_sizes=(8, 8, 8, 8))


def trainer(weights: dict, dropout: float) -> DataParallelTrainer:
    model = zoo.build("ResNetBigger", dropout_rate=dropout, **ARCH)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()}, strict=True)
    return DataParallelTrainer(model, device="cpu")


def state_of(prefix: str, t: DataParallelTrainer, opt=None) -> dict:
    out = {f"{prefix}/sd/{k}": v.detach().numpy().copy() for k, v in t.model.state_dict().items()}
    if opt is not None:
        out.update({f"{prefix}/mu/{k}": v.numpy() for k, v in opt.mu.items()})
        out.update({f"{prefix}/nu/{k}": v.numpy() for k, v in opt.nu.items()})
    return out


def grads_of(prefix: str, t: DataParallelTrainer, x, y, generator=None) -> dict:
    """The reduced gradients and loss of one step, without an update."""
    xb, yb = t._prep({"inputs": x, "is_laugh": y})
    loss, probs, grads = t.loss_and_grads(xb, yb, generator)
    grads, metrics = t._reduce(grads, loss, probs, yb)
    out = {f"{prefix}/grad/{k}": g.numpy() for k, g in grads.items()}
    out[f"{prefix}/loss"] = np.float32(float(metrics["loss"]))
    return out


def main(argv) -> int:
    rank, world, init, spec_path, out_path = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    torch.set_num_threads(1)
    distributed.initialize(coordinator_address=f"file://{init}", num_processes=world,
                           process_id=rank, device="cpu",
                           timeout=datetime.timedelta(seconds=60))
    spec = json.loads(open(spec_path).read())
    data = np.load(spec["arrays"])
    weights = lambda name: {k.split("/", 1)[1]: data[k] for k in data.files
                            if k.startswith(name + "/")}
    local = lambda b: mesh.shard_batch(b, rank, world)
    out = {"rank": np.int32(rank)}

    # 1. Against JAX: one step at dropout 0 on the global batch "x0".
    x0, y0 = local(data["x0"]), local(data["y0"])
    out.update(grads_of("jax", trainer(weights("w0"), 0.0), x0, y0))
    t = trainer(weights("w0"), 0.0)
    opt, m = t.train_batch(t.init(), {"inputs": x0, "is_laugh": y0})
    out.update(state_of("jax", t))
    out.update({f"jax/m/{k}": np.float32(float(v)) for k, v in m.items()})

    # 2. Dropout 0.5: one step on the global batch "x1".
    seed = spec["seed"]
    t = trainer(weights("w1"), 0.5)
    x1, y1 = local(data["x1"]), local(data["y1"])
    out.update(grads_of("drop", trainer(weights("w1"), 0.5), x1, y1, t.generator(seed, 0)))
    opt, m = t.train_batch(t.init(), {"inputs": x1, "is_laugh": y1}, t.generator(seed, 0))
    out["drop/step_loss"] = np.float32(float(m["loss"]))
    out.update(state_of("drop", t, opt))

    # 3. A resident split sharded over the processes: three steps as K
    #    steps from one call, one call a step, and the streamed local rows.
    ds = tds.LadDataset(spec["rows"], FeatureCache(spec["cache"]))
    res = tds.ResidentLadDataset(ds, sharding=(rank, world), pad_rows_to=world, device="cpu")
    out["res/rows"] = np.asarray([res.row_lo, res.row_hi, res.feats.shape[0]])
    idx_mat = np.asarray(spec["idx_mat"])
    k_steps = trainer(weights("w1"), 0.5)
    opt_k, km = k_steps.train_k_steps_resident(k_steps.init(), res, idx_mat, seed, 0)
    one = trainer(weights("w1"), 0.5)
    streamed = trainer(weights("w1"), 0.5)
    opt_1, opt_s = one.init(), streamed.init()
    batches = ds.batches(idx_mat.shape[1], seed=spec["epoch_seed"], drop_remainder=True,
                         local_rows=(rank, world), prefetch=0)
    for step, (idx, b) in enumerate(zip(idx_mat, batches)):
        opt_1, m1 = one.train_batch_resident(opt_1, res, idx, seed, step)
        opt_s, ms = streamed.train_batch(opt_s, b, streamed.generator(seed, step))
        out[f"res/loss{step}"] = np.asarray([float(km["loss"][step]), float(m1["loss"]),
                                              float(ms["loss"])])
    out.update(state_of("res_k", k_steps, opt_k))
    out.update(state_of("res_1", one, opt_1))
    out.update(state_of("res_s", streamed, opt_s))
    ev = trainer(weights("w1"), 0.5).eval_batch({"resident": res, "idx": idx_mat[0]})
    out["res/eval"] = np.asarray([float(ev[k]) for k in ("acc", "precision", "recall", "loss")])

    # 4. A meeting's channels over the processes, windows mode: each
    #    process decodes and classifies its block of the padded channels.
    model = trainer(weights("w1"), 0.0).model
    pipe = ShardedPipeline(model, settings=InferenceSettings(chunk=128, bucket_frames=256),
                           device="cpu")
    (probs, ts), _ = pipe.probs_for_meeting_device(spec["wavs"])
    for r, row in pipe.local_channels(probs, len(spec["wavs"])):
        out[f"probs/{r}"] = row[:ts[r]].numpy()
    out["probs/rows"] = np.asarray(probs.shape)
    refused = []
    for call in (lambda: pipe.probs_for_waveforms([np.zeros(16000, np.int16)]),
                 lambda: pipe.probs_for_meeting(spec["wavs"]),
                 lambda: ShardedStreamingSession(pipe, 3)):
        try:
            call()
        except (RuntimeError, NotImplementedError) as e:
            refused.append(type(e).__name__)
    out["refused"] = np.asarray(refused)

    # 5. Preemption votes and the resume broadcast.
    sync = distributed.make_preemption_sync()
    out["votes"] = np.asarray([sync(rank == 1), sync(False)])
    t = trainer(weights("w1"), 0.5)
    ckpt_dir = f"{out_path}.ckpt{rank}"
    loop = TrainLoop(trainer=t, checkpoint_dir=ckpt_dir, write_artifacts=rank == 0,
                     sync_preempt=sync, preempt_vote_every=3, log_frequency=0)
    loop._preempt_pending = rank == 1  # a signal on one process only, before step 1
    five = [{"inputs": local(data["x1"]), "is_laugh": local(data["y1"])}] * 5
    opt, _ = loop.run_epoch(t.init(), five, seed=seed, verbose=False)
    out["vote_stop"] = np.asarray([loop.global_step, loop.preempted, int(opt.step)])
    # Resume: rank 0 from the checkpoint the stop wrote (its Adam moments
    # come back in the checkpoint's order), rank 1 from nothing, off by 1.
    t = trainer(weights("w1"), 0.5)
    loop = TrainLoop(trainer=t, checkpoint_dir=ckpt_dir)
    if rank == 1:
        with torch.no_grad():
            for p in t.model.parameters():
                p.add_(1.0)
    opt = loop.resume_if_possible(t.init())
    if rank == 0:
        loop.epoch, loop.global_step, loop.epoch_step, loop.best_val_loss = 3, 17, 5, 0.25
    opt = distributed.sync_resume(loop, opt)
    out["resume/counters"] = np.asarray([loop.epoch, loop.global_step, loop.epoch_step,
                                         loop.best_val_loss, int(opt.step)])
    out.update(state_of("resume", t, opt))
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
