"""Training CLI for the PyTorch port (reference train.py:68-135 flag surface).

The JAX package's ``cli/train.py`` plus ``--device`` (default ``cuda``):
train a preset from the ``<split>_df.csv`` tables (``cli/create_data_df``)
on features from the feature cache; tracks the tables need but the cache
lacks are featurized first from ``<data_root>/signals/<meeting>/<chan>.sph``
(on the card by the fbank kernel).  ``--device_cache`` keeps both splits
resident on the device (``data.ResidentLadDataset``) and
``--steps_per_dispatch K`` hands K of its steps to one call.  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.train --config resnet_base \\
        --checkpoint_dir checkpoints/resnet_base --data_root data \\
        --data_dfs_dir data_dfs --device cuda [--device_cache on]

Each run trains ``--num_epochs`` more epochs from the checkpoint it
resumes.  The reference's torch-specific flags (--torch_device,
--num_workers, --lhotse_dir, --include_words, --train_on_noisy_audioset)
are parsed and ignored with a note.  ``--precision bfloat16`` trains in
bf16 with float32 masters (``Trainer(compute_dtype='bfloat16')``).

Several processes train one model with ``--data_parallel`` and the JAX
CLI's multi-process flags (``parallel/distributed.py``), one device each:
every process runs the same command with its own ``--process_id``, e.g.
on one card

    python -m laughter_detection_icsi_tpu_torch.cli.train ... --data_parallel \
        --coordinator_address 127.0.0.1:29500 --num_processes 2 \
        --process_id 0 --cpu_collectives gloo

(``--device cpu`` on the CPU; NCCL and no ``--cpu_collectives`` on one
card a process, or ``torchrun ... --distributed``).  Each process feeds
its block of every global batch; the coordinator featurizes first and
alone writes checkpoints and metrics; a SIGTERM on any process stops all
at one step boundary.

On ``cuda`` the run takes cuDNN's deterministic algorithms and no
autotuning (``CUDNN_FLAGS``), so two steps on the same values agree bit for
bit and a resumed run ends where an uninterrupted one does, as the JAX
package's does under XLA; ``main`` restores the caller's flags when it
returns.  What the mode costs is in PERF.md (``chip_smoke.py`` phase 9 (e)
measures both settings).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

COMPAT_FLAGS = ("torch_device", "include_words", "train_on_noisy_audioset", "num_workers",
                "lhotse_dir")

#: ``torch.backends.cudnn``'s (deterministic, benchmark) for a run on ``cuda``.
CUDNN_FLAGS = (True, False)


@contextlib.contextmanager
def cudnn_flags(flags: Optional[Tuple[bool, bool]] = None):
    """``torch.backends.cudnn``'s (deterministic, benchmark) set to
    ``flags`` inside the block (None leaves them as they are); the
    previous ones restored after it."""
    import torch

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    if flags is not None:
        cudnn.deterministic, cudnn.benchmark = flags
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint_dir", type=str, required=True)
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--num_epochs", type=int, default=1,
                   help="epochs to train IN THIS RUN; resumed runs train "
                        "this many MORE (reference-relative semantics)")
    p.add_argument("--data_dfs_dir", type=str, default="data_dfs")
    p.add_argument("--batch_size", type=str, default=None)
    p.add_argument("--dropout_rate", type=str, default="0.5")
    p.add_argument("--gradient_accumulation_steps", type=str, default="1")
    # Accepted for compatibility, unused (the reference never uses
    # --num_workers either).
    p.add_argument("--lhotse_dir", type=str, default="lhotse")
    p.add_argument("--torch_device", type=str, default=None)
    p.add_argument("--num_workers", type=str, default="8")
    p.add_argument("--include_words", type=str, default=None)
    p.add_argument("--train_on_noisy_audioset", type=str, default=None)
    p.add_argument("--feats_dir", type=str, default=None,
                   help="feature cache dir (default <data_root>/feats_tpu, the "
                        "JAX package's, so both packages share one cache)")
    p.add_argument("--signals_dir", type=str, default=None,
                   help="audio root with <meeting>/<chan>.sph "
                        "(default <data_root>/signals)")
    p.add_argument("--data_parallel", action="store_true",
                   help="data-parallel training over the processes of the "
                        "run (one device each; BatchNorm over the global "
                        "batch); required with several processes.  A host's "
                        "several cards train under torchrun, one process a "
                        "card (torchrun --nproc_per_node N ... --distributed); "
                        "one process trains on one device")
    p.add_argument("--transfer_dtype", type=str, default=None, choices=["bfloat16"],
                   help="ship feature batches to the device as bfloat16 (half "
                        "the host->device bytes; inputs are bf16-rounded, "
                        "parameters and gradients stay float32); with "
                        "--device_cache, the resident features' dtype")
    p.add_argument("--precision", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="training compute precision: bfloat16 runs the "
                        "forward and backward in bf16 with float32 masters "
                        "(parameters, Adam moments, BatchNorm statistics). "
                        "It pays off only at large batches: at the preset "
                        "batch of 32 the per-step cast of the parameters "
                        "makes bf16 slower than float32 on an H100")
    p.add_argument("--device_cache", type=str, default="auto", choices=["auto", "on", "off"],
                   help="keep both splits' features resident on the device "
                        "and gather batches there (no per-step feature "
                        "upload; data.ResidentLadDataset).  'auto' turns it "
                        "on on cuda when the splits fit "
                        "--device_cache_budget_gb")
    p.add_argument("--device_cache_budget_gb", type=float, default=4.0,
                   help="most device memory the 'auto' device cache may claim")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="K consecutive resident train steps from one call "
                        "(needs --device_cache and grad_accum 1; the numbers "
                        "of K single steps)")
    p.add_argument("--val_batches_per_log", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    from laughter_detection_icsi_tpu_torch.parallel import distributed

    distributed.add_cli_args(p)
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler trace of the training run here")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default: cuda).  On cuda "
                        "the run uses cuDNN's deterministic algorithms, so "
                        "its steps are reproducible and a resume is exact")
    return p


def _ensure_features(cache, rows, signals_dir: str, device) -> None:
    """Featurize every (meeting, chan) track the table needs and the cache
    lacks (stage 1 of reference compute_features.py:66-112)."""
    from laughter_detection_icsi_tpu_torch.data.audio import find_track_audio

    for meeting_id, chan_id in sorted({(r["meeting_id"], r["chan_id"]) for r in rows}):
        if cache.has(meeting_id, chan_id):
            continue
        path = find_track_audio(signals_dir, meeting_id, chan_id)
        if path is None:
            raise FileNotFoundError(
                f"no cached features and no audio ({chan_id}.sph or .wav) "
                f"for {meeting_id} under {signals_dir}")
        print(f"featurizing {meeting_id}/{chan_id} ...", flush=True)
        cache.add_audio_file(meeting_id, chan_id, path, device=device)


def main(argv: Optional[List[str]] = None) -> int:
    with cudnn_flags():  # the run may set CUDNN_FLAGS; the caller gets its own back
        return _train(argv)


def _train(argv: Optional[List[str]]) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    # Against the parser's default: num_workers and lhotse_dir have truthy
    # defaults.
    for flag in COMPAT_FLAGS:
        if getattr(args, flag) != parser.get_default(flag):
            print(f"note: --{flag} is accepted for compatibility and ignored")

    from laughter_detection_icsi_tpu_torch.cli.presets import PresetError, preset_model

    # The port trains the window classifiers on 100 x 44 windows.
    try:
        preset, model = preset_model(args.config, "cli/train", ("windows",),
                                     dropout_rate=float(args.dropout_rate), seed=args.seed)
    except PresetError as e:
        parser.error(str(e))
    if args.batch_size is not None:
        # type=str for the reference's flags: parsed and checked here.
        try:
            bs = int(args.batch_size)
        except ValueError:
            parser.error(f"--batch_size: not an integer: {args.batch_size!r}")
        if bs < 1:
            parser.error(f"--batch_size must be >= 1, got {bs}")

    from laughter_detection_icsi_tpu_torch.inference import resolve_device
    from laughter_detection_icsi_tpu_torch.parallel import distributed, mesh

    # Join the process group first: it makes this process's card the
    # current device.
    joined = distributed.initialize_from_args(args, parser)
    rank, world = mesh.world()
    multi_process = world > 1
    if multi_process and not args.data_parallel:
        # Refused before featurizing, which can take long.
        raise SystemExit(
            "multi-host runs require --data_parallel: without it each "
            "process would train its own divergent copy"
        )
    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch

        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = CUDNN_FLAGS

    from laughter_detection_icsi_tpu_torch.data import (
        FeatureCache, LadDataset, ResidentLadDataset, load_split_df)
    from laughter_detection_icsi_tpu_torch.train import Adam, TrainLoop, Trainer
    from laughter_detection_icsi_tpu_torch.utils.profiling import trace

    batch_size = int(args.batch_size) if args.batch_size is not None else preset.batch_size
    grad_accum = int(args.gradient_accumulation_steps)
    ckpt_dir = Path(args.checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    data_dfs_dir = args.data_dfs_dir
    if not os.path.isabs(data_dfs_dir):
        data_dfs_dir = os.path.join(args.data_root, data_dfs_dir)
    feats_dir = args.feats_dir or os.path.join(args.data_root, "feats_tpu")
    signals_dir = args.signals_dir or os.path.join(args.data_root, "signals")

    cache = FeatureCache(feats_dir)
    train_df = load_split_df(data_dfs_dir, "train")
    dev_df = load_split_df(data_dfs_dir, "dev")
    # Multi-process: the coordinator featurizes first, the others after a
    # barrier.  On shared storage they then find every track (one
    # featurization, no concurrent manifest writes); on disks of their own
    # they fill what is still missing.
    if rank == 0:
        _ensure_features(cache, train_df, signals_dir, device)
        _ensure_features(cache, dev_df, signals_dir, device)
    distributed.barrier()
    if rank != 0:
        cache = FeatureCache(feats_dir)  # re-read the coordinator's manifest
        _ensure_features(cache, train_df, signals_dir, device)
        _ensure_features(cache, dev_df, signals_dir, device)
    train_ds = LadDataset(train_df, cache)
    dev_ds = LadDataset(dev_df, cache)

    # The resident feature cache: both splits uploaded once, each batch a
    # gather on the device.
    use_cache = False
    if args.device_cache != "off":
        # Under --data_parallel each process holds its block of the rows:
        # the budget is a device's.
        est = (ResidentLadDataset.estimated_nbytes(train_ds, args.transfer_dtype)
               + ResidentLadDataset.estimated_nbytes(dev_ds, args.transfer_dtype))
        est //= world if args.data_parallel else 1
        on_card = device.type == "cuda"
        fits = est <= args.device_cache_budget_gb * 1e9
        use_cache = args.device_cache == "on" or (on_card and fits)
        if args.device_cache == "auto" and not use_cache and on_card:
            print(f"device_cache auto: split needs {est / 1e9:.2f} GB a device > budget "
                  f"{args.device_cache_budget_gb} GB; streaming from host")

    compute_dtype = None if args.precision == "float32" else args.precision
    local_rows = None
    if args.data_parallel:
        from laughter_detection_icsi_tpu_torch.parallel import DataParallelTrainer

        if batch_size % world:
            batch_size = -(-batch_size // world) * world
            print(f"note: batch_size rounded up to {batch_size} for {world} devices")
        if grad_accum != 1:
            raise SystemExit("--gradient_accumulation_steps requires single-device mode")
        trainer = DataParallelTrainer(model=model, optimizer=Adam(),
                                      compute_dtype=compute_dtype, device=device)
        print(f"data-parallel over {world} devices")
        if multi_process:
            # Each process assembles and feeds its own rows of every batch.
            local_rows = (rank, world)
            print(f"multi-host: process {rank} feeds {batch_size // world} of "
                  f"{batch_size} rows/batch")
        if args.transfer_dtype and not use_cache:
            print("note: --transfer_dtype applies to single-device streamed "
                  "batches and is ignored under --data_parallel (use "
                  "--device_cache for the bandwidth win)")
    else:
        trainer = Trainer(model=model, optimizer=Adam(), grad_accum=grad_accum,
                          transfer_dtype=args.transfer_dtype, compute_dtype=compute_dtype,
                          device=device)
    if use_cache:
        t0 = time.perf_counter()
        # Under --data_parallel each process uploads its block of the rows.
        shard = dict(sharding=(rank, world), pad_rows_to=world) if args.data_parallel else {}
        train_ds = ResidentLadDataset(train_ds, args.transfer_dtype, device=device, **shard)
        dev_ds = ResidentLadDataset(dev_ds, args.transfer_dtype, device=device, **shard)
        print(f"device cache: {len(train_ds)} train windows resident on {device} "
              f"({len(dev_ds)} dev; built in {time.perf_counter() - t0:.2f} s)")
    opt_state = trainer.init()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"The model has {n_params:,} trainable parameters")

    loop = TrainLoop(
        trainer=trainer,
        checkpoint_dir=str(ckpt_dir),
        log_frequency=preset.log_frequency,
        val_batches_per_log=args.val_batches_per_log,
        # the preemption path flushes the metric rows too
        metrics_path=str(ckpt_dir / "metrics.csv"),
        # multi-process: the coordinator is the one writer, and all stop at
        # the same step boundary on preemption
        write_artifacts=distributed.is_coordinator(),
        sync_preempt=distributed.make_preemption_sync() if multi_process else None,
        steps_per_dispatch=args.steps_per_dispatch,
    )
    if args.steps_per_dispatch > 1 and not use_cache:
        print("note: --steps_per_dispatch groups device-resident batches only; this run "
              "streams from host (--device_cache off), so steps run one a call")
    opt_state = loop.resume_if_possible(opt_state)
    # Processes without a checkpoint of their own (only the coordinator
    # writes) take the coordinator's resume state.
    opt_state = distributed.sync_resume(loop, opt_state)
    if loop.global_step:
        print(f"resumed from step {loop.global_step} (epoch {loop.epoch})")
    loop.install_preemption_handler()  # checkpoint and a clean exit on SIGTERM

    if loop.write_artifacts:
        with open(ckpt_dir / "train_params.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["num_train_samples", "num_dev_samples", "batch_size", "log_freq"])
            w.writerow([len(train_ds), len(dev_ds), batch_size, preset.log_frequency])

    def val_batches(n: int):
        if use_cache:
            it = dev_ds.index_batches(batch_size, shuffle=True, seed=loop.global_step,
                                      drop_remainder=args.data_parallel)
        else:
            it = dev_ds.batches(batch_size, shuffle=True, seed=loop.global_step,
                                drop_remainder=args.data_parallel, local_rows=local_rows)
        out = []
        for _ in range(n):
            try:
                out.append(next(it))
            except StopIteration:
                break
        return out

    t_start = time.perf_counter()
    # Relative epochs, as the reference: each run trains --num_epochs more
    # from wherever its checkpoint left off.
    target_epoch = loop.epoch + args.num_epochs
    with trace(args.trace_dir):
        while loop.epoch < target_epoch:
            if use_cache:
                epoch_batches = train_ds.index_batches(
                    batch_size, shuffle=True, seed=args.seed + loop.epoch,
                    drop_remainder=args.data_parallel)
            else:
                epoch_batches = train_ds.batches(
                    batch_size, shuffle=True, seed=args.seed + loop.epoch,
                    drop_remainder=args.data_parallel,
                    # a mid-epoch resume assembles nothing for the trained batches
                    skip_assembly=loop.epoch_step, local_rows=local_rows)
            opt_state, mean_loss = loop.run_epoch(
                opt_state, epoch_batches, val_batches_fn=val_batches,
                seed=args.seed * 1000 + loop.epoch)
            if loop.preempted:
                print("preemption requested: checkpoint saved, exiting cleanly")
                break
            print(f"epoch {loop.epoch} done: mean train loss {mean_loss:.4f}")
    if args.trace_dir:
        print(f"profiler trace written to {args.trace_dir}")
    print(f"training finished in {time.perf_counter() - t_start:.1f}s")
    loop.flush_metrics()
    loop.save(opt_state)
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
