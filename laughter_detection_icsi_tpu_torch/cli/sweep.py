"""Corpus-scale evaluation sweep for the PyTorch port.

The JAX package's ``cli/sweep.py`` (``--device``, default ``cuda``):
every meeting's channels go through ``ShardedPipeline`` as one
batch (one fbank kernel launch per bucket batch), the threshold x
min_length sweep runs on the device per channel row (only run tables come
back), and TextGrids land in the ``<out>/<split>/<meeting>/t_<thr>/
l_<minlen>/chanN.TextGrid`` layout the evaluator reads; ``--analyse`` then
scores the split (``eval/analyse.py``: no pandas, no lxml).  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.sweep \\
        --audio_dir data/icsi/speech --transcript_dir data/icsi/transcripts \\
        --output_dir out --split dev --model_path checkpoints/resnet_base \\
        --analyse [--transfer_codec packed] [--mode fused_conv]

``--config ast_audioset`` sweeps with the AudioSet Audio Spectrogram
Transformer in the clips mode (``--random_init`` for seeded weights).

``--device cuda`` (the default) splits every meeting's channels over
every visible card in a lone process, as the JAX CLI's ``make_mesh()``
does; ``--device cuda:0`` pins one card, and a comma list names the shards
(``cuda:0,cuda:0`` runs two on one card).  Several processes split every
meeting's channels (the JAX CLI's
multi-host flags, ``parallel/distributed.py``): every process runs the same
command with its own ``--process_id``; each decodes, classifies and writes
the TextGrids of its block of channels, after the processes agree that
they see the same audio, and ``--analyse`` runs on the coordinator once
all have written (``--output_dir`` on storage they share).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

# The reference's EXACT sweep grid (gen_eval_exp.py:30-36): 29 thresholds
# (linspace(0, 0.9, 19) + linspace(0.91, 1, 10), rounded to 2 dp) x 3
# min_lengths — row-for-row comparable against reference sum_stats CSVs.
DEFAULT_THRESHOLDS = ",".join(
    [str(round(0.05 * i, 2)) for i in range(19)]
    + [str(round(0.91 + 0.01 * i, 2)) for i in range(10)]
)
DEFAULT_MIN_LENGTHS = "0,0.1,0.2"


def selection_fingerprint(resolved) -> str:
    """Canonical text form of a resolved sweep selection: the list of
    (meeting_id, [chan_id], [path]) the sweep built, with each file's
    header identity (sample count / rate / encoding), so two selections
    that read different audio never print alike."""
    from laughter_detection_icsi_tpu_torch.data.audio import info as audio_info

    lines = []
    for m, ch, paths in resolved:
        metas = [audio_info(p) for p in paths]
        lines.append(
            f"{m}:" + ",".join(
                f"{c}={i.num_samples}/{i.sample_rate}/{i.encoding}"
                for c, i in zip(ch, metas)
            )
        )
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--audio_dir", type=str, required=True,
                   help="root with <meeting>/<chan>.sph")
    p.add_argument("--transcript_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="dev",
                   choices=["train", "dev", "test", "all"])
    p.add_argument("--model_path", type=str, default=None,
                   help="the checkpoint (required unless --random_init)")
    p.add_argument("--random_init", action="store_true",
                   help="seeded initial weights instead of a checkpoint (the "
                        "AST preset's published weights are not in the checkout)")
    p.add_argument("--config", type=str, default="resnet_base",
                   help=f"model preset: {', '.join(MODEL_MAP)} (ast_audioset: "
                        "the AudioSet Audio Spectrogram Transformer, clips mode)")
    p.add_argument("--thresholds", type=str, default=DEFAULT_THRESHOLDS)
    p.add_argument("--min_lengths", type=str, default=DEFAULT_MIN_LENGTHS)
    p.add_argument("--meetings", type=str, default=None,
                   help="comma-separated subset of meeting IDs")
    p.add_argument("--precision", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="default: bfloat16 on accelerators, float32 on CPU")
    p.add_argument("--chunk", type=int, default=None,
                   help="windows per device step (default: 6144 on the "
                        "card, 1024 on the CPU)")
    p.add_argument("--bucket_frames", type=int, default=None,
                   help="frames per fixed-size bucket (default: 6144 on "
                        "the card, 1024 on the CPU)")
    p.add_argument("--mode", type=str, default=None,
                   choices=["windows", "fused_conv", "clips"],
                   help="default: the preset's ('clips' for ast_audioset, "
                        "else 'windows'); 'windows' = reference-exact "
                        "per-window conv; 'fused_conv' = the conv stack once "
                        "over the whole track (faster, not checkpoint "
                        "parity); 'clips' = AST over 10.24 s clips")
    p.add_argument("--transfer_codec", type=str, default="raw",
                   choices=["raw", "auto", "packed"],
                   help="host->device PCM transfer: 'packed'/'auto' = "
                        "lossless bit-packed wire decoded on the device "
                        "(ops/pcm_pack.py; windows mode), 'raw' = plain "
                        "int16 upload")
    p.add_argument("--analyse", action="store_true",
                   help="run the evaluator on the sweep output afterwards")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler trace of the sweep here")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: 'cuda' (default) splits each meeting's "
                        "channels over every visible card (under a process "
                        "group, the process's own card), 'cuda:K' pins one, "
                        "a comma list ('cuda:0,cuda:1', 'cpu,cpu') names the "
                        "shards")
    # Multi-process (the flags of cli/train.py): every process runs the same
    # command; each decodes and uploads only its own channels of every
    # meeting and writes only their TextGrids.
    from laughter_detection_icsi_tpu_torch.parallel import distributed

    distributed.add_cli_args(p)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    from laughter_detection_icsi_tpu_torch.parallel import distributed

    joined = distributed.initialize_from_args(args, parser)

    import numpy as np
    import torch

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.cli.presets import preset_model
    from laughter_detection_icsi_tpu_torch.config import parse_float_list, split_of_meeting
    from laughter_detection_icsi_tpu_torch.data.audio import find_track_audio
    from laughter_detection_icsi_tpu_torch.eval import textgrid as tg
    from laughter_detection_icsi_tpu_torch.eval import transcript as transcript_lib
    from laughter_detection_icsi_tpu_torch.ops import smoothing
    from laughter_detection_icsi_tpu_torch.parallel import ShardedPipeline, mesh
    from laughter_detection_icsi_tpu_torch.runtime import native
    from laughter_detection_icsi_tpu_torch.utils.profiling import ThroughputMeter, trace

    if args.model_path is None and not args.random_init:
        raise SystemExit("--model_path is required (or --random_init)")
    preset, model = preset_model(args.config, "cli/sweep", ("windows", "clips"),
                                 checkpoint=None if args.random_init else args.model_path)
    thresholds = parse_float_list(args.thresholds, "--thresholds")
    min_lengths = parse_float_list(args.min_lengths, "--min_lengths")

    store = transcript_lib.load(args.transcript_dir)
    wanted = (
        {m.strip() for m in args.meetings.split(",") if m.strip()}
        if args.meetings
        else None
    )
    if wanted:
        unknown = wanted - set(store.meeting_ids)
        if unknown:
            raise SystemExit(
                f"unknown meetings: {', '.join(sorted(unknown))} "
                f"(known: {', '.join(store.meeting_ids)})"
            )
    meetings = [
        m
        for m in store.meeting_ids
        if (args.split == "all" or split_of_meeting(m) == args.split)
        and (wanted is None or m in wanted)
    ]
    if not meetings:
        # A typo'd or empty selection (or --meetings outside --split) must
        # not sweep nothing and exit 0, and a chained --analyse evaluate an
        # empty preds dir.
        raise SystemExit(
            f"no meetings selected (split={args.split!r}, "
            f"meetings={sorted(wanted) if wanted else 'all'}) — check that "
            f"the requested meetings belong to the requested split"
        )
    try:
        devices = mesh.local_devices(args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    settings = inference.settings_from_flags(
        chunk=args.chunk,
        bucket_frames=args.bucket_frames,
        precision=args.precision,
        device=devices[0],
        mode=args.mode or preset.mode,
        transfer_codec=args.transfer_codec,
    )
    try:
        pipe = ShardedPipeline(model, feat_cfg=preset.feat, settings=settings, devices=devices)
    except ValueError as e:  # a preset in a mode that cannot run it
        raise SystemExit(f"--config {args.config}: {e}")
    on_card = pipe.device.type == "cuda"

    # Resolve every meeting's channel audio up front: the warm-up below must
    # warm the channel counts actually swept (a meeting with missing audio
    # has fewer channels than its transcript lists).
    resolved = []  # (meeting_id, [chan_id], [path])
    for meeting_id in meetings:
        chans, paths = [], []
        for row in store.info:
            if row.meeting_id != meeting_id:
                continue
            path = find_track_audio(args.audio_dir, meeting_id, row.chan_id)
            if path is None:
                print(f"missing audio: {meeting_id}/{row.chan_id}.sph (and .wav)")
                continue
            chans.append(row.chan_id)
            paths.append(path)
        resolved.append((meeting_id, chans, paths))

    if distributed.is_multi_process():
        # The processes agree on the (meeting, channel) lists and each
        # file's header (sample count, rate, encoding): a file missing,
        # truncated or re-encoded on one host would give that process
        # other channel blocks and bucket counts than the others'.
        import hashlib

        digest = hashlib.sha256(selection_fingerprint(resolved).encode()).hexdigest()
        if len(set(distributed.all_gather_object(digest))) > 1:
            raise SystemExit(
                "multi-host sweep: the resolved (meeting, channel) audio "
                "lists or file headers differ across processes — every "
                "host must see the same files under --audio_dir (a file "
                "missing, truncated, or re-encoded on one host would "
                "desynchronize the SPMD channel batches); sync the audio "
                "or restrict --meetings to commonly-available ones"
            )

    # Warm each distinct channel count off the clock: cuDNN picks its
    # algorithms on the first call of each shape, which would be billed to
    # the first meeting's span.  Every shard takes rows of each batch, so
    # every card warms.  The rows come back on the first card, so its
    # synchronize waits for every card's work.
    warm_len = settings.bucket_frames * pipe.feat_cfg.frame_shift_samples
    for n_ch in sorted({len(paths) for _, _, paths in resolved if paths}):
        pipe.probs_for_waveforms_device([np.zeros(warm_len, np.int16)] * n_ch)
    if on_card:
        torch.cuda.synchronize(pipe.device)

    # Which decoder the shorten channels go through: the numpy fallback is
    # ~100x slower, so a sweep says which one it runs.
    if native.available():
        print(f"audio decoder: native C++ ({native.library_path('audiodec')})")
    else:
        print("audio decoder: numpy (the native library did not build; see the warning)")

    print(f"shards: {pipe.n_shards} (this process: {', '.join(map(str, pipe.devices))})")
    out_root = Path(args.output_dir) / args.split
    meter = ThroughputMeter(n_chips=pipe.n_shards)
    total_audio_s = 0.0
    t0 = time.perf_counter()
    with trace(args.trace_dir):
        for meeting_id, chans, paths in resolved:
            if not paths:
                continue
            print(f"{meeting_id}: {len(paths)} channels ...", flush=True)
            meter.start()
            (probs_dev, ts), durations = pipe.probs_for_meeting_device(paths)
            if on_card:
                # The device works asynchronously: without the wait the
                # meter would time the launches, not the work.
                torch.cuda.synchronize(pipe.device)
            rtf = meter.stop(float(np.sum(durations)))
            print(f"  {rtf:.1f}x realtime", flush=True)
            total_audio_s += float(np.sum(durations))
            # Each process postprocesses and writes its own channels (every
            # channel in a run of one), an all-empty meeting's too.
            if probs_dev is not None:
                rows = pipe.local_channels(probs_dev, len(chans))
            else:
                rows = [(i, None) for i in pipe.local_channel_indices(len(chans))]
            for i, row_probs in rows:
                chan_id, duration = chans[i], durations[i]
                # The threshold x min-length sweep of each row on the
                # device: only run tables cross to the host.
                t_i = ts[i]
                fps = t_i / duration if duration > 0 else 100.0
                row = row_probs[:t_i] if row_probs is not None else torch.zeros(0)
                instances = smoothing.instances_from_device_probs(
                    row, thresholds=thresholds, min_lengths=min_lengths, fps=fps,
                )
                for (thr, min_len), insts in instances.items():
                    d = out_root / meeting_id / f"t_{thr}" / f"l_{min_len}"
                    d.mkdir(parents=True, exist_ok=True)
                    tg.write_textgrid(str(d / f"{chan_id}.TextGrid"), insts, xmax=duration)
    dt = time.perf_counter() - t0
    if total_audio_s:
        print(
            f"swept {total_audio_s / 3600:.4f} h of audio ({total_audio_s:.3f} audio-s) in "
            f"{dt:.4f} s: {total_audio_s / dt:.2f} audio-s per wall-s end to end, "
            f"{meter.x_realtime_per_chip:.2f} inference only ({meter.wall_seconds:.4f} s)"
        )
    if args.trace_dir:
        print(f"profiler trace written to {args.trace_dir}")
    # Every process has written its TextGrids before the coordinator reads
    # them.
    distributed.barrier()
    if args.analyse and distributed.is_coordinator():
        from laughter_detection_icsi_tpu_torch.cli.analyse import print_report
        from laughter_detection_icsi_tpu_torch.eval.analyse import analyse

        if joined:
            print("analyse on coordinator (NOTE: --output_dir must be shared "
                  "storage for the evaluation to see every host's TextGrids)")
        print_report(analyse(str(out_root), transcript_dir=args.transcript_dir, force=True))
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
