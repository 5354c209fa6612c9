"""Streaming laughter-detection server for the PyTorch port: PCM in,
NDJSON events out.

The same flags as the JAX package's ``cli/serve.py``, plus ``--device``
(default ``cuda``).  The front end over ``inference.StreamingSession`` (one
stream, on one device) and ``parallel.sharded_inference.
ShardedStreamingSession`` (a live meeting's channels as one batch, split
over every device ``--device`` names: ``cuda`` is every visible card, as
JAX's ``make_mesh()``; ``cuda:0`` pins one; ``cuda:0,cuda:0`` runs two
shards on one card; ``cpu``, or ``cpu,cpu``, the CPU): feed 16 kHz PCM in chunks
of any size, get one JSON line the moment a laughter run closes.  The
probabilities equal the offline pipeline's on the concatenated audio bit
for bit, so the events equal ``segment_laughter``'s.

Input modes:
  --input -                raw interleaved s16le PCM @ 16 kHz on stdin
                           (``--channels N`` for N interleaved channels)
  --input file.wav|.sph    decode the file and replay it through the
                           streaming path in ``--chunk_ms`` slices

Output (stdout, one JSON object per line):
  {"type": "ready", ...}                          after the warm-up
  {"type": "event", "channel": c, "start": s, "end": e, "threshold": t}
  {"type": "done", "seconds": n, "events": k}     at end of stream

Run it as
  arecord -f S16_LE -r 16000 -t raw | \\
      python -m laughter_detection_icsi_tpu_torch.cli.serve --model_path ck/

``--precision`` defaults to bfloat16 on the card and float32 on the CPU,
as the JAX CLI's on an accelerator and on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    doc = (__doc__ or "").splitlines()
    p = argparse.ArgumentParser(
        description=" ".join(doc[:2]) if doc else "Streaming laughter-detection server"
    )
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--config", type=str, default="resnet_base")
    p.add_argument("--input", type=str, default="-",
                   help="'-' for raw s16le PCM on stdin, or an audio file "
                        "to replay through the streaming path")
    p.add_argument("--channels", type=int, default=1,
                   help="interleaved channel count of the stdin stream "
                        "(>1 runs the channels as one batch)")
    p.add_argument("--channel", type=int, default=0,
                   help="which channel of a replayed audio file to analyze "
                        "(file replay is single-stream)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--min_length", type=float, default=0.2)
    p.add_argument("--chunk_ms", type=int, default=250,
                   help="feed granularity in milliseconds")
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--bucket_frames", type=int, default=None,
                   help="probability latency bound: a bucket finalizes "
                        "every bucket_frames x 10 ms of audio")
    p.add_argument("--precision", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="default: bfloat16 on accelerators, float32 on CPU")
    p.add_argument("--save_probs", type=str, default=None,
                   help="write the full [channels, T] probability array "
                        "(.npy) at end of stream")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: 'cuda' (default) splits --channels over "
                        "every visible card, 'cuda:K' pins one, a comma list "
                        "('cuda:0,cuda:1', 'cuda:0,cuda:0', 'cpu,cpu') names "
                        "the shards; one stream runs on the first")
    return p


def _emit(obj: dict) -> None:
    try:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()
    except BrokenPipeError:
        # The NDJSON consumer exited (e.g. `... | head -5`): a normal end
        # for pipe-based serving.  Point stdout at devnull so the
        # interpreter's shutdown flush does not raise again, and exit with
        # the conventional SIGPIPE code.
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        raise SystemExit(141)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.channels < 1:
        # Before the model load: 0 would die deep in the stdin loop.
        raise SystemExit(f"--channels must be >= 1 (got {args.channels})")
    for name, v in (("--chunk", args.chunk), ("--bucket_frames", args.bucket_frames)):
        # `is not None`: an explicit 0 is refused here, not swapped for the
        # default.
        if v is not None and v < 1:
            raise SystemExit(f"{name} must be >= 1, got {v}")
    if args.input != "-" and args.channels != 1:
        raise SystemExit(
            "--channels applies to the interleaved stdin stream; file "
            "replay analyzes ONE channel (pick it with --channel)"
        )

    import numpy as np

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli.presets import preset_model
    from laughter_detection_icsi_tpu_torch.config import FEAT
    from laughter_detection_icsi_tpu_torch.ops.smoothing import StreamingEventDetector
    from laughter_detection_icsi_tpu_torch.parallel import mesh

    try:
        devices = mesh.local_devices(args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    settings = inference.settings_from_flags(
        chunk=args.chunk, bucket_frames=args.bucket_frames,
        precision=args.precision, device=devices[0],
    )
    # The sessions stream the windows mode.
    preset, model = preset_model(args.config, "cli/serve", ("windows",),
                                 checkpoint=args.model_path)

    n_ch = args.channels
    # Event times divide frame indices by this.  File replay takes the
    # offline fps (frames / duration), so its events equal
    # segment_laughter's even when the sample count is not frame-aligned;
    # live stdin has no known duration and takes the true 100 frames/s.
    fps = 100.0
    wave = None
    if args.input != "-":
        from laughter_detection_icsi_tpu_torch.data import audio as audio_io

        meta = audio_io.info(args.input)
        if inference.int16_transfer_eligible(meta, settings):
            wave, sr = audio_io.read_int16(args.input, channel=args.channel, meta=meta)
        else:
            wave, sr = audio_io.read(args.input, channel=args.channel)
        if sr != FEAT.sampling_rate:
            raise SystemExit(f"{args.input}: expected 16 kHz audio, got {sr}")
        duration = len(wave) / float(sr)
        if duration > 0:
            fps = host_prep.num_frames(len(wave)) / duration
    if n_ch == 1:
        devices = devices[:1]
        pipe = inference.LaughterPipeline(model, feat_cfg=preset.feat, settings=settings,
                                          device=devices[0])
        sess = inference.StreamingSession(pipe)
        feed = lambda chunks: sess.feed(chunks[0])
        finish = sess.finish
        warm_up = lambda w: pipe.probs_for_waveform(w)
    else:
        from laughter_detection_icsi_tpu_torch.parallel import (
            ShardedPipeline,
            ShardedStreamingSession,
        )

        pipe = ShardedPipeline(model, feat_cfg=preset.feat, settings=settings, devices=devices)
        sharded = ShardedStreamingSession(pipe, n_channels=n_ch)
        feed, finish = sharded.feed, sharded.finish
        # Every shard takes rows of the batch, so every card is warmed.
        warm_up = lambda w: pipe.probs_for_waveforms([w] * n_ch)

    detectors = [
        StreamingEventDetector(args.threshold, args.min_length, fps=fps) for _ in range(n_ch)
    ]
    probs_out: List[List[np.ndarray]] = [[] for _ in range(n_ch)]
    n_events = 0
    n_samples = 0
    # Session index -> the channel an event describes: file replay runs one
    # session over source channel --channel.
    chan_label = [args.channel] if wave is not None else list(range(n_ch))

    def emit_event(c: int, start: float, end: float) -> None:
        nonlocal n_events
        n_events += 1
        _emit({"type": "event", "channel": chan_label[c], "start": round(start, 3),
               "end": round(end, 3), "threshold": args.threshold})

    def handle(probs: np.ndarray) -> None:
        probs = np.atleast_2d(probs)
        for c in range(n_ch):
            if args.save_probs:
                probs_out[c].append(probs[c])
            for start, end in detectors[c].feed(probs[c]):
                emit_event(c, start, end)

    # Warm up before announcing readiness (cuDNN picks its algorithms on
    # the first bucket), with the dtype that will be fed (stdin is s16le)
    # and exactly one bucket of audio: bucket_frames * shift samples is
    # bucket_frames frames under snip_edges=False, the fixed shapes every
    # later bucket runs at.
    warm_up(np.zeros(settings.bucket_frames * FEAT.frame_shift_samples,
                     dtype=np.int16 if wave is None else wave.dtype))
    _emit({"type": "ready", "channels": n_ch,
           "bucket_latency_s": settings.bucket_frames / 100.0,
           "device": str(pipe.device),
           "devices": [str(d) for d in devices]})

    chunk_samples = max(1, args.chunk_ms * FEAT.sampling_rate // 1000)
    if args.input == "-":
        stdin = sys.stdin.buffer
        frame_bytes = 2 * n_ch
        # Carry partial frames across reads: an unbuffered or non-blocking
        # stdin can short-read mid-frame, and dropping the remainder would
        # misalign every later sample (and swap channels).  Only a trailing
        # partial frame at EOF is discarded.
        pending = b""
        while True:
            raw = stdin.read(chunk_samples * frame_bytes)
            if raw is None:
                # Non-blocking stdin with no bytes available yet: not EOF.
                time.sleep(0.005)
                continue
            if not raw:
                break
            raw = pending + raw
            usable = len(raw) - len(raw) % frame_bytes
            pending = raw[usable:]
            if not usable:
                continue
            deint = np.frombuffer(raw[:usable], dtype="<i2").reshape(-1, n_ch)
            n_samples += deint.shape[0]
            handle(feed([np.ascontiguousarray(deint[:, c]) for c in range(n_ch)]))
    else:
        for lo in range(0, len(wave), chunk_samples):
            piece = wave[lo : lo + chunk_samples]
            n_samples += len(piece)
            handle(feed([piece]))

    handle(finish())
    for c in range(n_ch):
        for start, end in detectors[c].finish():
            emit_event(c, start, end)
    if args.save_probs:
        np.save(args.save_probs, np.stack(
            [np.concatenate(p) if p else np.zeros(0, np.float32) for p in probs_out]
        ))
    _emit({"type": "done", "seconds": round(n_samples / float(FEAT.sampling_rate), 3),
           "events": n_events})
    return 0


if __name__ == "__main__":
    sys.exit(main())
