"""Laughter segmentation CLI for the PyTorch port (reference
segment_laughter.py:28-198).

The same flags as the JAX package's ``cli/segment_laughter.py``, plus
``--device`` (default ``cuda``).  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.segment_laughter \\
        --input_audio_file meeting.wav --model_path checkpoints/resnet_base \\
        --output_dir out --save_to_textgrid True --device cuda

``--mode fused_conv`` runs the conv stack once over the whole track
(models/fully_conv.py).  ``--config ast_audioset`` runs the AudioSet
Audio Spectrogram Transformer in the clips mode (its features, 10.24 s
clips a second apart); with ``--random_init`` its weights come from the
seed.  ``--transfer_codec packed|auto`` ships int16
buckets as a bit-packed wire decoded on the device (ops/pcm_pack.py;
windows mode).  ``--precision`` defaults to bfloat16 on the card and
float32 on the CPU, as the JAX CLI's on an accelerator and on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def strtobool(v: str) -> bool:
    """distutils.util.strtobool semantics: an unrecognized string is an
    error, not False (a typo must not discard every output)."""
    s = str(v).lower()
    if s in ("1", "true", "yes", "y", "t", "on"):
        return True
    if s in ("0", "false", "no", "n", "f", "off"):
        return False
    raise SystemExit(f"invalid truth value {v!r} (use true/false)")


def build_parser() -> argparse.ArgumentParser:
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", type=str, default="checkpoints/in_use/resnet_base")
    p.add_argument("--config", type=str, default="resnet_base",
                   help=f"model preset: {', '.join(MODEL_MAP)} (ast_audioset: "
                        "the AudioSet Audio Spectrogram Transformer, clips mode)")
    p.add_argument("--thresholds", type=str, default="0.5",
                   help="single value or comma-separated list")
    p.add_argument("--min_lengths", type=str, default="0.2",
                   help="single value or comma-separated list")
    p.add_argument("--input_audio_file", type=str, default=None)
    p.add_argument("--interactive", action="store_true",
                   help="REPL: read audio paths from stdin, print laugh "
                        "instances (reference i_pred, segment_laughter.py:163-175)")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--save_to_audio_files", type=str, default="True")
    p.add_argument("--save_to_textgrid", type=str, default="False")
    p.add_argument("--channel", type=int, default=0, help="audio channel to read")
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
                        "(windows mode), 'raw' = plain int16 upload")
    p.add_argument("--random_init", action="store_true",
                   help="skip checkpoint loading (seeded initial weights; "
                        "smoke tests/benchmarks)")
    p.add_argument("--benchmark", type=int, default=0, metavar="N",
                   help="measure the realtime factor over N runs and exit "
                        "(reference calc_real_time_factor, "
                        "segment_laughter.py:178-197)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def save_instances(
    instances, output_dir: str, save_to_audio_files: bool, save_to_textgrid: bool,
    audio_path: str, channel: int,
) -> None:
    """reference segment_laughter.py:124-161."""
    from laughter_detection_icsi_tpu_torch.data import audio as audio_io
    from laughter_detection_icsi_tpu_torch.eval import textgrid as tg

    # Before the empty check, like the reference's unconditional mkdir: an
    # empty t_<thr>/l_<minlen>/ dir is meaningful to the evaluator.
    os.makedirs(output_dir, exist_ok=True)
    if not instances:
        return
    if save_to_audio_files:
        for index, inst in enumerate(instances):
            wav, sr = audio_io.cut_segments(audio_path, [inst], channel=channel)
            wav_path = os.path.join(output_dir, f"laugh_{index}.wav")
            audio_io.write_wav(wav_path, wav, sr)
            print(f"{inst[0]:.2f}-{inst[1]:.2f}s -> {wav_path}")
    if save_to_textgrid:
        fname = os.path.splitext(os.path.basename(audio_path))[0]
        out = os.path.join(output_dir, fname + ".TextGrid")
        tg.write_textgrid(out, instances, xmax=audio_io.get_audio_length(audio_path))
        print(f"Saved laughter segments in {out}")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP, parse_float_list
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib

    if args.config not in MODEL_MAP:
        raise SystemExit(
            f"--config: unknown preset {args.config!r} "
            f"(choose from {sorted(MODEL_MAP)})"
        )
    preset = MODEL_MAP[args.config]
    thresholds = parse_float_list(args.thresholds, "--thresholds")
    min_lengths = parse_float_list(args.min_lengths, "--min_lengths")
    save_audio = strtobool(args.save_to_audio_files)
    save_tg = strtobool(args.save_to_textgrid)

    settings = inference.settings_from_flags(
        chunk=args.chunk,
        bucket_frames=args.bucket_frames,
        precision=args.precision,
        device=args.device,
        mode=args.mode or preset.mode,
        transfer_codec=args.transfer_codec,
    )
    model = zoo.build(
        preset.model,
        dropout_rate=0.0,
        linear_layer_size=preset.linear_layer_size,
        filter_sizes=preset.filter_sizes,
    )
    if not args.random_init:
        best = ckpt_lib.resolve_checkpoint(args.model_path)
        if best is None:
            raise SystemExit(f"Model checkpoint not found at {args.model_path}")
        model.load_state_dict(ckpt_lib.load_checkpoint(best)["state_dict"], strict=True)
    try:
        pipe = inference.LaughterPipeline(model, feat_cfg=preset.feat, settings=settings,
                                          device=args.device)
    except ValueError as e:  # a preset in a mode that cannot run it
        raise SystemExit(f"--config {args.config}: {e}")

    if args.interactive:
        print("Starting interactive laughter-prediction shell (Ctrl-D to exit)")
        while True:
            try:
                path = input("path to audio file: ").strip()
            except (EOFError, KeyboardInterrupt):
                print()
                return 0
            if not path:
                continue
            try:
                inst, took = pipe.segment_file(
                    path, thresholds=thresholds, min_lengths=min_lengths,
                    channel=args.channel,
                )
            except Exception as e:  # keep the shell alive on bad input
                print(f"error: {e}")
                continue
            for setting, instances in inst.items():
                print(f"t={setting[0]} l={setting[1]}: {instances}")
            print(f"({took:.2f}s)")

    if not args.input_audio_file:
        raise SystemExit("--input_audio_file is required (or use --interactive)")
    if args.benchmark:
        if args.benchmark < 1:
            raise SystemExit(f"--benchmark wants >= 1 iterations, got {args.benchmark}")
        rtf = inference.calc_real_time_factor(
            pipe, args.input_audio_file, iterations=args.benchmark,
            thresholds=thresholds, min_lengths=min_lengths, channel=args.channel,
        )
        print(f"Real-time factor over {args.benchmark} runs: {rtf:.6f} "
              f"({1.0 / rtf:.1f}x realtime)")
        return 0
    if (save_audio or save_tg) and not args.output_dir:
        # Same contract as the reference (segment_laughter.py:139).
        raise SystemExit("Need to specify an output directory to save audio files")
    instance_dict, took = pipe.segment_file(
        args.input_audio_file,
        thresholds=thresholds,
        min_lengths=min_lengths,
        channel=args.channel,
    )
    print(f"Completed in: {took:.2f}s")
    for setting, instances in instance_dict.items():
        print(
            f"Found {len(instances)} laughs for threshold {setting[0]} "
            f"and min_length {setting[1]}."
        )
        if args.output_dir:
            out = os.path.join(args.output_dir, f"t_{setting[0]}", f"l_{setting[1]}")
            save_instances(
                instances, out, save_audio, save_tg, args.input_audio_file, args.channel
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
