"""Export a trained model as a ``torch.export`` artifact, for the PyTorch
port.

The JAX package's ``cli/export_model.py`` with ``torch.export`` in place of
``jax.export``: the weights and the computation in one file that
``export.load`` runs without the model's source.  ``--what``:
- ``windows``: [B, 1, 100, 44] log-mel windows -> [B] probabilities; the
  batch is symbolic unless ``--batch N`` pins it.
- ``e2e``: one bucket's PCM buffer ([wave_len] int16 by default, plus the
  valid-frame count as a 0-d int32 tensor) -> [bucket_frames]
  per-10 ms-frame probabilities: the fbank kernel (a custom op),
  shared-stem windowing and the classifier in one graph.  Build the
  buffers with ``host_prep.bucket_inputs``.

JAX's ``--platforms`` and ``--pallas_fbank`` are XLA's and have no
counterpart: the artifact holds its tensors on ``--device`` (default
``cuda``), and on the card an e2e artifact runs the hand-written fbank
kernel.  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.export_model \\
        --model_path checkpoints/resnet_base --out model.pt2 --what e2e
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint (.ckpt.npz | .pth.tar) or its directory")
    # resnet_base, as the JAX CLI: resnet_with_augmentation's 128-wide head
    # does not fit the ICSI (100, 44) window this exporter bakes in.
    p.add_argument("--config", type=str, default="resnet_base")
    p.add_argument("--out", type=str, required=True,
                   help="output artifact path (e.g. model.pt2)")
    p.add_argument("--what", choices=["windows", "e2e"], default="windows")
    p.add_argument("--batch", type=int, default=None,
                   help="windows: pin the batch dim (default: symbolic)")
    p.add_argument("--precision", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--chunk", type=int, default=None,
                   help="e2e: windows per chunk (default: 6144 on the card, "
                        "1024 on the CPU)")
    p.add_argument("--bucket_frames", type=int, default=None,
                   help="e2e: frames per bucket (default 6144)")
    p.add_argument("--wave_dtype", choices=["int16", "float32"], default=None,
                   help="e2e: PCM dtype the artifact takes (default int16)")
    p.add_argument("--random_init", action="store_true",
                   help="export an untrained model (tests/smoke only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the artifact runs on (default: cuda)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    # Validation that needs only the arguments runs first, before the
    # checkpoint loads.  A knob the selected --what ignores is an error: a
    # user must not believe a no-op flag took effect in an artifact.
    e2e_only = {"--chunk": args.chunk, "--bucket_frames": args.bucket_frames,
                "--wave_dtype": args.wave_dtype}
    if args.what == "windows":
        given = [k for k, v in e2e_only.items() if v is not None]
        if given:
            raise SystemExit(f"{given[0]} only applies to --what e2e")
    elif args.batch is not None:
        raise SystemExit("--batch only applies to --what windows "
                         "(the e2e artifact has no batch dimension)")
    for name, v in (("--batch", args.batch), ("--chunk", args.chunk),
                    ("--bucket_frames", args.bucket_frames)):
        # `is not None`: an explicit 0 is refused, not swapped for the default.
        if v is not None and v < 1:
            raise SystemExit(f"{name} must be >= 1, got {v}")
    if args.model_path is None and not args.random_init:
        raise SystemExit("--model_path is required (or --random_init)")

    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP

    if args.config not in MODEL_MAP:
        raise SystemExit(
            f"--config: unknown preset {args.config!r} (choose from {sorted(MODEL_MAP)})"
        )
    if MODEL_MAP[args.config].mode != "windows":
        raise SystemExit(
            f"--config {args.config}: {MODEL_MAP[args.config].model} is not exported: its "
            "artifacts would be the window classifier ([B, 1, 100, 44] windows) or the "
            f"windows-mode bucket body, and it runs only in mode {MODEL_MAP[args.config].mode!r}"
        )

    from laughter_detection_icsi_tpu_torch import export as export_lib
    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib

    device = inference.resolve_device(args.device)
    preset = MODEL_MAP[args.config]
    model = zoo.build(preset.model, dropout_rate=0.0,
                      linear_layer_size=preset.linear_layer_size,
                      filter_sizes=preset.filter_sizes)
    if not args.random_init:
        found = ckpt_lib.resolve_checkpoint(args.model_path)
        if found is None:
            raise SystemExit(f"Model checkpoint not found at {args.model_path}")
        model.load_state_dict(ckpt_lib.load_checkpoint(found)["state_dict"], strict=True)
    model.eval()

    if args.what == "windows":
        exported = export_lib.export_window_classifier(
            model, batch=args.batch, precision=args.precision, device=device)
        b = args.batch if args.batch is not None else "b"
        sig = f"[{b}, 1, 100, 44] float32 windows -> [{b}] float32 probs"
    else:
        settings = inference.settings_from_flags(
            chunk=args.chunk,
            bucket_frames=args.bucket_frames if args.bucket_frames is not None else 6144,
            precision=args.precision, device=device,
        )
        wave_dtype = args.wave_dtype if args.wave_dtype is not None else "int16"
        pipe = inference.LaughterPipeline(model, settings=settings, device=device)
        exported, wave_len = export_lib.export_bucket_pipeline(
            pipe, int16_in=(wave_dtype == "int16"))
        sig = (f"([{wave_len}] {wave_dtype} bucket buffer (host_prep.bucket_inputs), "
               f"0-d int32 valid_frames) -> [{settings.bucket_frames}] float32 probs")

    n_bytes = export_lib.save(exported, args.out)
    print(f"wrote {args.out} ({n_bytes:,} bytes, {exported.precision} on {exported.device})")
    print(f"signature: {sig}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
