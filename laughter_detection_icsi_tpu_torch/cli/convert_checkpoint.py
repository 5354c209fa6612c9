"""Checkpoint converter for the PyTorch port: reference ``.pth.tar`` <->
native ``.ckpt.npz`` (the JAX package's ``cli/convert_checkpoint.py``).

The port reads both formats already (``train/checkpoint.py``); this writes
one from the other, for tools that take only one.  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.convert_checkpoint \\
        checkpoints/run/best.ckpt.npz exported/best.pth.tar
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", type=str, help=".pth.tar/.pth/.pt or .ckpt.npz")
    p.add_argument("dest", type=str, help="output path (.ckpt.npz or .pth.tar)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt

    loaded = ckpt.load_checkpoint(args.src)

    def get(key, default):
        # `or` would map legitimate zeros (epoch 0, best_val_loss 0.0) to
        # the default.
        v = loaded.get(key)
        return default if v is None else v

    # Both formats are written into a temporary directory beside ``dest``
    # and renamed into place: an interrupt never leaves a truncated file
    # where a valid one was, and save_checkpoint's fixed last.ckpt.npz
    # name never clobbers a live training checkpoint in dest's directory.
    with tempfile.TemporaryDirectory(dir=os.path.dirname(args.dest) or ".") as tmp:
        if args.dest.endswith((".pth.tar", ".pth", ".pt")):
            path = os.path.join(tmp, os.path.basename(args.dest))
            torch.save({"state_dict": loaded["state_dict"], "epoch": get("epoch", 0),
                        "global_step": get("global_step", 0),
                        "best_val_loss": get("best_val_loss", float("inf"))}, path)
        else:
            path = ckpt.save_checkpoint(
                tmp, loaded["state_dict"], opt_state=loaded.get("opt_state"),
                epoch=get("epoch", 0), global_step=get("global_step", 0),
                best_val_loss=get("best_val_loss", float("inf")),
                epoch_step=get("epoch_step", 0))
        os.replace(path, args.dest)
    n = sum(v.numel() for k, v in loaded["state_dict"].items()
            if k.rsplit(".", 1)[-1] not in ("running_mean", "running_var", "num_batches_tracked"))
    print(f"converted {args.src} -> {args.dest} ({n:,} parameters)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
