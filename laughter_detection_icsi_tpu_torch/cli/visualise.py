"""Visualisation CLI for the PyTorch port (reference visualise.py): plots
from training metrics and evaluation CSVs.

The JAX package's ``cli/visualise.py`` with the same modes, flags, column
checks and errors, on the port's ``viz.py``.  Host code only; drawing
needs matplotlib (``--help`` and the argument checks do not).  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.visualise pr \\
        out/dev_sum_stats.csv --out pr.png
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=["train", "pr", "confusion", "compare",
                                    "lengthdist", "ratiodist"])
    p.add_argument("inputs", nargs="+",
                   help="train: metrics.csv | pr: sum_stats CSV | "
                        "confusion/lengthdist/ratiodist: per-meeting "
                        "eval_df CSV | "
                        "compare: name=path pairs of sum_stats CSVs")
    p.add_argument("--out", type=str, required=True, help="output PNG path")
    p.add_argument("--min_len", type=float, default=None,
                   help="filter pr/confusion/compare/lengthdist/ratiodist "
                        "to one smoothing setting (rejected for train)")
    p.add_argument("--threshold", type=float, default=None,
                   help="prediction threshold for lengthdist/ratiodist "
                        "(required there, rejected elsewhere; reference "
                        "analyse.py:303-411 plots one threshold per figure)")
    p.add_argument("--title", type=str, default=None,
                   help="figure title (train only)")
    return p


# Column fingerprints of the three CSV kinds this CLI accepts: the wrong
# kind would otherwise crash on a missing column (confusion <- sum_stats)
# or draw a wrong figure (pr <- per-meeting eval_df).
_REQUIRED_COLUMNS = {
    "train": ("global_step",),
    "pr": ("threshold", "min_len", "precision", "recall"),
    "compare": ("threshold", "min_len", "precision", "recall"),
    "confusion": ("threshold", "min_len", "tot_fp_speech_time",
                  "tot_fp_noise_time", "tot_fp_silence_time"),
    "lengthdist": ("threshold", "min_len", "tot_pred_time",
                   "tot_transc_laugh_time"),
    "ratiodist": ("threshold", "min_len", "tot_pred_time",
                  "tot_transc_laugh_time", "corr_pred_time"),
}
_INPUT_KIND = {
    "train": "a training metrics.csv",
    "pr": "a sweep sum_stats CSV (analyse --sum_stats output)",
    "compare": "sweep sum_stats CSVs (analyse --sum_stats outputs)",
    "confusion": "a per-meeting eval_df CSV (analyse output)",
    "lengthdist": "a per-meeting eval_df CSV (analyse output)",
    "ratiodist": "a per-meeting eval_df CSV (analyse output)",
}


def _check_columns(what: str, path: str) -> None:
    with open(path, newline="") as f:
        header = next(csv.reader(f), [])
    missing = [c for c in _REQUIRED_COLUMNS[what] if c not in header]
    if missing:
        raise SystemExit(
            f"{path} is missing column(s) {missing} — '{what}' expects "
            f"{_INPUT_KIND[what]}"
        )
    if what in ("pr", "compare") and "tot_fp_speech_time" in header:
        # A per-meeting eval_df carries threshold/precision/recall too, but
        # its several rows per (threshold, min_len) would jumble one line.
        raise SystemExit(
            f"{path} looks like a per-meeting eval_df (has per-type FP "
            f"columns) — '{what}' expects {_INPUT_KIND[what]}"
        )


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from laughter_detection_icsi_tpu_torch import viz

    if args.what != "compare" and len(args.inputs) > 1:
        # Only compare takes several inputs; plotting the first alone would
        # report success for a figure missing the others.
        raise SystemExit(
            f"{args.what} takes exactly one input CSV "
            f"(got {len(args.inputs)}); use 'compare' for multiple runs"
        )
    # A flag a mode would ignore is refused: a user who believes they
    # filtered or titled the figure must not read an unfiltered one.
    if args.min_len is not None and args.what == "train":
        raise SystemExit("--min_len does not apply to 'train'")
    if args.title is not None and args.what != "train":
        raise SystemExit(f"--title does not apply to {args.what!r}")
    if args.what in ("lengthdist", "ratiodist"):
        if args.threshold is None:
            raise SystemExit(f"{args.what!r} requires --threshold")
    elif args.threshold is not None:
        raise SystemExit(f"--threshold does not apply to {args.what!r}")
    if args.what == "train":
        _check_columns("train", args.inputs[0])
        viz.plot_train_metrics(args.inputs[0], out_path=args.out, title=args.title)
    elif args.what == "pr":
        _check_columns("pr", args.inputs[0])
        viz.plot_precision_recall(args.inputs[0], out_path=args.out, min_len=args.min_len)
    elif args.what == "confusion":
        _check_columns("confusion", args.inputs[0])
        viz.plot_fp_confusion(args.inputs[0], out_path=args.out, min_len=args.min_len)
    elif args.what == "lengthdist":
        _check_columns("lengthdist", args.inputs[0])
        viz.plot_aggregated_laughter_length_dist(
            args.inputs[0], args.threshold, out_path=args.out, min_len=args.min_len,
        )
    elif args.what == "ratiodist":
        _check_columns("ratiodist", args.inputs[0])
        viz.plot_agg_pred_time_ratio_dist(
            args.inputs[0], args.threshold, out_path=args.out, min_len=args.min_len,
        )
    else:
        bad = [s for s in args.inputs if "=" not in s]
        if bad:
            raise SystemExit(
                f"compare inputs must be name=path pairs (got {bad[0]!r})"
            )
        pairs = dict(s.split("=", 1) for s in args.inputs)
        if len(pairs) != len(args.inputs):
            # dict() keeps only the last duplicate: one experiment would be
            # labelled as two.
            raise SystemExit("compare experiment names must be unique")
        for path in pairs.values():
            _check_columns("compare", path)
        viz.plot_experiment_comparison(pairs, out_path=args.out, min_len=args.min_len)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
