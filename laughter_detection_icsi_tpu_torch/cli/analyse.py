"""Evaluation CLI for the PyTorch port (reference analysis/analyse.py:541-547).

The same flags and outputs as the JAX package's ``cli/analyse.py``, on the
port's evaluator (``eval/analyse.py``: the standard library and numpy, no
pandas, no lxml).  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.analyse out/dev \\
        --transcript_dir data/icsi/transcripts

It needs no device: scoring reads TextGrids and transcripts on the host.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from pathlib import Path
from typing import List, Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("preds_dir", type=str, nargs="?", default=None,
                   help="dir of <meeting>/t_<thr>/l_<minlen>/chanN.TextGrid")
    p.add_argument("--transcript_dir", type=str, default=None,
                   help="defaults to $TRANSCRIPT_DIR (via --env_file) or "
                        "the repo-local corpus layout")
    p.add_argument("--env_file", type=str, default=".env",
                   help="dotenv file for TRANSCRIPT_DIR (reference "
                        "sample.env workflow)")
    p.add_argument("--force", action="store_true",
                   help="ignore cached eval CSVs")
    p.add_argument("--laugh_counts", action="store_true",
                   help="print per-meeting laugh-segment counts (all vs "
                        "laugh-only) from the transcripts and exit — the "
                        "reference's filter_all_laughs.sh / "
                        "filter_laugh_only.sh xmllint sweeps")
    p.add_argument("--min_length_sweep", type=str, default=None,
                   metavar="L1,L2,...",
                   help="re-evaluate the sweep at each laugh-validity "
                        "min_length (comma list of seconds, or 'default' "
                        "for 0.1..1.0 step 0.1), rebuilding the interval "
                        "indices per value; writes "
                        "<split>_sum_stats_for_different_min_lengths.csv "
                        "next to preds_dir")
    p.add_argument("--meeting_csvs", type=str, default=None, metavar="MEETING",
                   help="export <meeting>_transc.csv + <meeting>_preds.csv "
                        "for one meeting (reference analyse.py:481-506); "
                        "needs preds_dir")
    p.add_argument("--breath_laugh_csv", type=str, default=None, metavar="PATH",
                   help="export transcribed breath-laugh events to PATH "
                        "for listening audits (reference "
                        "analyse.py:420-428); no preds_dir needed")
    p.add_argument("--out_dir", type=str, default=".",
                   help="output dir for --meeting_csvs exports")
    return p


def print_report(stats: Sequence) -> None:
    """The sum-stats table, then the best F1 and the AP of each min_len."""
    from laughter_detection_icsi_tpu_torch.eval.analyse import (
        SumStats, average_precision, format_rows)

    print(format_rows(stats, SumStats._fields))
    scored = [r for r in stats if not math.isnan(r.f1)]
    if scored:
        # The first row of the highest F1, as DataFrame.idxmax picks it.
        best = max(scored, key=lambda r: r.f1)
        print(f"best F1 = {best.f1:.4f} at threshold={best.threshold} "
              f"min_len={best.min_len}")
    for ml in sorted({r.min_len for r in stats}):
        print(f"AP(min_len={ml}) = {average_precision(stats, ml):.4f}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    from laughter_detection_icsi_tpu_torch.config import ANALYSIS, load_env
    from laughter_detection_icsi_tpu_torch.eval import analyse as an
    from laughter_detection_icsi_tpu_torch.eval import transcript as transcript_lib

    if args.transcript_dir is None:
        # The .env / TRANSCRIPT_DIR convention, before the library's
        # repo-local default.
        load_env(args.env_file)
        args.transcript_dir = os.environ.get("TRANSCRIPT_DIR")
    if args.laugh_counts:
        tdir = args.transcript_dir or ANALYSIS.transcript_dir
        if not os.path.isdir(tdir):
            parser.error(f"transcript dir not found: {tdir}")
        counts = transcript_lib.count_laugh_segments(tdir)
        if not counts:
            parser.error(f"no .mrt transcripts under {tdir}")
        for meeting, (n_all, n_only) in counts.items():
            print(f"{meeting}: all={n_all} laugh_only={n_only}")
        print(f"total: all={sum(a for a, _ in counts.values())} "
              f"laugh_only={sum(o for _, o in counts.values())}")
        return 0
    if args.breath_laugh_csv is not None:
        store = transcript_lib.load(args.transcript_dir)
        n = an.laugh_df_to_csv(store.laugh_only, args.breath_laugh_csv)
        print(f"wrote {n} breath-laugh rows to {args.breath_laugh_csv}")
        if args.preds_dir is None and args.meeting_csvs is None:
            return 0
    if args.preds_dir is None:
        parser.error("preds_dir is required unless --laugh_counts/--breath_laugh_csv")
    if args.meeting_csvs is not None:
        store = transcript_lib.load(args.transcript_dir)
        transc_path, preds_path = an.create_csvs_for_meeting(
            args.meeting_csvs, args.preds_dir, store, out_dir=args.out_dir
        )
        print(f"wrote {transc_path} and {preds_path}")
        return 0
    if args.min_length_sweep is not None:
        if args.min_length_sweep.strip().lower() == "default":
            lengths = None
        else:
            try:
                lengths = [float(s) for s in args.min_length_sweep.split(",")]
            except ValueError:
                parser.error(
                    f"--min_length_sweep must be a comma list of floats or "
                    f"'default' (got {args.min_length_sweep!r})"
                )
        store = transcript_lib.load(args.transcript_dir)
        preds_path = Path(args.preds_dir)
        out = preds_path.parent / f"{preds_path.name}_sum_stats_for_different_min_lengths.csv"
        rows = an.stats_for_different_min_lengths(
            args.preds_dir, store, min_lengths=lengths, out_path=str(out), verbose=True,
        )
        print(an.format_rows(rows, an.MinLengthStats._fields))
        print(f"wrote {out}")
        return 0
    print_report(an.analyse(args.preds_dir, transcript_dir=args.transcript_dir,
                            force=args.force))
    return 0


if __name__ == "__main__":
    sys.exit(main())
