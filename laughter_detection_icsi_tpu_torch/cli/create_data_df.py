"""Sample-table CLI for the PyTorch port (reference create_data_df.py:209-215).

The JAX package's ``cli/create_data_df.py``: the train/dev/test tables of
laugh and matched non-laugh segments (``data/sampler.py``), written as
``<data_dfs_dir>/<split>_df.csv``.  Flags, or the reference's ``.env``
variables (DATA_DFS_DIR, NUM_OF_LAUGH_SAMPLES, NUM_OF_NON_LAUGH_SAMPLES,
RANDOM_SELECTION).  Host only; run it as

    python -m laughter_detection_icsi_tpu_torch.cli.create_data_df \\
        --transcript_dir data/icsi/transcripts --data_dfs_dir data_dfs \\
        --num_laugh_samples 10 --num_non_laugh_samples 10
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_dfs_dir", type=str, default=None)
    p.add_argument("--transcript_dir", type=str, default=None)
    p.add_argument("--num_laugh_samples", type=int, default=None)
    p.add_argument("--num_non_laugh_samples", type=int, default=None)
    p.add_argument("--random_selection", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="--random_selection / --no-random_selection; unset "
                        "falls back to RANDOM_SELECTION in env/.env")
    p.add_argument("--meeting_id", type=str, default=None)
    p.add_argument("--chan_id", type=str, default=None)
    p.add_argument("--noise_from_speech_bug", action="store_true",
                   help="reproduce the reference's noise-sampled-from-speech "
                        "behavior for parity runs")
    p.add_argument("--env_file", type=str, default=".env")
    return p


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        raise SystemExit(f"{name}={raw!r} is not an integer")


def _env_bool(name: str, default: bool) -> bool:
    """Strictly 'true' or 'false' (any case): '1' or 'yes' must not
    silently mean False."""
    raw = os.environ.get(name, "")
    if not raw.strip():
        return default
    low = raw.strip().lower()
    if low not in ("true", "false"):
        raise SystemExit(f"{name}={raw!r} must be 'True' or 'False'")
    return low == "true"


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from laughter_detection_icsi_tpu_torch.config import load_env
    from laughter_detection_icsi_tpu_torch.data.sampler import DataFrameSampler, write_data_dfs
    from laughter_detection_icsi_tpu_torch.eval import indices as indices_lib
    from laughter_detection_icsi_tpu_torch.eval import transcript as transcript_lib

    load_env(args.env_file)
    data_dfs_dir = args.data_dfs_dir or os.environ.get("DATA_DFS_DIR")
    if not data_dfs_dir:
        raise SystemExit("need --data_dfs_dir (or DATA_DFS_DIR in env/.env)")
    # `is None`, not `or`: an explicit 0 is a legal request.
    n_laugh = (args.num_laugh_samples if args.num_laugh_samples is not None
               else _env_int("NUM_OF_LAUGH_SAMPLES", 1))
    n_non = (args.num_non_laugh_samples if args.num_non_laugh_samples is not None
             else _env_int("NUM_OF_NON_LAUGH_SAMPLES", 1))
    random_sel = (args.random_selection if args.random_selection is not None
                  else _env_bool("RANDOM_SELECTION", False))

    store = transcript_lib.load(args.transcript_dir)
    idx = indices_lib.load(store)
    sampler = DataFrameSampler(store, idx, noise_from_speech_bug=args.noise_from_speech_bug)
    dfs = sampler.create_data_dfs(
        num_laugh_samples=n_laugh,
        num_non_laugh_samples=n_non,
        meeting_id=args.meeting_id,
        chan_id=args.chan_id,
        random=random_sel,
    )
    write_data_dfs(dfs, data_dfs_dir)
    for split, rows in dfs.items():
        print(f"{split}: {len(rows)} rows -> {data_dfs_dir}/{split}_df.csv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
