"""Corpus featurization CLI for the PyTorch port (reference
compute_features.py:266-294).

The JAX package's ``cli/compute_features.py`` plus ``--device`` (default
``cuda``): log-mel features of every (meeting, channel) track the
transcripts know, for the chosen splits, into the feature cache
(``data/feature_cache.py``; on the card one fbank kernel launch per
30,000-frame bucket).  Flags, or the reference's ``.env`` variables
(AUDIO_DIR, TRANSCRIPT_DIR, OUTPUT_DIR / SPLIT_FEAT_DIR).  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.compute_features \\
        --audio_dir data/icsi/speech --transcript_dir data/icsi/transcripts \\
        --output_dir feats --splits train,dev --device cuda

The reference's stage 2 (per-sample manifests) has no step here: the
dataset cuts its samples from the cache (data/dataset.py).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--audio_dir", type=str, default=None,
                   help="root with <meeting>/<chan>.sph (env AUDIO_DIR)")
    p.add_argument("--transcript_dir", type=str, default=None,
                   help="dir with preambles.mrt + <meeting>.mrt (env TRANSCRIPT_DIR)")
    p.add_argument("--output_dir", type=str, default=None,
                   help="feature cache dir (env OUTPUT_DIR / SPLIT_FEAT_DIR)")
    p.add_argument("--splits", type=str, default="train,dev,test",
                   help="comma-separated splits to featurize")
    p.add_argument("--meetings", type=str, default=None,
                   help="comma-separated meeting IDs (default: all in splits)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float16"])
    p.add_argument("--env_file", type=str, default=".env")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to featurize on (default: cuda)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from laughter_detection_icsi_tpu_torch.config import load_env, split_of_meeting
    from laughter_detection_icsi_tpu_torch.data.audio import find_track_audio
    from laughter_detection_icsi_tpu_torch.data.feature_cache import FeatureCache
    from laughter_detection_icsi_tpu_torch.eval import transcript as transcript_lib
    from laughter_detection_icsi_tpu_torch.inference import resolve_device

    device = resolve_device(args.device)
    load_env(args.env_file)
    audio_dir = args.audio_dir or os.environ.get("AUDIO_DIR")
    transcript_dir = args.transcript_dir or os.environ.get("TRANSCRIPT_DIR")
    output_dir = (args.output_dir or os.environ.get("OUTPUT_DIR")
                  or os.environ.get("SPLIT_FEAT_DIR"))
    if not (audio_dir and transcript_dir and output_dir):
        raise SystemExit(
            "need --audio_dir/--transcript_dir/--output_dir (or AUDIO_DIR/"
            "TRANSCRIPT_DIR/OUTPUT_DIR in the environment or .env)")

    # strip(): "train, dev" means train and dev.
    splits = {s.strip() for s in args.splits.split(",") if s.strip()}
    bad = splits - {"train", "dev", "test"}
    if bad:
        # A typo ('val') would featurize nothing and exit 0.
        raise SystemExit(f"unknown splits: {', '.join(sorted(bad))} (use train/dev/test)")
    store = transcript_lib.TranscriptStore(transcript_dir)
    wanted = ({m.strip() for m in args.meetings.split(",") if m.strip()}
              if args.meetings else None)
    if wanted:
        unknown = wanted - set(store.meeting_ids)
        if unknown:
            raise SystemExit(f"unknown meetings: {', '.join(sorted(unknown))} "
                             f"(known: {', '.join(store.meeting_ids)})")
        # A known meeting outside the chosen splits is the same silent no-op.
        if not {m for m in wanted if split_of_meeting(m) in splits}:
            raise SystemExit(f"none of the requested meetings belong to splits "
                             f"{sorted(splits)}; pass --splits all or the right split")
    cache = FeatureCache(output_dir)
    dtype = np.float16 if args.dtype == "float16" else np.float32

    done = skipped = missing = 0
    for row in store.info:
        if split_of_meeting(row.meeting_id) not in splits:
            continue
        if wanted and row.meeting_id not in wanted:
            continue
        # dtype-aware: a float16 rerun over a float32 cache featurizes again.
        if cache.has(row.meeting_id, row.chan_id, dtype=dtype):
            skipped += 1
            continue
        path = find_track_audio(audio_dir, row.meeting_id, row.chan_id)
        if path is None:
            print(f"missing audio: {row.meeting_id}/{row.chan_id}.sph (and .wav)")
            missing += 1
            continue
        print(f"featurizing {row.meeting_id}/{row.chan_id} ...", flush=True)
        cache.add_audio_file(row.meeting_id, row.chan_id, path, dtype=dtype, device=device)
        done += 1
    print(f"done: {done} featurized, {skipped} cached, {missing} missing")
    return 0 if missing == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
