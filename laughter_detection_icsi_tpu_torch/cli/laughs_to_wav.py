"""Cut predicted laughs to wav files for manual listening, for the PyTorch
port (reference analysis/output_processing/laughs_to_wav.py +
concat_laughs.sh).

The JAX package's ``cli/laughs_to_wav.py`` with the same flags, on the
port's SPHERE/WAV codec (``data/audio.py``): one WAV a laugh, and with
``--concat`` all of them in one file with a short silence between two.
Host code only.  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.laughs_to_wav \\
        --textgrid out/chan0.TextGrid --audio_file chan0.sph \\
        --output_dir laughs --concat
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--textgrid", type=str, required=True,
                   help="prediction TextGrid (laughter tier)")
    p.add_argument("--audio_file", type=str, required=True,
                   help="source .sph/.wav the predictions refer to")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--channel", type=int, default=0)
    p.add_argument("--concat", action="store_true",
                   help="also write all_laughs.wav with break delimiters")
    p.add_argument("--break_s", type=float, default=0.5,
                   help="silence between laughs in the concatenated file")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.eval import textgrid as tg

    intervals = tg.read_laughter_intervals(args.textgrid)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    sr = audio.info(args.audio_file).sample_rate
    pieces = []
    for i, (start, end) in enumerate(intervals):
        wav, _ = audio.read(
            args.audio_file, offset=start, duration=end - start, channel=args.channel
        )
        path = out / f"laugh_{i}_{start:.2f}-{end:.2f}.wav"
        audio.write_wav(str(path), wav, sr)
        if args.concat:  # only the concatenation needs the pieces again
            pieces.append(wav)
        print(f"{start:.2f}-{end:.2f}s -> {path}")
    if args.concat and pieces:
        gap = np.zeros(int(args.break_s * sr), dtype=np.float32)
        chunks: List[np.ndarray] = []
        for i, w in enumerate(pieces):
            if i:
                chunks.append(gap)
            chunks.append(w)
        audio.write_wav(str(out / "all_laughs.wav"), np.concatenate(chunks), sr)
        print(f"concatenated {len(pieces)} laughs -> {out / 'all_laughs.wav'}")
    if not intervals:
        print("no laughs in the TextGrid")
    return 0


if __name__ == "__main__":
    sys.exit(main())
