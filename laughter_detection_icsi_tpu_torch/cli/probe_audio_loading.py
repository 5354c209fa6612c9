"""Audio decode timing probe for the PyTorch port (reference
misc_scripts/check_librosa_loading_times.py:6-31): the decode's
real-time factor at several offsets, through what the pipeline runs (the
native decoder, ``runtime/native.py``, where it builds).

The JAX package's ``cli/probe_audio_loading.py`` with the same flags; it
says which decoder it timed.  Host code only.  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.probe_audio_loading \\
        meeting/chan0.sph --duration 5 --offsets 0,60,600,1800
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("audio_file", type=str)
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--offsets", type=str, default="0,60,600,1800")
    p.add_argument("--channel", type=int, default=0)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.runtime import native

    meta = audio.info(args.audio_file)
    # Time what the pipeline runs: the native decoder when it builds (the
    # numpy codec it falls back to is an order of magnitude slower).
    print(f"{args.audio_file}: {meta.duration:.1f}s @ {meta.sample_rate} Hz "
          f"({meta.container}/{meta.encoding}; "
          f"decoder {'native' if native.available() else 'python'})")
    for off in (float(o) for o in args.offsets.split(",")):
        if off >= meta.duration:
            # Said, not dropped: a short file would otherwise print fewer
            # rows than offsets asked for.
            print(f"offset {off:7.1f}s: skipped (past end of file)")
            continue
        t0 = time.perf_counter()
        wav, _ = native.read(
            args.audio_file, offset=off, duration=args.duration, channel=args.channel
        )
        dt = time.perf_counter() - t0
        rtf = dt / max(len(wav) / meta.sample_rate, 1e-9)
        print(f"offset {off:7.1f}s: {dt * 1e3:7.2f} ms for "
              f"{len(wav) / meta.sample_rate:.2f}s audio (RTF {rtf:.5f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
