"""Live-serving walkthrough of the PyTorch port: chunked PCM in, laughter
events out (the port's twin of examples/streaming_demo.py).

Simulates a microphone delivering 250 ms chunks of a synthetic "meeting"
(quiet floor with a couple of loud bursts) and runs the online serving
chain: ``inference.StreamingSession`` (bucket-finalized probabilities,
bit-exact vs the offline pipeline) feeding
``ops.smoothing.StreamingEventDetector`` (events emitted the moment their
run closes).  Full-width ResNetBigger on the card, a narrow one on the
CPU:

    python examples/streaming_demo_torch.py [--device cuda|cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(device: str = "cuda") -> None:
    import torch

    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda
    from laughter_detection_icsi_tpu_torch.ops.smoothing import StreamingEventDetector

    on_accel = torch.device(device).type != "cpu"
    model = zoo.build(
        "ResNetBigger",
        dropout_rate=0.0,
        linear_layer_size=48 if on_accel else 24,
        filter_sizes=(64, 32, 16, 16) if on_accel else (8, 8, 8, 8),
        seed=0,
    )
    pipe = inference.LaughterPipeline(
        model,
        settings=inference.InferenceSettings(
            chunk=1024, bucket_frames=1024  # ~10 s latency budget
        ),
        device=device,
    )
    session = inference.StreamingSession(pipe)
    detector = StreamingEventDetector(threshold=0.4, min_length=0.2, fps=100.0)

    # A synthetic 45 s "meeting": mic floor + two loud bursts.
    rng = np.random.default_rng(23)
    sr = 16000
    wave = (rng.standard_normal(sr * 45) * 0.02).astype(np.float32)
    for lo_s, hi_s in ((12.0, 14.5), (30.0, 31.0)):
        wave[int(lo_s * sr):int(hi_s * sr)] += (
            rng.standard_normal(int((hi_s - lo_s) * sr)) * 0.4
        ).astype(np.float32)

    print(f"== streaming 250 ms chunks on {device} (random-init weights: events "
          "are plumbing illustration, not detection quality) ...")
    launches = fbank_cuda.launches
    t0 = time.perf_counter()
    chunk = sr // 4
    frames_out = 0
    streamed = []
    for lo in range(0, len(wave), chunk):
        probs = session.feed(wave[lo:lo + chunk])
        streamed.append(np.asarray(probs))
        frames_out += len(probs)
        for s, e in detector.feed(probs):
            now = (lo + chunk) / sr
            print(f"  t={now:5.1f}s  event closed: {s:.2f}-{e:.2f}s "
                  f"(latency {now - e:.1f}s)")
    tail = session.finish()
    streamed.append(np.asarray(tail))
    frames_out += len(tail)
    for s, e in detector.feed(tail):
        print(f"  finish: event {s:.2f}-{e:.2f}s")
    for s, e in detector.finish():
        print(f"  finish: open event closed {s:.2f}-{e:.2f}s")
    took = time.perf_counter() - t0
    print(f"== {frames_out} frames emitted for {len(wave)/sr:.0f}s of audio "
          f"in {took:.1f}s ({len(wave)/sr/took:.1f}x realtime, "
          f"latency budget ~{pipe.settings.bucket_frames/100:.0f}s; "
          f"{fbank_cuda.launches - launches} fbank kernel launches)")

    # Streaming == offline, by value: an explicit check, not an assert
    # (``python -O`` compiles asserts away).
    offline = np.asarray(pipe.probs_for_waveform(wave))
    got = np.concatenate(streamed) if streamed else np.zeros(0, np.float32)
    if got.shape != offline.shape or not np.array_equal(got, offline):
        raise RuntimeError(
            f"streaming output diverged from offline: shapes {got.shape} vs "
            f"{offline.shape}, max diff "
            f"{np.max(np.abs(got - offline)) if got.shape == offline.shape else 'n/a'}"
        )
    print("== streaming probabilities are bit-identical to the offline pipeline")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    main(p.parse_args().device)
