"""PyTorch + CUDA port of the laughter-detection system, for NVIDIA Hopper.

A second package beside the JAX one (``laughter_detection_icsi_tpu``),
which stays the reference it is tested against.  It imports neither JAX
nor the JAX package.  The module paths mirror the JAX package's:

- ``config`` / ``host_prep`` — presets, Kaldi framing geometry;
- ``data``   — SPHERE/WAV decode (incl. embedded shorten);
- ``ops``    — the fbank featurizer (hand-written CUDA kernel + its plain
               PyTorch version), window extraction, smoothing, the
               packed-PCM wire codec;
- ``models`` — the model zoo as ``nn.Module``s, shared-stem inference;
- ``train``  — checkpoint loading (native ``*.ckpt.npz`` and ``.pth.tar``);
- ``eval``   — TextGrid IO, transcripts, interval indices, the evaluator;
- ``parallel`` — a meeting's channels as one batch on one device;
- ``utils``  — torch.profiler traces, throughput counters;
- ``inference`` / ``cli`` — the pipelines and the segment, serve, sweep
  and analyse CLIs.

Entry points run on ``cuda`` unless the caller passes another device.
"""
