"""PyTorch + CUDA port of the laughter-detection system, for NVIDIA Hopper.

A second package beside the JAX one (``laughter_detection_icsi_tpu``),
which stays the reference it is tested against.  It imports neither JAX
nor the JAX package.  The module paths mirror the JAX package's:

- ``config`` / ``host_prep`` — presets, Kaldi framing geometry;
- ``data``   — SPHERE/WAV decode (incl. embedded shorten);
- ``ops``    — the fbank featurizer (hand-written CUDA kernel + its plain
               PyTorch version), window extraction, smoothing;
- ``models`` — the model zoo as ``nn.Module``s, shared-stem inference;
- ``train``  — checkpoint loading (native ``*.ckpt.npz`` and ``.pth.tar``);
- ``eval``   — TextGrid IO;
- ``inference`` / ``cli`` — the offline ``windows`` pipeline and its CLI.

Entry points run on ``cuda`` unless the caller passes another device.
"""
