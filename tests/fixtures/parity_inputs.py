"""The inputs of the parity drill (``cli/parity.py`` and its port), made
from numpy seeds: the synthetic transcripts (``tests/fixtures/mrt.py``),
Btr001's two channels as 2.5 s of 16 kHz int16 WAV under
``<root>/audio/Btr001/chanN.wav``, and a full-width ``resnet_base``
checkpoint (``<root>/ckpt/last.ckpt.npz``, the JAX package's native
layout, written by the port's checkpoint writer; both packages read it).

``tests/fixtures/parity_goldens/`` holds what the JAX package's parity CLI
writes from these inputs on the CPU; regenerate it with

    env JAX_PLATFORMS=cpu python -m tests.fixtures.parity_inputs build/parity_inputs
    env JAX_PLATFORMS=cpu python cli/parity.py --write_goldens \\
        --goldens tests/fixtures/parity_goldens \\
        --audio_dir build/parity_inputs/audio \\
        --transcript_dir build/parity_inputs/transcripts \\
        --model_path build/parity_inputs/ckpt/last.ckpt.npz \\
        --chunk 512 --bucket_frames 1024 --train_steps 4

The module imports neither JAX nor pandas: ``chip_smoke.py`` writes the
same inputs on the card's machine and checks the port against the
committed goldens.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Iterable

import numpy as np

from .mrt import write_synthetic_corpus

MEETING = "Btr001"
CHANNELS = ("chan0", "chan1")
SECONDS = 2.5
SAMPLE_RATE = 16000
#: The weights' seed and the scale of the last linear layer, chosen so that
#: the TextGrid at (0.5, 0.2) holds intervals and no probability sits
#: within MARGIN of a threshold of the goldens' grid.
WEIGHT_SEED = 1
HEAD_GAIN = 0.3
AUDIO_SEED = 108
#: The thresholds of the manifest ``--write_goldens`` writes.
GRID_THRESHOLDS = (0.2, 0.5)
#: ``cli/parity.py`` compares instance counts exactly, so a probability
#: this close to a threshold could flip an instance between two runs that
#: agree within the probability tolerance.
MARGIN = 1e-4
PARITY_ARGS = ("--chunk", "512", "--bucket_frames", "1024", "--train_steps", "4")


@dataclasses.dataclass(frozen=True)
class ParityInputs:
    root: Path
    transcript_dir: Path
    audio_dir: Path
    ckpt: Path

    def argv(self, goldens) -> list:
        """The parity CLI's flags for these inputs and ``goldens``."""
        return ["--goldens", str(goldens), "--audio_dir", str(self.audio_dir),
                "--transcript_dir", str(self.transcript_dir),
                "--model_path", str(self.ckpt), *PARITY_ARGS]


def channel_pcm(index: int) -> np.ndarray:
    """SECONDS of int16 noise under a slow envelope, so the frames (and the
    probabilities) differ along the track."""
    r = np.random.default_rng(AUDIO_SEED + index)
    t = np.arange(int(SAMPLE_RATE * SECONDS)) / SAMPLE_RATE
    env = 0.05 + 0.6 * np.sin(2 * np.pi * (0.3 + 0.1 * index) * t + index) ** 2
    w = 0.3 * r.standard_normal(len(t)) * env
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


def write_parity_inputs(root) -> ParityInputs:
    """Transcripts, audio and checkpoint under ``root``."""
    # The weights are chip_smoke.py's recipe (the repository root is on the
    # path wherever this module is imported).
    from chip_smoke import seeded_state_dict
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.train import checkpoint

    root = Path(root)
    corpus = write_synthetic_corpus(root)
    audio_dir = root / "audio"
    (audio_dir / MEETING).mkdir(parents=True, exist_ok=True)
    for i, chan in enumerate(CHANNELS):
        audio.write_wav(str(audio_dir / MEETING / f"{chan}.wav"), channel_pcm(i), SAMPLE_RATE)
    preset = MODEL_MAP["resnet_base"]
    model = zoo.build(preset.model, dropout_rate=0.0,
                      linear_layer_size=preset.linear_layer_size,
                      filter_sizes=preset.filter_sizes)
    weights = seeded_state_dict(model, seed=WEIGHT_SEED, head_gain=HEAD_GAIN)
    ckpt = checkpoint.save_checkpoint(str(root / "ckpt"), weights)
    return ParityInputs(root, corpus.transcript_dir, audio_dir, Path(ckpt))


def threshold_margin(probs: Iterable[np.ndarray]) -> float:
    """The least distance of a probability to a threshold of the grid."""
    return min(float(np.min(np.abs(np.asarray(p, np.float64)[:, None] - GRID_THRESHOLDS)))
               for p in probs)


def check_margin(probs: Iterable[np.ndarray]) -> float:
    """``threshold_margin``, which must exceed MARGIN."""
    margin = threshold_margin(probs)
    if margin <= MARGIN:
        raise AssertionError(
            f"a probability lies {margin:.3e} from a threshold of {GRID_THRESHOLDS} "
            f"(<= {MARGIN}): the instance counts could differ between two runs")
    return margin


if __name__ == "__main__":
    made = write_parity_inputs(sys.argv[1])
    print(f"parity inputs under {made.root}: audio {made.audio_dir}, checkpoint {made.ckpt}")
