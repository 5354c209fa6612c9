"""Typed configuration the PyTorch port needs: model presets and the Kaldi
fbank knobs.

A copy of the JAX package's ``config.py`` (``ModelPreset``, ``MODEL_MAP``,
``FeatConfig``, ``FEAT``, ``parse_float_list``) with the same preset names
and values, so both packages build the same networks and features from the
same flags.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    """One entry of the reference's MODEL_MAP (reference config.py:9-26)."""

    name: str
    model: str  # model-zoo architecture name, resolved by models.build()
    batch_size: int
    linear_layer_size: int
    # Tuple, not List: frozen=True blocks rebinding but not in-place
    # mutation of the shared module-global presets.
    filter_sizes: Tuple[int, ...]
    log_frequency: int
    val_data_text_path: str = "./data/switchboard/val/switchboard_val_data.txt"


MODEL_MAP: Dict[str, ModelPreset] = {
    "resnet_base": ModelPreset(
        name="resnet_base",
        model="ResNetBigger",
        batch_size=32,
        # For (100, 44) log-mel windows: three stride-2 stages + AvgPool(4)
        # leave a (3, 1) map with 16 channels = 48 features.
        linear_layer_size=48,
        filter_sizes=(64, 32, 16, 16),
        log_frequency=900,
    ),
    "resnet_with_augmentation": ModelPreset(
        name="resnet_with_augmentation",
        model="ResNetBigger",
        batch_size=32,
        linear_layer_size=128,
        filter_sizes=(128, 64, 32, 32),
        log_frequency=200,
    ),
}


@dataclasses.dataclass(frozen=True)
class FeatConfig:
    """Log-mel (Fbank) featurizer configuration: 100 frames/s and 44 mel
    bins (reference config.py:28-31), plus the Kaldi fbank semantics the
    reference inherits from Lhotse's ``Fbank`` defaults (ops/fbank.py)."""

    num_samples: int = 100  # output frames per second -> frame_shift = 1/100 s
    num_filters: int = 44
    sampling_rate: int = 16000
    frame_length: float = 0.025  # seconds
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    dither: float = 0.0
    snip_edges: bool = False
    energy_floor: float = 1e-10
    low_freq: float = 20.0
    high_freq: float = -400.0  # negative => offset from Nyquist
    round_to_power_of_two: bool = True

    @property
    def frame_shift(self) -> float:
        return 1.0 / self.num_samples

    @property
    def frame_shift_samples(self) -> int:
        return int(round(self.frame_shift * self.sampling_rate))

    @property
    def frame_length_samples(self) -> int:
        return int(round(self.frame_length * self.sampling_rate))

    @property
    def fft_size(self) -> int:
        n = self.frame_length_samples
        if not self.round_to_power_of_two:
            return n
        fft = 1
        while fft < n:
            fft *= 2
        return fft


FEAT = FeatConfig()


def parse_float_list(text: str, flag: str = "value list") -> List[float]:
    """Comma-separated floats for CLI flags, tolerant of blanks and spaces
    ('0.5,' / '0.2, 0.4').  An all-blank string is a usage error, not an
    empty sweep."""
    out = [float(t) for t in text.split(",") if t.strip()]
    if not out:
        raise ValueError(f"{flag}: no values in {text!r}")
    return out
