"""Typed configuration the PyTorch port needs: model presets, the Kaldi
fbank knobs, the evaluation settings and the ICSI partitions.

A copy of the JAX package's ``config.py`` (``ModelPreset``, ``MODEL_MAP``,
``FeatConfig``, ``FEAT``, ``AnalysisConfig``, ``ANALYSIS``, ``load_env``,
``env``, ``parse_float_list``, ``PARTITIONS``, ``split_of_meeting``) with
the same names and values, so both packages build the same networks and
features and score the same splits from the same flags.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple


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


#: The Audio Spectrogram Transformer's features (its ``src/dataloader.py``
#: ``torchaudio.compliance.kaldi.fbank`` call at AudioSet's settings): 128
#: mel bins from 20 Hz to Nyquist, a Hann window, frames that fit inside
#: the audio (``snip_edges``), the log floored at float32's eps, no energy.
AST_FEAT = FeatConfig(num_filters=128, window_type="hanning", snip_edges=True,
                      energy_floor=1.1920928955078125e-07, low_freq=20.0, high_freq=0.0)

#: AST's AudioSet normalisation of the log-mel: ``(x - mean) / (2 * std)``.
AST_NORM_MEAN = -4.2677393
AST_NORM_STD = 4.5689974


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
    # The port's own: the features the preset classifies and the
    # inference mode that runs it (``InferenceSettings.mode``).
    feat: FeatConfig = FEAT
    mode: str = "windows"


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
    # The port's own, with no JAX twin: the published AudioSet AST
    # (models/ast.py) over 10.24 s clips, laughter its class 16.
    "ast_audioset": ModelPreset(
        name="ast_audioset",
        model="AST",
        batch_size=12,
        linear_layer_size=768,
        filter_sizes=(),
        log_frequency=900,
        feat=AST_FEAT,
        mode="clips",
    ),
}




# The checkout's root: the corpus layout defaults below sit under it.
_ROOT = Path(__file__).absolute().parent.parent


@dataclasses.dataclass
class AnalysisConfig:
    """Mirror of the reference's ANALYSIS dict (reference config.py:33-63)."""

    transcript_dir: str = str(_ROOT / "data/icsi/transcripts")
    speech_dir: str = str(_ROOT / "data/icsi/speech")
    plots_dir: str = "plots"
    eval_df_cache_file: str = "eval_df_per_meeting.csv"
    sum_stats_cache_file: str = "sum_stats.csv"
    force_index_recompute: bool = False

    # 'model' sub-dict (reference config.py:47-54)
    min_length: float = 0.2  # seconds; shorter laughs are invalid
    frame_duration_ms: int = 1  # evaluation frame resolution

    # 'train' sub-dict (reference config.py:56-63)
    subsample_duration: float = 1.0  # seconds per training sample
    random_seed: int = 23
    float_decimals: int = 2
    train_val_test_split: List[float] = dataclasses.field(
        default_factory=lambda: [0.8, 0.1]
    )

    @property
    def frames_per_second(self) -> float:
        return 1000.0 / self.frame_duration_ms


ANALYSIS = AnalysisConfig()


def load_env(env_file: str = ".env", override: bool = False) -> Dict[str, str]:
    """Parse a ``KEY=VALUE`` env file into os.environ (reference sample.env:1-7).

    Lines starting with '#' and blank lines are ignored; ``export`` prefixes
    are stripped and values may be quoted (with or without a trailing inline
    comment), the python-dotenv syntax the reference used.  Returns the
    parsed mapping.  Only the named path is read (relative to the CWD): a
    missing DEFAULT file is tolerated ({}), a missing named file raises.
    Unlike the JAX package's copy (dotenv's find_dotenv), this does not walk
    up from the CWD: a same-named file in a parent directory belongs to
    another tree and would silently redirect e.g. TRANSCRIPT_DIR.
    """
    parsed: Dict[str, str] = {}
    path = Path(env_file)
    if not path.is_file():
        if env_file != ".env":
            raise FileNotFoundError(f"env file {env_file!r} not found")
        return parsed
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        if line.startswith("export ") or line.startswith("export\t"):
            line = line[len("export") :].strip()
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if not key:
            # '=value': python-dotenv skips these; os.environ[''] raises.
            continue
        m = re.match(r"""(['"])(.*?)\1\s*(?:#.*)?$""", value)
        if m:
            # Quoted, optionally followed by an inline comment: the content
            # is kept verbatim (a '#' inside the quotes is data).
            value = m.group(2)
        else:
            # Unquoted: strip an inline comment (a whitespace-preceded '#').
            m = re.search(r"\s#", value)
            if m:
                value = value[: m.start()].rstrip()
            if value.startswith("#"):
                value = ""
        parsed[key] = value
        if override or key not in os.environ:
            os.environ[key] = value
    return parsed


def env(key: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(key, default)


def parse_float_list(text: str, flag: str = "value list") -> List[float]:
    """Comma-separated floats for CLI flags, tolerant of blanks and spaces
    ('0.5,' / '0.2, 0.4').  An all-blank string is a usage error, not an
    empty sweep."""
    out = [float(t) for t in text.split(",") if t.strip()]
    if not out:
        raise ValueError(f"{flag}: no values in {text!r}")
    return out


# ICSI partitions (reference create_data_df.py:15-29, taken from the Lhotse
# ICSI recipe to minimise speaker overlap between splits).
PARTITIONS: Dict[str, List[str]] = {
    "train": [
        "Bdb001", "Bed002", "Bed003", "Bed004", "Bed005", "Bed006", "Bed008",
        "Bed009", "Bed010", "Bed011", "Bed012", "Bed013", "Bed014", "Bed015",
        "Bed016", "Bed017", "Bmr001", "Bmr002", "Bmr003", "Bmr005", "Bmr006",
        "Bmr007", "Bmr008", "Bmr009", "Bmr010", "Bmr011", "Bmr012", "Bmr014",
        "Bmr015", "Bmr016", "Bmr019", "Bmr020", "Bmr022", "Bmr023", "Bmr024",
        "Bmr025", "Bmr026", "Bmr027", "Bmr028", "Bmr029", "Bmr030", "Bmr031",
        "Bns002", "Bns003", "Bro003", "Bro004", "Bro005", "Bro007", "Bro008",
        "Bro010", "Bro011", "Bro012", "Bro013", "Bro014", "Bro015", "Bro016",
        "Bro017", "Bro018", "Bro019", "Bro022", "Bro023", "Bro024", "Bro025",
        "Bro026", "Bro027", "Bro028", "Bsr001", "Btr001", "Btr002", "Buw001",
    ],
    "dev": ["Bmr021", "Bns001"],
    "test": ["Bmr013", "Bmr018", "Bro021"],
}


def split_of_meeting(meeting_id: str) -> str:
    if meeting_id in PARTITIONS["dev"]:
        return "dev"
    if meeting_id in PARTITIONS["test"]:
        return "test"
    return "train"
