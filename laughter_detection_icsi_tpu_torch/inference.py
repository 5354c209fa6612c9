"""End-to-end laughter inference: PCM -> fbank -> windows -> model -> probs.

The port of the JAX package's ``inference.LaughterPipeline`` in its
reference-exact ``windows`` mode.  Per fixed-size bucket of frames:

1. the bucket's slice of the host-padded PCM (Kaldi snip_edges=False
   reflection padding, host_prep.py) is uploaded once — 16-bit sources as
   int16, scaled by 1/32768 on the device;
2. the fbank kernel (ops/fbank_cuda.py) featurizes the bucket plus a
   ``window - 1`` frame halo, so buckets are independent and exact;
   frames at or past the true frame count are zeroed (the reference
   InferenceDataset's zero-pad tail, datasets.py:85-93);
3. one window per frame is classified, chunk by chunk: through the shared
   stem (models/shared_stem.py) for the ResNet family, else as a naive
   window batch;
4. the [T] probabilities stay on the device for the threshold x min-length
   smoothing (ops/smoothing.py); only run tables come back.

The pipeline runs on the device it is given, ``cuda`` by default, and in
float32 with TF32 off (``strict_fp32``).  Features of the JAX pipeline that
this port does not carry yet are refused with an error naming the ROADMAP
item that will port them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from laughter_detection_icsi_tpu_torch import host_prep
from laughter_detection_icsi_tpu_torch.config import FEAT, FeatConfig
from laughter_detection_icsi_tpu_torch.data import audio as audio_io
from laughter_detection_icsi_tpu_torch.models import shared_stem
from laughter_detection_icsi_tpu_torch.ops import smoothing, windows
from laughter_detection_icsi_tpu_torch.ops.fbank_cuda import fbank_cuda


def _not_ported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to the PyTorch package yet "
        f"(ROADMAP.md, 'Left to port' item {item})"
    )


@dataclasses.dataclass(frozen=True)
class InferenceSettings:
    window: int = 100  # frames per model input (config.FEAT.num_samples)
    chunk: int = 6144  # windows evaluated per device step
    bucket_frames: int = 6144  # frames per fixed-size bucket (~61 s)
    precision: str = "float32"  # 'bfloat16' is not ported yet
    # Ship 16-bit PCM to the device as int16 and scale by 1/32768 there:
    # identical numbers at half the host->device bytes.
    transfer_int16: bool = True
    transfer_codec: str = "raw"  # 'auto' / 'packed' are not ported yet
    # Shared-stem windows mode (models/shared_stem.py): None = on for the
    # ResNet family; False forces the naive window batch.
    shared_stem: Optional[bool] = None
    mode: str = "windows"  # 'fused_conv' is not ported yet

    def __post_init__(self):
        for name in ("chunk", "bucket_frames", "window"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.mode not in ("windows", "fused_conv"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.transfer_codec not in ("auto", "raw", "packed"):
            raise ValueError(f"unknown transfer_codec {self.transfer_codec!r}")
        if self.mode == "fused_conv":
            raise _not_ported("mode='fused_conv'", 1)
        if self.transfer_codec != "raw":
            raise _not_ported(f"transfer_codec={self.transfer_codec!r}", 4)
        if self.precision == "bfloat16":
            raise _not_ported("precision='bfloat16'", 6)


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means ``cuda``; asking for CUDA without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def settings_from_flags(
    chunk: Optional[int] = None,
    bucket_frames: Optional[int] = None,
    precision: Optional[str] = None,
    device: Union[None, str, torch.device] = None,
    **kwargs,
) -> InferenceSettings:
    """The CLI defaults: chunk and bucket 6144 on the card, 1024 on the CPU;
    float32 everywhere.  ``is not None``, not ``or``: an explicit 0 must
    reach InferenceSettings' validation and fail loudly."""
    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    default = 6144 if on_card else 1024
    return InferenceSettings(
        chunk=chunk if chunk is not None else default,
        bucket_frames=bucket_frames if bucket_frames is not None else default,
        precision=precision if precision is not None else "float32",
        **kwargs,
    )


@contextlib.contextmanager
def strict_fp32():
    """Full float32 for convs and matmuls inside the block, TF32 off: a
    float32 cuDNN convolution runs in TF32 by default, which keeps ~3
    decimal digits.  Restores the previous settings on exit."""
    conv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    prev = (conv.fp32_precision, mm.fp32_precision)
    conv.fp32_precision = mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = prev


def int16_transfer_eligible(meta, settings) -> bool:
    """May this source ship to the device as raw int16 (16-bit PCM or
    decoded shorten)?"""
    return (
        settings.transfer_int16
        and meta.encoding in ("pcm", "shorten")
        and meta.sample_bytes == 2
    )


class LaughterPipeline:
    """Featurize + classify for one model, on one device."""

    def __init__(
        self,
        model: torch.nn.Module,
        feat_cfg: FeatConfig = FEAT,
        settings: InferenceSettings = InferenceSettings(),
        device: Union[None, str, torch.device] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.feat_cfg = feat_cfg
        self.settings = settings
        self.shared_stem = shared_stem.resolve_shared_stem(
            settings.shared_stem, model.name, settings.window
        )
        self.wave_len = host_prep.bucket_wave_len(settings, feat_cfg)

    # ------------------------------------------------------------------ #

    def _bucket_probs(self, buf: np.ndarray, valid: int) -> torch.Tensor:
        """One bucket buffer (``wave_len`` samples, int16 or float32) -> its
        [n_chunks * chunk] probabilities, on the device."""
        s = self.settings
        ext = s.bucket_frames + s.window - 1  # frames featurized (with halo)
        n_chunks = -(-s.bucket_frames // s.chunk)
        # Enough rows that the last window of the last chunk reads in bounds.
        feat_rows = n_chunks * s.chunk + s.window - 1
        with torch.inference_mode(), strict_fp32():
            wave = torch.from_numpy(buf).to(self.device)
            if wave.dtype == torch.int16:
                wave = wave.float() * (1.0 / 32768.0)
            feats = fbank_cuda(wave, host_prep.snip_cfg(self.feat_cfg))  # [ext, F]
            valid_rows = torch.arange(ext, device=self.device)[:, None] < valid
            feats = torch.where(valid_rows, feats, 0.0)
            feats = F.pad(feats, (0, 0, 0, feat_rows - ext))
            starts = [i * s.chunk for i in range(n_chunks)]
            if not self.shared_stem:
                outs = [
                    self.model(windows.extract_windows(feats, i, s.chunk, s.window)[:, None])
                    for i in starts
                ]
            elif shared_stem.supports_track2(s.window):
                track1 = shared_stem.stem_track(self.model, feats)
                track2 = shared_stem.stem_track2(self.model, track1)
                outs = [
                    shared_stem.chunk_probs_from_track2(
                        self.model, track1, track2, feats, i, s.chunk, s.window
                    )
                    for i in starts
                ]
            else:
                track1 = shared_stem.stem_track(self.model, feats)
                outs = [
                    shared_stem.chunk_probs_from_track(
                        self.model, track1, feats, i, s.chunk, s.window
                    )
                    for i in starts
                ]
            return torch.cat(outs)

    def bucket_buffers(self, padded: np.ndarray, t: int):
        """Yield ``(buf, valid_frames, keep_frames)`` per bucket: the
        fixed-size buffers, valid-frame counts and kept-frame counts the
        offline loop executes."""
        bucket = self.settings.bucket_frames
        shift = self.feat_cfg.frame_shift_samples
        for k in range(-(-t // bucket)):
            lo = k * bucket * shift
            buf = np.zeros(self.wave_len, dtype=padded.dtype)
            src = padded[lo : lo + self.wave_len]
            buf[: len(src)] = src
            valid = min(t - k * bucket, bucket + self.settings.window - 1)
            yield buf, valid, min(bucket, t - k * bucket)

    def probs_for_waveform(self, wave: np.ndarray) -> np.ndarray:
        """[n] waveform -> [T] laughter probabilities (one per 10 ms frame).
        Accepts float32/float64 in [-1, 1] or raw int16 PCM."""
        return self.probs_for_waveform_device(wave).cpu().numpy()

    def probs_for_waveform_device(self, wave: np.ndarray) -> torch.Tensor:
        """Like :meth:`probs_for_waveform`, but the probabilities stay on
        the device (for ops/smoothing.instances_from_device_probs)."""
        wave = np.asarray(wave)
        if wave.ndim != 1:
            raise ValueError(
                f"probs_for_waveform wants 1-D PCM, got shape {wave.shape}; "
                "pass one channel"
            )
        if wave.dtype not in (np.int16, np.float32, np.float64):
            # Silently casting e.g. int32 PCM would feed +-30000-range values
            # to a featurizer expecting [-1, 1].
            raise TypeError(
                f"unsupported PCM dtype {wave.dtype}; pass int16 or "
                "float32/float64 in [-1, 1]"
            )
        if wave.dtype != np.int16:
            wave = wave.astype(np.float32)
        padded, t = host_prep.host_pad_waveform(wave, self.feat_cfg)
        if t == 0:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        pieces = [
            self._bucket_probs(buf, valid)[:keep]
            for buf, valid, keep in self.bucket_buffers(padded, t)
        ]
        return torch.cat(pieces)

    def probs_for_file(
        self, audio_path: str, channel: int = 0, keep_on_device: bool = False
    ) -> Tuple[Union[np.ndarray, torch.Tensor], float]:
        """Returns (probs [T], audio_duration_s).  16-bit PCM sources ship
        to the device as raw int16."""
        meta = audio_io.info(audio_path)
        if meta.sample_rate != self.feat_cfg.sampling_rate:
            # 44.1 kHz samples under 16 kHz Kaldi geometry give meaningless
            # probabilities whose timestamps still look right.
            raise ValueError(
                f"{audio_path}: sample rate {meta.sample_rate} != featurizer "
                f"rate {self.feat_cfg.sampling_rate}"
            )
        if int16_transfer_eligible(meta, self.settings):
            wave, _sr = audio_io.read_int16(audio_path, channel=channel, meta=meta)
        else:
            wave, _sr = audio_io.read(audio_path, channel=channel)
        probs = self.probs_for_waveform_device(wave)
        return (probs if keep_on_device else probs.cpu().numpy()), meta.duration

    def segment_file(
        self,
        audio_path: str,
        thresholds: Sequence[float] = (0.5,),
        min_lengths: Sequence[float] = (0.2,),
        channel: int = 0,
    ) -> Tuple[Dict[Tuple[float, float], List[Tuple[float, float]]], float]:
        """The reference load_and_pred (segment_laughter.py:79-122): probs
        -> threshold x min_length sweep -> instance dict.  Returns
        (instances, seconds_taken)."""
        t0 = time.perf_counter()
        probs_dev, duration = self.probs_for_file(
            audio_path, channel=channel, keep_on_device=True
        )
        fps = probs_dev.shape[0] / float(duration) if duration > 0 else 100.0
        instances = smoothing.instances_from_device_probs(
            probs_dev, thresholds=thresholds, min_lengths=min_lengths, fps=fps
        )
        return instances, time.perf_counter() - t0


class StreamingSession:
    """Online inference over one audio stream: not ported yet."""

    def __init__(self, pipeline: LaughterPipeline):
        raise _not_ported("StreamingSession (streaming inference)", 2)


def calc_real_time_factor(
    pipeline: LaughterPipeline, audio_path: str, iterations: int = 3, **kwargs
) -> float:
    """Average (prediction time / audio duration)
    (reference segment_laughter.py:178-197)."""
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    duration = audio_io.get_audio_length(audio_path)
    if duration <= 0.0:
        raise ValueError(
            f"cannot compute a realtime factor for zero-duration audio "
            f"{audio_path!r}"
        )
    total = 0.0
    for _ in range(iterations):
        _, took = pipeline.segment_file(audio_path, **kwargs)
        total += took
    return (total / iterations) / duration
