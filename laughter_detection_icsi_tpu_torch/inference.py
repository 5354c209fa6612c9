"""End-to-end laughter inference: PCM -> fbank -> windows -> model -> probs.

The port of the JAX package's ``inference.LaughterPipeline`` and its
streaming sessions.  In the reference-exact ``windows`` mode, per
fixed-size bucket of frames:

1. the bucket's slice of the host-padded PCM (Kaldi snip_edges=False
   reflection padding, host_prep.py) is uploaded once — 16-bit sources as
   int16, scaled by 1/32768 on the device; with ``transfer_codec`` 'packed'
   or 'auto' as one bit-packed wire (ops/pcm_pack.py), decoded on the
   device to the same int16 values;
2. the fbank kernel (ops/fbank_cuda.py) featurizes the bucket plus a
   ``window - 1`` frame halo, so buckets are independent and exact;
   frames at or past the true frame count are zeroed (the reference
   InferenceDataset's zero-pad tail, datasets.py:85-93);
3. one window per frame is classified, chunk by chunk: through the shared
   stem (models/shared_stem.py) for the ResNet family, else as a naive
   window batch;
4. the [T] probabilities stay on the device for the threshold x min-length
   smoothing (ops/smoothing.py); only run tables come back.

``mode='fused_conv'`` featurizes the whole track in one launch and runs
the dilated conv stack once over it (models/fully_conv.py).
``mode='clips'`` runs an AudioSet tagger, the Audio Spectrogram
Transformer (``models/ast.py``, the ``ast_audioset`` preset), through the
same bucket loop: each bucket's 128-bin features are cut into
``clip_frames`` clips at a hop of ``hop_frames``, each centred on its block
of output frames, and every frame of a block gets the laughter class's
probability of its clip (``classify_clips``).
``StreamingSession`` feeds live PCM through the same bucket body, so its
probabilities equal the offline ones bit for bit.

The pipeline runs on the device it is given, ``cuda`` by default.  The
featurizer runs in float32 with TF32 off (``strict_fp32``).  The classifier
runs in float32 too, or, with ``precision='bfloat16'`` (the CLI default on
the card, as JAX's on an accelerator), on a bfloat16 copy of the model:
the masked features are cast once at the model boundary, everything inside
runs in bf16 and the probabilities come back as float32
(``precision_scope`` keeps cuBLAS's bf16 reductions in float32, as XLA's).
A ResNet-family bf16 copy on the card holds channels-last conv weights, so
its windows-mode classify step runs on NHWC activations, the layout of
cuDNN's bf16 convs there (``channels_last_classify``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from laughter_detection_icsi_tpu_torch import host_prep
from laughter_detection_icsi_tpu_torch.config import AST_NORM_MEAN, AST_NORM_STD, FEAT, FeatConfig
from laughter_detection_icsi_tpu_torch.data import audio as audio_io
from laughter_detection_icsi_tpu_torch.models import fully_conv, shared_stem, zoo
from laughter_detection_icsi_tpu_torch.models.ast import LAUGHTER_CLASS
from laughter_detection_icsi_tpu_torch.ops import pcm_pack, smoothing, windows
from laughter_detection_icsi_tpu_torch.ops.fbank_cuda import fbank_cuda
from laughter_detection_icsi_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class InferenceSettings:
    window: int = 100  # frames per model input (config.FEAT.num_samples)
    chunk: int = 6144  # windows evaluated per device step
    bucket_frames: int = 6144  # frames per fixed-size bucket (~61 s)
    precision: str = "float32"  # 'bfloat16': settings_from_flags' default on the card
    # Ship 16-bit PCM to the device as int16 and scale by 1/32768 there:
    # identical numbers at half the host->device bytes.
    transfer_int16: bool = True
    # Host->device PCM in windows mode: 'raw' uploads the buffer; 'packed'
    # uploads int16 buffers as one bit-packed wire (ops/pcm_pack.py),
    # decoded on the device; 'auto' packs only when that saves >= 10%.
    transfer_codec: str = "raw"
    # Shared-stem windows mode (models/shared_stem.py): None = on for the
    # ResNet family; False forces the naive window batch.
    shared_stem: Optional[bool] = None
    # 'windows' = reference-exact per-window conv; 'fused_conv' = the conv
    # stack once over the whole track (models/fully_conv.py), not
    # checkpoint parity; 'clips' = a clip tagger (AST) over clips of
    # ``clip_frames`` centred on blocks of ``hop_frames`` output frames,
    # ``clip_batch`` clips a model call (``classify_clips``).
    mode: str = "windows"
    clip_frames: int = 1024
    hop_frames: int = 100
    clip_batch: int = 60  # one bucket row at the card's clips bucket of 6,000 frames

    def __post_init__(self):
        for name in ("chunk", "bucket_frames", "window", "clip_frames", "hop_frames",
                     "clip_batch"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.mode not in ("windows", "fused_conv", "clips"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "clips":
            halo = self.clip_frames - self.hop_frames
            if halo <= 0 or halo % 2:
                raise ValueError(
                    f"mode='clips' centres each clip on its block: clip_frames "
                    f"({self.clip_frames}) must exceed hop_frames ({self.hop_frames}) "
                    "by an even count"
                )
            if self.bucket_frames % self.hop_frames:
                raise ValueError(
                    f"mode='clips' needs whole blocks a bucket: bucket_frames "
                    f"({self.bucket_frames}) is not a multiple of hop_frames "
                    f"({self.hop_frames})"
                )
            if self.shared_stem:
                raise ValueError("shared_stem is the ResNet family's; mode='clips' has none")
        if self.transfer_codec not in ("auto", "raw", "packed"):
            raise ValueError(f"unknown transfer_codec {self.transfer_codec!r}")
        if self.transfer_codec == "packed" and self.mode == "fused_conv":
            raise ValueError(
                "transfer_codec='packed' is not implemented for "
                "mode='fused_conv' (the whole-track graph has no packed "
                "decode stage); use 'raw', or the 'windows' mode"
            )


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
    """The CLI defaults: chunk and bucket 6144 on the card, 1024 on the CPU
    (in the clips mode 6000 and 1000: whole blocks of 100 frames);
    bfloat16 on the card and float32 on the CPU, as the JAX package's on an
    accelerator and on the CPU.  ``is not None``, not ``or``: an explicit 0
    must reach InferenceSettings' validation and fail loudly."""
    on_card = torch.device("cuda" if device is None else device).type == "cuda"
    default = 6144 if on_card else 1024
    if kwargs.get("mode") == "clips":
        default = 6000 if on_card else 1000
    return InferenceSettings(
        chunk=chunk if chunk is not None else default,
        bucket_frames=bucket_frames if bucket_frames is not None else default,
        precision=precision if precision is not None else ("bfloat16" if on_card else "float32"),
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


@contextlib.contextmanager
def precision_scope(precision: str = "float32"):
    """``strict_fp32`` for the featurizer and a float32 classifier; for
    ``precision='bfloat16'`` also cuBLAS's reduced-precision bf16
    reductions off, so a bf16 product accumulates in float32 as XLA's does
    (``allow_bf16_reduced_precision_reduction`` is on by default).
    Restores the previous settings on exit."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_bf16_reduced_precision_reduction
    with strict_fp32():
        if precision == "bfloat16":
            mm.allow_bf16_reduced_precision_reduction = False
        try:
            yield
        finally:
            mm.allow_bf16_reduced_precision_reduction = prev


def compute_dtype(precision: str) -> torch.dtype:
    """The classifier's dtype for a ``precision`` setting."""
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


def cast_model_bf16(model: torch.nn.Module) -> torch.nn.Module:
    """A bfloat16 copy of ``model`` (JAX ``cast_tree_bf16``): the floating
    parameters and buffers (BN running statistics included, or the first
    BN would re-promote the activations) are cast, ``num_batches_tracked``
    stays an integer, and the caller's model is left as it was."""
    return copy.deepcopy(model).to(torch.bfloat16)


def channels_last_classify(model: torch.nn.Module, dtype: torch.dtype, device_type: str) -> bool:
    """Whether the windows-mode classify step runs ``model`` on channels-last
    (NHWC) activations: a ResNet-family model in bfloat16 on the card,
    where cuDNN's bf16 convs are NHWC tensor-core kernels that would
    otherwise transpose every conv's input in and its output back out.
    Its float32 convs are NCHW-native, and the CPU's composed chain stays
    NCHW, as the JAX package's comparisons expect."""
    return (dtype == torch.bfloat16 and device_type == "cuda"
            and isinstance(model, zoo.ResNetFamily))


def int16_transfer_eligible(meta, settings) -> bool:
    """May this source ship to the device as raw int16 (16-bit PCM or
    decoded shorten)?"""
    return (
        settings.transfer_int16
        and meta.encoding in ("pcm", "shorten")
        and meta.sample_bytes == 2
    )


def scale_pcm(wave: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 scaled by 1/32768 where it lies; float PCM as
    it is."""
    if wave.dtype == torch.int16:
        wave = wave.float() * (1.0 / 32768.0)
    return wave


def upload_wave(
    buf: Union[np.ndarray, torch.Tensor], device: torch.device, pinned: bool = False
) -> torch.Tensor:
    """One host buffer to the device as float32: int16 ships as int16 and
    is scaled by 1/32768 there (the same numbers as scaling on the host).
    A tensor already on the device is only scaled.  ``pinned``: a host
    buffer bound for a card is staged in page-locked memory and copied
    without blocking, so the host goes on queueing work (a pageable copy
    waits for the device's stream)."""
    t = torch.as_tensor(buf)
    if pinned and device.type == "cuda" and t.device.type == "cpu":
        return scale_pcm(t.pin_memory().to(device, non_blocking=True))
    return scale_pcm(t.to(device))


def upload_packed(
    wires: np.ndarray, n: int, deltas: Sequence[bool], device: torch.device
) -> torch.Tensor:
    """One upload of a [C, wire_len] batch of bit-packed wires
    (``PackedPCM.wire()`` rows, zero-padded alike) of ``n`` samples each,
    decoded on the device row by row, each in its own mode -> float32
    [C, n], scaled by 1/32768 (the numbers ``upload_wave`` gives for the
    same int16 rows)."""
    n_blocks = pcm_pack.block_count(n)
    dev = pcm_pack.widen(pcm_pack.wire_tensor(wires).to(device))
    rows = [
        pcm_pack.unpack_pcm(words, widths, n, delta)
        for (widths, words), delta in zip((pcm_pack.split_wire(r, n_blocks) for r in dev), deltas)
    ]
    return torch.stack(rows).float() * (1.0 / 32768.0)


def codec_wants_pack(buf: np.ndarray, codec: str) -> bool:
    """May ``buf`` go packed under ``codec`` (the JAX package's rules)?
    Only int16 PCM packs; 'packed' on float input warns and uploads raw."""
    if codec == "raw":
        return False
    if buf.dtype != np.int16:
        if codec == "packed":
            warnings.warn(
                "transfer_codec='packed' needs int16 PCM input; this float "
                "waveform uploads raw",
                stacklevel=4,
            )
        return False
    return True


def check_pcm(wave: np.ndarray) -> None:
    """Refuse what is not one channel of int16 or float PCM: silently
    casting e.g. int32 PCM would feed +-30000-range values to a featurizer
    expecting [-1, 1]."""
    if wave.ndim != 1:
        raise ValueError(
            f"want 1-D PCM (one channel), got shape {wave.shape}; use "
            "parallel.sharded_inference.ShardedPipeline for multichannel batches"
        )
    if wave.dtype not in (np.int16, np.float32, np.float64):
        raise TypeError(
            f"unsupported PCM dtype {wave.dtype}; pass int16 or "
            "float32/float64 in [-1, 1]"
        )


def classify_bucket(
    model: torch.nn.Module, feats: torch.Tensor, valid: Union[int, torch.Tensor],
    settings: InferenceSettings, use_shared_stem: bool,
) -> torch.Tensor:
    """One bucket's float32 features ([bucket + window - 1, F], the bucket
    and its halo) -> its [n_chunks * chunk] float32 probabilities.  Frames
    at or past ``valid`` (an int, or a 0-d tensor, which an exported graph
    takes: the mask is one comparison, with no branch on it) are zeroed
    (the reference InferenceDataset's zero-pad tail) and the features cast
    to the settings' compute dtype, then one window per frame is
    classified, ``chunk`` windows at a time: through the shared stem, or as
    a naive window batch.  The classify step of every windows-mode path, a
    multichannel batch's rows included.  Its activations take the layout
    of the model's conv weights: NHWC for channels-last ones (a pipeline's
    bf16 ResNet-family copy on the card), NCHW otherwise.  Its spans:
    ``classify/track`` (the mask, cast, pad and the stem's whole-track
    convs) and one ``classify/chunk`` a chunk (its windows; the last also
    the splice)."""
    s = settings
    n_chunks = -(-s.bucket_frames // s.chunk)
    # Enough rows that the last window of the last chunk reads in bounds.
    feat_rows = n_chunks * s.chunk + s.window - 1
    with annotate("classify/track"):
        valid_rows = torch.arange(feats.shape[0], device=feats.device)[:, None] < valid
        feats = torch.where(valid_rows, feats, 0.0).to(compute_dtype(s.precision))
        feats = F.pad(feats, (0, 0, 0, feat_rows - feats.shape[0]))
        track1 = shared_stem.stem_track(model, feats) if use_shared_stem else None
        track2 = (shared_stem.stem_track2(model, track1)
                  if use_shared_stem and shared_stem.supports_track2(s.window) else None)
    outs = []
    for i in range(0, n_chunks * s.chunk, s.chunk):
        with annotate("classify/chunk"):
            if track1 is None:
                outs.append(model(windows.extract_windows(feats, i, s.chunk, s.window)[:, None]))
            elif track2 is not None:
                outs.append(shared_stem.chunk_probs_from_track2(
                    model, track1, track2, feats, i, s.chunk, s.window))
            else:
                outs.append(shared_stem.chunk_probs_from_track(
                    model, track1, feats, i, s.chunk, s.window))
            if len(outs) == n_chunks:  # the last chunk's span holds the splice
                probs = torch.cat(outs).float()
    return probs


#: What the clips mode classified in this process, counted on the host from
#: the bucket plan (no device read): the clips the model ran, and the frames
#: of those clips that lie outside their track (zero log-mel: the front of
#: a track, its end, a silent padding row).
clips_classified = 0
clip_padded_frames = 0


def _count_clips(bounds: np.ndarray, settings: InferenceSettings) -> None:
    global clips_classified, clip_padded_frames
    s = settings
    starts = np.arange(s.bucket_frames // s.hop_frames) * s.hop_frames
    lo, hi = bounds[:, :1], bounds[:, 1:]
    inside = np.clip(np.minimum(hi, starts + s.clip_frames) - np.maximum(lo, starts), 0, None)
    clips_classified += inside.size
    clip_padded_frames += int(inside.size * s.clip_frames - inside.sum())


def classify_clips(
    model: torch.nn.Module, feats: torch.Tensor, bounds, settings: InferenceSettings,
    sink: Optional[list] = None,
) -> torch.Tensor:
    """The clips mode's classify step over a bucket batch: float32 log-mel
    ([R, bucket + halo, F], each row a bucket buffer from
    ``host_prep.bucket_start``) and each row's [lo, hi) frames inside
    its track (``host_prep.clip_bounds``) -> [R, bucket] float32
    probabilities.  Frames outside [lo, hi) are log-mel 0 (the published
    model's zero padding), the features are normalised as AST's AudioSet
    data are, cast to the compute dtype and cut into the bucket's clips
    (block ``b``'s clip is frames [b * hop, b * hop + clip_frames) of the
    buffer), which go through ``model`` ``clip_batch`` at a time.  Every
    frame of block ``b`` gets ``sigmoid`` of its clip's laughter logit.
    ``sink``, a list, receives each call's [R, blocks, classes] logits.
    Spans: ``classify/clips`` (mask, normalisation, cut, patch embedding,
    tokens and positions), ``classify/encoder`` (the blocks), and
    ``classify/head``."""
    s = settings
    rows, n_blocks = feats.shape[0], s.bucket_frames // s.hop_frames
    bounds = np.asarray(bounds, dtype=np.int64).reshape(rows, 2)
    with annotate("classify/clips"):
        for r, (lo, hi) in enumerate(bounds.tolist()):
            if lo > 0:
                feats[r, :lo] = 0.0
            if hi < feats.shape[1]:
                feats[r, hi:] = 0.0
        x = ((feats - AST_NORM_MEAN) / (2 * AST_NORM_STD)).to(compute_dtype(s.precision))
        # [R, blocks, F, clip] views of overlapping frames, copied once.
        clips = x.unfold(1, s.clip_frames, s.hop_frames).reshape(
            rows * n_blocks, x.shape[2], s.clip_frames)
    _count_clips(bounds, s)
    logits = []
    for i in range(0, rows * n_blocks, s.clip_batch):
        with annotate("classify/clips"):
            tokens = model.embed(clips[i : i + s.clip_batch].transpose(1, 2))
        with annotate("classify/encoder"):
            tokens = model.encode(tokens)
        with annotate("classify/head"):
            logits.append(model.head(tokens))
    with annotate("classify/head"):
        logits = torch.cat(logits).reshape(rows, n_blocks, -1)
        if sink is not None:
            sink.append(logits)
        probs = torch.sigmoid(logits[..., LAUGHTER_CLASS].float())
        return probs.repeat_interleave(s.hop_frames, dim=1)


def track_wave_len(total_frames: int, feat_cfg: FeatConfig = FEAT) -> int:
    """Samples a whole-track (fused_conv) buffer of ``total_frames`` frames
    holds under the snip_edges geometry of the host-padded wave."""
    cfg = host_prep.snip_cfg(feat_cfg)
    return (total_frames - 1) * cfg.frame_shift_samples + cfg.frame_length_samples


def fused_conv_probs(
    model: torch.nn.Module, bufs: Union[np.ndarray, torch.Tensor], valid: Sequence[int],
    feat_cfg: FeatConfig, window: int, device: torch.device,
    precision: str = "float32",
) -> torch.Tensor:
    """mode='fused_conv' over a channel batch: [C, wave_len] whole-track
    buffers (on the host, or already on the device) and each channel's
    frame count -> [C, total] float32
    probabilities on the device.  One fbank launch featurizes the batch;
    frames at or past a channel's count are zeroed and the features cast to
    ``precision``'s dtype (``model`` is in that dtype); the dilated conv
    stack then runs channel by channel, at most ``fully_conv.MAX_BLOCKS`` blocks a dispatch
    (``fully_conv_probs_blocked``), so the live activations are bounded
    whatever the channel count and the track length.  The tail past a
    channel's count holds a bias-leak constant, not 0: callers slice it
    off."""
    with torch.inference_mode(), precision_scope(precision):
        feats = fbank_cuda(upload_wave(bufs, device), host_prep.snip_cfg(feat_cfg))
        rows = torch.arange(feats.shape[1], device=device)
        counts = torch.as_tensor(np.asarray(valid, dtype=np.int64), device=device)
        feats = torch.where((rows[None, :] < counts[:, None])[:, :, None], feats, 0.0)
        feats = feats.to(compute_dtype(precision))
        return torch.stack(
            [fully_conv.fully_conv_probs_blocked(model, f, window) for f in feats]
        ).float()


def check_model_mode(model: torch.nn.Module, feat_cfg: FeatConfig,
                     settings: InferenceSettings) -> None:
    """Refuse a model in a mode that cannot run it: AST only in the clips
    mode, at its clip length and bin count; the window classifiers never
    there."""
    is_ast = getattr(model, "name", None) == "AST"
    if is_ast != (settings.mode == "clips"):
        raise ValueError(
            f"model {getattr(model, 'name', type(model).__name__)!r} cannot run in "
            f"mode={settings.mode!r}: AST runs in mode='clips' (the ast_audioset preset), "
            "the window classifiers in 'windows' or 'fused_conv'"
        )
    if is_ast and (model.tdim, model.fdim) != (settings.clip_frames, feat_cfg.num_filters):
        raise ValueError(
            f"AST takes {model.tdim} x {model.fdim} clips; the settings cut "
            f"{settings.clip_frames} x {feat_cfg.num_filters}"
        )


class LaughterPipeline:
    """Featurize + classify for one model, on one device.  In float32 the
    pipeline moves the caller's model to the device and classifies with it;
    in bfloat16 it classifies with a bf16 copy (``cast_model_bf16``) and
    the caller's model is left as it was; a ResNet-family copy on the card
    gets channels-last conv weights for the windows mode
    (``channels_last_classify``).  In the clips mode,
    ``logit_sink`` (None, or a list) receives each bucket batch's clip
    logits."""

    def __init__(
        self,
        model: torch.nn.Module,
        feat_cfg: FeatConfig = FEAT,
        settings: InferenceSettings = InferenceSettings(),
        device: Union[None, str, torch.device] = None,
    ):
        check_model_mode(model, feat_cfg, settings)
        self.device = resolve_device(device)
        if settings.precision == "bfloat16":
            model = cast_model_bf16(model)
        self.model = model.to(self.device).eval()
        if settings.mode == "windows" and channels_last_classify(
                model, compute_dtype(settings.precision), self.device.type):
            # Channels-last conv weights (the bf16 copy's, once): cuDNN then
            # writes every conv's output NHWC, and the classify step keeps it.
            self.model.to(memory_format=torch.channels_last)
        self.feat_cfg = feat_cfg
        self.settings = settings
        self.shared_stem = shared_stem.resolve_shared_stem(
            settings.shared_stem, model.name, settings.window
        )
        self.wave_len = host_prep.bucket_wave_len(settings, feat_cfg)
        self._pack_pool: Optional[ThreadPoolExecutor] = None  # see _pack_rows
        self.logit_sink: Optional[list] = None

    # ------------------------------------------------------------------ #

    def _pack_rows(self, rows: np.ndarray) -> List[pcm_pack.PackedPCM]:
        """``pack_pcm`` of each row, in the pipeline's thread pool: rows
        pack independently and numpy's large-array work runs outside the
        interpreter lock.  The pool lives as long as the pipeline (one per
        bucket would pay thread start-up on every bucket)."""
        if self._pack_pool is None:
            self._pack_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="pcm-pack")
            # Idle workers would otherwise outlive a discarded pipeline.
            weakref.finalize(self, self._pack_pool.shutdown, wait=False)
        return list(self._pack_pool.map(pcm_pack.pack_pcm, rows))

    def _maybe_pack(self, buf: np.ndarray) -> Optional[Tuple[np.ndarray, List[bool]]]:
        """Pack a bucket buffer ([wave_len], or a [C, wave_len] batch) for
        one upload when the codec settings say so and, under 'auto', the
        wire saves at least 10% of the raw bytes: (wires [C, wire_len]
        uint32, rows zero-padded to the longest; each row's delta flag), or
        None = upload ``buf`` raw.  Each row takes its own smaller mode: the
        device decodes row by row, so rows need not share one (the JAX
        package's batched decode forces deltas on every row)."""
        codec = self.settings.transfer_codec
        if not codec_wants_pack(buf, codec):
            return None
        packs = self._pack_rows(buf.reshape(-1, buf.shape[-1]))
        wire_len = max(p.packed_bytes for p in packs) // 4
        if codec == "auto" and len(packs) * wire_len * 4 > 0.9 * buf.nbytes:
            return None
        wires = np.zeros((len(packs), wire_len), dtype=np.uint32)
        for row, p in zip(wires, packs):
            wire = p.wire()
            row[: len(wire)] = wire
        return wires, [p.delta for p in packs]

    def _upload(self, buf: np.ndarray, device: Optional[torch.device] = None,
                pinned: bool = False) -> torch.Tensor:
        """A bucket buffer ([wave_len], or a [C, wave_len] batch) on
        ``device`` (default the pipeline's) as float32 of its shape: raw
        (``upload_wave``), or as one packed upload decoded there (the same
        numbers)."""
        device = self.device if device is None else device
        with annotate("sweep/upload"):
            packed = self._maybe_pack(buf)
            if packed is None:
                return upload_wave(buf, device, pinned)
            wires, deltas = packed
            return upload_packed(wires, buf.shape[-1], deltas, device).reshape(buf.shape)

    def _bucket_probs(self, buf: np.ndarray, valid: int) -> torch.Tensor:
        """One bucket buffer (``wave_len`` samples, int16 or float32) -> its
        [n_chunks * chunk] probabilities, on the device.  The one bucket
        body: the offline loop and StreamingSession both run through it,
        which keeps streaming bit-equal to offline."""
        with torch.inference_mode(), precision_scope(self.settings.precision):
            return self.bucket_body(self._upload(buf), valid)

    def bucket_body(self, wave: torch.Tensor, valid: Union[int, torch.Tensor]) -> torch.Tensor:
        """A bucket's float32 wave on the device -> its probabilities: the
        fbank op over the bucket and its halo ([bucket + window - 1, F]),
        then ``classify_bucket`` (in the clips mode ``valid`` is the
        bucket's [lo, hi) pair and ``classify_clips`` runs).  What
        ``export.export_bucket_pipeline`` traces, so the artifact runs this
        body."""
        with annotate("sweep/body"):
            feats = fbank_cuda(wave, host_prep.snip_cfg(self.feat_cfg))
            if self.settings.mode == "clips":
                return classify_clips(self.model, feats[None], [valid], self.settings,
                                      self.logit_sink)[0]
            return classify_bucket(self.model, feats, valid, self.settings, self.shared_stem)

    def bucket_buffers(self, padded: np.ndarray, t: int):
        """Yield ``(buf, valid_frames, keep_frames)`` per bucket: the
        fixed-size buffers, valid-frame counts and kept-frame counts the
        offline loop executes (``host_prep.bucket_slices``, the e2e
        artifact's host prep too)."""
        return host_prep.bucket_slices(padded, t, self.settings, self.feat_cfg)

    def probs_for_waveform(self, wave: np.ndarray) -> np.ndarray:
        """[n] waveform -> [T] laughter probabilities (one per 10 ms frame).
        Accepts float32/float64 in [-1, 1] or raw int16 PCM."""
        return self.probs_for_waveform_device(wave).cpu().numpy()

    def probs_for_waveform_device(self, wave: np.ndarray) -> torch.Tensor:
        """Like :meth:`probs_for_waveform`, but the probabilities stay on
        the device (for ops/smoothing.instances_from_device_probs)."""
        wave = np.asarray(wave)
        check_pcm(wave)
        if wave.dtype != np.int16:
            wave = wave.astype(np.float32)
        padded, t = host_prep.host_pad(wave, self.feat_cfg, self.settings)
        if t == 0:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        if self.settings.mode == "fused_conv":
            return self._probs_fused_conv_device(padded, t)
        pieces = [
            self._bucket_probs(buf, valid)[:keep]
            for buf, valid, keep in self.bucket_buffers(padded, t)
        ]
        return torch.cat(pieces)

    def _probs_fused_conv_device(self, padded: np.ndarray, t: int) -> torch.Tensor:
        """The whole track in one buffer of a bucket-multiple frame count
        (one shape per rounded length), featurized in one launch."""
        bucket = self.settings.bucket_frames
        total = max(bucket, -(-t // bucket) * bucket)
        buf = np.zeros((1, track_wave_len(total, self.feat_cfg)), dtype=padded.dtype)
        buf[0, : len(padded)] = padded
        probs = fused_conv_probs(
            self.model, buf, [t], self.feat_cfg, self.settings.window, self.device,
            self.settings.precision,
        )
        return probs[0, :t]

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


class _StreamingBase:
    """Shared state machine for online (streaming) inference sessions.

    Owns everything the single-stream and the multichannel session must
    agree on for streaming to equal offline bit for bit: per-chunk dtype
    validation and normalization (int16 into a float stream scales exactly
    like the offline mixed path), the constant left reflection pad applied
    once a whole frame exists (shorter streams have truncated-reflection
    padding only the offline path reproduces, so :meth:`_finish_impl`
    delegates them), the eager full-validity bucket loop (a bucket runs
    only once every sample its windows and halo read is final), memory
    bounding, and the end-of-stream reflection and flush.  Subclasses
    provide the bucket executor, the short-stream delegate and the output
    shape.
    """

    def __init__(self, pipeline, n_streams: int):
        if pipeline.settings.mode != "windows":
            raise ValueError(f"{type(self).__name__} requires mode='windows'")
        if pipeline.feat_cfg.snip_edges:
            # Same contract as the offline path (host_pad_waveform): the
            # streaming left/right reflection pads implement
            # snip_edges=False framing; applying them under a
            # snip_edges=True cfg would shift every frame.
            raise ValueError(
                f"{type(self).__name__} implements snip_edges=False "
                "framing; a snip_edges=True FeatConfig must not reach it"
            )
        if n_streams < 1:
            raise ValueError("need at least one stream")
        self._pipe = pipeline
        self._cfg = host_prep.snip_cfg(pipeline.feat_cfg)
        self.n_streams = n_streams
        self._raw_head: Optional[List[List[np.ndarray]]] = [[] for _ in range(n_streams)]
        self._bufs: List[np.ndarray] = []
        # Chunks appended since the last consolidation: feed() is O(chunk);
        # the buffer materializes only when a bucket executes or trims.
        self._pending: List[List[np.ndarray]] = [[] for _ in range(n_streams)]
        self._total = 0  # padded samples known so far (incl. consumed ones)
        self._consumed = 0  # padded samples dropped from the buffers' front
        self._n = 0  # raw samples seen per stream
        self._bucket_idx = 0
        self._dtype: Optional[np.dtype] = None
        self._finished = False

    # ---- subclass hooks ---------------------------------------------- #

    def _execute(self, buf_slices: List[np.ndarray], valid: int) -> np.ndarray:
        """[n_streams] bucket buffers -> [n_streams, bucket+extra] probs."""
        raise NotImplementedError

    def _delegate_short(self, heads: List[np.ndarray]) -> np.ndarray:
        """Whole-stream fallback for streams shorter than one frame."""
        raise NotImplementedError

    def _empty(self) -> np.ndarray:
        return np.zeros((self.n_streams, 0), dtype=np.float32)

    # ---- shared machinery -------------------------------------------- #

    @property
    def _left_pad(self) -> int:
        # Kaldi's per-term truncation, matching host_prep.pad_amounts.
        cfg = self._cfg
        return cfg.frame_length_samples // 2 - cfg.frame_shift_samples // 2

    def _padded_buffer(self, buf_slice: np.ndarray) -> np.ndarray:
        """A bucket's buffer: the slice, zero-filled to the bucket length
        (the offline loop's bucket_buffers, exactly)."""
        buf = np.zeros(self._pipe.wave_len, dtype=self._dtype)
        src = buf_slice[: self._pipe.wave_len]
        buf[: len(src)] = src
        return buf

    def _append(self, chunks: Sequence[np.ndarray]) -> None:
        if len(chunks) != self.n_streams:
            raise ValueError(
                f"expected {self.n_streams} channel chunks, got {len(chunks)}"
            )
        chunks = [np.asarray(c) for c in chunks]
        for c in chunks:
            if c.ndim != 1:
                raise ValueError("feed() wants 1-D PCM chunks")
            if len(c) and c.dtype not in (np.int16, np.float32, np.float64):
                raise TypeError(f"unsupported PCM dtype {c.dtype}")
        n = len(chunks[0])
        if any(len(c) != n for c in chunks):
            raise ValueError("channel chunks must have equal lengths")
        if self._dtype is None and n:
            self._dtype = np.dtype(
                np.int16 if all(c.dtype == np.int16 for c in chunks) else np.float32
            )
        if n:
            conv = []
            for c in chunks:
                if c.dtype == self._dtype:
                    # Copy: chunks are kept until a bucket executes, and a
                    # caller may reuse one capture buffer for every feed
                    # (the usual audio-callback pattern); an alias would
                    # corrupt every buffered chunk.  The conversions below
                    # copy anyway.
                    conv.append(np.array(c, copy=True))
                elif self._dtype == np.float32 and c.dtype == np.int16:
                    # Int16 into a float stream: scale like the offline
                    # mixed batch (parallel/sharded_inference.py), exactly.
                    conv.append(c.astype(np.float32) / 32768.0)
                elif self._dtype == np.float32:
                    conv.append(c.astype(np.float32))
                else:
                    raise TypeError(
                        "cannot mix float chunks into an int16 stream "
                        "(floats are not exactly representable as int16)"
                    )
            chunks = conv
        self._n += n
        if self._raw_head is not None:
            for i, c in enumerate(chunks):
                if len(c):
                    self._raw_head[i].append(c)
            heads = self._heads()
            if len(heads[0]) < self._cfg.frame_length_samples:
                return
            self._raw_head = None
            self._bufs = [np.concatenate([h[: self._left_pad][::-1], h]) for h in heads]
            self._total = len(self._bufs[0])
            return
        if n:
            for i, c in enumerate(chunks):
                self._pending[i].append(c)
            self._total += n

    def _consolidate(self) -> None:
        """Materialize pending chunks into the contiguous buffers (only when
        a bucket is about to execute or trim)."""
        if self._pending[0]:
            self._bufs = [np.concatenate([b, *p]) for b, p in zip(self._bufs, self._pending)]
            self._pending = [[] for _ in range(self.n_streams)]

    def _heads(self) -> List[np.ndarray]:
        dtype = self._dtype or np.float32
        return [
            np.concatenate(parts) if (parts := [p for p in h if len(p)])
            else np.zeros(0, dtype=dtype)
            for h in self._raw_head
        ]

    def _slices(self, lo: int) -> List[np.ndarray]:
        o = lo - self._consumed
        return [b[o : o + self._pipe.wave_len] for b in self._bufs]

    def _feed_impl(self, chunks: Sequence[np.ndarray]) -> np.ndarray:
        if self._finished:
            raise RuntimeError("stream already finished")
        self._append(chunks)
        if self._raw_head is not None:
            return self._empty()
        s = self._pipe.settings
        shift = self._cfg.frame_shift_samples
        bucket = s.bucket_frames
        pieces = []
        while True:
            lo = self._bucket_idx * bucket * shift
            if self._total < lo + self._pipe.wave_len:
                break
            self._consolidate()
            # Every halo sample is final: a full-validity bucket, exactly
            # the offline path's non-final buckets.
            probs = self._execute(self._slices(lo), bucket + s.window - 1)
            pieces.append(probs[:, :bucket])
            self._bucket_idx += 1
            # Bound memory: drop consumed samples, keeping what later
            # buckets and the final reflection pad still need.
            new_lo = self._bucket_idx * bucket * shift
            drop = new_lo - self._consumed
            if drop > 0:
                self._bufs = [b[drop:] for b in self._bufs]
                self._consumed = new_lo
        return np.concatenate(pieces, axis=1) if pieces else self._empty()

    def _finish_impl(self) -> np.ndarray:
        if self._finished:
            raise RuntimeError("stream already finished")
        self._finished = True
        if self._raw_head is not None:
            # Too short to ever initialize: delegate whole-stream.
            return self._delegate_short(self._heads())
        s = self._pipe.settings
        shift = self._cfg.frame_shift_samples
        t = host_prep.num_frames(self._n, self._pipe.feat_cfg)
        _left, right = host_prep.pad_amounts(self._n, self._pipe.feat_cfg)
        self._consolidate()
        if right > 0:
            self._bufs = [np.concatenate([b, b[len(b) - right :][::-1]]) for b in self._bufs]
            self._total += right
        bucket = s.bucket_frames
        pieces = []
        emitted = self._bucket_idx * bucket
        while emitted < t:
            lo = self._bucket_idx * bucket * shift
            valid = min(t - self._bucket_idx * bucket, bucket + s.window - 1)
            probs = self._execute(self._slices(lo), valid)
            pieces.append(probs[:, : min(bucket, t - emitted)])
            emitted += bucket
            self._bucket_idx += 1
        return np.concatenate(pieces, axis=1) if pieces else self._empty()


class StreamingSession(_StreamingBase):
    """Online (streaming) inference over one audio stream.

    Feed PCM in chunks of any size; probabilities come back as soon as
    their bucket completes, so a live stream is classified with bounded
    latency (``bucket_frames`` x 10 ms + compute) and bounded memory.  The
    emitted sequence equals ``pipeline.probs_for_waveform`` of the
    concatenated audio bit for bit: a bucket runs through the pipeline's
    own ``_bucket_probs`` at the offline shapes, only once every sample its
    windows (and their halo) read is final, and the end-of-stream
    reflection padding is applied in :meth:`finish`, as offline.  The
    multichannel version is
    ``parallel.sharded_inference.ShardedStreamingSession``.

    Usage::

        sess = StreamingSession(pipeline)
        for chunk in microphone():        # int16 or float32 PCM @ 16 kHz
            probs = sess.feed(chunk)      # [k] newly final frame probs
        probs_tail = sess.finish()
    """

    def __init__(self, pipeline: LaughterPipeline):
        super().__init__(pipeline, n_streams=1)

    def _execute(self, buf_slices: List[np.ndarray], valid: int) -> np.ndarray:
        buf = self._padded_buffer(buf_slices[0])
        return self._pipe._bucket_probs(buf, valid).cpu().numpy()[None, :]

    def _delegate_short(self, heads: List[np.ndarray]) -> np.ndarray:
        return self._pipe.probs_for_waveform(heads[0])

    def feed(self, pcm: np.ndarray) -> np.ndarray:
        """Add a PCM chunk; returns probabilities for every frame that
        became final (possibly none)."""
        return self._feed_impl([pcm])[0]

    def finish(self) -> np.ndarray:
        """End of stream: apply the final reflection padding and flush the
        remaining frames."""
        out = self._finish_impl()
        return out if out.ndim == 1 else out[0]


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
