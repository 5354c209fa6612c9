"""Meeting-scale multichannel inference: a [C, n] channel batch on one device.

The port of the JAX package's ``parallel/sharded_inference.py`` for a
single device.  The JAX class shards the channel axis over a device mesh;
here the batch lives on the one device the pipeline is given (``device=``
in place of ``mesh=``), as a one-shard mesh would hold it, so no channel is
padded.  Per bucket, one fbank kernel launch featurizes every channel's
[wave_len] buffer at once; the classifier then runs each channel as the
single-channel pipeline runs its bucket (``inference.classify_bucket``, the
JAX package's per-channel loop), so a row equals that channel run alone.
A meeting's channels share a length, so a meeting is one batch; ragged
batches mask each channel's frames past its own count.  Under the packed
codec a bucket batch goes up as one [C, wire_len] upload of bit-packed
rows, each decoded on the device (``LaughterPipeline._upload``).  In
bfloat16 the batch runs on the pipeline's bf16 copy of the model, each row
cast at the model boundary as a single channel's bucket is.

A mesh over several processes (``torch.distributed``) is ROADMAP item 7;
building a pipeline inside a process group of more than one rank raises.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from laughter_detection_icsi_tpu_torch import host_prep
from laughter_detection_icsi_tpu_torch.data import audio as audio_io
from laughter_detection_icsi_tpu_torch.inference import (
    LaughterPipeline,
    _StreamingBase,
    _not_ported,
    check_pcm,
    classify_bucket,
    fused_conv_probs,
    int16_transfer_eligible,
    precision_scope,
    track_wave_len,
)
from laughter_detection_icsi_tpu_torch.ops.fbank_cuda import fbank_cuda
from laughter_detection_icsi_tpu_torch.runtime import native


class ShardedPipeline(LaughterPipeline):
    """Batched multichannel inference on one device.  A
    :class:`LaughterPipeline` (its single-channel methods included) that
    also takes a batch of channels."""

    def __init__(self, *args, **kwargs):
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise _not_ported("ShardedPipeline over a multi-process device mesh", 7)
        super().__init__(*args, **kwargs)

    def probs_for_waveforms(self, waves: Sequence[np.ndarray]) -> List[np.ndarray]:
        """[n_i]-sample waveforms -> per-channel [T_i] probabilities: the
        channels stream together through fixed-size frame buckets
        ('windows' mode) or run through one whole-track batch
        ('fused_conv')."""
        probs, ts = self.probs_for_waveforms_device(waves)
        if probs is None:
            return [np.zeros(0, dtype=np.float32) for _ in waves]
        host = probs.cpu().numpy()  # one device->host copy for the batch
        return [host[i, : ts[i]] for i in range(len(waves))]

    def probs_for_waveforms_device(self, waves: Sequence[np.ndarray]):
        """Like :meth:`probs_for_waveforms`, but returns (probs [C, t_max] on
        the device, frame counts) for on-device smoothing of each row;
        (None, counts) when there is nothing to compute."""
        if len(waves) == 0:
            # len(), not truthiness: a [C, n] ndarray batch is ambiguous
            # under `not`.
            return None, []
        for w in waves:
            check_pcm(np.asarray(w))
        int16_in = all(np.asarray(w).dtype == np.int16 for w in waves)
        dtype = np.int16 if int16_in else np.float32
        padded_list, ts = [], []
        for w in waves:
            w = np.asarray(w)
            if not int16_in and w.dtype == np.int16:
                # Mixed batch: the device scales only an all-int16 batch, so
                # this channel is scaled on the host (a bare astype would
                # feed +-32768-range values to the featurizer).
                w = w.astype(np.float32) / 32768.0
            p, t = host_prep.host_pad_waveform(w.astype(dtype), self.feat_cfg)
            padded_list.append(p)
            ts.append(t)
        return self._probs_padded_device(padded_list, ts, int16_in), ts

    def _probs_padded_device(self, padded_list, ts, int16_in: bool) -> Optional[torch.Tensor]:
        """[C, t_max] device probabilities from host-padded channel buffers."""
        dtype = np.int16 if int16_in else np.float32
        t_max = max(ts)
        if t_max == 0:
            return None
        c = len(ts)
        if self.settings.mode == "fused_conv":
            b = self.settings.bucket_frames
            total = max(b, -(-t_max // b) * b)
            batch = np.zeros((c, track_wave_len(total, self.feat_cfg)), dtype=dtype)
            for r, p in enumerate(padded_list):
                batch[r, : len(p)] = p
            probs = fused_conv_probs(
                self.model, batch, ts, self.feat_cfg, self.settings.window, self.device,
                self.settings.precision,
            )
            # Slice to [C, t_max]: the masked tail carries a fully-conv
            # bias-leak constant (~0.48 at init scale), not 0, and a device
            # consumer would smooth phantom laughter past the audio's end.
            return probs[:, :t_max]
        bucket = self.settings.bucket_frames
        pieces = []
        for batch, valid, k in self.bucket_batches(padded_list, ts, int16_in):
            probs = self._bucket_probs_batch(batch, valid)
            pieces.append(probs[:, : min(bucket, t_max - k * bucket)])
        return torch.cat(pieces, dim=1)

    def bucket_batches(self, padded_list, ts, int16_in: bool = False):
        """Yield the windows-mode bucket plan, one ``(batch [C, wave_len],
        valid [C], bucket_index)`` per bucket, exactly as
        :meth:`_probs_padded_device` runs it."""
        dtype = np.int16 if int16_in else np.float32
        ts = list(ts)
        c = len(ts)
        bucket = self.settings.bucket_frames
        window = self.settings.window
        shift = host_prep.snip_cfg(self.feat_cfg).frame_shift_samples
        for k in range(-(-max(ts) // bucket)):
            lo = k * bucket * shift
            batch = np.zeros((c, self.wave_len), dtype=dtype)
            valid = np.zeros(c, dtype=np.int32)
            for r in range(c):
                src = padded_list[r][lo : lo + self.wave_len]
                batch[r, : len(src)] = src
                valid[r] = int(np.clip(ts[r] - k * bucket, 0, bucket + window - 1))
            yield batch, valid, k

    def _bucket_probs_batch(self, batch: np.ndarray, valid: np.ndarray) -> torch.Tensor:
        """One bucket batch ([C, wave_len] buffers, each channel's valid
        frames) -> [C, n_chunks * chunk] device probabilities.  The one
        bucket body: the offline loop and ShardedStreamingSession both run
        through it.  One fbank launch for the batch; each row is then
        classified as the single-channel pipeline classifies its bucket
        (``classify_bucket``, at the same chunk), so a row equals that
        channel run alone, and the activations live are one channel's."""
        with torch.inference_mode(), precision_scope(self.settings.precision):
            feats = fbank_cuda(self._upload(batch), host_prep.snip_cfg(self.feat_cfg))
            return torch.stack([
                classify_bucket(self.model, f, int(v), self.settings, self.shared_stem)
                for f, v in zip(feats, valid)
            ])

    def probs_for_meeting(
        self, audio_paths: Sequence[str], channel: int = 0
    ) -> Tuple[List[np.ndarray], List[float]]:
        """All channels of one meeting in one batch.  Returns (probs per
        channel, durations)."""
        (probs_dev, ts), durations = self.probs_for_meeting_device(audio_paths, channel)
        if probs_dev is None:
            return [np.zeros(0, dtype=np.float32) for _ in ts], durations
        host = probs_dev.cpu().numpy()
        return [host[i, : ts[i]] for i in range(len(ts))], durations

    def probs_for_meeting_device(self, audio_paths: Sequence[str], channel: int = 0):
        """Like :meth:`probs_for_meeting`, but the probabilities stay on the
        device: ((probs [C, t_max] | None, frame counts), durations).
        16-bit sources (shorten included) decode to int16 in a thread pool
        and ship as int16: the native decoder (runtime/native.py) releases
        the GIL inside its ctypes call, so the channels decode
        concurrently.  Other encodings decode to float in the native
        library's own thread pool (``native.read_batch``)."""
        if not audio_paths:
            return (None, []), []
        metas = [audio_io.info(p) for p in audio_paths]
        for p, m in zip(audio_paths, metas):
            if m.sample_rate != self.feat_cfg.sampling_rate:
                # A stray non-16k file would otherwise give its channel
                # meaningless probabilities whose timestamps look right.
                raise ValueError(
                    f"{p}: sample rate {m.sample_rate} != featurizer rate "
                    f"{self.feat_cfg.sampling_rate}"
                )
        int16_in = all(int16_transfer_eligible(m, self.settings) for m in metas)
        if int16_in:
            with ThreadPoolExecutor(max_workers=min(8, len(audio_paths))) as ex:
                decoded = list(ex.map(
                    lambda pm: audio_io.read_int16(pm[0], channel=channel, meta=pm[1]),
                    zip(audio_paths, metas),
                ))
        else:
            decoded = native.read_batch(audio_paths, channels=[channel] * len(audio_paths))
        ts = [host_prep.num_frames(m.num_samples, self.feat_cfg) for m in metas]
        dtype = np.int16 if int16_in else np.float32
        padded_list = []
        for path, t_header, (w, _sr) in zip(audio_paths, ts, decoded):
            p, t = host_prep.host_pad_waveform(np.asarray(w).astype(dtype), self.feat_cfg)
            if t != t_header:
                raise RuntimeError(
                    f"{path}: decoded frame count {t} != header-derived "
                    f"{t_header} (truncated file or header mismatch?)"
                )
            padded_list.append(p)
        probs = self._probs_padded_device(padded_list, ts, int16_in)
        return (probs, ts), [m.duration for m in metas]


class ShardedStreamingSession(_StreamingBase):
    """Online inference for a live multichannel meeting.

    Feed synchronized PCM chunks, one array per channel of equal length,
    and per-channel probabilities come back as each bucket completes,
    computed as one bucket batch through the offline path's
    ``_bucket_probs_batch``.  The emitted rows equal
    :meth:`ShardedPipeline.probs_for_waveforms` of the concatenated audio
    bit for bit.  The stream rules (dtype mixing, reflection pads, eager
    full-validity buckets, short-stream delegation) are the single-stream
    session's: one state machine, ``inference._StreamingBase``.
    """

    def __init__(self, pipeline: ShardedPipeline, n_channels: int):
        super().__init__(pipeline, n_streams=n_channels)

    @property
    def n_channels(self) -> int:
        return self.n_streams

    def _execute(self, buf_slices: List[np.ndarray], valid: int) -> np.ndarray:
        batch = np.stack([self._padded_buffer(sl) for sl in buf_slices])
        valids = np.full(self.n_streams, valid, dtype=np.int32)
        return self._pipe._bucket_probs_batch(batch, valids).cpu().numpy()

    def _delegate_short(self, heads: List[np.ndarray]) -> np.ndarray:
        out = self._pipe.probs_for_waveforms(heads)
        t = max((len(o) for o in out), default=0)
        res = np.zeros((self.n_streams, t), dtype=np.float32)
        for i, o in enumerate(out):
            res[i, : len(o)] = o
        return res

    def feed(self, chunks: Sequence[np.ndarray]) -> np.ndarray:
        """Add one synchronized chunk per channel; returns a [n_channels, k]
        array of newly final frame probabilities (k may be 0)."""
        return self._feed_impl(chunks)

    def finish(self) -> np.ndarray:
        """End of stream: apply the final reflection padding and flush."""
        return self._finish_impl()
