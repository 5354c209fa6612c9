"""Meeting-scale multichannel inference: a [C, n] channel batch, one device a process.

The port of the JAX package's ``parallel/sharded_inference.py``.  The JAX
class shards the channel axis over a device mesh; here each process of a
``torch.distributed`` group (or the one process) holds one device, given
as ``device=`` in place of ``mesh=``, and the channel axis, padded with
silent channels to a multiple of the process count, splits into
contiguous blocks in rank order (``parallel.mesh.row_block``), as JAX's
1-D mesh of one device a process places it.  Every process passes the same
channel list; each decodes, uploads and classifies only its block, and
postprocesses the rows :meth:`ShardedPipeline.local_channels` gives it.
In a run of one process the block is every channel and nothing is padded.
Per bucket, one fbank kernel launch featurizes every channel's
[wave_len] buffer at once; the classifier then runs each channel as the
single-channel pipeline runs its bucket (``inference.classify_bucket``, the
JAX package's per-channel loop), so a row equals that channel run alone.
A meeting's channels share a length, so a meeting is one batch; ragged
batches mask each channel's frames past its own count.  Under the packed
codec a bucket batch goes up as one [C, wire_len] upload of bit-packed
rows, each decoded on the device (``LaughterPipeline._upload``).  In
bfloat16 the batch runs on the pipeline's bf16 copy of the model, each row
cast at the model boundary as a single channel's bucket is.

Over several processes, the calls that hand every channel to one process
(``probs_for_waveforms``, ``probs_for_meeting``) raise, as JAX's do, and
``ShardedStreamingSession`` raises: the JAX package has no multi-process
session.
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
    check_pcm,
    classify_bucket,
    fused_conv_probs,
    int16_transfer_eligible,
    precision_scope,
    track_wave_len,
)
from laughter_detection_icsi_tpu_torch.ops.fbank_cuda import fbank_cuda
from laughter_detection_icsi_tpu_torch.parallel import mesh
from laughter_detection_icsi_tpu_torch.runtime import native


class ShardedPipeline(LaughterPipeline):
    """Batched multichannel inference, the channel axis split over the
    processes of the default group.  A :class:`LaughterPipeline` (its
    single-channel methods included) that also takes a batch of
    channels."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rank, self.n_shards = mesh.world()
        self._multi = self.n_shards > 1

    def _rows_slice(self, c: int) -> Tuple[int, int]:
        """[lo, hi) rows of ``c`` channels padded to a multiple of the
        process count that this process builds and uploads: all of them in
        a run of one."""
        return mesh.row_block(-(-c // self.n_shards) * self.n_shards, self.rank, self.n_shards)

    def local_channel_indices(self, c: int) -> List[int]:
        """The channels (of ``c``) this process owns: disjoint across the
        processes and together every channel once, the partition
        multi-process postprocessing and writes key on."""
        lo, hi = self._rows_slice(c)
        return list(range(lo, min(hi, c)))

    def local_channels(self, probs_dev: torch.Tensor, c: int):
        """[(channel, probs row)] for the channels of
        :meth:`local_channel_indices`, from the ``probs_dev`` of a
        ``*_device`` call (this process's block of rows)."""
        lo, _ = self._rows_slice(c)
        return [(r, probs_dev[r - lo]) for r in self.local_channel_indices(c)]

    def _refuse_multi(self, what: str) -> None:
        if self._multi:
            # Before any compute: an all-empty batch would otherwise
            # "succeed" on every process at once.
            raise RuntimeError(
                f"{what} returns ALL channels to one host, which a "
                f"multi-process mesh cannot do; use {what}_device + "
                "local_channels (each process postprocesses its own rows)"
            )

    def probs_for_waveforms(self, waves: Sequence[np.ndarray]) -> List[np.ndarray]:
        """[n_i]-sample waveforms -> per-channel [T_i] probabilities: the
        channels stream together through fixed-size frame buckets
        ('windows' mode) or run through one whole-track batch
        ('fused_conv').  A run of one process only."""
        self._refuse_multi("probs_for_waveforms")
        probs, ts = self.probs_for_waveforms_device(waves)
        if probs is None:
            return [np.zeros(0, dtype=np.float32) for _ in waves]
        host = probs.cpu().numpy()  # one device->host copy for the batch
        return [host[i, : ts[i]] for i in range(len(waves))]

    def probs_for_waveforms_device(self, waves: Sequence[np.ndarray]):
        """Like :meth:`probs_for_waveforms`, but returns (probs [C, t_max] on
        the device, frame counts) for on-device smoothing of each row;
        (None, counts) when there is nothing to compute.  Over several
        processes the probabilities are this process's block of rows
        (:meth:`local_channels`) and the counts every channel's."""
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
        """[rows, t_max] device probabilities of this process's rows of the
        padded channel axis (every channel in a run of one) from
        host-padded channel buffers.  ``padded_list[r]`` may be None for a
        row another process holds; ``ts`` are every channel's frame
        counts."""
        dtype = np.int16 if int16_in else np.float32
        t_max = max(ts)
        if t_max == 0:
            return None
        c = len(ts)
        if self.settings.mode == "fused_conv":
            b = self.settings.bucket_frames
            total = max(b, -(-t_max // b) * b)
            lo, hi = self._rows_slice(c)
            batch = np.zeros((hi - lo, track_wave_len(total, self.feat_cfg)), dtype=dtype)
            valid = [0] * (hi - lo)
            for r in range(lo, min(hi, c)):
                if padded_list[r] is not None:
                    batch[r - lo, : len(padded_list[r])] = padded_list[r]
                valid[r - lo] = ts[r]
            probs = fused_conv_probs(
                self.model, batch, valid, self.feat_cfg, self.settings.window, self.device,
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
        """Yield the windows-mode bucket plan of this process's rows, one
        ``(batch [rows, wave_len], valid [rows], bucket_index)`` per bucket,
        exactly as :meth:`_probs_padded_device` runs it."""
        dtype = np.int16 if int16_in else np.float32
        ts = list(ts)
        c = len(ts)
        row_lo, row_hi = self._rows_slice(c)
        bucket = self.settings.bucket_frames
        window = self.settings.window
        shift = host_prep.snip_cfg(self.feat_cfg).frame_shift_samples
        for k in range(-(-max(ts) // bucket)):
            lo = k * bucket * shift
            batch = np.zeros((row_hi - row_lo, self.wave_len), dtype=dtype)
            valid = np.zeros(row_hi - row_lo, dtype=np.int32)
            for r in range(row_lo, min(row_hi, c)):
                if padded_list[r] is not None:
                    src = padded_list[r][lo : lo + self.wave_len]
                    batch[r - row_lo, : len(src)] = src
                valid[r - row_lo] = int(np.clip(ts[r] - k * bucket, 0, bucket + window - 1))
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
            return self.bucket_batch_body(self._upload(batch), valid)

    def bucket_batch_body(self, waves: torch.Tensor, valid) -> torch.Tensor:
        """A bucket batch's float32 waves on the device ([C, wave_len]) and
        each channel's valid frames -> [C, n_chunks * chunk] probabilities:
        the batch body of :meth:`_bucket_probs_batch`, as
        ``LaughterPipeline.bucket_body`` is the single channel's."""
        feats = fbank_cuda(waves, host_prep.snip_cfg(self.feat_cfg))
        return torch.stack([
            classify_bucket(self.model, f, int(v), self.settings, self.shared_stem)
            for f, v in zip(feats, valid)
        ])

    def probs_for_meeting(
        self, audio_paths: Sequence[str], channel: int = 0
    ) -> Tuple[List[np.ndarray], List[float]]:
        """All channels of one meeting in one batch.  Returns (probs per
        channel, durations).  A run of one process only."""
        self._refuse_multi("probs_for_meeting")
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
        library's own thread pool (``native.read_batch``).  Over several
        processes every process passes every path and reads every header
        (the frame counts fix each bucket's shape), but decodes only its
        own block of channels."""
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
        mine = self.local_channel_indices(len(audio_paths))
        my_paths = [audio_paths[r] for r in mine]
        if int16_in:
            with ThreadPoolExecutor(max_workers=min(8, max(1, len(mine)))) as ex:
                decoded = list(ex.map(
                    lambda r: audio_io.read_int16(audio_paths[r], channel=channel,
                                                  meta=metas[r]),
                    mine,
                ))
        elif my_paths:
            decoded = native.read_batch(my_paths, channels=[channel] * len(my_paths))
        else:
            decoded = []
        ts = [host_prep.num_frames(m.num_samples, self.feat_cfg) for m in metas]
        dtype = np.int16 if int16_in else np.float32
        padded_list: List[Optional[np.ndarray]] = [None] * len(audio_paths)
        for r, (w, _sr) in zip(mine, decoded):
            p, t = host_prep.host_pad_waveform(np.asarray(w).astype(dtype), self.feat_cfg)
            if t != ts[r]:
                raise RuntimeError(
                    f"{audio_paths[r]}: decoded frame count {t} != header-derived "
                    f"{ts[r]} (truncated file or header mismatch?)"
                )
            padded_list[r] = p
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
        if pipeline._multi:
            # The session holds every channel's host buffers; the JAX
            # package has no multi-process session either.
            raise NotImplementedError(
                "ShardedStreamingSession is single-process; run live "
                "serving on one host's mesh, or use the batched "
                "probs_for_meeting_device across hosts"
            )
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
