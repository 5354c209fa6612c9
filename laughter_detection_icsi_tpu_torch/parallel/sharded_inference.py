"""Meeting-scale multichannel inference: a [C, n] channel batch split over shards.

The port of the JAX package's ``parallel/sharded_inference.py``.  The JAX
class shards the channel axis over a 1-D device mesh (``make_mesh()``:
every local chip).  Here the process drives a list of devices, given as
``devices=`` (``parallel.mesh.local_devices`` turns a ``--device`` value
into it) or one as ``device=``, and each process of a ``torch.distributed``
group (or the one process) drives its own list.  The channel axis, padded
with silent channels to a multiple of the shard count (processes x local
devices), splits into contiguous blocks in shard order
(``parallel.mesh.local_row_blocks``), as JAX's 1-D mesh places it.  Every
process passes the same channel list; each decodes, uploads and
classifies only its block, and postprocesses the rows
:meth:`ShardedPipeline.local_channels` gives it.  In a run of one process
the block is every channel.

Per bucket batch, each shard takes its rows on its own device: one upload
(pinned, without blocking the host), one fbank kernel launch over its rows'
[wave_len] buffers, then each row classified as the single-channel
pipeline classifies its bucket (``inference.classify_bucket``, the JAX
package's per-channel loop), on the shard's copy of the model.  So a row
equals that channel run alone, whatever the shard count, and the host
queues every shard's batch before it reads any back.  The results are
gathered onto the first device, one peer copy a shard.  A meeting's
channels share a length, so a meeting is one batch; ragged batches mask
each channel's frames past its own count.  Under the packed codec a
shard's rows go up as one [rows, wire_len] upload of bit-packed rows, each
decoded on the device (``LaughterPipeline._upload``).  In bfloat16 each
shard runs a bf16 copy of the model, each row cast at the model boundary
as a single channel's bucket is.  In a profiler's timeline each stage is a
span (``utils/profiling.annotate``): ``sweep/decode``, ``sweep/prepare``
(checks and host padding), ``sweep/batch`` (a bucket batch's host buffer),
``sweep/upload``, ``sweep/body`` and ``sweep/gather``.  In the clips mode
(the AST preset) a shard's rows of a bucket batch are classified together
(``inference.classify_clips``: the rows' clips in batches of
``clip_batch``), and ``valid`` is each row's [lo, hi) pair.

Over several processes, the calls that hand every channel to one process
(``probs_for_waveforms``, ``probs_for_meeting``) raise, as JAX's do, and
``ShardedStreamingSession`` raises: the JAX package has no multi-process
session.  The session runs over every local device of one process.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from laughter_detection_icsi_tpu_torch import host_prep
from laughter_detection_icsi_tpu_torch.config import FEAT, FeatConfig
from laughter_detection_icsi_tpu_torch.data import audio as audio_io
from laughter_detection_icsi_tpu_torch.inference import (
    InferenceSettings,
    LaughterPipeline,
    _StreamingBase,
    check_pcm,
    classify_bucket,
    classify_clips,
    fused_conv_probs,
    int16_transfer_eligible,
    precision_scope,
    resolve_device,
    track_wave_len,
)
from laughter_detection_icsi_tpu_torch.ops.fbank_cuda import fbank_cuda
from laughter_detection_icsi_tpu_torch.parallel import mesh
from laughter_detection_icsi_tpu_torch.runtime import native
from laughter_detection_icsi_tpu_torch.utils.profiling import annotate


class ShardedPipeline(LaughterPipeline):
    """Batched multichannel inference, the channel axis split over this
    process's devices and the processes of the default group.  A
    :class:`LaughterPipeline` on the first device (its single-channel
    methods included) that also takes a batch of channels.  ``devices``
    lists the local shards (repeats allowed: two shards of one card);
    ``device`` is one.  Every process of a group drives as many."""

    def __init__(self, model: torch.nn.Module, feat_cfg: FeatConfig = FEAT,
                 settings: InferenceSettings = InferenceSettings(),
                 device: Union[None, str, torch.device] = None,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None):
        if devices is not None and device is not None:
            raise ValueError("pass device= (one) or devices= (the local shards), not both")
        devices = [device] if devices is None else list(devices)
        if not devices:
            raise ValueError("devices= names no device")
        self.devices = [resolve_device(d) for d in devices]
        super().__init__(model, feat_cfg, settings, self.devices[0])
        # One model a distinct device: the first is the pipeline's own;
        # the others are copies (the caller's model stays where the
        # pipeline put it), each the bf16 copy in bfloat16.
        models = {self.device: self.model}
        for d in self.devices[1:]:
            if d not in models:
                models[d] = copy.deepcopy(self.model).to(d)
        self.shard_models = [models[d] for d in self.devices]
        self.rank, self.world = mesh.world()
        self.n_shards = self.world * len(self.devices)
        self._multi = self.world > 1

    def _rows_slice(self, c: int) -> Tuple[int, int]:
        """[lo, hi) rows of ``c`` channels padded to a multiple of the
        shard count that this process builds and uploads: all of them in
        a run of one."""
        blocks = mesh.local_row_blocks(
            -(-c // self.n_shards) * self.n_shards, self.rank, self.world, len(self.devices))
        return blocks[0][0], blocks[-1][1]

    def _split(self, rows: int) -> List[Tuple[int, int]]:
        """[lo, hi) of each local shard in a batch of this process's
        ``rows`` rows."""
        return [mesh.row_block(rows, j, len(self.devices)) for j in range(len(self.devices))]

    def local_channel_indices(self, c: int) -> List[int]:
        """The channels (of ``c``) this process owns: disjoint across the
        processes and together every channel once, the partition
        multi-process postprocessing and writes key on.  Padding rows are
        never among them."""
        lo, hi = self._rows_slice(c)
        return list(range(lo, min(hi, c)))

    def local_channels(self, probs_dev: torch.Tensor, c: int):
        """[(channel, probs row)] for the channels of
        :meth:`local_channel_indices`, from the ``probs_dev`` of a
        ``*_device`` call (this process's block of rows, on the first
        device)."""
        lo, _ = self._rows_slice(c)
        return [(r, probs_dev[r - lo]) for r in self.local_channel_indices(c)]

    def _gather(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """Each local shard's rows, on its device -> this process's rows on
        the first device: one peer copy a shard on another card."""
        with annotate("sweep/gather"):
            if len(pieces) == 1:
                return pieces[0]
            return torch.cat([p.to(self.device) for p in pieces])

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
        with annotate("sweep/prepare"):
            for w in waves:
                check_pcm(np.asarray(w))
            int16_in = all(np.asarray(w).dtype == np.int16 for w in waves)
            dtype = np.int16 if int16_in else np.float32
            padded_list, ts = [], []
            for w in waves:
                w = np.asarray(w)
                if not int16_in and w.dtype == np.int16:
                    # Mixed batch: the device scales only an all-int16 batch,
                    # so this channel is scaled on the host (a bare astype
                    # would feed +-32768-range values to the featurizer).
                    w = w.astype(np.float32) / 32768.0
                p, t = host_prep.host_pad(w.astype(dtype, copy=False), self.feat_cfg, self.settings)
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
            with annotate("sweep/batch"):
                batch = np.zeros((hi - lo, track_wave_len(total, self.feat_cfg)), dtype=dtype)
                valid = [0] * (hi - lo)
                for r in range(lo, min(hi, c)):
                    if padded_list[r] is not None:
                        batch[r - lo, : len(padded_list[r])] = padded_list[r]
                    valid[r - lo] = ts[r]
            # Slice to [C, t_max]: the masked tail carries a fully-conv
            # bias-leak constant (~0.48 at init scale), not 0, and a device
            # consumer would smooth phantom laughter past the audio's end.
            bufs = [batch[r0:r1] for r0, r1 in self._split(hi - lo)]
            return self.fused_batch_body(bufs, valid)[:, :t_max]
        bucket = self.settings.bucket_frames
        shards = [[] for _ in self.devices]
        for batch, valid, k in self.bucket_batches(padded_list, ts, int16_in):
            keep = min(bucket, t_max - k * bucket)
            for acc, probs in zip(shards, self._shard_probs(batch, valid)):
                acc.append(probs[:, :keep])
        with annotate("sweep/gather"):
            rows = [torch.cat(acc, dim=1) for acc in shards]
        return self._gather(rows)

    def bucket_batches(self, padded_list, ts, int16_in: bool = False):
        """Yield the windows-mode bucket plan of this process's rows, one
        ``(batch [rows, wave_len], valid [rows], bucket_index)`` per bucket,
        exactly as :meth:`_probs_padded_device` runs it; in the clips mode
        ``valid`` is [rows, 2], each row's ``host_prep.clip_bounds``."""
        dtype = np.int16 if int16_in else np.float32
        ts = list(ts)
        c = len(ts)
        row_lo, row_hi = self._rows_slice(c)
        bucket = self.settings.bucket_frames
        window = self.settings.window
        clips = host_prep.is_clips(self.settings)
        for k in range(-(-max(ts) // bucket)):
            # The span closes before the yield: it never stays open while
            # the consumer runs the batch.
            with annotate("sweep/batch"):
                start = host_prep.bucket_start(k, self.settings, self.feat_cfg)
                batch = np.zeros((row_hi - row_lo, self.wave_len), dtype=dtype)
                valid = np.zeros((row_hi - row_lo, 2) if clips else row_hi - row_lo,
                                 dtype=np.int32)
                for r in range(row_lo, min(row_hi, c)):
                    if padded_list[r] is not None:
                        host_prep.copy_bucket(batch[r - row_lo], padded_list[r], start)
                    valid[r - row_lo] = (host_prep.clip_bounds(ts[r], k, self.settings) if clips
                                         else int(np.clip(ts[r] - k * bucket, 0,
                                                          bucket + window - 1)))
            yield batch, valid, k

    def _shard_probs(self, batch: np.ndarray, valid: np.ndarray) -> List[torch.Tensor]:
        """One bucket batch of this process's rows ([rows, wave_len]
        buffers, each row's valid frames) -> each local shard's
        [rows / shards, n_chunks * chunk] probabilities on its own device.
        Every shard's rows are uploaded (pinned, without blocking), then
        every shard's work queued; nothing is read back."""
        with torch.inference_mode(), precision_scope(self.settings.precision):
            waves = [self._upload(batch[a:b], d, pinned=True)
                     for d, (a, b) in zip(self.devices, self._split(len(batch)))]
            return self._shard_bodies(waves, valid)

    def _bucket_probs_batch(self, batch: np.ndarray, valid: np.ndarray) -> torch.Tensor:
        """One bucket batch ([C, wave_len] buffers, each channel's valid
        frames) -> [C, n_chunks * chunk] probabilities on the first device.
        The one bucket body: the offline loop and ShardedStreamingSession
        both run through it (``_shard_probs``, then one gather)."""
        return self._gather(self._shard_probs(batch, valid))

    def _shard_bodies(self, waves: Sequence[torch.Tensor], valid) -> List[torch.Tensor]:
        """Each local shard's float32 waves on its device ([rows, wave_len])
        and every row's valid frames -> each shard's [rows, n_chunks *
        chunk] probabilities there: one fbank launch for a shard's rows,
        then each row classified as the single-channel pipeline classifies
        its bucket (``classify_bucket``, at the same chunk), so a row
        equals that channel run alone, and the activations live are one
        channel's."""
        out = []
        with annotate("sweep/body"):
            for model, w, (a, b) in zip(self.shard_models, waves, self._split(len(valid))):
                feats = fbank_cuda(w, host_prep.snip_cfg(self.feat_cfg))
                if self.settings.mode == "clips":
                    out.append(classify_clips(model, feats, valid[a:b], self.settings,
                                              self.logit_sink))
                    continue
                out.append(torch.stack([
                    classify_bucket(model, f, int(v), self.settings, self.shared_stem)
                    for f, v in zip(feats, valid[a:b])
                ]))
        return out

    def fused_batch_body(self, bufs: Sequence, valid: Sequence[int]) -> torch.Tensor:
        """mode='fused_conv': each local shard's whole-track buffers (host
        arrays, or tensors on its device) and every row's frame count ->
        [rows, total] probabilities on the first device, each shard
        through ``fused_conv_probs`` on its own device."""
        split = self._split(len(valid))
        with annotate("sweep/body"):
            pieces = [
                fused_conv_probs(model, buf, valid[r0:r1], self.feat_cfg, self.settings.window,
                                 dev, self.settings.precision)
                for model, dev, buf, (r0, r1) in zip(self.shard_models, self.devices, bufs, split)
            ]
        return self._gather(pieces)

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
        with annotate("sweep/decode"):
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
        with annotate("sweep/prepare"):
            for r, (w, _sr) in zip(mine, decoded):
                p, t = host_prep.host_pad(np.asarray(w).astype(dtype, copy=False), self.feat_cfg,
                                          self.settings)
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
        # Silent channels (valid 0) pad the batch to a multiple of the
        # shard count, as JAX's session pads to its mesh; they are cut
        # before the rows come back.
        c_pad = -(-self.n_streams // self._pipe.n_shards) * self._pipe.n_shards
        batch = np.zeros((c_pad, self._pipe.wave_len), dtype=self._dtype)
        for i, sl in enumerate(buf_slices):
            batch[i] = self._padded_buffer(sl)
        valids = np.zeros(c_pad, dtype=np.int32)
        valids[: self.n_streams] = valid
        probs = self._pipe._bucket_probs_batch(batch, valids)
        return probs[: self.n_streams].cpu().numpy()

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
