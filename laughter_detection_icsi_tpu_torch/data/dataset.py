"""Training datasets: table rows + feature cache -> model batches.

The port of the JAX package's ``data/dataset.py`` (reference
datasets.py:23-68 and load_data.py:12-34) on record lists, with no pandas.
A batch is ``{'inputs' [B, 100, 44] float32, 'input_lens' [B],
'is_laugh' [B]}``, assembled from memory maps of the feature cache; an
epoch visits the rows in a seeded permutation (:func:`_epoch_slices`).

:class:`LadDataset` assembles batches on the host (numpy, a background
prefetch thread); :class:`ResidentLadDataset` uploads the whole split to
the device once and gathers each batch there, so only the index vector
crosses the link.  Both draw their batch order from ``_epoch_slices``, so
a streamed and a resident epoch train on the same batches.

Over several processes (``parallel.DataParallelTrainer``) every process
draws the same global batch order: ``LadDataset.batches(local_rows=...)``
assembles only this process's block of each batch, and a
``ResidentLadDataset(sharding=...)`` holds only this process's block of
the split's rows and gathers a batch's rows from every process.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from laughter_detection_icsi_tpu_torch.data.feature_cache import FeatureCache
from laughter_detection_icsi_tpu_torch.data.sampler import FLOAT_COLS

Row = Mapping[str, Any]


@dataclasses.dataclass
class LadDataset:
    """Laughter-activity-detection dataset over one split's table (a list
    of rows keyed like ``data.sampler.COLS``)."""

    df: Sequence[Row]
    cache: FeatureCache
    window_frames: int = 0  # 0 -> cfg.num_samples (100 = 1 s)

    def __post_init__(self):
        if self.window_frames == 0:
            self.window_frames = self.cache.cfg.num_samples
        self.df = list(self.df)

    def __len__(self) -> int:
        return len(self.df)

    def example(self, i: int) -> Dict[str, np.ndarray]:
        row = self.df[i]
        feats = self.cache.cut(
            row["meeting_id"],
            row["chan_id"],
            float(row["sub_start"]),
            float(row["sub_duration"]),
            pad_to_frames=self.window_frames,
        )
        n_valid = min(
            int(round(float(row["sub_duration"]) * self.cache.cfg.num_samples)),
            self.window_frames,
        )
        return {
            "inputs": feats,
            "input_lens": np.int32(n_valid),
            "is_laugh": np.float32(row["label"]),
        }

    # Batches are assembled with one fancy-indexed gather per (track,
    # batch) from the memory-mapped cache (example() row by row costs ~1 ms
    # a row), and an epoch assembles ahead on a background thread.

    def _plan(self):
        """Per-row gather plan, keyed on the cache generation: add_track
        rewrites .npy files in place, and a plan built earlier would gather
        through stale memory maps.  Published as one (generation, plan)
        tuple once built, so the prefetch thread never reads a plan under
        another generation's key."""
        gen = getattr(self.cache, "generation", 0)
        cached = getattr(self, "_plan_cache", None)
        if cached is not None and cached[0] == gen:
            return cached[1]
        fps = self.cache.cfg.num_samples
        # pd.factorize's numbering: tracks in the order they first appear.
        numbering: Dict[str, int] = {}
        track_idx = np.empty(len(self.df), dtype=np.int64)
        for i, row in enumerate(self.df):
            key = f"{row['meeting_id']}/{row['chan_id']}"
            track_idx[i] = numbering.setdefault(key, len(numbering))
        tracks = []
        for key in numbering:
            meeting_id, chan_id = key.split("/", 1)
            tracks.append(self.cache.track(meeting_id, chan_id))
        first = np.round(self._column("sub_start") * fps).astype(np.int64)
        n = np.round(self._column("sub_duration") * fps).astype(np.int64)
        lens = np.asarray([t.shape[0] for t in tracks], dtype=np.int64)
        first = np.clip(first, 0, lens[track_idx])
        plan = {
            "track_idx": track_idx,
            "first": first,
            "n": n,
            "labels": self._column("label").astype(np.float32),
            "tracks": tracks,
            "lens": lens,
        }
        self._plan_cache = (gen, plan)
        return plan

    def _column(self, name: str) -> np.ndarray:
        return np.array([float(r[name]) for r in self.df], dtype=np.float64)

    def _assemble(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """The batch of rows ``idx``: the cut [first, first + n) clipped to
        the track and zero-padded on the right to the window, as
        ``example()`` cuts it."""
        plan = self._plan()
        w = self.window_frames
        nf = self.cache.cfg.num_filters
        out = np.zeros((len(idx), w, nf), dtype=np.float32)
        t_idx = plan["track_idx"][idx]
        first = plan["first"][idx]
        n = plan["n"][idx]
        cols = np.arange(w)
        for t in np.unique(t_idx):
            track = plan["tracks"][t]
            rows = np.nonzero(t_idx == t)[0]
            if track.shape[0] == 0:
                # A zero-frame track: example()'s windows are all zero, and
                # the clamped gather below would index -1.
                continue
            pos = first[rows][:, None] + cols[None, :]
            mask = (cols[None, :] < np.minimum(n[rows], w)[:, None]) & (pos < track.shape[0])
            gathered = np.asarray(track[np.minimum(pos, track.shape[0] - 1)], dtype=np.float32)
            out[rows] = np.where(mask[:, :, None], gathered, 0.0)
        return {
            "inputs": out,
            "input_lens": np.minimum(n, w).astype(np.int32),
            "is_laugh": plan["labels"][idx],
        }

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = False,
        prefetch: int = 2,
        skip_assembly: int = 0,
        local_rows: Optional[tuple] = None,
    ) -> Iterator[Optional[Dict[str, np.ndarray]]]:
        """One epoch of batches.  ``drop_remainder`` drops a partial last
        batch; ``prefetch`` > 0 assembles that many batches ahead on a
        background thread (an assembly error is raised to the consumer).

        ``skip_assembly`` = k (a mid-epoch resume): the first k batches
        were trained already, so k ``None`` placeholders stand for them
        and nothing is read for them.

        ``local_rows=(process_id, num_processes)`` (multi-process training):
        every process computes the same seeded global batch order and
        assembles only its contiguous ``batch_size / num_processes`` rows
        of each batch, in process order, which is how the data-parallel
        step splits the global batch.  Requires ``drop_remainder`` and
        ``num_processes | batch_size``."""
        slices = _epoch_slices(len(self.df), batch_size, shuffle, seed, drop_remainder)
        if local_rows is not None:
            pid, nproc = int(local_rows[0]), int(local_rows[1])
            if not 0 <= pid < nproc:
                raise ValueError(f"local_rows: bad process id {pid}/{nproc}")
            if nproc > 1:
                if not drop_remainder:
                    raise ValueError(
                        "local_rows needs drop_remainder=True: a ragged tail "
                        "batch cannot split evenly across processes")
                if batch_size % nproc:
                    raise ValueError(
                        f"local_rows: batch_size {batch_size} not divisible "
                        f"by num_processes {nproc}")
                k = batch_size // nproc
                slices = [s[pid * k:(pid + 1) * k] for s in slices]
        if skip_assembly:
            k = min(skip_assembly, len(slices))
            for _ in range(k):
                yield None
            slices = slices[k:]

        if prefetch <= 0:
            for idx in slices:
                yield self._assemble(idx)
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """A put that gives up once the consumer is gone (a plain put
            could block for ever on a full queue)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idx in slices:
                    if stop.is_set():
                        return
                    if not put(self._assemble(idx)):
                        return
            except BaseException as e:  # handed to the consumer
                put(e)
            finally:
                put(None)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # Unblock a worker waiting on a full queue, then reap it.
            while not q.empty():
                q.get_nowait()
            th.join(timeout=5)


def _epoch_slices(n: int, batch_size: int, shuffle: bool, seed: int, drop_remainder: bool):
    """One epoch's batch index slices: a seeded permutation cut into
    consecutive slices.  The one source of batch order for both datasets,
    which makes streamed and resident epochs the same run."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    slices = [order[lo : lo + batch_size] for lo in range(0, n, batch_size)]
    if drop_remainder and slices and len(slices[-1]) < batch_size:
        slices.pop()
    return slices


def resolve_transfer_dtype(transfer_dtype):
    """(torch dtype, itemsize) for a transfer_dtype flag: the one accepted
    set, shared by the resident dataset and its memory estimate; a typo
    fails here rather than storing float32 at twice the planned size."""
    if transfer_dtype == "bfloat16":
        return torch.bfloat16, 2
    if transfer_dtype is None or transfer_dtype == "float32":
        return torch.float32, 4
    raise ValueError(
        f"unknown transfer_dtype {transfer_dtype!r}; use 'bfloat16' or 'float32'/None")


class ResidentLadDataset:
    """The whole split resident in device memory; a batch is a gather on the
    device.

    The features ``[N, W, F]`` (float32, or bfloat16 at half the bytes),
    lengths and labels are uploaded once; each step sends only its row
    indices, and ``gather`` selects the rows on the device and casts them to
    float32.  The batch order is ``LadDataset.batches``'s.  No reference
    analogue: the reference re-reads its feature files in the train loop.

    ``sharding=(process_id, num_processes)`` (multi-process training, over
    the default process group) keeps only this process's block of rows
    (``parallel.mesh.row_block``) of the split zero-padded to a multiple of
    ``pad_rows_to`` (the process count): each process assembles and
    uploads its own share.  Padded rows are never indexed.  A gather is
    then a collective: every process fills the batch rows it holds into a
    zeroed buffer, and one sum ``all_reduce`` gives every process the whole
    batch (B x (W x F + 2) float32: 18 MB at B = 1024).
    """

    def __init__(
        self,
        dataset: LadDataset,
        transfer_dtype: Optional[str] = None,
        assemble_chunk: int = 8192,
        sharding: Optional[Tuple[int, int]] = None,
        pad_rows_to: int = 1,
        device: Union[None, str, torch.device] = None,
    ):
        from laughter_detection_icsi_tpu_torch.inference import resolve_device
        from laughter_detection_icsi_tpu_torch.parallel.mesh import row_block

        self.dataset = dataset
        self.device = resolve_device(device)
        n = len(dataset)
        n_pad = -(-max(n, 1) // pad_rows_to) * pad_rows_to
        w = dataset.window_frames
        nf = dataset.cache.cfg.num_filters
        dtype, _ = resolve_transfer_dtype(transfer_dtype)
        self.world = 1 if sharding is None else int(sharding[1])
        self.row_lo, self.row_hi = (0, n_pad) if sharding is None else row_block(
            n_pad, int(sharding[0]), self.world)
        rows = self.row_hi - self.row_lo
        feats = torch.zeros((rows, w, nf), dtype=dtype)
        lens = np.zeros(rows, dtype=np.int32)
        labels = np.zeros(rows, dtype=np.float32)
        for lo in range(self.row_lo, min(self.row_hi, n), assemble_chunk):
            idx = np.arange(lo, min(lo + assemble_chunk, self.row_hi, n))
            batch = dataset._assemble(idx)
            at = slice(lo - self.row_lo, lo - self.row_lo + len(idx))
            feats[at] = torch.from_numpy(batch["inputs"]).to(dtype)
            lens[at] = batch["input_lens"]
            labels[at] = batch["is_laugh"]
        # One upload of this process's rows.
        self.feats = feats.to(self.device)
        self.lens = torch.from_numpy(lens).to(self.device)
        self.labels = torch.from_numpy(labels).to(self.device)

    def gather(self, idx):
        """(inputs [B, W, F] float32, lens [B], labels [B]) of rows ``idx``,
        selected on the device; sharded, a collective every process of the
        group calls with the same ``idx``."""
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.asarray(idx, dtype=np.int64))
        idx = idx.to(self.device, torch.int64)
        if self.world == 1:
            return (self.feats.index_select(0, idx).float(), self.lens.index_select(0, idx),
                    self.labels.index_select(0, idx))
        import torch.distributed as dist

        # The rows this process holds, selected without a host sync: the
        # others read row 0 and are zeroed.
        own = (idx >= self.row_lo) & (idx < self.row_hi)
        local = torch.where(own, idx - self.row_lo, 0)
        b = idx.shape[0]
        feats = torch.where(own[:, None, None], self.feats.index_select(0, local).float(), 0.0)
        flat = torch.cat([
            feats.reshape(-1),
            torch.where(own, self.lens.index_select(0, local), 0).float(),
            torch.where(own, self.labels.index_select(0, local), 0.0),
        ])
        dist.all_reduce(flat)
        feats, lens, labels = flat.split([feats.numel(), b, b])
        return feats.view(b, *self.feats.shape[1:]), lens.to(self.lens.dtype), labels

    @staticmethod
    def estimated_nbytes(dataset: LadDataset, transfer_dtype: Optional[str] = None) -> int:
        """Device bytes of the features before building the dataset."""
        _, itemsize = resolve_transfer_dtype(transfer_dtype)
        return len(dataset) * dataset.window_frames * dataset.cache.cfg.num_filters * itemsize

    def __len__(self) -> int:
        return len(self.dataset)

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_remainder: bool = False) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch of device batches in ``LadDataset.batches``'s order."""
        for idx in _epoch_slices(len(self.dataset), batch_size, shuffle, seed, drop_remainder):
            x, lens, labels = self.gather(idx)
            yield {"inputs": x, "input_lens": lens, "is_laugh": labels}

    def index_batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                      drop_remainder: bool = False) -> Iterator[Dict[str, object]]:
        """Like :meth:`batches`, but {'resident', 'idx'} markers that the
        train loop turns into a gather and a step
        (``Trainer.train_batch_resident``), or K steps from one call."""
        for idx in _epoch_slices(len(self.dataset), batch_size, shuffle, seed, drop_remainder):
            yield {"resident": self, "idx": idx}


def load_split_df(data_dfs_dir: str, split: str) -> List[Dict[str, Any]]:
    """The rows of ``<dir>/<split>_df.csv`` (reference load_data.py:12-18)
    as ``pandas.read_csv`` types them: the float columns as floats,
    ``label`` as an int ('1') or a float ('1.0'), the ids as text."""
    with open(os.path.join(data_dfs_dir, f"{split}_df.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        for k in FLOAT_COLS:
            r[k] = float(r[k])
        label = r["label"]
        r["label"] = int(label) if label.lstrip("-").isdigit() else float(label)
    return rows
