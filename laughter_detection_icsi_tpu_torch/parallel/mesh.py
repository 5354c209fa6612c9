"""The devices a process drives, and the partition of a global batch over them.

The port of the JAX package's ``parallel/mesh.py``.  JAX's 1-D ``data``
mesh (``make_mesh()``: every local chip of a lone process, or every chip
of a ``jax.distributed`` job) places contiguous blocks of a row-sharded
array on its devices in process order.  Here a process drives the list of
devices :func:`local_devices` gives, and there are ``world size x
len(devices)`` shards: process ``rank`` holds the consecutive blocks
``rank*L .. rank*L+L-1`` (:func:`local_row_blocks`), one a device, with
the parameters replicated.  Training keeps one device a process (one
process a card under torchrun).  No mesh object is needed: a shard's rows
follow from its index and the shard count.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def world() -> Tuple[int, int]:
    """(rank, world size) of this process in the default process group;
    (0, 1) when no process group is up."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def row_block(n_rows: int, rank: int, world_size: int) -> Tuple[int, int]:
    """[lo, hi) rows of an ``n_rows`` global batch that process ``rank``
    of ``world_size`` holds: contiguous blocks of ``n_rows / world_size``,
    in rank order (JAX ``addressable_row_block`` on a 1-D mesh of one
    device per process)."""
    if not 0 <= rank < world_size:
        raise ValueError(f"bad process id {rank}/{world_size}")
    if n_rows % world_size:
        raise ValueError(f"leading dim {n_rows} not divisible by mesh size {world_size}")
    k = n_rows // world_size
    return rank * k, (rank + 1) * k


def local_row_blocks(n_rows: int, rank: int, world_size: int,
                     n_local: int) -> List[Tuple[int, int]]:
    """[lo, hi) rows of an ``n_rows`` global batch on each of process
    ``rank``'s ``n_local`` devices: shard ``rank * n_local + j`` of
    ``world_size * n_local`` for device ``j``.  Together they are the
    process's :func:`row_block` of ``world_size``, in device order."""
    if n_local < 1:
        raise ValueError(f"a process drives at least one device, got {n_local}")
    if not 0 <= rank < world_size:
        raise ValueError(f"bad process id {rank}/{world_size}")
    n = world_size * n_local
    return [row_block(n_rows, rank * n_local + j, n) for j in range(n_local)]


def own_card(rank: int, count: int) -> int:
    """The card a process of a group takes: ``LOCAL_RANK`` (torchrun's, or
    the rank where it is unset) modulo the visible card count."""
    return int(os.environ.get("LOCAL_RANK", rank)) % count


def local_devices(spec: str = "cuda", count: Optional[int] = None) -> List[torch.device]:
    """The devices this process drives, from a ``--device`` value:

    - ``"cuda"``: every visible card (``cuda:0 .. cuda:n-1``) in a lone
      process, as ``make_mesh()`` takes ``jax.devices()``; inside a
      ``torch.distributed`` group, this process's own card
      (:func:`own_card`, as ``distributed.initialize`` picks it);
    - ``"cuda:K"``: that card; ``"cpu"``: the CPU;
    - a comma list (``"cuda:0,cuda:1"``, ``"cuda:0,cuda:0"``,
      ``"cpu,cpu"``): those devices, repeats allowed (two shards of one
      card), all of one type; not inside a group, where each process
      drives one device.

    ``count`` is the visible card count (default
    ``torch.cuda.device_count()``).  A card index past it raises, as
    ``make_mesh`` does past ``jax.devices()``, and so does ``cuda`` with no
    card."""
    names = [s.strip() for s in spec.split(",")]
    if not all(names):
        raise ValueError(f"--device {spec!r}: an empty entry")
    devs = [torch.device(n) for n in names]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"--device {spec!r}: shards must be all cuda or all cpu")
    in_group = dist.is_available() and dist.is_initialized()
    if len(devs) > 1 and (in_group or any(d.type == "cuda" and d.index is None for d in devs)):
        raise ValueError(
            f"--device {spec!r}: a list names one process's shards, each card "
            "with its index (cuda:K), and only outside a process group, where "
            "each process drives its own device")
    if devs[0].type != "cuda":
        return devs
    if count is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 1:
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass --device cpu to run on the CPU")
    if devs[0].index is None:
        if in_group:
            return [torch.device("cuda", own_card(dist.get_rank(), count))]
        return [torch.device("cuda", k) for k in range(count)]
    for d in devs:
        if d.index >= count:
            raise ValueError(f"--device {spec!r}: asked for {d}, only {count} cards visible")
    return devs


def shard_batch(batch: Any, rank: int, world_size: int) -> Any:
    """This process's rows of a global batch: each array or tensor leaf of
    a dict (or a bare leaf) cut to :func:`row_block` of its leading dim;
    scalars pass whole.  In JAX ``shard_batch`` places the global batch on
    the mesh and ``shard_local_batch`` assembles it from each process's
    rows; here a process only ever holds its own rows, which is what both
    leave on its devices."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world_size) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        leaf = batch
    else:
        leaf = np.asarray(batch)
    if leaf.ndim == 0:
        return leaf
    lo, hi = row_block(leaf.shape[0], rank, world_size)
    return leaf[lo:hi]
