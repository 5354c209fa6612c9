"""The partition of a global batch over the processes of a group.

The port of the JAX package's ``parallel/mesh.py`` for one device per
process: the JAX package's 1-D ``data`` mesh places contiguous blocks of a
row-sharded array on its devices in process order, and here each process
of a ``torch.distributed`` group holds one such block of every global
batch, on its own device, with the parameters replicated.  No mesh object
is needed: a process's rows follow from its rank and the world size.
"""

from __future__ import annotations

from typing import Any, Tuple

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
