"""Multi-process runs on ``torch.distributed``.

The port of the JAX package's ``parallel/distributed.py``: where JAX joins
the pod runtime with ``jax.distributed.initialize``, each process here
joins a ``torch.distributed`` process group, with one device per process
(``cuda:{LOCAL_RANK % device_count}``, or the CPU).  Device tensors cross
processes only through ``all_reduce`` and ``broadcast`` on the default
group: NCCL between cards, Gloo on the CPU, or Gloo for processes that
share one card (``--cpu_collectives gloo``: NCCL refuses two processes on
one device, and Gloo stages CUDA tensors through the host).  Host-side
agreement (preemption votes, digests, barriers) goes over a CPU Gloo group
(:func:`cpu_group`).

Processes find each other through ``--coordinator_address host:port``
(a ``tcp://`` rendezvous; a ``file://`` URL is taken as it is), or, with
bare ``--distributed``, through torchrun's ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``), the counterpart of JAX's
autodetection.  ``tests/test_torch_distributed.py`` runs two processes
over Gloo on the CPU; ``chip_smoke.py`` phase 14 runs one over NCCL and
two sharing the card over Gloo.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

#: How long a collective waits for the other processes before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)

_cpu_group = None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_collectives: Optional[str] = None,
    device: str = "cuda",
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> torch.device:
    """Join the process group and return this process's device.

    With ``coordinator_address`` the rendezvous is ``tcp://host:port`` (or
    the URL given) with ``num_processes`` and ``process_id``; without it,
    torchrun's environment (``env://``).  The backend is NCCL when the
    processes run on ``cuda``, Gloo on the CPU or when ``cpu_collectives``
    is ``'gloo'``.  A ``cuda`` device without an index becomes
    ``cuda:{LOCAL_RANK % device_count}`` (the rank when ``LOCAL_RANK`` is
    unset) and the current device.  NCCL with two processes on one card
    raises on every process, naming ``--cpu_collectives gloo``."""
    global _cpu_group
    if cpu_collectives == "mpi" and not dist.is_mpi_available():
        raise RuntimeError(
            "--cpu_collectives mpi: this torch build has no MPI backend; "
            "use --cpu_collectives gloo")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    if cpu_collectives in ("gloo", "mpi"):
        backend = cpu_collectives
    else:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kwargs)
    rank = dist.get_rank()
    if dev.type == "cuda" and dev.index is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _cpu_group = None if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    places: List[Optional[tuple]] = [None] * dist.get_world_size()
    dist.all_gather_object(places, (socket.gethostname(), str(dev)), group=_cpu_group)
    if backend == "nccl" and len(set(places)) < len(places):
        dist.destroy_process_group()
        _cpu_group = None
        raise RuntimeError(
            f"NCCL takes one process per card, and these processes share one: "
            f"{places}; pass --cpu_collectives gloo to run them on one card over Gloo")
    return dev


def add_cli_args(parser) -> None:
    """The multi-process flags of every CLI (train, sweep), as JAX's."""
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="multi-process: join the process group from torchrun's "
        "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); use the "
        "explicit flags below without torchrun",
    )
    parser.add_argument(
        "--coordinator_address",
        type=str,
        default=None,
        help="multi-process: the rendezvous host:port (tcp://), or a "
        "file:// URL on storage every process sees",
    )
    parser.add_argument(
        "--num_processes",
        type=int,
        default=None,
        help="multi-process: world size (omit under torchrun)",
    )
    parser.add_argument(
        "--process_id", type=int, default=None,
        help="multi-process: this process's rank",
    )
    parser.add_argument(
        "--cpu_collectives",
        type=str,
        default=None,
        choices=("gloo", "mpi"),
        help="multi-process: collectives through the host: 'gloo' runs "
        "several processes on one card (NCCL takes one process a card) "
        "and is the backend on the CPU anyway",
    )


def initialize_from_args(args, parser) -> bool:
    """Validate the :func:`add_cli_args` flags and join the process group
    on ``args.device``.  Returns True when it was joined.  Call it straight
    after ``parse_args``.  Errors go through ``parser.error``, as JAX's:

    - --num_processes/--process_id need --coordinator_address;
    - --cpu_collectives alone is refused: it acts only when the group is
      joined, so accepting it would leave the user believing it acted;
    - bare --distributed reads torchrun's environment."""
    explicit = args.coordinator_address is not None or args.process_id is not None
    if (args.num_processes is not None or args.process_id is not None) \
            and args.coordinator_address is None:
        parser.error("--num_processes/--process_id require --coordinator_address")
    if args.cpu_collectives is not None and not (explicit or args.distributed):
        parser.error(
            "--cpu_collectives has no effect without --coordinator_address "
            "or --distributed (the process group is never joined)"
        )
    if not (explicit or args.distributed):
        return False
    initialize(
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
        cpu_collectives=args.cpu_collectives,
        device=getattr(args, "device", "cuda"),
    )
    print(process_info(), flush=True)
    return True


def is_multi_process() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def is_coordinator() -> bool:
    """Rank 0, or a run of one process."""
    return not is_multi_process() or dist.get_rank() == 0


def cpu_group():
    """The group for host-side agreement: Gloo over the CPU (the default
    group when its backend is Gloo)."""
    global _cpu_group
    if dist.get_backend() == "gloo":
        return None
    if _cpu_group is None:
        _cpu_group = dist.new_group(backend="gloo")
    return _cpu_group


def barrier() -> None:
    """Wait for every process (no-op in a run of one)."""
    if is_multi_process():
        dist.barrier(group=cpu_group())


def all_gather_object(obj) -> list:
    """Every process's ``obj``, in rank order ([obj] in a run of one)."""
    if not is_multi_process():
        return [obj]
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=cpu_group())
    return out


def make_preemption_sync():
    """A ``TrainLoop.sync_preempt`` hook: processes agree on preemption.

    SIGTERM lands on one process; if it alone stopped at a step boundary
    while the others entered the next step's collectives, they would wait
    for it until the group's timeout.  The hook MAX-reduces each process's
    local flag over the CPU group, so every process sees the stop at the
    same step boundary.  One host round trip a vote, which is why TrainLoop
    votes every ``preempt_vote_every`` steps.  Identity in a run of one."""
    if not is_multi_process():
        return lambda flag: flag
    group = cpu_group()

    def sync(flag: bool) -> bool:
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t.item())

    return sync


def broadcast_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite ``tensors`` in place with process 0's values: one
    broadcast a dtype, of the tensors flattened into one buffer.  Every
    process passes tensors of the same shapes, dtypes and order."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, 0)
            for t, piece in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(piece.view_as(t))


def sync_resume(loop, opt_state):
    """Align a multi-process resume on the coordinator's checkpoint.

    Each process resumes from its own ``checkpoint_dir``; where only the
    coordinator's disk holds a checkpoint (it is the one writer), the
    others would enter the epoch loop at other steps.  This broadcasts
    process 0's parameters, BatchNorm buffers, Adam ``step`` / ``mu`` /
    ``nu`` (in place) and the loop's ``epoch`` / ``global_step`` /
    ``epoch_step`` / ``best_val_loss``.  Returns the Adam state to train
    with; identity in a run of one."""
    if not is_multi_process():
        return opt_state
    model = loop.trainer.model
    # The moments in the parameters' order: a state read from a checkpoint
    # holds them in another.
    names = [n for n, _ in model.named_parameters()]
    broadcast_tensors([*model.parameters(), *model.buffers(), opt_state.step,
                       *(opt_state.mu[n] for n in names), *(opt_state.nu[n] for n in names)])
    counters = [loop.epoch, loop.global_step, loop.epoch_step, loop.best_val_loss]
    dist.broadcast_object_list(counters, 0, group=cpu_group())
    loop.epoch, loop.global_step, loop.epoch_step = (int(c) for c in counters[:3])
    loop.best_val_loss = float(counters[3])
    return opt_state


def process_info() -> str:
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return f"process {rank}/{world}, 1 local of {world} global devices ({backend})"
