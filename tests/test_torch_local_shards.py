"""Which devices a process drives (parallel/mesh.local_devices, the twin of
JAX's make_mesh()) and how the channel rows split over them
(local_row_blocks) against JAX's 1-D mesh of every device.  The card
counts are injected, so the ``cuda`` cases run on the CPU."""

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.parallel.mesh import data_sharding, make_mesh
from laughter_detection_icsi_tpu_torch.parallel import mesh

cuda = lambda k: torch.device("cuda", k)


@pytest.mark.parametrize("spec, count, want", [
    ("cuda", 4, [cuda(0), cuda(1), cuda(2), cuda(3)]),
    ("cuda", 1, [cuda(0)]),
    ("cuda:2", 4, [cuda(2)]),
    ("cuda:0,cuda:1", 2, [cuda(0), cuda(1)]),
    ("cuda:0, cuda:0", 1, [cuda(0), cuda(0)]),
    ("cpu", 0, [torch.device("cpu")]),
    ("cpu,cpu,cpu", 0, [torch.device("cpu")] * 3),
])
def test_local_devices(spec, count, want):
    assert mesh.local_devices(spec, count=count) == want


@pytest.mark.parametrize("spec, count, error, match", [
    ("cuda:4", 4, ValueError, "only 4 cards"),
    ("cuda:0,cuda:2", 2, ValueError, "only 2 cards"),
    ("cuda", 0, RuntimeError, "CUDA is not available"),
    ("cuda:0", 0, RuntimeError, "CUDA is not available"),
    ("cuda,cuda", 2, ValueError, "with its index"),
    ("cuda:0,cpu", 1, ValueError, "all cuda or all cpu"),
    ("cpu,", 0, ValueError, "empty entry"),
])
def test_local_devices_refuses(spec, count, error, match):
    with pytest.raises(error, match=match):
        mesh.local_devices(spec, count=count)


def test_local_devices_in_a_process_group(monkeypatch):
    """Inside a group ``cuda`` is the process's own card, as
    distributed.initialize picks it, and a list is refused."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 5)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mesh.local_devices("cuda", count=4) == [cuda(1)]
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert mesh.local_devices("cuda", count=4) == [cuda(2)]
    assert mesh.local_devices("cuda:3", count=4) == [cuda(3)]
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="only outside a process group"):
        mesh.local_devices("cpu,cpu")


@pytest.mark.parametrize("world, n_local", [(1, 2), (1, 3), (2, 2), (2, 4)])
def test_local_row_blocks_are_jaxs_device_blocks(world, n_local):
    """Process ``rank`` of ``world``, ``n_local`` devices each: its blocks
    are the rows JAX's mesh over all ``world * n_local`` devices places on
    devices ``rank * n_local ..``, and together its row_block."""
    n = world * n_local
    devices = list(make_mesh(n).devices.flat)
    for c in (1, 3, 5, 8):
        c_pad = -(-c // n) * n
        index_map = data_sharding(make_mesh(n)).devices_indices_map((c_pad, 1))
        for rank in range(world):
            blocks = mesh.local_row_blocks(c_pad, rank, world, n_local)
            want = [index_map[devices[rank * n_local + j]][0] for j in range(n_local)]
            assert blocks == [(s.start or 0, c_pad if s.stop is None else s.stop) for s in want]
            assert (blocks[0][0], blocks[-1][1]) == mesh.row_block(c_pad, rank, world)
    with pytest.raises(ValueError, match="at least one device"):
        mesh.local_row_blocks(4, 0, 1, 0)
    rows = np.arange(8)
    assert [rows[a:b].tolist() for a, b in mesh.local_row_blocks(8, 1, 2, 2)] == [[4, 5], [6, 7]]


def test_cli_device_lists_are_checked():
    """serve refuses a mixed list before loading a model, and a device list
    under a process group's flags is refused before the group is joined."""
    import argparse

    from laughter_detection_icsi_tpu_torch.cli import serve
    from laughter_detection_icsi_tpu_torch.parallel import distributed

    with pytest.raises(SystemExit, match="all cuda or all cpu"):
        serve.main(["--model_path", "/nonexistent", "--channels", "2", "--device", "cuda:0,cpu"])
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    distributed.add_cli_args(parser)
    args = parser.parse_args(["--device", "cpu,cpu", "--coordinator_address", "127.0.0.1:1",
                              "--num_processes", "2", "--process_id", "0"])
    with pytest.raises(SystemExit):
        distributed.initialize_from_args(args, parser)
    assert not torch.distributed.is_initialized()
