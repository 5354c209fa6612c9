"""Checkpoints for the port: the JAX package's native ``*.ckpt.npz`` format
and the reference's ``.pth.tar``, both read into a torch ``state_dict``.

The JAX package keeps parameters in torch's names and shapes (conv OIHW,
linear [out, in], BatchNorm running stats as buffers), so crossing over is
a re-keying: nested ``(params, state)`` trees flatten to dotted keys —
exactly the keys of the port's modules (models/zoo.py) — and
``num_batches_tracked`` widens from int32 to torch's int64.

The native format is a flat ``np.savez``: ``params/<key>``, ``state/<key>``
and ``opt/<key>`` arrays (the Adam state: ``opt/step``, ``opt/mu.<key>``,
``opt/nu.<key>``) plus a JSON ``__meta__`` blob with the training counters
(format_version 1).  Either package resumes the other's checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from laughter_detection_icsi_tpu_torch.train.optim import AdamState

LAST_NAME = "last.ckpt.npz"
BEST_NAME = "best.ckpt.npz"


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict tree to torch-style dotted keys (a flat dict of
    dotted keys passes through unchanged).  Empty subtrees vanish."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten_tree(tree[k], f"{prefix}.{k}" if prefix else str(k)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def state_dict_from_jax(params: Any, state: Any) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` trees (numpy or array leaves) -> a state dict
    for ``load_state_dict(strict=True)``: parameters as float32,
    ``num_batches_tracked`` as int64, other buffers as stored."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in {**flatten_tree(params), **flatten_tree(state)}.items():
        if key.endswith("num_batches_tracked"):
            arr = arr.astype(np.int64)
        else:
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(arr, copy=True))
    return out


def opt_state_from_jax(opt: Any) -> AdamState:
    """A JAX ``AdamState`` (or the ``{'step', 'mu', 'nu'}`` tree its
    checkpoints hold; numpy or array leaves) -> the port's, on the CPU."""
    get = opt.get if isinstance(opt, dict) else lambda k: getattr(opt, k)
    moments = lambda tree: {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
                            for k, v in flatten_tree(tree).items()}
    return AdamState(step=torch.tensor(int(np.asarray(get("step"))), dtype=torch.int32),
                     mu=moments(get("mu")), nu=moments(get("nu")))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a native ``*.ckpt.npz`` or a reference ``.pth.tar`` (detected by
    suffix) into {'state_dict', 'opt_state' (an :class:`AdamState` on the
    CPU, or None), 'epoch', 'global_step', 'best_val_loss', 'epoch_step'}."""
    if str(path).endswith((".pth.tar", ".pth", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return {
            "state_dict": state_dict_from_jax(
                {k: v.detach().numpy() for k, v in ckpt["state_dict"].items()}, {}
            ),
            "opt_state": None,
            "epoch": ckpt.get("epoch"),
            "global_step": ckpt.get("global_step"),
            "best_val_loss": ckpt.get("best_val_loss"),
            "epoch_step": 0,
        }
    trees: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "state": {}, "opt": {}}
    try:
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            for key in data.files:
                if key != "__meta__":
                    prefix, _, rest = key.partition("/")
                    trees[prefix][rest] = data[key]
    except FileNotFoundError:
        raise
    except (ValueError, OSError, EOFError, KeyError, zipfile.BadZipFile) as e:
        raise ValueError(
            f"{path}: corrupt or unreadable checkpoint ({e}); writes are atomic, "
            "so a stale .tmp sibling may hold a partial save"
        ) from e
    version = meta.get("format_version", 1)
    if version != 1:
        raise ValueError(
            f"{path}: unsupported checkpoint format_version {version} "
            "(this build reads version 1)"
        )
    missing = [k for k in ("epoch", "global_step", "best_val_loss") if k not in meta]
    if missing:
        raise ValueError(f"{path}: checkpoint meta missing keys {missing}")
    opt = trees["opt"]
    opt_state = None
    if "step" in opt:  # an Adam state (another optimizer's tree is not read)
        opt_state = opt_state_from_jax({
            "step": opt["step"],
            "mu": {k[3:]: v for k, v in opt.items() if k.startswith("mu.")},
            "nu": {k[3:]: v for k, v in opt.items() if k.startswith("nu.")},
        })
    return {
        "state_dict": state_dict_from_jax(trees["params"], trees["state"]),
        "opt_state": opt_state,
        "epoch": meta["epoch"],
        "global_step": meta["global_step"],
        "best_val_loss": meta["best_val_loss"],
        "epoch_step": meta.get("epoch_step", 0),
    }


def save_checkpoint(checkpoint_dir: str, state_dict: Dict[str, torch.Tensor],
                    opt_state: Optional[AdamState] = None, epoch: int = 0,
                    global_step: int = 0, best_val_loss: float = float("inf"),
                    is_best: bool = False, epoch_step: int = 0) -> str:
    """Write ``last.ckpt.npz`` in the native format (buffers under
    ``state/``, ``num_batches_tracked`` as int32, everything else under
    ``params/``, the Adam state under ``opt/``), which the JAX package's
    ``load_checkpoint`` reads too; with ``is_best`` also ``best.ckpt.npz``.
    ``epoch_step`` is the batches already trained in the current epoch,
    which a resume skips.  Returns the path of ``last``."""
    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy()
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            arrays[f"state/{key}"] = arr.astype(np.int32)
        elif leaf in ("running_mean", "running_var"):
            arrays[f"state/{key}"] = arr
        else:
            arrays[f"params/{key}"] = arr
    if opt_state is not None:
        arrays["opt/step"] = np.asarray(int(opt_state.step), dtype=np.int32)
        for name, moments in (("mu", opt_state.mu), ("nu", opt_state.nu)):
            for key, val in moments.items():
                arrays[f"opt/{name}.{key}"] = val.detach().cpu().numpy()
    meta = {"epoch": int(epoch), "global_step": int(global_step),
            "best_val_loss": float(best_val_loss), "epoch_step": int(epoch_step),
            "format_version": 1}
    path = ckpt_dir / LAST_NAME
    # Process-unique name: two writers to one directory (a stale job and
    # its requeued successor) must not interleave into one file.
    tmp = ckpt_dir / (LAST_NAME + f".tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
        f.flush()
        os.fsync(f.fileno())  # the data reaches the disk before the rename
    if is_best:
        # Published before ``last``, which records the new best_val_loss: a
        # kill between the two renames then leaves best no older than last
        # says it is.
        best_tmp = ckpt_dir / (BEST_NAME + f".tmp.{os.getpid()}")
        shutil.copyfile(tmp, best_tmp)
        with open(best_tmp, "rb+") as bf:
            os.fsync(bf.fileno())
        os.replace(best_tmp, ckpt_dir / BEST_NAME)
    os.replace(tmp, path)  # atomic: a crash never leaves half a checkpoint
    return str(path)


def find_resume_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The ``last`` checkpoint in ``checkpoint_dir`` (native first, then a
    reference ``.pth.tar``), or None."""
    return _find(checkpoint_dir, (LAST_NAME, "last.pth.tar"))


def find_best_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The ``best`` checkpoint in ``checkpoint_dir``, or None."""
    return _find(checkpoint_dir, (BEST_NAME, "best.pth.tar"))


def _find(checkpoint_dir: str, names) -> Optional[str]:
    for name in names:
        p = Path(checkpoint_dir) / name
        if p.is_file():
            return str(p)
    return None


def resolve_checkpoint(model_path: str) -> Optional[str]:
    """A checkpoint FILE as given, or the best checkpoint inside a directory,
    falling back (with a warning) to the last one — the JAX package's
    --model_path rule."""
    if os.path.isfile(model_path):
        return model_path
    best = find_best_checkpoint(model_path)
    if best is not None:
        return best
    last = find_resume_checkpoint(model_path)
    if last is not None:
        warnings.warn(f"no best checkpoint in {model_path}; falling back to {last}",
                      stacklevel=2)
    return last
