"""Checkpoints for the port: the JAX package's native ``*.ckpt.npz`` format
and the reference's ``.pth.tar``, both read into a torch ``state_dict``.

The JAX package keeps parameters in torch's names and shapes (conv OIHW,
linear [out, in], BatchNorm running stats as buffers), so crossing over is
a re-keying: nested ``(params, state)`` trees flatten to dotted keys —
exactly the keys of the port's modules (models/zoo.py) — and
``num_batches_tracked`` widens from int32 to torch's int64.

The native format is a flat ``np.savez``: ``params/<key>``, ``state/<key>``
and ``opt/<key>`` arrays plus a JSON ``__meta__`` blob with the training
counters (format_version 1).  The port reads ``params/`` and ``state/`` and
ignores ``opt/`` (optimizer state is for training, a later slice).
"""

from __future__ import annotations

import json
import os
import warnings
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a native ``*.ckpt.npz`` or a reference ``.pth.tar`` (detected by
    suffix) into {'state_dict', 'epoch', 'global_step', 'best_val_loss'}."""
    if str(path).endswith((".pth.tar", ".pth", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return {
            "state_dict": state_dict_from_jax(
                {k: v.detach().numpy() for k, v in ckpt["state_dict"].items()}, {}
            ),
            "epoch": ckpt.get("epoch"),
            "global_step": ckpt.get("global_step"),
            "best_val_loss": ckpt.get("best_val_loss"),
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
        raise ValueError(f"{path}: corrupt or unreadable checkpoint ({e})") from e
    version = meta.get("format_version", 1)
    if version != 1:
        raise ValueError(
            f"{path}: unsupported checkpoint format_version {version} "
            "(this build reads version 1)"
        )
    return {
        "state_dict": state_dict_from_jax(trees["params"], trees["state"]),
        "epoch": meta.get("epoch"),
        "global_step": meta.get("global_step"),
        "best_val_loss": meta.get("best_val_loss"),
    }


def save_checkpoint(checkpoint_dir: str, state_dict: Dict[str, torch.Tensor],
                    epoch: int = 0, global_step: int = 0,
                    best_val_loss: float = float("inf")) -> str:
    """Write ``last.ckpt.npz`` in the native format (buffers under
    ``state/``, ``num_batches_tracked`` as int32, everything else under
    ``params/``), which the JAX package's ``load_checkpoint`` reads too."""
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
    meta = {"epoch": int(epoch), "global_step": int(global_step),
            "best_val_loss": float(best_val_loss), "epoch_step": 0,
            "format_version": 1}
    path = ckpt_dir / LAST_NAME
    tmp = ckpt_dir / (LAST_NAME + f".tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)
    return str(path)


def resolve_checkpoint(model_path: str) -> Optional[str]:
    """A checkpoint FILE as given, or the best checkpoint inside a directory,
    falling back (with a warning) to the last one — the JAX package's
    --model_path rule."""
    if os.path.isfile(model_path):
        return model_path
    for names, fallback in (((BEST_NAME, "best.pth.tar"), False),
                            ((LAST_NAME, "last.pth.tar"), True)):
        for name in names:
            p = Path(model_path) / name
            if p.is_file():
                if fallback:
                    warnings.warn(f"no best checkpoint in {model_path}; "
                                  f"falling back to {p}", stacklevel=2)
                return str(p)
    return None
