"""Serialized model export: ``torch.export`` artifacts.

The port of the JAX package's ``export.py``.  Where the JAX package lowers
a jitted function to versioned StableHLO, the port exports an
``ExportedProgram``: the weights and the computation in one file, which
``torch.export.load`` (or :func:`load` here) runs without the model's
source.  Two artifact kinds:

- **window classifier** — ``[B, 1, window, n_feats]`` float32 log-mel
  windows -> ``[B]`` float32 probabilities.  ``B`` may be symbolic (the
  default), so one artifact serves every batch size.
- **e2e bucket pipeline** — one bucket's PCM buffer (``[wave_len]`` int16
  or float32, plus the bucket's valid-frame count as a 0-d int32 tensor)
  -> per-10 ms-frame probabilities ``[bucket_frames]``: the int16 scaling,
  the fbank kernel (the custom op ``torch.ops.laughter_icsi_torch.fbank``,
  ops/fbank_cuda.py), the shared-stem windowing and the classifier in one
  graph.  It traces the live bucket body (``LaughterPipeline.
  bucket_body``), so its output equals ``LaughterPipeline.
  probs_for_waveform``'s; on the card the artifact launches the
  hand-written kernel.  The buffer is not the raw recording: build it with
  ``host_prep.bucket_inputs`` (numpy only).

An artifact holds its tensors on the device it was exported on
(``device=``, default ``cuda``).  Backend flags are process state, not part
of a program, so :func:`load` returns an :class:`Artifact` that runs the
program inside its precision's scope (``inference.precision_scope``):
TF32 off, and for bf16 cuBLAS's bf16 reductions in float32.  The custom
ops (the fbank's, and on the card the conv epilogue's that
``models/layers.conv_bn_act`` calls) are registered when this module is
imported, before any artifact loads.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
import threading
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from laughter_detection_icsi_tpu_torch.host_prep import bucket_inputs  # noqa: F401
from laughter_detection_icsi_tpu_torch.inference import (
    cast_model_bf16, compute_dtype, precision_scope, resolve_device, scale_pcm)
# Registers torch.ops.laughter_icsi_torch.fbank, which an e2e artifact calls:
# it must exist before torch.export.load reads one.
from laughter_detection_icsi_tpu_torch.ops import fbank_cuda  # noqa: F401

#: The extra file of an artifact that records how to run it.
META_NAME = "laughter_export.json"

# torch.export.save registers a process-wide pickler hook while it
# serializes and refuses to stack a second one: concurrent saves take
# turns here (the file writes that follow run in parallel).
_SERIALIZE = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Exported:
    """An exported program and what running it needs: its precision (the
    scope :class:`Artifact` runs it in) and the device its tensors are on."""

    program: torch.export.ExportedProgram
    precision: str
    device: str


class _WindowClassifier(nn.Module):
    def __init__(self, model: nn.Module, precision: str):
        super().__init__()
        self.model = model
        self.dtype = compute_dtype(precision)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.dtype)).float()


def export_window_classifier(
    model: nn.Module,
    *,
    window: int = 100,
    n_feats: int = 44,
    batch: Optional[int] = None,
    precision: str = "float32",
    device: Union[None, str, torch.device] = None,
) -> Exported:
    """Export ``[B, 1, window, n_feats] -> [B]`` eval-mode inference.

    ``batch=None`` exports a symbolic batch dimension; an int pins it.
    ``precision='bfloat16'`` exports a bf16 copy of the model (the artifact
    still takes float32 windows and returns float32 probabilities).  The
    caller's model is not changed."""
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}")
    dev = resolve_device(device)
    m = cast_model_bf16(model) if precision == "bfloat16" else copy.deepcopy(model)
    module = _WindowClassifier(m.to(dev).eval(), precision)
    example = torch.zeros((2 if batch is None else int(batch), 1, window, n_feats), device=dev)
    dynamic = {"x": {0: torch.export.Dim("b", min=1)}} if batch is None else None
    with torch.no_grad():
        program = torch.export.export(module, (example,), dynamic_shapes=dynamic)
    return Exported(program, precision, str(dev))


class _BucketBody(nn.Module):
    def __init__(self, pipeline):
        super().__init__()
        self.model = pipeline.model  # registered, so the export lifts its weights
        self.pipeline = pipeline

    def forward(self, wave: torch.Tensor, valid_frames: torch.Tensor) -> torch.Tensor:
        probs = self.pipeline.bucket_body(scale_pcm(wave), valid_frames)
        return probs[: self.pipeline.settings.bucket_frames]


def export_bucket_pipeline(pipeline, *, int16_in: bool = True):
    """Export one bucket of ``pipeline`` as a single graph on the
    pipeline's device, in its precision.

    Signature of the artifact: ``(wave [wave_len] int16|float32,
    valid_frames 0-d int32) -> probs [bucket_frames] float32``.  ``wave`` is
    one bucket's slice of the Kaldi-padded waveform, zero-filled to
    ``wave_len``: the buffers the live bucket loop builds, which
    ``host_prep.bucket_inputs`` yields with each bucket's ``valid`` and the
    count of leading rows that are its frames.  Returns ``(exported,
    wave_len)``."""
    if pipeline.settings.mode != "windows":
        # fused_conv runs another graph, not checkpoint parity; exporting
        # the windows body for such a pipeline would break the artifact ==
        # pipeline promise silently.
        raise ValueError(
            f"export_bucket_pipeline supports mode='windows' only "
            f"(pipeline has mode={pipeline.settings.mode!r})"
        )
    s = pipeline.settings
    dev = pipeline.device
    wave = torch.zeros(pipeline.wave_len, dtype=torch.int16 if int16_in else torch.float32,
                       device=dev)
    valid = torch.tensor(s.bucket_frames + s.window - 1, dtype=torch.int32, device=dev)
    with torch.no_grad():
        program = torch.export.export(_BucketBody(pipeline), (wave, valid))
    return Exported(program, s.precision, str(dev)), pipeline.wave_len


def save(exported: Exported, path: str) -> int:
    """Serialize an :class:`Exported` to ``path``; returns the byte count.
    Atomic and durable (a tmp name unique to the call, fsync, rename), so a
    crash mid-export never leaves a truncated artifact, and concurrent
    writers each publish a whole one (the last rename wins)."""
    buf = io.BytesIO()
    meta = json.dumps({"precision": exported.precision, "device": exported.device})
    with _SERIALIZE:
        torch.export.save(exported.program, buf, extra_files={META_NAME: meta})
    blob = buf.getvalue()
    tmp = f"{path}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(blob)


class Artifact:
    """A loaded artifact.  ``call(*args)`` runs the program under
    ``torch.inference_mode`` in its precision's scope; numpy inputs
    (``bucket_inputs``' buffers and counts) move to the artifact's device
    first."""

    def __init__(self, program: torch.export.ExportedProgram, precision: str, device: str):
        self.program = program
        self.precision = precision
        self.device = torch.device(device)
        self._module = program.module()

    def call(self, *args) -> torch.Tensor:
        args = [a if isinstance(a, torch.Tensor)
                else torch.as_tensor(np.asarray(a), device=self.device) for a in args]
        with torch.inference_mode(), precision_scope(self.precision):
            return self._module(*args)


def load(path: str) -> Artifact:
    """Deserialize an artifact file."""
    with open(path, "rb") as f:
        return load_bytes(f.read())


def load_bytes(blob: bytes) -> Artifact:
    """Deserialize an in-memory artifact."""
    extra = {META_NAME: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    meta = json.loads(extra[META_NAME])
    return Artifact(program, meta["precision"], meta["device"])
