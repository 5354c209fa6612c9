"""The CLIs' one way from a ``--config`` preset name to its model: the name
checked against ``config.MODEL_MAP``, the preset's mode against the modes
the CLI runs, the model built at the preset's widths and, given a
checkpoint, its weights loaded strictly.  It lives here, not in
``config``: ``host_prep`` imports ``config`` and stays free of model
code."""

from typing import Optional, Sequence, Tuple

import torch

from laughter_detection_icsi_tpu_torch.config import MODEL_MAP, ModelPreset


class PresetError(SystemExit):
    """A ``--config`` the CLI cannot run.  A CLI that lets it through exits
    with its message (rc 1); ``cli/train`` turns it into ``parser.error``
    (rc 2)."""


def preset_for(name: str, cli: str, modes: Sequence[str]) -> ModelPreset:
    """``MODEL_MAP[name]``, refused (``PresetError``) when the name is
    unknown or the preset runs in a mode outside ``modes``, the modes that
    ``cli`` runs."""
    if name not in MODEL_MAP:
        raise PresetError(f"--config: unknown preset {name!r} (choose from {sorted(MODEL_MAP)})")
    preset = MODEL_MAP[name]
    if preset.mode not in modes:
        raise PresetError(
            f"--config {name}: {cli} runs mode {' or '.join(map(repr, modes))}, and this "
            f"preset ({preset.model}) runs in mode {preset.mode!r}"
        )
    return preset


def preset_model(name: str, cli: str, modes: Sequence[str], dropout_rate: float = 0.0,
                 seed: int = 0,
                 checkpoint: Optional[str] = None) -> Tuple[ModelPreset, torch.nn.Module]:
    """(preset, model): :func:`preset_for`'s preset and its model from
    ``zoo.build`` at the preset's widths, with ``checkpoint``'s weights
    (a file, or a directory's best checkpoint, else its last) when one
    is given."""
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib

    preset = preset_for(name, cli, modes)
    model = zoo.build(preset.model, dropout_rate=dropout_rate,
                      linear_layer_size=preset.linear_layer_size,
                      filter_sizes=preset.filter_sizes, seed=seed)
    if checkpoint is not None:
        found = ckpt_lib.resolve_checkpoint(checkpoint)
        if found is None:
            raise SystemExit(f"Model checkpoint not found at {checkpoint}")
        model.load_state_dict(ckpt_lib.load_checkpoint(found)["state_dict"], strict=True)
    return preset, model
