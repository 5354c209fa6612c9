"""The CLIs' one way from ``--config`` to a model (``cli/presets.py``),
across its callers: an unknown preset, a missing checkpoint and a preset
in a mode the CLI does not run exit the same way from every CLI, and each
case checks that the CLI went through the seam (a CLI with its own copy of
the wiring fails it).  CPU, no model runs."""

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu_torch.cli import (export_model, parity, presets, segment_laughter,
                                                   serve, sweep)
from laughter_detection_icsi_tpu_torch.cli import train as train_cli
from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
from laughter_detection_icsi_tpu_torch.data import audio as audio_io
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt


@pytest.fixture
def seam(monkeypatch):
    """The CLI names the seam was called with, in call order: the
    functions are wrapped, and a CLI imports them when it runs."""
    calls = []
    preset_for, preset_model = presets.preset_for, presets.preset_model

    def spy_for(name, cli, modes):
        calls.append(cli)
        return preset_for(name, cli, modes)

    def spy_model(name, cli, modes, **kw):
        calls.append(("model", cli, kw.get("checkpoint")))
        return preset_model(name, cli, modes, **kw)

    monkeypatch.setattr(presets, "preset_for", spy_for)
    monkeypatch.setattr(presets, "preset_model", spy_model)
    return calls


@pytest.fixture
def dirs(tmp_path):
    """An audio root with one 16 kHz WAV, an empty goldens directory, an
    output path and a checkpoint path that holds nothing."""
    audio = tmp_path / "audio" / "M"
    audio.mkdir(parents=True)
    audio_io.write_wav(str(audio / "chan0.wav"), np.zeros(1600, np.float32), 16000)
    (tmp_path / "goldens").mkdir()
    return dict(audio=str(tmp_path / "audio"), goldens=str(tmp_path / "goldens"),
                out=str(tmp_path / "out"), nope=str(tmp_path / "nope"), root=str(tmp_path))


def _argv(cli, d, weights):
    """``cli``'s arguments up to the preset: ``weights`` is its
    ``--model_path`` (``--random_init`` where None and the CLI has it)."""
    model = ["--model_path", weights] if weights else ["--random_init"]
    return {
        "segment_laughter": [*model, "--device", "cpu"],
        "sweep": ["--audio_dir", d["audio"], "--output_dir", d["out"], *model,
                  "--device", "cpu"],
        "serve": ["--model_path", weights or d["nope"], "--device", "cpu"],
        "parity": ["--goldens", d["goldens"], "--audio_dir", d["audio"], "--device", "cpu",
                   *(["--model_path", weights] if weights else [])],
        "export_model": [*model, "--out", d["out"] + ".pt2", "--device", "cpu"],
        "train": ["--checkpoint_dir", d["out"], "--data_root", d["root"], "--device", "cpu"],
    }[cli]


MAINS = {"segment_laughter": segment_laughter.main, "sweep": sweep.main, "serve": serve.main,
         "parity": parity.main, "export_model": export_model.main, "train": train_cli.main}


@pytest.mark.parametrize("cli", sorted(MAINS))
def test_unknown_preset_exits_naming_the_choices(cli, dirs, seam, capsys):
    with pytest.raises(SystemExit) as e:
        MAINS[cli](_argv(cli, dirs, None) + ["--config", "resnet_bsae"])
    # cli/train exits through parser.error: rc 2, the message on stderr.
    if cli == "train":
        said = capsys.readouterr().err
        assert e.value.code == 2
    else:
        said = str(e.value)
    assert (f"--config: unknown preset 'resnet_bsae' (choose from {sorted(MODEL_MAP)})"
            in said)
    assert f"cli/{cli}" in seam, seam


@pytest.mark.parametrize("cli", ["export_model", "parity", "segment_laughter", "serve", "sweep"])
def test_missing_checkpoint_exits_not_found(cli, dirs, seam):
    with pytest.raises(SystemExit, match=f"Model checkpoint not found at {dirs['nope']}"):
        MAINS[cli](_argv(cli, dirs, dirs["nope"]))
    assert ("model", f"cli/{cli}", dirs["nope"]) in seam, seam


@pytest.mark.parametrize("cli", ["parity", "serve"])
def test_windows_clis_refuse_the_clips_preset(cli, dirs, seam):
    said = (fr"^--config ast_audioset: cli/{cli} runs mode 'windows', and this preset "
            r"\(AST\) runs in mode 'clips'$")
    with pytest.raises(SystemExit, match=said):
        MAINS[cli](_argv(cli, dirs, dirs["nope"]) + ["--config", "ast_audioset"])
    assert f"cli/{cli}" in seam, seam


def test_preset_model_builds_the_presets_widths_and_loads_strictly(tmp_path):
    preset = MODEL_MAP["resnet_with_augmentation"]  # not ResNetBigger's default widths
    got, model = presets.preset_model("resnet_with_augmentation", "cli/x", ("windows",),
                                      dropout_rate=0.25, seed=7)
    assert got is preset and model.dropout_rate == 0.25
    last_convs = [[m for m in stage.modules() if isinstance(m, torch.nn.Conv2d)][-1]
                  for stage in model.stages()]
    assert tuple(c.out_channels for c in last_convs) == preset.filter_sizes
    assert model.linear1.in_features == preset.linear_layer_size
    want = zoo.build(preset.model, dropout_rate=0.25, linear_layer_size=preset.linear_layer_size,
                     filter_sizes=preset.filter_sizes, seed=7).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())

    trained = zoo.build(preset.model, linear_layer_size=preset.linear_layer_size,
                        filter_sizes=preset.filter_sizes, seed=3).state_dict()
    ckpt.save_checkpoint(str(tmp_path / "ck"), trained, is_best=True)
    _, loaded = presets.preset_model("resnet_with_augmentation", "cli/x", ("windows",),
                                     checkpoint=str(tmp_path / "ck"))
    assert all(torch.equal(v, trained[k]) for k, v in loaded.state_dict().items())
    # Strict: a checkpoint short of one tensor is refused, not half loaded.
    short = {k: v for k, v in trained.items() if k != "linear2.bias"}
    ckpt.save_checkpoint(str(tmp_path / "short"), short, is_best=True)
    with pytest.raises(RuntimeError, match="linear2.bias"):
        presets.preset_model("resnet_with_augmentation", "cli/x", ("windows",),
                             checkpoint=str(tmp_path / "short"))
