"""Import contract of the PyTorch port: it (and chip_smoke.py, the
multi-process tests' worker tests/fixtures/torch_dist_worker.py, the parity
drill's inputs tests/fixtures/parity_inputs.py and the examples
examples/*_torch.py) imports neither JAX nor the JAX package, nor pandas,
lxml or ml_dtypes (the card's machine has none of them), checked in a
fresh interpreter (this test process has JAX loaded by conftest) and by
reading the sources.  Importing the port loads no matplotlib either: the
plots import it when they draw."""

import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "laughter_detection_icsi_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, runpy, sys
import laughter_detection_icsi_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
runpy.run_path("chip_smoke.py", run_name="chip_smoke_probe")  # defines, runs nothing
importlib.import_module("tests.fixtures.torch_dist_worker")  # defines, runs nothing
importlib.import_module("tests.fixtures.parity_inputs")
for example in ("examples/demo_torch.py", "examples/streaming_demo_torch.py"):
    runpy.run_path(example, run_name="example_probe")  # defines, runs nothing
from laughter_detection_icsi_tpu_torch.cli import (
    analyse, compute_features, convert_checkpoint, create_data_df, export_model,
    laughs_to_wav, parity, probe_audio_loading, segment_laughter, serve, sweep, train,
    visualise)
for cli in (segment_laughter, serve, sweep, analyse, create_data_df, compute_features, train,
            export_model, convert_checkpoint, parity, laughs_to_wav, probe_audio_loading,
            visualise):
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
FORBIDDEN = ("jax", "laughter_detection_icsi_tpu", "pandas", "lxml", "ml_dtypes")
bad = sorted(m for m in sys.modules
             if m in FORBIDDEN or m.startswith(tuple(f + "." for f in FORBIDDEN)))
print("MODULES", len(names))
print("NAMES", " ".join(names))
print("BAD", bad)
print("MATPLOTLIB", sorted(m for m in sys.modules if m.split(".")[0] == "matplotlib"))
"""


def test_port_never_imports_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "MATPLOTLIB []" in out.stdout, out.stdout
    n = int(re.search(r"MODULES (\d+)", out.stdout).group(1))
    assert n >= 40, out.stdout  # every module of the slices was imported
    names = re.search(r"NAMES (.*)", out.stdout).group(1).split()
    for mod in ("runtime.native", "train.checkpoint", "train.loop", "train.optim",
                "data.dataset", "data.feature_cache", "data.sampler", "cli.create_data_df",
                "cli.compute_features", "cli.train", "export", "cli.export_model",
                "cli.convert_checkpoint", "parallel.mesh", "parallel.distributed",
                "parallel.data_parallel", "utils.timing", "cli.presets", "cli.parity",
                "cli.laughs_to_wav", "cli.probe_audio_loading", "cli.visualise", "viz"):
        assert f"laughter_detection_icsi_tpu_torch.{mod}" in names, mod
    # Every CLI's --help ran: segment_laughter's, serve's, sweep's, analyse's,
    # create_data_df's, compute_features's, train's, export_model's,
    # convert_checkpoint's.
    assert "--input_audio_file" in out.stdout and "--save_probs" in out.stdout
    assert "--transfer_codec" in out.stdout and "--min_length_sweep" in out.stdout
    assert "--num_non_laugh_samples" in out.stdout and "--splits" in out.stdout
    assert "--device_cache" in out.stdout and "--steps_per_dispatch" in out.stdout
    assert "--device" in out.stdout
    assert "--wave_dtype" in out.stdout and ".ckpt.npz or .pth.tar" in out.stdout
    # parity's, laughs_to_wav's, probe_audio_loading's and visualise's.
    assert "--write_goldens" in out.stdout and "--loss_atol" in out.stdout
    assert "--break_s" in out.stdout and "--offsets" in out.stdout
    assert "lengthdist" in out.stdout and "--threshold" in out.stdout
    # sweep's and train's multi-process flags (JAX's).
    assert out.stdout.count("--coordinator_address") >= 2
    assert out.stdout.count("--cpu_collectives") >= 2


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|laughter_detection_icsi_tpu|pandas|lxml|ml_dtypes)\b"
    r"|import_module\(\s*['\"](?:jax|laughter_detection_icsi_tpu|pandas|lxml|ml_dtypes)\b",
    re.MULTILINE,
)


def test_sources_name_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tests" / "fixtures" / "torch_dist_worker.py",
                                          REPO / "tests" / "fixtures" / "parity_inputs.py",
                                          *sorted((REPO / "examples").glob("*_torch.py"))]
    assert len(files) > 27
    for sub in ("runtime", "train", "data", "cli"):
        assert any(f.parent == PORT / sub for f in files), sub
    for name in ("data/dataset.py", "data/feature_cache.py", "data/sampler.py",
                 "cli/create_data_df.py", "cli/compute_features.py", "cli/train.py",
                 "export.py", "cli/export_model.py", "cli/convert_checkpoint.py",
                 "parallel/mesh.py", "parallel/distributed.py", "parallel/data_parallel.py",
                 "utils/timing.py", "cli/presets.py", "cli/parity.py", "cli/laughs_to_wav.py",
                 "cli/probe_audio_loading.py", "cli/visualise.py", "viz.py"):
        assert PORT / name in files, name
    for example in ("demo_torch.py", "streaming_demo_torch.py"):
        assert REPO / "examples" / example in files, example
    offenders = [str(f.relative_to(REPO)) for f in files if _IMPORT.search(f.read_text())]
    assert offenders == []


def test_pattern_catches_what_it_should():
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("    from laughter_detection_icsi_tpu.ops import fbank")
    assert _IMPORT.search("importlib.import_module('jax')")
    assert _IMPORT.search("import pandas as pd")
    assert _IMPORT.search("    from lxml import etree")
    assert _IMPORT.search("import ml_dtypes")
    assert not _IMPORT.search("import pandasql")
    assert not _IMPORT.search("from laughter_detection_icsi_tpu_torch.ops import fbank")
    assert not _IMPORT.search("import jaxtyping")
