"""Goldens written by the port's parity CLI (``--write_goldens``, on the
CPU) pass the JAX package's ``cli/parity.py``: the goldens' format (the
JAX CLI reads the port's CSVs with pandas) and their numbers, all five
checks at the JAX CLI's own tolerances and at the port's parity bounds
(probabilities 1e-5, analyse rows exact, the 4-step loss curve 1e-3).
Its own file, beside tests/test_torch_parity.py, to keep each file's time
small: one port run writes, one JAX run checks.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from cli import parity as jax_parity
from laughter_detection_icsi_tpu_torch.cli import parity
from tests.fixtures import parity_inputs
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401

GOLDENS = Path(__file__).resolve().parent / "fixtures" / "parity_goldens"
SIZES = ["--chunk", "256", "--bucket_frames", "256"]


@pytest.fixture(scope="module")
def port_goldens(tmp_path_factory):
    inputs = parity_inputs.write_parity_inputs(tmp_path_factory.mktemp("parity_inputs"))
    g = inputs.root / "port_goldens"
    assert parity.main(inputs.argv(g) + SIZES + ["--device", "cpu", "--write_goldens"]) == 0
    return inputs, g


def test_port_goldens_pass_the_jax_cli(port_goldens, tmp_path):
    inputs, g = port_goldens
    out = tmp_path / "report.json"
    rc = jax_parity.main(inputs.argv(g) + SIZES + [
        "--prob_atol", "1e-5", "--metric_atol", "0", "--loss_atol", "1e-3", "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0, report
    assert report["n_pass"] == 5 and report["n_skipped"] == 0
    assert report["configs"]["analyse"]["max_metric_diff"] == 0.0


def test_port_goldens_have_the_jax_layout(port_goldens):
    """The same files as the JAX CLI's goldens, the same manifest and
    pinned batches, CSVs that pandas reads with the JAX columns."""
    _, g = port_goldens
    names = lambda root: sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    assert names(g) == names(GOLDENS)
    assert json.loads((g / "manifest.json").read_text()) == json.loads(
        (GOLDENS / "manifest.json").read_text())
    ours, theirs = np.load(g / "train" / "batches.npz"), np.load(GOLDENS / "train" / "batches.npz")
    for key in ("inputs", "labels"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    for name in ("sum_stats.csv", "train/loss_curve.csv"):
        a, b = pd.read_csv(g / name), pd.read_csv(GOLDENS / name)
        assert list(a.columns) == list(b.columns) and len(a) == len(b), name
