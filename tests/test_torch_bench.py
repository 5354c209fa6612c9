"""The port's bench (``laughter_detection_icsi_tpu_torch/bench.py``) on the
CPU: the twin of tests/test_bench.py less its tunnel tests.  The emission
contract (one JSON line on every exit path, exit 3 with a diagnostic when
nothing was measured, the history file), each mode's record on
``--device cpu`` and the refusal without a card, in subprocesses; and the
default mode's pipeline against the JAX bench's on the same audio and
weights.

The subprocesses narrow ``resnet_base`` (``build_model``'s ``widths``) to
keep the CPU runs short; the card runs the full width (chip_smoke.py phase
15)."""

import functools
import json
import os
import signal
import subprocess as sp
import sys

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu import inference as jinference
from laughter_detection_icsi_tpu_torch import bench
from tests.fixtures.torch_weights import SMALL, both_models, few_torch_threads  # noqa: F401
from tests.test_torch_import import REPO

#: A child that runs the bench's main at SMALL's widths.
NARROW = ("import functools, sys; from laughter_detection_icsi_tpu_torch import bench; "
          f"bench.build_model = functools.partial(bench.build_model, widths={SMALL!r}); "
          "sys.exit(bench.main(sys.argv[1:]))")


def _env(**kw):
    return dict(os.environ, BENCH_HISTORY="off", OMP_NUM_THREADS="1", **kw)


def _run(args, timeout=240, **env):
    return sp.run([sys.executable, "-c", NARROW, *args], cwd=REPO, env=_env(**env),
                  capture_output=True, text=True, timeout=timeout)


#: The modes the CPU-mode tests read, with their environments.  They start
#: together (``cpu_runs``), so the file waits for the slowest, not the sum.
CPU_RUNS = {
    "default": ([], dict(BENCH_TOTAL_BUDGET_S="300")),
    "train": (["--train"], dict(BENCH_TRAIN_PRECISION="float32")),
    "train_loop": (["--train-loop"], dict(BENCH_TRAIN_LOOP_KS="1", BENCH_TRAIN_PRECISION="float32")),
    "sharded": (["--sharded"], {}),
}


@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory):
    """Each of CPU_RUNS started at once on ``--device cpu``; a test's
    ``cpu_runs(mode)`` waits for its run and returns (rc, stdout,
    stderr)."""
    out = tmp_path_factory.mktemp("bench_runs")
    procs = {}
    for mode, (args, env) in CPU_RUNS.items():
        with open(out / f"{mode}.out", "w") as o, open(out / f"{mode}.err", "w") as e:
            procs[mode] = sp.Popen([sys.executable, "-c", NARROW, *args, "--device", "cpu"],
                                   cwd=REPO, env=_env(**env), stdout=o, stderr=e)

    def wait(mode):
        rc = procs[mode].wait(timeout=600)
        return rc, (out / f"{mode}.out").read_text(), (out / f"{mode}.err").read_text()

    yield wait
    for p in procs.values():
        p.kill()
        p.wait()


def _record(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, stdout  # one JSON line, printed once
    return json.loads(lines[0])


@pytest.fixture
def state(tmp_path, monkeypatch):
    """The bench's emission state as a fresh process has it, the history
    in a temporary file."""
    monkeypatch.setenv("BENCH_HISTORY_PATH", str(tmp_path / "runs.jsonl"))
    monkeypatch.delenv("BENCH_HISTORY", raising=False)
    saved = dict(bench._STATE)
    bench._STATE.update(phase="startup", emitted=False, record=None,
                        metric="e2e_inference_throughput", unit="x_realtime_per_chip")
    yield tmp_path / "runs.jsonl"
    bench._STATE.clear()
    bench._STATE.update(saved)


def test_emit_final_diagnostic_when_no_record(state, capsys):
    bench._STATE["phase"] = "warmup"
    rec = bench._emit_final()
    assert json.loads(capsys.readouterr().out.strip()) == rec
    assert rec["value"] is None and "warmup" in rec["error"]
    assert rec["metric"] == "e2e_inference_throughput"
    # Idempotent: the first emitter wins, later calls print nothing.
    assert bench._emit_final({"metric": "x", "value": 1}) == rec
    assert capsys.readouterr().out == ""


def test_emit_final_prefers_stored_record(state, capsys):
    bench._STATE["record"] = {"metric": "e2e_inference_throughput", "value": 42.0}
    bench._emit_final()
    assert json.loads(capsys.readouterr().out.strip())["value"] == 42.0


def test_emit_final_appends_history_unless_off(state, capsys, monkeypatch):
    bench._emit_final({"metric": "e2e_inference_throughput", "value": 7.0})
    capsys.readouterr()
    (entry,) = [json.loads(ln) for ln in state.read_text().splitlines()]
    assert entry["value"] == 7.0 and "ts" in entry
    bench._STATE["emitted"] = False
    monkeypatch.setenv("BENCH_HISTORY", "off")
    bench._emit_final({"metric": "e2e_inference_throughput", "value": 8.0})
    capsys.readouterr()
    assert len(state.read_text().splitlines()) == 1


def test_history_defaults_to_the_ports_own_file(monkeypatch):
    monkeypatch.delenv("BENCH_HISTORY_PATH", raising=False)
    assert bench._history_path() == REPO / "build" / "bench_runs_torch.jsonl"


def test_budget_exhaustion_emits_diagnostic_record():
    r = _run(["--device", "cpu"], BENCH_TOTAL_BUDGET_S="3")
    assert r.returncode == 3, r.stderr[-2000:]
    rec = _record(r.stdout)
    assert rec["value"] is None and "budget 3s" in rec["error"]
    assert "exhausted" in r.stderr


def test_sigterm_emits_diagnostic_record():
    p = sp.Popen([sys.executable, "-c", NARROW, "--device", "cpu"], cwd=REPO,
                 env=_env(BENCH_TOTAL_BUDGET_S="600"), stdout=sp.PIPE, stderr=sp.PIPE, text=True)
    try:
        # The guard is armed before the first phase line.
        for line in p.stderr:
            if "bench: phase=" in line:
                break
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        p.kill()
    assert p.returncode == 3, err[-2000:]
    rec = _record(out)
    assert rec["value"] is None and "no measurement" in rec["error"]


def test_without_a_card_exits_3_naming_the_device():
    r = sp.run([sys.executable, "-m", "laughter_detection_icsi_tpu_torch.bench"], cwd=REPO,
               env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=120)
    assert r.returncode == 3
    rec = _record(r.stdout)
    assert rec["value"] is None and "no CUDA device" in rec["error"]
    assert rec["metric"] == "e2e_inference_throughput" and "platform" not in rec


def test_mutually_exclusive_mode_flags_rejected():
    r = _run(["--train", "--sharded"], timeout=60)
    assert r.returncode == 2 and "mutually exclusive" in r.stderr


def test_cpu_end_to_end_emits_decomposed_record(cpu_runs):
    rc, out, err = cpu_runs("default")
    assert rc == 0, err[-2000:]
    rec = _record(out)
    assert rec["metric"] == "e2e_inference_throughput" and rec["unit"] == "x_realtime_per_chip"
    assert rec["platform"] == "cpu" and rec["cpu_fallback"] is True
    assert rec["value"] > 0 and rec["vs_baseline"] == pytest.approx(rec["value"] / 500, abs=1e-4)
    assert (rec["audio_s"], rec["precision"]) == (12, "float32") and rec["warmup_s"] >= 0
    assert rec["upload_s"] >= 0
    assert rec["device_x_realtime"] > 0 and rec["fused_conv_device_x_realtime"] > 0
    assert not any(k.endswith(("_skipped", "_error")) for k in rec), rec
    assert "phase=decompose" in err and "phase=measure_refine" in err


def test_cpu_train_mode_emits_record(cpu_runs):
    rc, out, err = cpu_runs("train")
    assert rc == 0, err[-2000:]
    rec = _record(out)
    assert rec["metric"] == "train_step_throughput" and rec["platform"] == "cpu"
    assert (rec["batch_size"], rec["precision"]) == (32, "float32")
    assert rec["value"] > 0 and rec["vs_baseline"] is None and "another" in rec["baseline_ref"]
    # value is measured under cli/train's flags, the deterministic ones, in
    # turns with PyTorch's default flags (A B B A), each keeping its best.
    assert rec["deterministic_samples_per_s"] == rec["value"]
    a, b = rec["readings"][0][0], rec["readings"][1][0]
    assert "deterministic=True" in a and "deterministic=False" in b
    assert [r[0] for r in rec["readings"]] == [a, b, b, a]
    assert rec["value"] == max(r[1] for r in rec["readings"] if r[0] == a)
    assert rec["nondeterministic_samples_per_s"] > 0 and "deterministic_cost" in rec
    assert "cudnn.deterministic=True cudnn.benchmark=False" in rec["cudnn"]["value"]


def test_cpu_train_loop_mode_emits_record(cpu_runs):
    rc, out, err = cpu_runs("train_loop")
    assert rc == 0, err[-2000:]
    rec = _record(out)
    assert rec["metric"] == "train_loop_throughput" and rec["platform"] == "cpu"
    assert rec["precision"] == "float32" and rec["resident_rows"] == 128
    assert rec["value"] == rec["loop_k1_samples_per_s"] > 0
    assert rec["streamed_samples_per_s"] > 0
    assert not any(k.startswith("loop_k4") for k in rec)


def test_cpu_sharded_mode_emits_record(cpu_runs):
    rc, out, err = cpu_runs("sharded")
    assert rc == 0, err[-2000:]
    rec = _record(out)
    assert rec["metric"] == "sharded_inference_throughput" and rec["platform"] == "cpu"
    assert (rec["n_channels"], rec["channel_audio_s"], rec["mesh_devices"]) == (2, 8, 1)
    assert rec["value"] > 0
    assert rec["per_channel_x_realtime"] == pytest.approx(rec["value"] / 2, abs=0.01)
    assert rec["sharded_device_x_realtime"] > 0
    assert rec["sharded_fused_skipped"] == "cpu self-test"


def test_default_pipeline_matches_the_jax_bench():
    """The default mode's pipeline on the CPU (chunk 512, bucket 1024,
    float32) against the JAX bench's (bench.main's settings on the CPU) on
    the same speech_like_pcm seed, weights carried across by
    state_dict_from_jax: within 1e-5.  (The fixture's head gain: at 3 or 8
    this near-saturated narrow model turns float32 rounding into up to
    2.2e-5 on speech-like audio, half of it from the model on equal
    features; ROADMAP queue 3's tolerance caveats.)"""
    sys.path.insert(0, str(REPO))
    import bench as jbench

    jmodel, params, state_, tmodel = both_models("ResNetBigger", seed=5, **SMALL)
    jpipe = jinference.LaughterPipeline(jmodel, params, state_, settings=jinference.InferenceSettings(
        chunk=512, bucket_frames=1024, precision="float32"))
    tpipe = bench.build_pipeline(torch.device("cpu"), model=tmodel)
    s = tpipe.settings
    assert (s.chunk, s.bucket_frames, s.precision) == (512, 1024, "float32")
    wave = bench.speech_like_pcm(3, seed=24)
    np.testing.assert_array_equal(wave, jbench.speech_like_pcm(3, seed=24))
    got, want = tpipe.probs_for_waveform(wave), jpipe.probs_for_waveform(wave)
    assert got.shape == want.shape == (300,)
    assert want.std() > 1e-3  # the probabilities spread: the check has teeth
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_build_model_widths():
    full = bench.build_model(0.5)
    assert full.dropout_rate == 0.5
    narrow = functools.partial(bench.build_model, widths=SMALL)(0.0)
    assert sum(p.numel() for p in narrow.parameters()) < sum(p.numel() for p in full.parameters())
