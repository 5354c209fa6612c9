"""The clips cells' pieces: the AST operation count, `drivers/sweep_clips.py` at a small
size on the CPU, its refusal of a program without the clips mode, and the
manifest's new entries."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from conftest import BENCH, ROOT
from torch.utils.flop_counter import FlopCounterMode

import harness
from counts import ast as counts
from reference import ast as ref_ast

CONFIG = json.loads((BENCH / "configs" / "ast_audioset_bf16.json").read_text())
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "ast_audioset_bf16.clips_6ch_600s"
TRAIN = "resnet_base_f32.train_b1024"
NARROW = dict(dim=32, depth=2, heads=2, mlp=64, tdim=64)


def test_one_clip_at_published_widths_by_hand():
    m = CONFIG["model"]
    n, d = 12 * 101 + 2, 768
    assert counts.tokens(m) == n == 1214
    patch = 2 * 16 * 16 * d * (n - 2)
    linears = 2 * n * (d * 3 * d + d * d + 2 * d * 3072)
    attention = 2 * 2 * n * n * d
    head = 2 * d * 527
    assert counts.clip_flops(m) == patch + 12 * (linears + attention) + head
    assert counts.attention_flops(m) == 12 * attention
    assert round(counts.clip_flops(m) / 1e9, 1) == 261.0
    assert round(patch / 1e9, 2) == 0.48 and round(linears / 1e9, 2) == 17.19
    assert round(attention / 1e9, 2) == 4.53
    assert round(100 * counts.attention_flops(m) / counts.clip_flops(m), 1) == 20.8


def test_count_matches_torchs_flop_counter_on_the_reference():
    m = {**CONFIG["model"], **NARROW}
    g = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s, generator=g) * 0.05 for k, s in ref_ast.param_shapes(m).items()}
    x = torch.randn(2, m["tdim"], m["fdim"], generator=g)
    with FlopCounterMode(display=False) as fc:
        ref_ast.forward(p, x, m)
    assert fc.get_total_flops() == 2 * counts.clip_flops(m)


def small(cell) -> None:
    """The clips cell cut to what a CPU test can run: a narrow AST over
    64-frame clips a 10-frame block apart, short meetings of two channels,
    in float32."""
    cell.config["model"].update(NARROW)
    cell.config["precision"] = "float32"
    cell.config["clips"].update(clip_frames=64, hop_frames=10, clip_batch=16)
    cell.config["inference"]["bucket_frames"] = 400
    cell.config["weights"]["calibration_clips"] = 8
    cell.traffic.update(meeting_seconds=8, channels=2, pool_meetings=2, offset_max_seconds=2)
    cell.check["sample_clips"] = 12


DRY_RUN = """
import sys
sys.path[:0] = [{bench!r}, {tests!r}]
import torch
import run
from test_benchmark_clips import small
torch.set_num_threads(2)
for trace in ("0", "1"):
    rc = run.main(["--workload", {cell!r}, "--seed", "2147483777", "--seconds", "0.5",
                   "--trace", trace], device=torch.device("cpu"), tweak=small)
    assert rc == 0, trace
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_driver_at_a_small_size_on_the_cpu():
    code = DRY_RUN.format(bench=str(BENCH), tests=str(Path(__file__).parent), cell=CELL)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.rsplit("LOADED", 1)[1]))
    assert not loaded & set(harness.FORBIDDEN)
    results = [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]
    assert len(results) == 2 and all(r["correct"] for r in results), results
    assert set(results[0]["metrics"]) == {"x_realtime", "setup_s"}
    assert results[1]["metrics"] == {}  # the CPU has no device ops for the readers
    checks = results[0]["checks"]
    assert checks["logit_gap_mean"]["value"] < 1e-3
    assert checks["event_mismatches"]["value"] == checks["block_mismatches"]["value"] == 0


def test_a_program_without_the_clips_mode_fails_at_once(monkeypatch):
    from laughter_detection_icsi_tpu_torch.models import zoo

    driver = harness.load_module(BENCH / "drivers" / "sweep_clips.py", "bench_driver_clips_test")
    monkeypatch.delitem(zoo.MODEL_REGISTRY, "AST")
    with pytest.raises(harness.RunFailed, match="no AST"):
        driver.require_clips_mode()


def test_the_manifests_new_entries():
    cells = {w["name"]: w for w in MANIFEST["workloads"]}
    assert cells[CELL]["chips"] == cells[TRAIN]["chips"] == 1
    assert cells[CELL]["config"] == "ast_audioset_bf16" and cells[TRAIN]["config"] == "resnet_base_f32"
    config = next(c for c in MANIFEST["configs"] if c["name"] == "ast_audioset_bf16")
    assert config["reduced"] == [] and len(config["source"]) <= 200
    metrics = {m["name"]: m for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]}
    for name in ("clips.mfu_pct", "clips.attention_roofline", "clips.encoder_ms_per_audio_min",
                 "clips.frontend_ms_per_audio_min"):
        assert metrics[name]["workloads"] == [CELL] and metrics[name]["moves"] == "x_realtime"
    for name in ("x_realtime", "sweep.device_idle_pct", "sweep.fbank_roofline",
                 "sweep.prep_stall_pct", "sweep.dispatch_stall_pct", "sweep.smoothing_stall_pct"):
        assert metrics[name]["workloads"][-1] == CELL
    for name in ("sweep.mfu_pct", "sweep.elementwise_ms_per_audio_min",
                 "sweep.track_ms_per_audio_min", "sweep.chunk_ms_per_audio_min"):
        assert CELL not in metrics[name]["workloads"]
    for name in ("train_samples_per_s", "train.device_idle_pct", "train.mfu_pct",
                 "train.host_ms_per_step"):
        assert metrics[name]["workloads"][-1] == TRAIN
    b32 = json.loads((BENCH / "traffic" / "train_b32.json").read_text())
    b1024 = json.loads((BENCH / "traffic" / "train_b1024.json").read_text())
    assert {k: v for k, v in b1024.items() if b32[k] != v} == {"batch_size": 1024, "trace_steps": 16}
    sweep = json.loads((BENCH / "traffic" / "sweep_6ch_600s.json").read_text())
    clips = json.loads((BENCH / "traffic" / "clips_6ch_600s.json").read_text())
    assert {k: v for k, v in clips.items() if sweep[k] != v} == {"driver": "sweep_clips"}


def test_the_configs_features_are_the_ports_ast_features():
    from laughter_detection_icsi_tpu_torch.config import AST_FEAT, AST_NORM_MEAN, AST_NORM_STD

    driver = harness.load_module(BENCH / "drivers" / "sweep_clips.py", "bench_driver_clips_feat")
    assert driver.feat_config(CONFIG) == AST_FEAT
    assert CONFIG["normalisation"] == {"mean": AST_NORM_MEAN, "std": AST_NORM_STD}
