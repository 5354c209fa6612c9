"""The harness: found by name, no JAX, no result without a card."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import torch
from conftest import BENCH, ROOT

import harness


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_files_are_found_without_editing_any(tmp_path):
    """A configuration, traffic, cell, driver and metric dropped in as new
    files (and named in the manifest) run through the unchanged harness."""
    root = _copy(tmp_path)
    bench = root / "benchmark"
    (bench / "configs" / "toy.json").write_text(json.dumps({"name": "toy", "scale": 3.0}))
    (bench / "traffic" / "ticks.json").write_text(json.dumps({"driver": "ticker", "ticks": 4}))
    (bench / "workloads" / "toy.ticks.json").write_text(json.dumps({"limits": {"err": 0.5}}))
    (bench / "drivers" / "ticker.py").write_text(textwrap.dedent('''
        import time

        def run(job):
            n = job.cell.traffic["ticks"]
            opened = time.perf_counter()
            if job.trace:
                trace = job.profiled(lambda: {"ticks": n})
            total = sum(job.cell.config["scale"] for _ in range(n))
            out = {"e2e": {"setup_s": opened - job.started, "ticks_per_s": n / 0.5},
                   "memory_peak_bytes": 0, "attempted": n, "failed": 0,
                   "checks": {"err": (abs(total - 12.0), job.cell.check["limits"]["err"])}}
            if job.trace:
                out["trace"] = trace
            return out
    '''))
    (bench / "metrics" / "toy.ticks_seen.py").write_text(
        "def read(trace):\n    return float(trace.work['ticks'])\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "toy", "source": "https://example.org/toy",
                                "file": "benchmark/configs/toy.json", "reduced": [], "why": "toy"})
    manifest["workloads"].append({"name": "toy.ticks", "config": "toy", "traffic": "ticks",
                                  "chips": 1, "why": "ticks"})
    manifest["end_to_end"].append({"name": "ticks_per_s", "unit": "1/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["toy.ticks"]})
    manifest["per_layer"].append({"name": "toy.ticks_seen", "unit": "1", "better": "higher",
                                  "source": "program_counter", "layer": "toy",
                                  "moves": "ticks_per_s", "workloads": ["toy.ticks"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    cpu = torch.device("cpu")
    result, checks = harness.run_cell(root, "toy.ticks", 1, 0.1, False, 0.0, device=cpu)
    assert set(result["metrics"]) == {"ticks_per_s", "setup_s"}
    assert result["correct"] and checks == {"err": (0.0, 0.5)}
    result, _ = harness.run_cell(root, "toy.ticks", 1, 0.1, True, 0.0, device=cpu)
    assert result["metrics"] == {"toy.ticks_seen": {"value": 4.0, "unit": "1"}}
    assert list(result)[-1] == "checks"


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "resnet_base_f32.train_b32", "--seed", "2147483999", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA is not available" in p.stderr


def test_a_directory_with_only_the_benchmark_fails(tmp_path):
    root = _copy(tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "resnet_base_bf16.sweep_6ch_600s", "--seed", "7", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


DRY_RUN = """
import sys
sys.path[:0] = [{bench!r}, {tests!r}]
import torch
import run
from bench_small import small
torch.set_num_threads(2)
for cell in ("resnet_base_bf16.sweep_6ch_600s", "resnet_base_f32.train_b32"):
    for trace in ("0", "1"):
        rc = run.main(["--workload", cell, "--seed", "2147483777", "--seconds", "0.5",
                       "--trace", trace], device=torch.device("cpu"), tweak=small)
        assert rc == 0, (cell, trace)
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_cpu_dry_run_loads_neither_jax_nor_the_jax_package():
    """Both cells end to end with the card check stubbed, at a small size,
    in a fresh process: nothing JAX-side is imported."""
    code = DRY_RUN.format(bench=str(BENCH), tests=str(Path(__file__).parent))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.rsplit("LOADED", 1)[1]))
    assert "laughter_detection_icsi_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
    results = [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]
    assert len(results) == 4 and all(r["correct"] for r in results)
    assert [set(r["metrics"]) for r in results[::2]] == [{"x_realtime", "setup_s"},
                                                         {"train_samples_per_s", "setup_s"}]


def test_the_reference_imports_nothing_of_the_program():
    imports = re.compile(r"^\s*(?:from|import)\s+(laughter_detection_icsi_tpu\w*|jax\w*|flax)",
                         re.M)
    for f in sorted((BENCH / "reference").glob("*.py")) + [BENCH / "traffic.py",
                                                          BENCH / "weights.py"]:
        assert not imports.findall(f.read_text()), f
