"""The harness: finds a cell's pieces by name, runs its driver, reads its
per-layer metrics and prints the result line.

Everything about one configuration, traffic mix or metric is a file of its
own under this folder, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic's parameters, with the name of
  the driver that offers it (``drivers/<driver>.py``);
- ``workloads/<cell>.json``: the cell's correctness check (sample sizes and
  the limit of each number compared);
- ``metrics/<metric>.py``: one per-layer metric, ``read(trace) -> float or
  None``, over the :class:`Trace` of the cell's profiled slice.

A driver is ``run(job) -> dict`` (see :class:`Job`).  Its device work is
the program's (the PyTorch port); the reference it is checked against lives
in ``reference/`` and imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import heapq
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

#: Top-level module names that may not be loaded when a run ends.
FORBIDDEN = ("jax", "jaxlib", "flax", "laughter_detection_icsi_tpu")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since import."""
    print(f"[{time.perf_counter() - _T0:8.2f}] {msg}", file=sys.stderr, flush=True)


class RunFailed(RuntimeError):
    """A run that prints no result."""


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise RunFailed(f"no file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One cell as the manifest and its files give it."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: Path  # the folder the cell's files are found in

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def find_cell(root: Path, name: str, tweak: Optional[Callable[["Cell"], None]] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files;
    ``tweak`` may change the loaded dicts (tests run cells at small
    sizes)."""
    manifest = load_json(root / "BENCHMARK.json")
    bench = root / manifest["paths"][0]
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise RunFailed(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    config = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, name, names)]
    cell = Cell(
        name=name, entry=entry,
        config=load_json(root / config["file"]),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        check=load_json(bench / "workloads" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer, bench=bench,
    )
    if tweak is not None:
        tweak(cell)
    return cell


@dataclasses.dataclass
class Trace:
    """The profiled slice of a run, as a per-layer metric reads it.

    ``events``: the chrome trace's events; ``device``: its device ops
    (kernels, copies, fills); ``wall_s``: the slice's length on the host
    clock; ``work``: what the driver says the slice did (audio seconds,
    frames, steps, launches, ...); ``config``/``traffic``: the cell's."""

    events: List[dict]
    device: List[dict]
    wall_s: float
    work: dict
    config: dict
    traffic: dict

    def busy_s(self) -> float:
        return union_us(self.device) / 1e6

    def device_ms_by_name(self) -> Dict[str, Tuple[int, float]]:
        out: Dict[str, Tuple[int, float]] = {}
        for e in self.device:
            n, ms = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, ms + float(e["dur"]) / 1e3)
        return out

    def host_spans(self, name: str) -> List[dict]:
        return [e for e in self.events if e.get("ph") == "X" and e.get("name") == name
                and e.get("cat") in HOST_CATEGORIES]


#: The chrome-trace categories of device work, and of host spans.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("user_annotation", "cpu_op", "python_function", "cuda_runtime", "cuda_driver")


def union_us(events: List[dict]) -> float:
    """The union of the events' intervals, overlap counted once (us)."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def kernel_kind(name: str) -> str:
    """A device op's kind: fbank, layout (cuDNN's NCHW <-> NHWC transposes
    around a bf16 conv), convs, cat, copies or elementwise (the rest).
    The port's ``utils/timing.kernel_kind``, copied."""
    low = name.lower()
    if "fbank_kernel" in name:
        return "fbank"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout"
    if any(c in low for c in ("conv", "cudnn", "xmma", "dgrad", "wgrad", "fprop", "winograd",
                              "gemm", "cutlass")):
        return "convs"
    if "catarray" in low:
        return "cat"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copies"
    return "elementwise"


def breakdown(tr: Trace) -> dict:
    """The device ops that took the most time, and the device's idle time
    within the slice by what the host was doing then: the innermost
    benchmark or program span around each gap's middle, and the innermost
    host op there."""
    by_name = tr.device_ms_by_name()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    device_ops = [[name, ms / 1e3] for name, (_, ms) in top]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["cat"], e["name"])
                    for e in tr.events
                    if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES))
    ivals = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in tr.device)
    if not spans or not ivals:
        return {"device_ops": device_ops, "idle_gaps": []}
    gaps, end = [], spans[0][0]
    for a, b in ivals + [(max(s[1] for s in spans), None)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b if b is not None else a)
    idle: Dict[str, float] = {}
    open_, i = [], 0  # a heap of (end, start, cat, name) of the spans open at the mid
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][0] <= mid:
            heapq.heappush(open_, (spans[i][1], spans[i][0], spans[i][2], spans[i][3]))
            i += 1
        while open_ and open_[0][0] < mid:
            heapq.heappop(open_)
        inner = lambda pick: min((s for s in open_ if pick(s[2])), default=None,
                                 key=lambda s: s[0] - s[1])
        ann = inner(lambda c: c == "user_annotation")
        op = inner(lambda c: c != "user_annotation")
        key = f"{ann[3] if ann else '-'} | {op[3] if op else '-'}"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
    idle_gaps = [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": device_ops, "idle_gaps": idle_gaps}


def profile(fn: Callable[[], dict], synchronize: Callable[[], None]) -> Tuple[List[dict], float, dict]:
    """Run ``fn`` under ``torch.profiler`` (host and device), ending in
    ``synchronize``: (the chrome trace's events, the wall seconds, what
    ``fn`` returned).  The trace file lives in ``TMPDIR`` only while it is
    read."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        work = fn()
        synchronize()
        wall = time.perf_counter() - t0
    log(f"profiled slice: {wall:.3f} s")
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        log(f"trace exported: {os.path.getsize(path) / 1e6:.1f} MB")
        events = json.loads(Path(path).read_text()).get("traceEvents", [])
    finally:
        os.unlink(path)
    log(f"trace read: {len(events)} events")
    return events, wall, work


@dataclasses.dataclass
class Job:
    """What a driver is given: the cell, the run's arguments, the device,
    and the time the process started (``setup_s`` counts from it)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float

    def synchronize(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def profiled(self, fn: Callable[[], dict]) -> Trace:
        events, wall, work = profile(fn, self.synchronize)
        device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
        return Trace(events=events, device=device, wall_s=wall, work=work,
                     config=self.cell.config, traffic=self.cell.traffic)


def card_power_limit() -> Optional[float]:
    """The card's power limit (W) as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0].split(",")[-1].strip().split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def require_cards(n: int):
    """The first card, or RunFailed when CUDA is missing or has fewer than
    ``n`` cards: the benchmark never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RunFailed("CUDA is not available: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise RunFailed(f"the cell needs {n} cards, {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, started: float,
             device=None, tweak=None) -> Tuple[dict, Dict[str, Tuple[float, float]]]:
    """Run the cell once: (the result line's dict, the numbers compared
    and their limits).  ``device`` None asks for the cell's cards."""
    cell = find_cell(root, name, tweak)
    if device is None:
        device = require_cards(cell.entry["chips"])
    power = card_power_limit() if device.type == "cuda" else None
    if power is not None:
        print(f"card power limit: {power} W", file=sys.stderr)
    job = Job(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, started=started)
    driver = load_module(cell.bench / "drivers" / f"{cell.driver}.py", f"bench_driver_{cell.driver}")
    out = driver.run(job)
    log("driver done")
    checks: Dict[str, Tuple[float, float]] = out["checks"]
    correct = all(math.isfinite(v) and v <= limit for v, limit in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": _device_kind(device), "count": cell.entry["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        tr: Trace = out["trace"]
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.wall_s
        metrics = {}
        for m in cell.per_layer:
            reader = load_module(cell.bench / "metrics" / f"{m['name']}.py",
                                 f"bench_metric_{m['name']}")
            value = reader.read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = breakdown(tr)
        log("per-layer metrics and breakdown read")
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in out["e2e"]:
                raise RunFailed(f"the {cell.driver} driver reported no {m['name']}")
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = device_info
    result["power_limit_w"] = power
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    return result, checks


def _device_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
