#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check that it is right.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device — the card's name and power limit, as nvidia-smi reports them;
2. build  — compile the fbank kernel from csrc/fbank.cu (timed); ptxas's
   register/spill report (any spill fails) and the count of tensor-core
   ``HMMA`` instructions in the kernel's SASS (none fails); the frames a
   block computes, as the library reports them;
3. kernel — ``fbank_cuda`` against its plain PyTorch version on the card
   (atol 2e-4, rtol 1e-4) at the listed shapes (int16-scaled audio, a
   silent stretch at the energy floor, 3 whole blocks of frames and one
   frame more among them), a [3, n] batch equal to each channel alone,
   and the kernel's, the plain version's and one cuBLAS matmul's times at
   the main-path bucket beside the 3xTF32 tensor-core bound (the JSON
   line's ``bound_ms``) and the fp32 CUDA-core one (printed only);
4. main path — full-width ``resnet_base`` ResNetBigger (numpy-seeded
   weights in a ``.ckpt.npz``) segments ~150 s of synthetic int16 audio
   through the port's CLI on ``cuda``; the kernel must launch once per
   bucket; the probabilities must be finite, in [0, 1], and agree with the
   port on the CPU; the TextGrid must read back as the smoothing of those
   probabilities; shared-stem and naive windows must agree within 1e-5;
   then the e2e time (best of 3 warm ``segment_file`` calls) and, from a
   torch.profiler trace of one more call, where its device time goes;
5. the card, one JSON line of the kernels, then the result line.

The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_fbank_pallas.py's feature tolerance
SECONDS = 150  # main-path audio: three 6144-frame buckets, the last partial

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# float32 outside the tensor cores, TF32 on the tensor cores (half the
# sheets' with-sparsity figure), and memory bandwidth.
PEAKS = (  # (name fragment, FP32 FLOP/s, TF32 FLOP/s, bytes/s); first match wins
    ("H100 PCIe", 51.2e12, 378e12, 2.0e12),
    ("H100 NVL", 60.0e12, 417.5e12, 3.9e12),
    ("H200", 67.0e12, 495e12, 4.8e12),
    ("H100", 67.0e12, 495e12, 3.35e12),
)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def speechlike(n: int, seed: int) -> np.ndarray:
    """Int16 audio whose frames differ: noise under a slow envelope plus a
    gated frequency sweep."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    env = 0.05 + 0.6 * np.sin(2 * np.pi * 0.7 * t) ** 2
    tone = np.sin(2 * np.pi * (200 + 300 * np.sin(2 * np.pi * 0.3 * t)) * t)
    w = 0.3 * r.standard_normal(n) * env + 0.3 * tone * (np.sin(2 * np.pi * 1.3 * t) > 0)
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


def seeded_state_dict(model, seed: int, head_gain: float = 0.03):
    """Numpy-drawn weights in the JAX package's (params, state) layout,
    carried in through ``state_dict_from_jax``.  ``head_gain`` scales the
    last linear layer so the probabilities spread over (0, 1)."""
    from laughter_detection_icsi_tpu_torch.train.checkpoint import state_dict_from_jax

    rng = np.random.default_rng(seed)
    params, state = {}, {}
    for key, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            state[key] = np.asarray(rng.integers(0, 100), np.int32)
        elif leaf == "running_mean":
            state[key] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif leaf == "running_var":
            state[key] = (1.0 + 0.5 * rng.random(shape)).astype(np.float32)
        elif len(shape) == 1:
            base = 1.0 if leaf == "weight" else 0.0
            params[key] = (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            w = rng.standard_normal(shape) * math.sqrt(2.0 / np.prod(shape[1:]))
            params[key] = (w * (head_gain if key.startswith("linear2") else 1.0)).astype(np.float32)
    return state_dict_from_jax(params, state)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events; inputs stay L2-warm across calls).

    A device-side wait is queued ahead of the timed calls, so the host has
    queued all of them before the device starts the first: the events then
    time the device, not the host's launch rate (a wrapper's Python costs
    tens of microseconds a call, which a 0.1 ms kernel would otherwise
    wait for)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for cycles in (10**8, 10**9):  # ~0.05 s and ~0.5 s at H100 clocks
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()  # the device is still in the wait
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
    raise PhaseError("the host could not queue the timed calls ahead of the device")


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    peak = next((dict(fp32=f, tf32=tf, bytes=b) for frag, f, tf, b in PEAKS if frag in kind),
                None)
    check(peak is not None, f"no published peaks on file for {kind!r}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s); peaks used: "
          f"{peak['fp32'] / 1e12:g} TFLOP/s fp32, {peak['tf32'] / 1e12:g} TFLOP/s TF32 "
          f"tensor cores, {peak['bytes'] / 1e12:g} TB/s")
    return card, kind, peak


def phase_build():
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

    t0 = time.perf_counter()
    lib = fbank_cuda.build()
    fbank_cuda._library()
    seconds = time.perf_counter() - t0
    print(f"built {lib.relative_to(REPO)} in {seconds:.2f} s")
    log = lib.with_suffix(".log")
    check(log.is_file(), f"no nvcc report beside {lib.name}")
    spills = []
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills.append(int(m.group(1)) + int(m.group(2)))
    check(spills, "ptxas printed no spill report")
    check(not any(spills), "the fbank kernel spills registers")
    ops = sass_opcodes(lib, "fbank_kernel")
    hmma = sum(op.startswith("HMMA") for op in ops)
    print(f"  SASS: {hmma} HMMA (tensor-core) of {len(ops)} instructions in fbank_kernel "
          f"(dump: {lib.with_suffix('.sass').relative_to(REPO)})")
    check(hmma > 0, "no HMMA instruction in fbank_kernel: the DFT is not on the tensor cores")
    block_frames = fbank_cuda.frames_per_block()
    print(f"  the kernel computes {block_frames} frames a block")
    return block_frames


def sass_opcodes(lib: Path, function: str) -> list:
    """The opcodes, in order, that ``cuobjdump -sass`` shows in the kernels
    of ``lib`` whose name holds ``function``.  The whole dump is kept beside
    the library as ``.sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    check(CUDA_HOME is not None, "no CUDA toolkit (cuobjdump)")
    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    lib.with_suffix(".sass").write_text(sass.stdout)
    ops, inside = [], False
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            ops.append(m.group(1))
    return ops


def phase_kernel(card, peak, block_frames: int):
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep
    from laughter_detection_icsi_tpu_torch.config import FEAT
    from laughter_detection_icsi_tpu_torch.inference import InferenceSettings, strict_fp32
    from laughter_detection_icsi_tpu_torch.ops import fbank as fbank_ops
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda

    rng = np.random.default_rng(0)
    noise = lambda shape: (rng.standard_normal(shape) * 0.1).astype(np.float32)
    snip = host_prep.snip_cfg(FEAT)
    bucket_n = host_prep.bucket_wave_len(InferenceSettings())
    check(bucket_n == 999_120, f"bucket length {bucket_n}")
    silent = noise(32000)
    silent[6000:22000] = 0.0  # whole frames of silence: power at the floor
    tile = block_frames * 3 * FEAT.frame_shift_samples  # 3 whole blocks of frames
    cases = [
        ("n=16000", noise(16000), FEAT),
        ("n=48777", noise(48777), FEAT),
        ("n=399 (under one frame length)", noise(399), FEAT),
        ("n=80 (under one frame length)", noise(80), FEAT),
        ("multi-block, 549 frames", noise((2 * 256 + 37) * 160), FEAT),
        ("batch [3, 16777]", noise((3, 16777)), FEAT),
        ("int16-scaled, n=48777", speechlike(48777, seed=3) / np.float32(32768), FEAT),
        ("silent stretch, n=32000", silent, FEAT),
        (f"tile boundary, {3 * block_frames} frames", noise(tile), FEAT),
        (f"tile boundary, {3 * block_frames + 1} frames",
         noise(tile + FEAT.frame_shift_samples), FEAT),
        ("main-path bucket n=999120", noise(bucket_n), snip),
    ]
    max_err = 0.0
    with strict_fp32():
        print(f"precision in force: {precision_setting()}")
        for label, wave, cfg in cases:
            x = torch.from_numpy(wave).cuda()
            got = fbank_cuda.fbank_cuda(x, cfg)
            want = fbank_ops.fbank(x, cfg)
            torch.cuda.synchronize()
            check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
            try:
                torch.testing.assert_close(got, want, **TOL)
            except AssertionError as e:
                raise PhaseError(f"{label}: kernel disagrees with the plain version: {e}")
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            print(f"  {label}: frames {got.shape[-2]}, max |kernel - plain| = {err:.3e}")
            if label.startswith("silent"):
                floor = torch.full_like(got, math.log(cfg.energy_floor))
                at_floor = int(torch.isclose(got, floor, rtol=0, atol=1e-5).sum().item())
                check(at_floor > 0, f"{label}: no feature at the energy floor")
                print(f"  {label}: {at_floor} features at log(energy_floor)")
            if x.ndim == 2:
                for c in range(x.shape[0]):
                    check(torch.equal(got[c], fbank_cuda.fbank_cuda(x[c].contiguous(), cfg)),
                          f"{label}: channel {c} differs from its own run")
                print("  batch rows equal each channel run alone (bit for bit)")
            if cfg is snip:
                bucket_x = x

        # Times at the main-path bucket.
        x = bucket_x
        t = host_prep.num_frames(bucket_n, snip)
        flen = snip.frame_length_samples
        basis, mel, mel_range = fbank_cuda.kernel_constants(snip, x.device)
        kernel_ms = cuda_ms(lambda: fbank_cuda.fbank_cuda(x, snip))
        plain_ms = cuda_ms(lambda: fbank_ops.fbank(x, snip))
        frames = x.as_strided((t, flen), (snip.frame_shift_samples, 1)).contiguous()
        dft = basis[:flen].contiguous()
        library_ms = cuda_ms(lambda: torch.matmul(frames, dft))
    mel_nnz = int((mel_range[:, 1] - mel_range[:, 0]).sum().item())
    dft_flops, mel_flops = 2 * t * flen * dft.shape[1], 2 * t * mel_nnz
    nbytes = 4 * (bucket_n + basis.numel() + mel.numel() + mel_range.numel()
                  + t * snip.num_filters)
    bound_bytes_ms = 1e3 * nbytes / peak["bytes"]
    # The kernel's DFT is three TF32 products a term (3xTF32) on the tensor
    # cores; the mel sums run on the CUDA cores.  The fp32 bound is the
    # same work as fp32 FMAs on the CUDA cores only.
    bound_ops_ms = 1e3 * (3 * dft_flops / peak["tf32"] + mel_flops / peak["fp32"])
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    bound_fp32_ms = max(1e3 * (dft_flops + mel_flops) / peak["fp32"], bound_bytes_ms)
    print(f"fbank at the bucket ({t} frames; DFT {dft_flops / 1e9:.3f} GFLOP = "
          f"{3 * dft_flops / 1e9:.3f} GFLOP in 3xTF32, mel {mel_flops / 1e9:.4f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) on {card}:")
    print(f"  kernel {kernel_ms:.4f} ms | plain PyTorch {plain_ms:.4f} ms | "
          f"cuBLAS fp32 matmul [{t},{flen}]x[{flen},{dft.shape[1]}] {library_ms:.4f} ms")
    print(f"  3xTF32 tensor-core bound {bound_ms:.4f} ms ({bound_by}; "
          f"{100 * bound_ms / kernel_ms:.1f}% of it reached) | fp32 CUDA-core bound "
          f"{bound_fp32_ms:.4f} ms ({100 * bound_fp32_ms / kernel_ms:.1f}% of it reached)")
    return dict(
        name="fbank", route="cuda",
        source="laughter_detection_icsi_tpu_torch/csrc/fbank.cu",
        replaces="laughter_detection_icsi_tpu/ops/fbank_pallas.py:86",
        max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


def precision_setting() -> str:
    import torch

    return (f"cudnn.conv.fp32_precision={torch.backends.cudnn.conv.fp32_precision}, "
            f"cuda.matmul.fp32_precision={torch.backends.cuda.matmul.fp32_precision}")


def phase_main_path(card, work: Path):
    import torch

    from laughter_detection_icsi_tpu_torch import host_prep, inference
    from laughter_detection_icsi_tpu_torch.cli import segment_laughter as cli
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.data import audio
    from laughter_detection_icsi_tpu_torch.eval import textgrid
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.train import checkpoint

    preset = MODEL_MAP["resnet_base"]

    def build_model():
        return zoo.build(preset.model, dropout_rate=0.0,
                         linear_layer_size=preset.linear_layer_size,
                         filter_sizes=preset.filter_sizes)

    model = build_model()
    ckpt = checkpoint.save_checkpoint(str(work / "ckpt"), seeded_state_dict(model, seed=1))
    model.load_state_dict(checkpoint.load_checkpoint(ckpt)["state_dict"], strict=True)
    wav = work / "meeting.wav"
    pcm = speechlike(16000 * SECONDS, seed=2)
    audio.write_wav(str(wav), pcm, 16000)
    settings = inference.settings_from_flags(device="cuda")
    n_frames = host_prep.num_frames(len(pcm))
    n_buckets = -(-n_frames // settings.bucket_frames)
    print(f"resnet_base ResNetBigger {preset.filter_sizes}, head {preset.linear_layer_size}; "
          f"{SECONDS} s int16 audio = {n_frames} frames = {n_buckets} buckets of "
          f"{settings.bucket_frames}, chunk {settings.chunk}, {settings.precision}")

    pipe = inference.LaughterPipeline(model, settings=settings, device="cuda")
    probs, duration = pipe.probs_for_file(str(wav))  # also warms cuDNN up
    check(probs.shape == (n_frames,), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    check(bool((probs >= 0).all() and (probs <= 1).all()), "probabilities outside [0, 1]")
    # A threshold midway between neighbouring probabilities near the median,
    # so no rerun's rounding can flip a frame across it.
    srt = np.sort(probs.astype(np.float64))
    i = len(srt) // 2
    j = i + int(np.argmax(np.diff(srt[i : i + 50])))
    thr = round(float(srt[j] + srt[j + 1]) / 2, 6)
    check(np.min(np.abs(srt - thr)) > 1e-6, f"threshold {thr} sits on a probability")
    print(f"probs: min {probs.min():.4f}, median {np.median(probs):.4f}, max {probs.max():.4f}")

    # The main path, through the CLI a user calls; kernel launches counted.
    out = work / "out"
    fbank_cuda.launches = 0
    t0 = time.perf_counter()
    rc = cli.main([
        "--model_path", ckpt, "--input_audio_file", str(wav), "--output_dir", str(out),
        "--thresholds", f"{thr},0.9", "--min_lengths", "0.2",
        "--save_to_textgrid", "True", "--save_to_audio_files", "False",
        "--device", "cuda",
    ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = fbank_cuda.launches
    check(rc == 0, f"CLI returned {rc}")
    check(launches == n_buckets, f"fbank kernel launched {launches} times for {n_buckets} buckets")
    print(f"CLI run: fbank kernel launched {launches} times ({n_buckets} buckets)")

    grid = out / f"t_{thr}" / "l_0.2" / "meeting.TextGrid"
    want = smoothing.get_laughter_instances(probs, [thr], [0.2])[(thr, 0.2)]
    check(len(want) > 0, "no laughter instances at the median threshold")
    check(grid.is_file(), f"no TextGrid at {grid}")
    got = textgrid.read_laughter_intervals(str(grid))
    check(got == want, f"TextGrid intervals {got[:3]}... != smoothing {want[:3]}...")
    print(f"TextGrid reads back: {len(got)} instances at threshold {thr}, min_length 0.2")

    # The card against the port on the CPU, on a short clip.
    clip = pcm[: 16000 * 5]
    cpu_model = build_model()
    cpu_model.load_state_dict(model.state_dict())
    cpu_pipe = inference.LaughterPipeline(
        cpu_model, settings=inference.InferenceSettings(chunk=256, bucket_frames=512),
        device="cpu",
    )
    d_cpu = np.abs(pipe.probs_for_waveform(clip) - cpu_pipe.probs_for_waveform(clip)).max()
    check(d_cpu <= 1e-4, f"card vs CPU probs differ by {d_cpu:.3e} > 1e-4")
    print(f"card vs CPU, 5 s clip: max |diff| = {d_cpu:.3e} (limit 1e-4)")

    # Shared stem against the naive window batch, on the card.
    clip = pcm[: 16000 * 20]
    naive = inference.LaughterPipeline(
        model, settings=inference.settings_from_flags(device="cuda", shared_stem=False),
        device="cuda",
    )
    d_stem = np.abs(pipe.probs_for_waveform(clip) - naive.probs_for_waveform(clip)).max()
    check(d_stem <= 1e-5, f"shared stem vs naive differ by {d_stem:.3e} > 1e-5")
    print(f"shared stem vs naive windows, 20 s clip: max |diff| = {d_stem:.3e} (limit 1e-5)")

    # End to end, warm: file read -> probs -> smoothing, as segment_file times it.
    took = [pipe.segment_file(str(wav), [thr], [0.2])[1] for _ in range(3)]
    best = min(took)
    print(f"e2e segment_file on {card}: {SECONDS} s audio in "
          f"{', '.join(f'{s:.4f}' for s in took)} s -> {duration / best:.1f}x realtime "
          f"(best of 3); CLI wall time incl. model load {cli_s:.3f} s")
    device_breakdown(lambda: pipe.segment_file(str(wav), [thr], [0.2]), best,
                     work / "segment_file.trace.json")
    return launches


def device_breakdown(fn, best_s: float, trace_path: Path) -> None:
    """Profile one call of ``fn`` (torch.profiler) and print where its device
    time goes: the busy share of the call's wall time, the kernels with the
    most device time, and the fbank kernel's share.  A profiler that records
    no device activity leaves these unmeasured: that says nothing about the
    port, so it is reported and not failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        print("device breakdown: not measured (the profiler recorded no device activity)")
        return
    by_name = {}
    for e in dev:
        n, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, us + float(e["dur"]))
    total_ms = sum(us for _, us in by_name.values()) / 1e3
    busy_us, end = 0.0, -math.inf  # union of the device's intervals
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    print(f"profiled segment_file: wall {wall_ms:.2f} ms, {len(dev)} device ops, "
          f"device time {total_ms:.2f} ms, busy {busy_ms:.2f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% of this call's wall "
          f"({100 * busy_ms / (1e3 * best_s):.1f}% of the best unprofiled e2e)")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {100 * us / 1e3 / total_ms:5.1f}% {us / 1e3:9.3f} ms  x{n:<5d} {name[:100]}")
    fb_ms = sum(us for name, (_, us) in by_name.items() if "fbank_kernel" in name) / 1e3
    print(f"  fbank kernel: {fb_ms:.3f} ms = {100 * fb_ms / total_ms:.2f}% of device time")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAILED: PyTorch is missing ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (REPO / "laughter_detection_icsi_tpu_torch").is_dir():
        print(f"chip_smoke: FAILED: no laughter_detection_icsi_tpu_torch package beside "
              f"{Path(__file__).name}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        print("== 1. device ==")
        card, kind, peak = phase_device()
        print("== 2. build ==")
        block_frames = phase_build()
        print("== 3. fbank kernel vs its plain version ==")
        entry = phase_kernel(card, peak, block_frames)
        print("== 4. main path ==")
        launches = phase_main_path(card, work)
    except Exception as e:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    entry = {"name": entry.pop("name"), "route": entry.pop("route"),
             "source": entry.pop("source"), "replaces": entry.pop("replaces"),
             "launches": launches, **entry}
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
