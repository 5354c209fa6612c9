"""A meeting sweep: one meeting after another through the program's
multichannel pipeline and its on-device smoothing, in a closed loop.

Each meeting (int16 [channels, samples]) goes through
``ShardedPipeline(devices=[card]).probs_for_waveforms_device``, then each
channel's probabilities through ``ops/smoothing.instances_from_device_probs``
over the threshold x minimum-length grid, whose run tables come to the
host: ``cli/sweep.py``'s loop without its disk reads and TextGrid writes.
The window closes at the first meeting boundary after ``--seconds``, and
``x_realtime`` is the audio seconds of its meetings over its length.

The check: a sample of frames drawn from the seed (with every channel's
first and last frame and the frames beside each bucket boundary) against
the reference's float32 features and per-window network
(``logit_gap_mean``, the mean gap of their logits; the widest and the mean
gap of the probabilities are printed, not compared), and every channel's
event tables against the reference smoothing of that channel's
probabilities (``event_mismatches``, exact).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import traffic
import weights
from harness import log
from reference import fbank as ref_fbank
from reference import resnet as ref_resnet
from reference import smoothing as ref_smoothing
from reference.precision import float32


def build(job):
    """The program's pipeline over the cell's weights, and the traffic."""
    from laughter_detection_icsi_tpu_torch.inference import InferenceSettings
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.parallel.sharded_inference import ShardedPipeline

    cfg, tr = job.cell.config, job.cell.traffic
    log("building")
    pool = traffic.meeting_pool(tr, job.seed)
    log("traffic made")
    p = weights.calibrated(cfg, job.seed, calibration_windows(cfg, pool[0][0], job.seed, job.device))
    log("weights made")
    m = cfg["model"]
    model = zoo.build(m["architecture"], dropout_rate=m["dropout_rate"],
                      linear_layer_size=m["linear_layer_size"], filter_sizes=m["filter_sizes"])
    model.load_state_dict(weights.port_state_dict(p), strict=True)
    inf = cfg["inference"]
    settings = InferenceSettings(
        window=cfg["features"]["window"], chunk=inf["chunk"], bucket_frames=inf["bucket_frames"],
        precision=cfg["precision"], transfer_int16=inf["transfer_int16"],
        transfer_codec=inf["transfer_codec"], shared_stem=inf["shared_stem"], mode=inf["mode"])
    pipe = ShardedPipeline(model, settings=settings, devices=[job.device])
    return pipe, pool, p


def calibration_windows(cfg: dict, pcm: np.ndarray, seed: int, device) -> torch.Tensor:
    feat, w = cfg["features"], cfg["weights"]
    n = feat["sampling_rate"] * w["calibration_seconds"]
    with float32():
        feats = ref_fbank.fbank(pcm[:n], feat, device).float()
    frames = np.random.default_rng([seed, 3]).integers(
        0, feats.shape[0] - feat["window"], size=w["calibration_windows"])
    return ref_fbank.windows_at(feats, frames, feat["window"])


def sweep_meeting(pipe, pcm: np.ndarray, tr: dict):
    """One meeting: (probs [C, t] on the device, frame counts, each
    channel's events)."""
    from laughter_detection_icsi_tpu_torch.ops import smoothing

    with torch.profiler.record_function("bench/pipeline"):
        probs, ts = pipe.probs_for_waveforms_device(list(pcm))
    duration = pcm.shape[1] / tr["sampling_rate"]
    events = []
    with torch.profiler.record_function("bench/smoothing"):
        for i, row in pipe.local_channels(probs, len(ts)):
            events.append(smoothing.instances_from_device_probs(
                row[:ts[i]], thresholds=tr["thresholds"], min_lengths=tr["min_lengths"],
                fps=ts[i] / duration))
    return probs, ts, events


def run(job) -> dict:
    tr = job.cell.traffic
    pipe, pool, p = build(job)
    # Every shape of the traffic, once: a whole bucket batch and a partial
    # one (a meeting's buckets all have one shape; the count is a value).
    bucket = pipe.settings.bucket_frames * job.cell.config["features"]["frame_shift_samples"]
    sweep_meeting(pipe, pool[0][:, : 3 * bucket // 2], tr)
    job.synchronize()
    log("warm")
    done = []  # (pool index, probs, counts, events)
    opened = time.perf_counter()
    setup_s = opened - job.started
    out = {"e2e": {"setup_s": setup_s}}
    if job.trace:
        def slice_():
            for k in range(tr["trace_meetings"]):
                done.append((k % len(pool), *sweep_meeting(pipe, pool[k % len(pool)], tr)))
            return {"meetings": tr["trace_meetings"]}
        trace = job.profiled(slice_)
        trace.work.update(_work(pipe, pool[0], job.cell.config, trace.work["meetings"]))
        out["trace"] = trace
    else:
        k, last = 0, opened
        while True:
            done.append((k % len(pool), *sweep_meeting(pipe, pool[k % len(pool)], tr)))
            k += 1
            now = time.perf_counter()
            log(f"meeting {k}: {now - last:.4f} s")
            last = now
            if now - opened >= job.seconds:
                break
        job.synchronize()
        window = time.perf_counter() - opened
        audio = k * pool[0].shape[0] * pool[0].shape[1] / tr["sampling_rate"]
        out["e2e"]["x_realtime"] = audio / window
        print(f"window: {k} meetings, {audio:.1f} audio-s in {window:.4f} s", flush=True)
    out["memory_peak_bytes"] = job.memory_peak()
    out["attempted"] = len(done) * pool[0].shape[0]
    out["failed"] = 0
    probs = [(m, pr[:, :max(ts)].float().cpu().numpy(), ts, ev) for m, pr, ts, ev in done]
    del pipe, done
    if job.device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = compare(job, pool, p, probs)
    log("checked")
    return out


def _work(pipe, pcm: np.ndarray, cfg: dict, meetings: int) -> dict:
    """What a profiled slice of ``meetings`` meetings did, for the
    per-layer metrics."""
    c, n = pcm.shape
    shift = cfg["features"]["frame_shift_samples"]
    t = (n + shift // 2) // shift
    s = pipe.settings
    buckets = -(-t // s.bucket_frames)
    return {"audio_s": meetings * c * n / cfg["features"]["sampling_rate"],
            "frames": meetings * c * t,
            "fbank_launches": meetings * buckets,
            "fbank_launch": {"rows": c, "samples": pipe.wave_len,
                             "frames": s.bucket_frames + s.window - 1}}


def sample_frames(seed: int, n: int, instances: list, channels: int, t: int, bucket: int) -> list:
    """(meeting instance, channel, frame) triples to compare, over meeting
    instances of the pool meetings ``instances``: every channel's first and
    last frames and those beside each bucket boundary in one instance of
    each pool meeting, and ``n`` drawn from the seed."""
    rng = np.random.default_rng([seed, 4])
    first = {}
    for j, m in enumerate(instances):
        first.setdefault(m, j)
    edges = sorted({0, t - 1, t - 2, *[b + d for b in range(bucket, t, bucket) for d in (-1, 0)]})
    picks = [(j, ch, f) for j in first.values() for ch in range(channels) for f in edges]
    js = rng.integers(0, len(instances), size=n)
    chs = rng.integers(0, channels, size=n)
    fs = rng.integers(0, t, size=n)
    return picks + list(zip(js.tolist(), chs.tolist(), fs.tolist()))


def reference_probs(job, pool, p, picks, instances, quant=None) -> np.ndarray:
    """The reference's probability of each picked frame: float32 features of
    the channel, the window at the frame, the per-window network in
    float32 (TF32 off), or through ``quant`` (a control)."""
    cfg = job.cell.config
    feat, model = cfg["features"], {**cfg["model"], "dropout_rate": 0.0}
    out = np.zeros(len(picks))
    by_channel = {}
    for i, (j, ch, f) in enumerate(picks):
        by_channel.setdefault((instances[j], ch), []).append((i, f))
    with float32():
        for (m, ch), items in sorted(by_channel.items()):
            feats = ref_fbank.fbank(pool[m][ch], feat, job.device).float()
            wins = ref_fbank.windows_at(feats, [f for _, f in items], feat["window"])
            out[[i for i, _ in items]] = ref_resnet.probs_in_blocks(
                p, wins, model, quant=quant).double().cpu().numpy()
    return out


def picks_for(job, pool, instances) -> list:
    cfg = job.cell.config
    shift = cfg["features"]["frame_shift_samples"]
    t = (pool[0].shape[1] + shift // 2) // shift
    return sample_frames(job.seed, job.cell.check["sample_frames"], instances, pool[0].shape[0], t,
                         cfg["inference"]["bucket_frames"])


def prob_gaps(got: np.ndarray, ref: np.ndarray):
    """(widest gap of the probabilities, their mean gap, the mean gap of
    their logits)."""
    gap = np.abs(got - ref)
    logit = lambda p: np.log(np.clip(p, 1e-7, 1 - 1e-7)) - np.log1p(-np.clip(p, 1e-7, 1 - 1e-7))
    return float(gap.max()), float(gap.mean()), float(np.abs(logit(got) - logit(ref)).mean())


def compare(job, pool, p, done_probs) -> dict:
    tr, limits = job.cell.traffic, job.cell.check["limits"]
    instances = [m for m, *_ in done_probs]
    picks = picks_for(job, pool, instances)
    ref = reference_probs(job, pool, p, picks, instances)
    got = np.array([done_probs[j][1][ch, f] for j, ch, f in picks], dtype=np.float64)
    widest, mean_gap, logit_gap = prob_gaps(got, ref)
    log(f"probability gaps, not compared: widest {widest!r} (it swings by its nature), "
        f"mean {mean_gap!r} (the fp8 control's reads under 3x it)")
    mismatches = 0
    for m, probs, ts, events in done_probs:
        for ch, ev in enumerate(events):
            want = ref_smoothing.events(probs[ch, :ts[ch]], tr["thresholds"], tr["min_lengths"],
                                        ts[ch] / (pool[m].shape[1] / tr["sampling_rate"]))
            mismatches += sum(ev.get(k) != v for k, v in want.items()) + len(set(ev) - set(want))
    return {"logit_gap_mean": (logit_gap, limits["logit_gap_mean"]),
            "event_mismatches": (float(mismatches), limits["event_mismatches"])}
