"""A meeting sweep of the clips mode: the AudioSet Audio Spectrogram
Transformer tagging laughter over whole meetings, in a closed loop.

The sweep driver's loop (``drivers/sweep.py``'s ``sweep_meeting``: each
int16 meeting through ``ShardedPipeline(devices=[card])
.probs_for_waveforms_device``, then each channel's probabilities through
``ops/smoothing.instances_from_device_probs`` over the threshold x
minimum-length grid) with the program's AST in its clips mode: each
bucket's 128-bin features cut into 1,024-frame clips a block of 100
frames apart, every frame of a block the laughter class's probability of
its clip.  The pipeline keeps each bucket batch's clip logits
(``logit_sink``) for the check.  The window closes at the first meeting
boundary after ``--seconds``; ``x_realtime`` is the audio seconds of its
meetings over its length.

Weights come from the seed on the card (timm's initialisation), the
laughter row of the head scaled and biased on the traffic's own clips so
that its logits have the configured mean and spread, all rounded to
values bfloat16 holds in a bfloat16 configuration.

The check, against ``reference/ast.py`` (float32, TF32 off):
``logit_gap_mean``, the mean gap of all the head's logits over a sample
of clips (every channel's first and last clip of each pool meeting's first
run, the zero-padded ones, and ``sample_clips`` drawn from the seed);
``event_mismatches``, every channel's event tables against the reference
smoothing of that channel's probabilities (exact); ``block_mismatches``,
the frames whose probability is not ``sigmoid`` of their block's own
laughter logit (exact).

A program without AST or the clips mode fails at once, before any traffic
is made.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

import traffic
from drivers import sweep as meeting_sweep
from harness import RunFailed, log
from reference import ast as ref_ast
from reference import smoothing as ref_smoothing


#: Seconds the warm-up runs whole meetings for, the first one's compiles
#: included.  The card reaches its power cap within a meeting and then
#: heats: after a warm-up of 1.5 buckets a window's meetings slowed by up to
#: 3% over its first ~25 s; after this one they hold within 1% (H100 80GB
#: HBM3, 700 W).
WARM_SECONDS = 15.0


def require_clips_mode():
    """The program's pieces this driver needs, or RunFailed."""
    try:
        from laughter_detection_icsi_tpu_torch import inference
        from laughter_detection_icsi_tpu_torch.models import zoo

        inference.InferenceSettings(mode="clips", bucket_frames=1000)
    except (ImportError, ValueError, TypeError) as e:
        raise RunFailed(f"the program has no clips mode (AST): {e}") from None
    if "AST" not in zoo.MODEL_REGISTRY:
        raise RunFailed("the program's zoo has no AST")
    return inference


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def initial(cfg: dict, seed: int, device) -> dict:
    """Every leaf (float32, on ``device``) by timm's initialisation: each
    linear weight, the tokens and the position embedding trunc-normal with
    ``init_std``, their biases 0, LayerNorm 1 and 0, the patch conv uniform
    in +-1/sqrt(fan_in)."""
    std = cfg["weights"]["init_std"]
    gen = _generator(seed, device)
    shapes = ref_ast.param_shapes(cfg["model"])
    bound = 1.0 / math.sqrt(math.prod(shapes["v.patch_embed.proj.weight"][1:]))
    out = {}
    for k, shape in shapes.items():
        t = torch.empty(shape, device=device)
        is_ln = k.rsplit(".", 1)[0].endswith(("norm1", "norm2", "v.norm", "mlp_head.0"))
        if k.startswith("v.patch_embed"):
            t.uniform_(-bound, bound, generator=gen)
        elif is_ln:
            t.fill_(1.0 if k.endswith("weight") else 0.0)
        elif k.endswith(".bias"):
            t.zero_()
        else:
            torch.nn.init.trunc_normal_(t, std=std, generator=gen)
        out[k] = t
    return out


def features(cfg: dict, pcm: np.ndarray, device) -> torch.Tensor:
    return ref_ast.fbank(pcm, cfg["features"], device)


def calibrated(cfg: dict, seed: int, pcm: np.ndarray, device) -> dict:
    """``initial``, then the laughter row of the head scaled and biased so
    that the reference's laughter logits of ``calibration_clips`` clips of
    ``pcm`` ([channels, n], drawn from the seed) have the configured mean
    and spread; rounded to bfloat16 values in a bfloat16 configuration."""
    w, model = cfg["weights"], cfg["model"]
    p = initial(cfg, seed, device)
    rng = np.random.default_rng([seed, 3])
    chans = rng.integers(0, pcm.shape[0], size=w["calibration_clips"])
    clips = []
    for ch in sorted(set(chans.tolist())):
        feats = features(cfg, pcm[ch], device)
        blocks = rng.integers(0, -(-feats.shape[0] // cfg["clips"]["hop_frames"]),
                              size=int((chans == ch).sum()))
        clips.append(ref_ast.clips_at(feats, blocks, cfg["clips"], cfg["normalisation"]))
    logit = ref_ast.logits(p, torch.cat(clips), model)[:, model["laughter_class"]].double()
    gain = w["head_logit_std"] / float(logit.std())
    row = model["laughter_class"]
    p["mlp_head.1.weight"][row] *= gain
    p["mlp_head.1.bias"][row] = p["mlp_head.1.bias"][row] * gain + (
        w["head_logit_mean"] - gain * float(logit.mean()))
    if cfg["precision"] == "bfloat16":
        p = {k: v.to(torch.bfloat16).float() for k, v in p.items()}
    return p


def feat_config(cfg: dict):
    """The program's ``FeatConfig`` of the configuration's features."""
    from laughter_detection_icsi_tpu_torch.config import FeatConfig

    f = cfg["features"]
    return FeatConfig(
        num_samples=f["sampling_rate"] // f["frame_shift_samples"], num_filters=f["num_filters"],
        sampling_rate=f["sampling_rate"],
        frame_length=f["frame_length_samples"] / f["sampling_rate"],
        preemph_coeff=f["preemph_coeff"], remove_dc_offset=f["remove_dc_offset"],
        window_type=f["window_type"], dither=f["dither"], snip_edges=f["snip_edges"],
        energy_floor=f["energy_floor"], low_freq=f["low_hz"], high_freq=f["high_hz"])


def build(job):
    """The program's pipeline over the cell's weights, and the traffic."""
    inference = require_clips_mode()
    from laughter_detection_icsi_tpu_torch.models.ast import ASTModel
    from laughter_detection_icsi_tpu_torch.parallel.sharded_inference import ShardedPipeline

    cfg, tr = job.cell.config, job.cell.traffic
    log("building")
    pool = traffic.meeting_pool(tr, job.seed)
    log("traffic made")
    p = calibrated(cfg, job.seed, pool[0], job.device)
    log("weights made")
    m = cfg["model"]
    model = ASTModel(fdim=m["fdim"], tdim=m["tdim"], fstride=m["fstride"], tstride=m["tstride"],
                     dim=m["dim"], depth=m["depth"], heads=m["heads"], mlp=m["mlp"],
                     label_dim=m["label_dim"])
    model.load_state_dict({k: v.detach().cpu() for k, v in p.items()}, strict=True)
    inf, clips = cfg["inference"], cfg["clips"]
    settings = inference.InferenceSettings(
        mode=inf["mode"], bucket_frames=inf["bucket_frames"], precision=cfg["precision"],
        transfer_int16=inf["transfer_int16"], transfer_codec=inf["transfer_codec"],
        clip_frames=clips["clip_frames"], hop_frames=clips["hop_frames"],
        clip_batch=clips["clip_batch"])
    pipe = ShardedPipeline(model, feat_cfg=feat_config(cfg), settings=settings,
                           devices=[job.device])
    return inference, pipe, pool, p


def sweep_meeting(pipe, pcm: np.ndarray, tr: dict):
    """One meeting: (probs [C, t] on the device, frame counts, each
    channel's events, the clip logits [C, blocks, classes] on the device)."""
    pipe.logit_sink = []
    probs, ts, events = meeting_sweep.sweep_meeting(pipe, pcm, tr)
    logits = torch.cat(pipe.logit_sink, dim=1)
    pipe.logit_sink = None
    return probs, ts, events, logits


def run(job) -> dict:
    tr = job.cell.traffic
    inference, pipe, pool, p = build(job)
    # Whole meetings (a meeting's bucket batches all have one shape) for
    # WARM_SECONDS, or the window's length if shorter: every shape runs in
    # the first, and the card's clocks settle under its power cap.
    k, warm_from = 0, time.perf_counter()
    while k == 0 or time.perf_counter() - warm_from < min(WARM_SECONDS, job.seconds):
        sweep_meeting(pipe, pool[k % len(pool)], tr)
        job.synchronize()
        k += 1
    log(f"warm: {k} meetings")
    done = []  # (pool index, probs, counts, events, logits)
    opened = time.perf_counter()
    out = {"e2e": {"setup_s": opened - job.started}}
    if job.trace:
        counted = (inference.clips_classified, inference.clip_padded_frames)

        def slice_():
            for k in range(tr["trace_meetings"]):
                done.append((k % len(pool), *sweep_meeting(pipe, pool[k % len(pool)], tr)))
            return {"meetings": tr["trace_meetings"]}
        trace = job.profiled(slice_)
        trace.work.update(_work(pipe, pool[0], job.cell.config, trace.work["meetings"]))
        trace.work.update(clips=inference.clips_classified - counted[0],
                          clip_padded_frames=inference.clip_padded_frames - counted[1])
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
    hop = pipe.settings.hop_frames
    del pipe
    out["checks"] = compare(job, pool, p, done, hop)
    log("checked")
    return out


def _work(pipe, pcm: np.ndarray, cfg: dict, meetings: int) -> dict:
    """What a profiled slice of ``meetings`` meetings did, for the
    per-layer metrics (the clips the program counted are added beside)."""
    from laughter_detection_icsi_tpu_torch import host_prep

    c, n = pcm.shape
    t = ref_ast.num_frames(n, cfg["features"])
    s = pipe.settings
    buckets = -(-t // s.bucket_frames)
    return {"audio_s": meetings * c * n / cfg["features"]["sampling_rate"],
            "frames": meetings * c * t,
            "fbank_launches": meetings * buckets,
            "fbank_launch": {"rows": c, "samples": pipe.wave_len,
                             "frames": s.bucket_frames + host_prep.halo_frames(s)}}


def sample_clips(seed: int, n: int, instances: list, channels: int, blocks: int) -> list:
    """(meeting instance, channel, block) triples to compare: every
    channel's first and last block in one instance of each pool meeting,
    and ``n`` drawn from the seed over every instance."""
    rng = np.random.default_rng([seed, 4])
    first = {}
    for j, m in enumerate(instances):
        first.setdefault(m, j)
    picks = [(j, ch, b) for j in first.values() for ch in range(channels) for b in (0, blocks - 1)]
    js = rng.integers(0, len(instances), size=n)
    chs = rng.integers(0, channels, size=n)
    bs = rng.integers(0, blocks, size=n)
    return picks + list(zip(js.tolist(), chs.tolist(), bs.tolist()))


def picks_for(job, pool, instances) -> list:
    cfg = job.cell.config
    t = ref_ast.num_frames(pool[0].shape[1], cfg["features"])
    blocks = -(-t // cfg["clips"]["hop_frames"])
    return sample_clips(job.seed, job.cell.check["sample_clips"], instances, pool[0].shape[0],
                        blocks)


def reference_logits(job, pool, p, picks, instances, quant=None) -> torch.Tensor:
    """The reference's logits of each picked clip ([picks, classes] float32,
    on the device): float32 features of the channel, the clip of the block,
    the model in float32 (TF32 off), or through ``quant`` (a control)."""
    cfg = job.cell.config
    out = torch.zeros((len(picks), cfg["model"]["label_dim"]), device=job.device)
    by_channel = {}
    for i, (j, ch, b) in enumerate(picks):
        by_channel.setdefault((instances[j], ch), []).append((i, b))
    for (m, ch), items in sorted(by_channel.items()):
        feats = features(cfg, pool[m][ch], job.device)
        clips = ref_ast.clips_at(feats, [b for _, b in items], cfg["clips"], cfg["normalisation"])
        out[[i for i, _ in items]] = ref_ast.logits(p, clips, cfg["model"], quant=quant)
    return out


def compare(job, pool, p, done, hop: int) -> dict:
    tr, limits = job.cell.traffic, job.cell.check["limits"]
    laugh = job.cell.config["model"]["laughter_class"]
    instances = [m for m, *_ in done]
    picks = picks_for(job, pool, instances)
    got = torch.stack([done[j][4][ch, b] for j, ch, b in picks]).float()
    ref = reference_logits(job, pool, p, picks, instances)
    logit_gap = float((got - ref).abs().mean())
    laugh_gap = float((got[:, laugh] - ref[:, laugh]).abs().mean())
    log(f"laughter logit gap, not compared: mean {laugh_gap!r} over {len(picks)} clips")
    blocks_off, mismatches = 0, 0
    for m, probs, ts, events, logits in done:
        own = torch.sigmoid(logits[..., laugh].float()).repeat_interleave(hop, dim=1)
        for ch, t in enumerate(ts):
            blocks_off += int((probs[ch, :t] != own[ch, :t]).sum())
        host = probs[:, :max(ts)].float().cpu().numpy()
        for ch, ev in enumerate(events):
            want = ref_smoothing.events(host[ch, :ts[ch]], tr["thresholds"], tr["min_lengths"],
                                        ts[ch] / (pool[m].shape[1] / tr["sampling_rate"]))
            mismatches += sum(ev.get(k) != v for k, v in want.items()) + len(set(ev) - set(want))
    return {"logit_gap_mean": (logit_gap, limits["logit_gap_mean"]),
            "event_mismatches": (float(mismatches), limits["event_mismatches"]),
            "block_mismatches": (float(blocks_off), limits["block_mismatches"])}
