"""Reference-parity protocol harness for the PyTorch port (BASELINE.md /
BASELINE.json configs).

The JAX package's ``cli/parity.py`` with the same flags, goldens layout,
report and exit codes, plus ``--device`` (default ``cuda``, no fallback):
the five parity checks against a goldens directory, one JSON pass/fail
report.  The goldens come from the PyTorch reference (the export contract
below), from the JAX package's ``--write_goldens`` (the repository commits
a drill set in ``tests/fixtures/parity_goldens/``, which holds the port on
the card against the JAX package through files), or from this CLI's own
``--write_goldens``.  Run it as

    python -m laughter_detection_icsi_tpu_torch.cli.parity \\
        --goldens tests/fixtures/parity_goldens --audio_dir a/ \\
        --transcript_dir t/ --model_path ck/last.ckpt.npz \\
        --chunk 512 --bucket_frames 1024 --device cuda

Checks (BASELINE.json configs 1-5):
  features    fbank features per audio file vs features/<stem>.npy (on
              ``cuda`` the fbank kernel, one launch a 30,000-frame bucket)
  probs       laugh probabilities per audio file vs probs/<stem>.npy
  textgrids   segmentation at the manifest's (threshold, min_length) vs
              textgrids/<stem>.TextGrid
  analyse     full sweep -> eval: corpus-weighted precision/recall rows vs
              sum_stats.csv
  loss_curve  K train steps on the EXACT batches in train/batches.npz,
              starting from --model_path, vs train/loss_curve.csv

Parity is defined in float32: the pipeline and the sweep this CLI starts
run in float32 on every device, where the other CLIs default to bfloat16
on the card.

Goldens layout:
  <goldens>/manifest.json      {"threshold": .., "min_length": ..,
                                "thresholds": [..], "min_lengths": [..],
                                "split": "all"}
  <goldens>/features/<stem>.npy      [T, num_filters] float32
  <goldens>/probs/<stem>.npy         [T] float32
  <goldens>/textgrids/<stem>.TextGrid
  <goldens>/sum_stats.csv
  <goldens>/train/batches.npz        inputs [K,B,T,F], labels [K,B]
  <goldens>/train/loss_curve.csv     columns: step, loss

<stem> is the audio file's path relative to --audio_dir, extension
stripped, path separators replaced by "__" (e.g. Bmr021__chan1).  Checks
whose goldens are absent are reported "skipped", never failed.  Exit code 0
iff nothing failed.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

#: The precision parity is defined in (see the module docstring).
PRECISION = "float32"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--goldens", type=str, required=True,
                   help="goldens directory (see module docstring for layout)")
    p.add_argument("--audio_dir", type=str, required=True,
                   help="audio root: <meeting>/<chan>.sph|.wav")
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint (.ckpt.npz / .pth.tar / dir) for the "
                        "probs/textgrids/analyse/loss checks")
    p.add_argument("--transcript_dir", type=str, default=None,
                   help="ICSI transcripts (needed for the analyse check)")
    p.add_argument("--config", type=str, default="resnet_base")
    p.add_argument("--configs", type=str,
                   default="features,probs,textgrids,analyse,loss_curve",
                   help="comma list of checks to run")
    p.add_argument("--out", type=str, default=None,
                   help="write the JSON report here (default: stdout only)")
    p.add_argument("--write_goldens", action="store_true",
                   help="produce the goldens from THIS framework (drill "
                        "mode / reference-export template)")
    p.add_argument("--feat_atol", type=float, default=1e-3)
    p.add_argument("--prob_atol", type=float, default=1e-3)
    p.add_argument("--tg_tol", type=float, default=0.02,
                   help="TextGrid boundary tolerance in seconds")
    p.add_argument("--metric_atol", type=float, default=1e-3)
    p.add_argument("--loss_atol", type=float, default=5e-2)
    p.add_argument("--train_steps", type=int, default=8,
                   help="--write_goldens: steps in the pinned batch stream")
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--bucket_frames", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def _audio_files(audio_dir: str) -> Dict[str, str]:
    """stem -> path for every .sph/.wav under audio_dir."""
    out = {}
    root = Path(audio_dir)
    for ext in ("*.sph", "*.wav"):
        for f in sorted(root.rglob(ext)):
            stem = str(f.relative_to(root).with_suffix("")).replace(os.sep, "__")
            if stem in out:
                # Silent overwrite would compare goldens against the WRONG
                # audio file (e.g. a .sph and its converted .wav twin).
                raise SystemExit(
                    f"audio stems collide: {out[stem]} and {f} both flatten "
                    f"to {stem!r} — remove one or separate the directories"
                )
            out[stem] = str(f)
    return out


def _load_model(args):
    """The preset's model at dropout 0 with --model_path's weights, or None
    without --model_path."""
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt_lib

    if args.model_path is None:
        return None
    preset = MODEL_MAP[args.config]
    model = zoo.build(
        preset.model,
        dropout_rate=0.0,
        linear_layer_size=preset.linear_layer_size,
        filter_sizes=preset.filter_sizes,
    )
    best = ckpt_lib.resolve_checkpoint(args.model_path)
    if best is None:
        raise SystemExit(f"Model checkpoint not found at {args.model_path}")
    model.load_state_dict(ckpt_lib.load_checkpoint(best)["state_dict"], strict=True)
    return model


def _pipeline(args, model):
    from laughter_detection_icsi_tpu_torch import inference

    settings = inference.settings_from_flags(
        chunk=args.chunk, bucket_frames=args.bucket_frames, precision=PRECISION,
        device=args.device,
    )
    return inference.LaughterPipeline(model, settings=settings, device=args.device)


# --------------------------------------------------------------------------- #
# Checks
# --------------------------------------------------------------------------- #


def _finish_compared(out: dict, n: int, missing: List[str], ok: bool) -> dict:
    """Final status for a per-golden comparison check: goldens whose audio
    file is absent fail the check (a "pass" from half the goldens would
    claim parity that was never established); whole-check "skipped" is
    reserved for goldens that don't exist at all."""
    if missing:
        out.update(
            status="fail", missing_audio=missing,
            reason=f"{len(missing)} golden(s) had no matching audio file "
                   f"under --audio_dir — parity cannot be claimed from a "
                   f"partial comparison",
        )
        return out
    out["status"] = "pass" if (n and ok) else "fail"
    return out


def _check_features(gdir: Path, audio: Dict[str, str], atol: float,
                    device: str = "cuda") -> dict:
    import numpy as np

    from laughter_detection_icsi_tpu_torch.config import FEAT
    from laughter_detection_icsi_tpu_torch.data import audio as audio_io
    from laughter_detection_icsi_tpu_torch.data.feature_cache import compute_track_features

    feat_dir = gdir / "features"
    goldens = sorted(feat_dir.glob("*.npy")) if feat_dir.is_dir() else []
    if not goldens:
        return {"status": "skipped", "reason": "no features/ goldens"}
    worst, n = 0.0, 0
    missing: List[str] = []
    for g in goldens:
        stem = g.stem
        if stem not in audio:
            missing.append(stem)
            continue
        want = np.load(g)
        wave, sr = audio_io.read(audio[stem])
        # The other checks route through probs_for_file, which rejects a
        # wrong-rate file; this one featurizes directly.
        if sr != FEAT.sampling_rate:
            return {
                "status": "fail", "stem": stem,
                "reason": f"{audio[stem]} is {sr} Hz; the featurizer "
                          f"expects {FEAT.sampling_rate} Hz",
            }
        got = compute_track_features(wave, device=device)
        if got.shape != want.shape:
            return {
                "status": "fail", "stem": stem,
                "reason": f"shape {got.shape} vs golden {want.shape}",
            }
        worst = max(worst, float(np.max(np.abs(got - want))) if got.size else 0.0)
        n += 1
    out = {"n": n, "max_abs_diff": worst, "atol": atol}
    return _finish_compared(out, n, missing, ok=worst <= atol)


def _check_probs(gdir: Path, audio: Dict[str, str], pipe, atol: float) -> dict:
    import numpy as np

    probs_dir = gdir / "probs"
    goldens = sorted(probs_dir.glob("*.npy")) if probs_dir.is_dir() else []
    if not goldens:
        return {"status": "skipped", "reason": "no probs/ goldens"}
    if pipe is None:
        return {"status": "skipped", "reason": "no --model_path"}
    worst, n = 0.0, 0
    missing: List[str] = []
    for g in goldens:
        if g.stem not in audio:
            missing.append(g.stem)
            continue
        want = np.load(g)
        got, _dur = pipe.probs_for_file(audio[g.stem])
        if got.shape != want.shape:
            return {
                "status": "fail", "stem": g.stem,
                "reason": f"shape {got.shape} vs golden {want.shape}",
            }
        worst = max(worst, float(np.max(np.abs(got - want))) if got.size else 0.0)
        n += 1
    out = {"n": n, "max_abs_diff": worst, "atol": atol}
    return _finish_compared(out, n, missing, ok=worst <= atol)


def _check_textgrids(
    gdir: Path, audio: Dict[str, str], pipe, manifest: dict, tol: float
) -> dict:
    from laughter_detection_icsi_tpu_torch.eval import textgrid as tg

    tg_dir = gdir / "textgrids"
    goldens = sorted(tg_dir.glob("*.TextGrid")) if tg_dir.is_dir() else []
    if not goldens:
        return {"status": "skipped", "reason": "no textgrids/ goldens"}
    if pipe is None:
        return {"status": "skipped", "reason": "no --model_path"}
    thr = float(manifest.get("threshold", 0.5))
    min_len = float(manifest.get("min_length", 0.2))
    worst, n = 0.0, 0
    missing: List[str] = []
    for g in goldens:
        stem = g.stem
        if stem not in audio:
            missing.append(stem)
            continue
        want = tg.read_laughter_intervals(str(g))
        inst, _took = pipe.segment_file(
            audio[stem], thresholds=[thr], min_lengths=[min_len]
        )
        got = inst[(thr, min_len)]
        if len(got) != len(want):
            return {
                "status": "fail", "stem": stem,
                "reason": f"{len(got)} instances vs golden {len(want)}",
            }
        for (a0, a1), (b0, b1) in zip(got, want):
            worst = max(worst, abs(a0 - b0), abs(a1 - b1))
        n += 1
    out = {
        "n": n, "max_boundary_diff_s": worst, "tol_s": tol,
        "threshold": thr, "min_length": min_len,
    }
    return _finish_compared(out, n, missing, ok=worst <= tol)


def _run_sweep_stats(args, manifest: dict, workdir: Path) -> Path:
    """Run the port's full sweep + analyse in float32; returns the
    sum-stats CSV path.  Raises RuntimeError on sweep failure."""
    from laughter_detection_icsi_tpu_torch.cli import sweep as sweep_cli

    split = manifest.get("split", "all")
    thresholds = ",".join(str(t) for t in manifest.get("thresholds", [0.5]))
    min_lengths = ",".join(str(m) for m in manifest.get("min_lengths", [0.2]))
    out_dir = workdir / "preds"
    sweep_args = [
        "--audio_dir", args.audio_dir,
        "--transcript_dir", args.transcript_dir,
        "--output_dir", str(out_dir),
        "--split", split,
        "--model_path", args.model_path,
        # Without forwarding the preset, sweep would build its default
        # resnet_base and apply a differently-shaped checkpoint to it.
        "--config", args.config,
        "--thresholds", thresholds,
        "--min_lengths", min_lengths,
        "--precision", PRECISION,
        "--device", args.device,
        "--analyse",
    ]
    if args.chunk:
        sweep_args += ["--chunk", str(args.chunk)]
    if args.bucket_frames:
        sweep_args += ["--bucket_frames", str(args.bucket_frames)]
    rc = sweep_cli.main(sweep_args)
    if rc != 0:
        raise RuntimeError(f"sweep exited {rc}")
    ours_csv = out_dir / f"{split}_sum_stats.csv"
    if not ours_csv.is_file():
        raise RuntimeError(f"sweep produced no {ours_csv}")
    return ours_csv


def _read_table(path) -> List[Dict[str, str]]:
    """A CSV's rows as dicts of its cells (text)."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _number(text: str) -> float:
    """A CSV cell as pandas reads a float column: an empty cell is NaN."""
    return float(text) if text.strip() else math.nan


def _grid_key(row: Dict[str, str]) -> tuple:
    """(threshold, min_len) at 6 decimals: the reference export may carry
    float-repr noise (np.arange thresholds like 0.30000000000000004) while
    our keys round-trip through t_*/l_* directory names as exact short
    decimals."""
    import numpy as np

    return tuple(float(np.round(_number(row[c]), 6)) for c in ("threshold", "min_len"))


def _check_analyse(args, gdir: Path, manifest: dict, atol: float, workdir: Path) -> dict:
    from laughter_detection_icsi_tpu_torch.eval.analyse import (
        SumStats, average_precision, read_csv)

    golden_csv = gdir / "sum_stats.csv"
    if not golden_csv.is_file():
        return {"status": "skipped", "reason": "no sum_stats.csv golden"}
    if args.model_path is None or args.transcript_dir is None:
        return {
            "status": "skipped",
            "reason": "needs --model_path and --transcript_dir",
        }
    try:
        ours_csv = _run_sweep_stats(args, manifest, workdir)
    except RuntimeError as e:
        return {"status": "fail", "reason": str(e)}
    ours = _read_table(ours_csv)
    want = _read_table(golden_csv)
    if not want:
        # A headered-but-empty golden (e.g. a failed reference export)
        # would otherwise pass vacuously.
        return {
            "status": "fail",
            "reason": f"golden {golden_csv} has a header but no data rows",
        }
    by_key: Dict[tuple, list] = {}
    for row in ours:
        by_key.setdefault(_grid_key(row), []).append(row)
    merged = [(w, o) for w in want for o in by_key.get(_grid_key(w), [])]
    if len(merged) != len(want):
        return {
            "status": "fail",
            "reason": f"grid mismatch: {len(merged)} joined rows vs "
                      f"{len(want)} golden rows",
        }
    worst = 0.0
    for col in ("precision", "recall"):
        diffs = []
        for w, o in merged:
            ref, tpu = _number(w[col]), _number(o[col])
            # NaN in BOTH columns is agreement (recall is 0/0 for a split
            # with no transcribed laugh time); NaN on one side only fails.
            diffs.append(0.0 if math.isnan(ref) and math.isnan(tpu) else abs(ref - tpu))
        n_nan = sum(math.isnan(d) for d in diffs)
        if n_nan:
            return {
                "status": "fail",
                "reason": f"{col}: NaN on one side only ({n_nan} rows)",
            }
        if diffs:
            worst = max(worst, max(diffs))
    out = {
        "status": "pass" if worst <= atol else "fail",
        "rows": len(merged), "max_metric_diff": worst, "atol": atol,
    }
    # Informational quality summary from OUR sweep (row parity implies
    # F1/AP parity).
    stats = read_csv(ours_csv, SumStats)
    f1 = [r.f1 for r in stats if not math.isnan(r.f1)]
    if f1:
        out["best_f1"] = round(float(max(f1)), 6)
    ap = {}
    for ml in sorted({r.min_len for r in stats}):
        v = average_precision(stats, ml)
        if not math.isnan(v):
            ap[str(ml)] = round(v, 6)
    if ap:
        out["ap"] = ap
    return out


def _run_pinned_batches(model, inputs, labels, device: str = "cuda") -> List[float]:
    """K train steps on the pinned batch stream from fresh Adam state, on a
    copy of ``model``; returns the per-step losses.  THE single definition
    of the loss-curve contract: _check_loss_curve and _write_goldens both
    call this."""
    import copy

    from laughter_detection_icsi_tpu_torch.train import Adam, Trainer

    trainer = Trainer(copy.deepcopy(model), optimizer=Adam(), device=device)
    opt = trainer.init()
    losses = []
    for k in range(inputs.shape[0]):
        opt, metrics = trainer.train_batch(opt, {"inputs": inputs[k], "is_laugh": labels[k]})
        losses.append(float(metrics["loss"]))
    return losses


def _check_loss_curve(gdir: Path, model, atol: float, device: str = "cuda") -> dict:
    import numpy as np

    batches_npz = gdir / "train" / "batches.npz"
    curve_csv = gdir / "train" / "loss_curve.csv"
    if not (batches_npz.is_file() and curve_csv.is_file()):
        return {"status": "skipped", "reason": "no train/ goldens"}
    if model is None:
        return {"status": "skipped", "reason": "no --model_path"}
    blob = np.load(batches_npz)
    inputs, labels = blob["inputs"], blob["labels"]
    want = np.asarray([_number(r["loss"]) for r in _read_table(curve_csv)])
    losses = np.asarray(_run_pinned_batches(model, inputs, labels, device))
    if len(losses) != len(want):
        return {
            "status": "fail",
            "reason": f"{len(losses)} steps vs golden {len(want)}",
        }
    worst = float(np.max(np.abs(losses - want)))
    return {
        "status": "pass" if worst <= atol else "fail",
        "steps": len(losses), "max_loss_diff": worst, "atol": atol,
        "first_loss_diff": float(abs(losses[0] - want[0])),
    }


# --------------------------------------------------------------------------- #
# Golden generation (drill mode / reference-export template)
# --------------------------------------------------------------------------- #


def _write_goldens(args, gdir: Path, audio: Dict[str, str]) -> dict:
    import numpy as np

    from laughter_detection_icsi_tpu_torch.config import FEAT
    from laughter_detection_icsi_tpu_torch.data import audio as audio_io
    from laughter_detection_icsi_tpu_torch.data.feature_cache import compute_track_features
    from laughter_detection_icsi_tpu_torch.eval import textgrid as tg
    from laughter_detection_icsi_tpu_torch.eval.analyse import write_csv
    from laughter_detection_icsi_tpu_torch.ops import smoothing

    manifest = {
        "threshold": 0.5,
        "min_length": 0.2,
        "thresholds": [0.2, 0.5],
        "min_lengths": [0.1, 0.2],
        "split": "all",
    }
    gdir.mkdir(parents=True, exist_ok=True)
    (gdir / "features").mkdir(exist_ok=True)
    for stem, path in audio.items():
        wave, sr = audio_io.read(path)
        if sr != FEAT.sampling_rate:
            # Featurizing a wrong-rate file here would write garbage
            # goldens that later self-consistently "pass" the check.
            raise SystemExit(
                f"{path} is {sr} Hz; goldens must be "
                f"{FEAT.sampling_rate} Hz audio"
            )
        np.save(gdir / "features" / f"{stem}.npy",
                compute_track_features(wave, device=args.device))

    model = _load_model(args)
    if model is not None:
        pipe = _pipeline(args, model)
        (gdir / "probs").mkdir(exist_ok=True)
        (gdir / "textgrids").mkdir(exist_ok=True)
        for stem, path in audio.items():
            # One forward pass per file: the probabilities stay on the
            # device for the smoothing, and a host copy is saved.
            probs_dev, duration = pipe.probs_for_file(path, keep_on_device=True)
            np.save(gdir / "probs" / f"{stem}.npy", probs_dev.cpu().numpy())
            fps = probs_dev.shape[0] / float(duration) if duration > 0 else 100.0
            inst = smoothing.instances_from_device_probs(
                probs_dev,
                thresholds=[manifest["threshold"]],
                min_lengths=[manifest["min_length"]],
                fps=fps,
            )
            tg.write_textgrid(
                str(gdir / "textgrids" / f"{stem}.TextGrid"),
                inst[(manifest["threshold"], manifest["min_length"])],
                xmax=duration,
            )
        if args.transcript_dir:
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                src = _run_sweep_stats(args, manifest, Path(tmp))
                (gdir / "sum_stats.csv").write_text(src.read_text())
        # Pinned batch stream + our loss curve
        rng = np.random.default_rng(0)
        k, b = args.train_steps, 8
        inputs = rng.standard_normal((k, b, 100, 44)).astype(np.float32)
        labels = (rng.uniform(size=(k, b)) > 0.5).astype(np.float32)
        (gdir / "train").mkdir(exist_ok=True)
        np.savez(gdir / "train" / "batches.npz", inputs=inputs, labels=labels)
        losses = _run_pinned_batches(model, inputs, labels, args.device)
        write_csv(gdir / "train" / "loss_curve.csv", ["step", "loss"],
                  list(enumerate(losses)))

    (gdir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return manifest


# --------------------------------------------------------------------------- #


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # Named arg-only error before any heavy work.
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.inference import resolve_device

    if args.config not in MODEL_MAP:
        raise SystemExit(
            f"--config: unknown preset {args.config!r} "
            f"(choose from {sorted(MODEL_MAP)})"
        )
    if MODEL_MAP[args.config].mode != "windows":
        raise SystemExit(
            f"--config {args.config}: the parity drill holds the port to the JAX package's "
            "goldens, and this preset has no JAX twin"
        )
    resolve_device(args.device)  # no card for --device cuda raises here
    gdir = Path(args.goldens)
    audio = _audio_files(args.audio_dir)
    if not audio:
        raise SystemExit(f"no .sph/.wav files under {args.audio_dir}")

    if args.write_goldens:
        _write_goldens(args, gdir, audio)
        print(f"goldens written to {gdir} ({len(audio)} audio files)")
        return 0

    if not gdir.is_dir():
        raise SystemExit(f"goldens directory {gdir} does not exist")
    manifest_path = gdir / "manifest.json"
    manifest = (
        json.loads(manifest_path.read_text()) if manifest_path.is_file() else {}
    )

    wanted = [c.strip() for c in args.configs.split(",") if c.strip()]
    model = _load_model(args)
    pipe = _pipeline(args, model) if model is not None else None

    import tempfile

    report: Dict[str, dict] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in wanted:
            if name == "features":
                report[name] = _check_features(gdir, audio, args.feat_atol, args.device)
            elif name == "probs":
                report[name] = _check_probs(gdir, audio, pipe, args.prob_atol)
            elif name == "textgrids":
                report[name] = _check_textgrids(
                    gdir, audio, pipe, manifest, args.tg_tol
                )
            elif name == "analyse":
                report[name] = _check_analyse(
                    args, gdir, manifest, args.metric_atol, Path(tmp)
                )
            elif name == "loss_curve":
                report[name] = _check_loss_curve(gdir, model, args.loss_atol, args.device)
            else:
                report[name] = {"status": "fail", "reason": "unknown check"}
            print(f"{name}: {report[name]}", flush=True)

    statuses = [r["status"] for r in report.values()]
    summary = {
        "configs": report,
        "n_pass": statuses.count("pass"),
        "n_fail": statuses.count("fail"),
        "n_skipped": statuses.count("skipped"),
        "pass": statuses.count("fail") == 0,
    }
    text = json.dumps(summary, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
