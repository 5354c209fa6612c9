"""Readings behind each cell's limits, at the cell's own size, on the card.

    python3 benchmark/controls.py --workload <cell> --seeds 1,2,3 [--program --seconds 3]

One JSON line a seed and reading on standard output:

- the control: the reference put in the program's place in the precision
  below the configuration's (bfloat16 inference: float8 e4m3 rounding of
  every conv's and linear's input and weight; float32 training: TF32),
  held against the reference as a run's check holds the program;
- for a training cell, the faults a run can have, planted in the
  reference put in the program's place: half of each batch left out (the
  mean over the rest); a step that leaves the state unchanged reads 1 by
  the change's measure and needs no run;
- with ``--program``, sound runs of the program itself (the driver's whole
  run at ``--seconds``, or with ``--trace 1`` the profiled slice's, one
  process for every seed), the lower readings;
  for a training cell, the control and the half-batch fault are then read
  over the step after that run's window as well, from its state.

``--details FILE`` appends the per-leaf readings, a JSON line a seed.
"""

import argparse
import json
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

import harness  # noqa: E402
import traffic  # noqa: E402
import weights  # noqa: E402
from reference import train as ref_train  # noqa: E402
from reference.precision import fp8_round  # noqa: E402


def sweep_control(job) -> dict:
    sweep = harness.load_module(HERE / "drivers" / "sweep.py", "bench_driver_sweep")
    cfg, tr = job.cell.config, job.cell.traffic
    pool = traffic.meeting_pool(tr, job.seed)
    p = weights.calibrated(cfg, job.seed, sweep.calibration_windows(cfg, pool[0][0], job.seed,
                                                                     job.device))
    instances = list(range(len(pool)))
    picks = sweep.picks_for(job, pool, instances)
    ref = sweep.reference_probs(job, pool, p, picks, instances)
    got = sweep.reference_probs(job, pool, p, picks, instances, quant=fp8_round)
    gap, mean_gap, logit_gap = sweep.prob_gaps(got, ref)
    return {"control_fp8": {"prob_gap": gap, "prob_gap_mean": mean_gap, "logit_gap_mean": logit_gap}}


def _in_program_place(job, train, rec, half: bool, tf32: bool):
    """``rec``'s records as the reference gives them put in the program's
    place: in TF32 (the control), or on the first half of each batch (the
    half-batch fault); the step after the window too, from the same state,
    where ``rec`` has one."""
    def one(r, post):
        batches = train.first_batches(job, r)
        if half:
            batches = [(x[: len(x) // 2], y[: len(y) // 2]) for x, y in batches]
        out = train.reference_of(job, r, post, batches=batches, tf32=tf32)
        return types.SimpleNamespace(**{**vars(r), "losses": out["losses"], "grad1": out["grad1"],
                                        "after1": out["after1"], "after": out["after"]})

    got = one(rec, False)
    if getattr(rec, "post", None) is not None:
        got.post = one(rec.post, True)
    return got


def train_control(job, rec=None, details=None) -> dict:
    """The TF32 control and the half-batch fault, each held against the
    float32 reference as a run's check holds the program: over the first
    steps from the seed, and where ``rec`` (a program run's records) is
    given, over its step after the window too, from the program's state."""
    train = harness.load_module(HERE / "drivers" / "train.py", "bench_driver_train")
    cfg, tr = job.cell.config, job.cell.traffic
    if rec is None:
        feats, labels = traffic.train_split(tr, job.seed)
        epoch = next(traffic.batch_orders(len(labels), tr["batch_size"], job.seed))
        rec = types.SimpleNamespace(p0=weights.initial(cfg, job.seed, job.device), feats=feats,
                                    labels=labels,
                                    rows=[next(epoch) for _ in range(tr["first_steps"])])
    post = getattr(rec, "post", None)
    truth = (train.reference_of(job, rec, False),
             None if post is None else train.reference_of(job, post, True))
    out = {}
    for name, half, tf32 in (("control_tf32", False, True), ("fault_half_batch", True, False)):
        got = _in_program_place(job, train, rec, half, tf32)
        d = None if details is None else details.setdefault(name, {})
        out[name] = train.readings(job, got, refs=truth, details=d)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true", help="sound runs of the program instead")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="with --program: the run a --trace 1 run makes (its profiled slice)")
    p.add_argument("--details", help="a file the per-leaf readings are appended to")
    args = p.parse_args(argv)
    cell = harness.find_cell(HERE.parent, args.workload)
    device = harness.require_cards(cell.entry["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        job = harness.Job(cell=cell, seed=seed, seconds=args.seconds, trace=bool(args.trace),
                          device=device, started=time.perf_counter())
        details = {} if args.details else None
        if args.program:
            driver = harness.load_module(cell.bench / "drivers" / f"{cell.driver}.py",
                                         f"bench_driver_{cell.driver}")
            out = driver.run(job)
            if cell.driver == "train":
                rec = out["records"]
                readings = {"program": driver.readings(
                    job, rec, details=None if details is None else details.setdefault("program", {}))}
                readings.update(train_control(job, rec, details))
            else:
                readings = {"program": {k: v for k, (v, _) in out["checks"].items()}}
        elif cell.driver == "sweep":
            readings = sweep_control(job)
        else:
            readings = train_control(job, details=details)
        if details is not None:
            with open(args.details, "a") as f:
                f.write(json.dumps({"workload": args.workload, "seed": seed, **details}) + "\n")
        for what, numbers in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what, **numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
