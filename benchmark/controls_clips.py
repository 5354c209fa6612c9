"""The control behind the clips cells' ``logit_gap_mean`` limit, on the card.

    python3 benchmark/controls_clips.py --workload ast_audioset_bf16.clips_6ch_600s --seeds 1,2,3

For each seed, the cell's traffic and weights as a run makes them, and the
clips a run's check samples (over one instance of each pool meeting): the
reference (``reference/ast.py``) put in the program's place in the
precision below the configuration's bfloat16 (every product's inputs and
weights rounded to float8 e4m3 under a per-tensor scale), held against the
float32 reference as a run's check holds the program.  One JSON line a
seed on standard output.  The program's own readings come from
``controls.py --program``, which runs any driver.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import harness  # noqa: E402
import traffic  # noqa: E402
from reference.precision import fp8_round  # noqa: E402


def clips_control(job) -> dict:
    clips = harness.load_module(HERE / "drivers" / "sweep_clips.py", "bench_driver_sweep_clips")
    cfg, tr = job.cell.config, job.cell.traffic
    pool = traffic.meeting_pool(tr, job.seed)
    p = clips.calibrated(cfg, job.seed, pool[0], job.device)
    instances = list(range(len(pool)))
    picks = clips.picks_for(job, pool, instances)
    ref = clips.reference_logits(job, pool, p, picks, instances)
    got = clips.reference_logits(job, pool, p, picks, instances, quant=fp8_round)
    laugh = cfg["model"]["laughter_class"]
    return {"control_fp8": {"logit_gap_mean": float((got - ref).abs().mean()),
                            "laugh_logit_gap_mean": float((got[:, laugh] - ref[:, laugh]).abs().mean()),
                            "clips": len(picks)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    cell = harness.find_cell(HERE.parent, args.workload)
    if cell.driver != "sweep_clips":
        raise SystemExit(f"{args.workload} is not a clips cell (driver {cell.driver!r})")
    device = harness.require_cards(cell.entry["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        job = harness.Job(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                          started=time.perf_counter())
        for what, numbers in clips_control(job).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what, **numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
