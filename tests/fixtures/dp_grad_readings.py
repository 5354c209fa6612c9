"""The readings behind ROADMAP queue 3's phase-14 (b) entry, on the CPU:
two Gloo processes' data-parallel gradients against one process's, each
to float64 truth, on the rows ``chip_smoke.py`` phase 14 (b) trains on.
Run ``python -m tests.fixtures.dp_grad_readings WORK_DIR`` from the repo
root (~10 min on 8 threads; the corpus and features stay in WORK_DIR for
a rerun).

It builds phase 8's corpus with Bro012 (the train split, 4 x 200 s in
shorten) as phase 8 writes it, the others cut to 30 s (they are not in
the train table), featurizes it on the CPU, and writes phase 10's tables
at 50 + 50 and 100 + 100 samples a laugh.  On the first 512 train rows of
each, with phase 14's weights (seed 3), batch order (seed 5) and dropout
seeds (11):

1. dropout 0.5, three steps from the two-process state: the two-process
   gradients' distance to float64 truth as a share of max(1, max|g|),
   one process's on 8 and 1 threads, their ratio (phase 14 (b) fails
   above 1.5 where one process is over 6.7e-5);
2. dropout 0, step 0: the two-process distance against one process's
   over 7 permutations of the batch's rows (the same function summed in
   other orders).
"""

from __future__ import annotations

import datetime
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BATCH, EPOCH, EPOCH_SEED, SEED, WEIGHT_SEED = 64, 8, 5, 11, 3


def _model(weights, dropout: float):
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP
    from laughter_detection_icsi_tpu_torch.models import zoo

    preset = MODEL_MAP["resnet_base"]
    m = zoo.build(preset.model, dropout_rate=dropout, linear_layer_size=preset.linear_layer_size,
                  filter_sizes=preset.filter_sizes)
    m.load_state_dict(weights, strict=True)
    return m


def worker(spec_path: str, rank: int) -> None:
    """One process of two: ``steps`` data-parallel steps of its rows,
    rank 0 saving each step's starting state and reduced gradients."""
    from laughter_detection_icsi_tpu_torch.data import FeatureCache, LadDataset
    from laughter_detection_icsi_tpu_torch.parallel import DataParallelTrainer, distributed

    torch.set_num_threads(4)
    spec = json.loads(Path(spec_path).read_text())
    distributed.initialize(coordinator_address=f"file://{spec['store']}", num_processes=2,
                           process_id=rank, device="cpu",
                           timeout=datetime.timedelta(seconds=600))

    class Recording(DataParallelTrainer):
        def _update(self, grads, opt_state):
            self.grads = grads
            return super()._update(grads, opt_state)

    t = Recording(_model(torch.load(spec["weights"]), spec["dropout"]), device="cpu")
    ds = LadDataset(json.loads(Path(spec["rows"]).read_text()), FeatureCache(spec["feats"]))
    copy = lambda d: {k: v.detach().clone() for k, v in d.items()}
    opt, rec = t.init(), []
    batches = ds.batches(BATCH, seed=EPOCH_SEED, drop_remainder=True, prefetch=0,
                         local_rows=(rank, 2))
    for k, b in enumerate(itertools.islice(batches, spec["steps"])):
        sd = copy(t.model.state_dict())
        opt, _ = t.train_batch(opt, b, t.generator(SEED, k))
        rec.append(dict(sd=sd, grads=copy(t.grads)))
    if rank == 0:
        torch.save(rec, spec["out"])
    torch.distributed.destroy_process_group()


def two_processes(work: Path, tag: str, rows_path: Path, feats: Path, dropout: float,
                  steps: int) -> list:
    spec = dict(store=str(work / f"store_{tag}_{time.time_ns()}"), weights=str(work / "w.pt"),
                rows=str(rows_path), feats=str(feats), out=str(work / f"steps_{tag}.pt"),
                dropout=dropout, steps=steps)
    (work / f"spec_{tag}.json").write_text(json.dumps(spec))
    procs = [subprocess.Popen([sys.executable, "-m", "tests.fixtures.dp_grad_readings",
                               "--worker", str(work / f"spec_{tag}.json"), str(r)], cwd=REPO)
             for r in range(2)]
    if not all(p.wait() == 0 for p in procs):
        raise SystemExit(f"a worker of {tag} failed")
    return torch.load(spec["out"])


def main(work: Path) -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from laughter_detection_icsi_tpu_torch.cli import compute_features, create_data_df
    from laughter_detection_icsi_tpu_torch.data import FeatureCache, LadDataset, load_split_df
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.train import Trainer

    torch.set_num_threads(8)
    work.mkdir(parents=True, exist_ok=True)
    # Bro012 keeps its place (its audio seeds follow it) and its length.
    corpus = (("Bmr021", 4, 30, "pcm"), ("Bns001", 3, 30, "pcm"), ("Bmr013", 2, 30, "pcm"),
              ("Bro012", 4, 200, "shorten"))
    if not (work / "corpus" / "audio").is_dir():
        cs.write_sweep_corpus(work / "corpus", work / "cache", corpus)
    tdir, adir, feats = work / "corpus" / "transcripts", work / "corpus" / "audio", work / "feats"
    if not feats.is_dir():
        assert compute_features.main(["--audio_dir", str(adir), "--transcript_dir", str(tdir),
                                      "--output_dir", str(feats), "--device", "cpu"]) == 0
    from laughter_detection_icsi_tpu_torch.config import MODEL_MAP

    preset = MODEL_MAP["resnet_base"]
    weights = {k: v.detach() for k, v in zoo.build(
        preset.model, dropout_rate=0.5, linear_layer_size=preset.linear_layer_size,
        filter_sizes=preset.filter_sizes, seed=WEIGHT_SEED).state_dict().items()}
    torch.save(weights, work / "w.pt")
    f64 = lambda g: {n: v.double() for n, v in g.items()}
    report = {}
    for n in (50, 100):
        dfs = work / f"dfs_{n}"
        if not dfs.is_dir():
            assert create_data_df.main(["--transcript_dir", str(tdir), "--data_dfs_dir", str(dfs),
                                        "--num_laugh_samples", str(n),
                                        "--num_non_laugh_samples", str(n)]) == 0
        rows = load_split_df(str(dfs), "train")[: EPOCH * BATCH]
        rows_path = work / f"rows_{n}.json"
        rows_path.write_text(json.dumps(rows))
        ds = LadDataset(rows, FeatureCache(str(feats)))
        batches = list(itertools.islice(ds.batches(BATCH, seed=EPOCH_SEED, drop_remainder=True,
                                                   prefetch=0), 3))
        # 1. Dropout 0.5, three steps.
        steps = two_processes(work, f"{n}_d05", rows_path, feats, 0.5, 3)
        table = []
        for k, b in enumerate(batches):
            one = {}
            for threads in (8, 1):
                torch.set_num_threads(threads)
                t = Trainer(_model(steps[k]["sd"], 0.5), device="cpu")
                x, y = t._prep(b)
                one[threads] = t.loss_and_grads(x, y, t.generator(SEED, k))[2]
            torch.set_num_threads(8)
            truth = cs.grads_f64(_model(steps[k]["sd"], 0.5), x, y, t.generator(SEED, k))
            e2, e8, e1 = (cs.grad_err(g, truth) for g in (steps[k]["grads"], one[8], one[1]))
            table.append(dict(step=k, two=e2, one_8_threads=e8, one_1_thread=e1,
                              two_over_one=e2 / e8, one_1_over_8=e1 / e8,
                              two_vs_one=cs.grad_err(steps[k]["grads"], f64(one[8]))))
            print(f"{n} + {n}, dropout 0.5: {table[-1]}", flush=True)
        # 2. Dropout 0, step 0, against row permutations.
        two = two_processes(work, f"{n}_d0", rows_path, feats, 0.0, 1)[0]["grads"]
        t = Trainer(_model(weights, 0.0), device="cpu")
        x, y = t._prep(batches[0])
        truth = cs.grads_f64(_model(weights, 0.0), x, y, t.generator(SEED, 0))
        g = torch.Generator().manual_seed(0)
        perms = []
        for _ in range(7):
            perm = torch.randperm(len(y), generator=g)
            perms.append(cs.grad_err(t.loss_and_grads(x[perm], y[perm], t.generator(SEED, 0))[2],
                                     truth))
        unpermuted = cs.grad_err(t.loss_and_grads(x, y, t.generator(SEED, 0))[2], truth)
        report[f"{n}+{n}"] = dict(dropout_05=table, dropout_0=dict(
            two=cs.grad_err(two, truth), one=unpermuted, one_permuted=sorted(perms)))
        print(f"{n} + {n}, dropout 0: {report[f'{n}+{n}']['dropout_0']}", flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], int(sys.argv[3]))
    else:
        main(Path(sys.argv[1]))
