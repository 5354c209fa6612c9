"""End-to-end walkthrough of the PyTorch port on a synthetic miniature
corpus (the port's twin of examples/demo.py).

Synthetic transcripts -> audio -> features on the device (the fbank kernel
on ``cuda``) -> sample tables -> training -> sliding-window inference ->
TextGrids -> corpus evaluation.  Runs on the card, or on the CPU in well
under a minute:

    python examples/demo_torch.py [workdir] [--device cuda|cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

import numpy as np


def main(workdir: str = "/tmp/lad_demo_torch", device: str = "cuda") -> None:
    from fixtures.mrt import write_synthetic_corpus
    from laughter_detection_icsi_tpu_torch import inference
    from laughter_detection_icsi_tpu_torch.data import (
        DataFrameSampler,
        FeatureCache,
        LadDataset,
        audio,
        write_data_dfs,
    )
    from laughter_detection_icsi_tpu_torch.eval import indices as indices_lib
    from laughter_detection_icsi_tpu_torch.eval import textgrid as tg
    from laughter_detection_icsi_tpu_torch.eval import transcript as transcript_lib
    from laughter_detection_icsi_tpu_torch.eval.analyse import SumStats, analyse, format_rows
    from laughter_detection_icsi_tpu_torch.models import zoo
    from laughter_detection_icsi_tpu_torch.ops import fbank_cuda, smoothing
    from laughter_detection_icsi_tpu_torch.train import Trainer

    inference.resolve_device(device)  # no card for --device cuda fails here
    root = Path(workdir)
    root.mkdir(parents=True, exist_ok=True)
    print(f"== demo workdir: {root} (device {device})")

    # 1. Ground truth: synthetic ICSI-style .mrt transcripts
    corpus = write_synthetic_corpus(root)
    store = transcript_lib.TranscriptStore(str(corpus.transcript_dir))
    idx = indices_lib.build_indices(store)
    print(f"== parsed {len(store.meeting_ids)} meetings, "
          f"{len(store.laugh_only)} laugh segments")

    # 2. Audio: synthesize channels — laughs get a distinctive loud band
    gen = np.random.default_rng(7)
    cache = FeatureCache(str(root / "feats"))
    launches = fbank_cuda.launches
    for row in store.info:
        n = int(row.length * 16000)
        wave = (gen.standard_normal(n) * 0.02).astype(np.float32)
        for seg in store.laugh_only:
            if seg.meeting_id == row.meeting_id and seg.part_id == row.part_id:
                lo, hi = int(seg.start * 16000), int(seg.end * 16000)
                wave[lo:hi] += (gen.standard_normal(hi - lo) * 0.3).astype(np.float32)
        p = root / "signals" / row.meeting_id
        p.mkdir(parents=True, exist_ok=True)
        audio.write_sphere(str(p / f"{row.chan_id}.sph"), wave, 16000)
        cache.add_audio_file(row.meeting_id, row.chan_id, str(p / f"{row.chan_id}.sph"),
                             device=device)
    print(f"== featurized {len(cache.keys())} channel tracks on {device} "
          f"({fbank_cuda.launches - launches} fbank kernel launches)")

    # 3. Sample tables (seeded 70/10/20 silence/noise/speech mix)
    dfs = DataFrameSampler(store, idx).create_data_dfs(
        num_laugh_samples=6, num_non_laugh_samples=6
    )
    write_data_dfs(dfs, str(root / "data_dfs"))
    print(f"== sample tables: { {k: len(v) for k, v in dfs.items()} }")

    # 4. Train a small ResNetBigger briefly
    model = zoo.build("ResNetBigger", dropout_rate=0.0,
                      linear_layer_size=24, filter_sizes=(8, 8, 8, 8), seed=0)
    trainer = Trainer(model, device=device)
    opt = trainer.init()
    ds = LadDataset(dfs["train"], cache)
    t0 = time.perf_counter()
    losses = []
    for epoch in range(10):
        for batch in ds.batches(batch_size=16, seed=epoch):
            opt, m = trainer.train_batch(opt, batch)
            losses.append(float(m["loss"]))
    print(f"== trained {len(losses)} steps in {time.perf_counter()-t0:.1f}s: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # 5. Inference: whole dev channels through the sliding-window pipeline
    pipe = inference.LaughterPipeline(
        model, settings=inference.InferenceSettings(chunk=512, bucket_frames=1024),
        device=device,
    )
    preds_root = root / "preds" / "dev"
    launches = fbank_cuda.launches
    for row in store.info:
        if row.meeting_id != "Bmr021":
            continue
        path = root / "signals" / row.meeting_id / f"{row.chan_id}.sph"
        probs, duration = pipe.probs_for_file(str(path))
        fps = len(probs) / duration
        inst = smoothing.get_laughter_instances(
            probs, thresholds=[0.3], min_lengths=[0.2], fps=fps
        )[(0.3, 0.2)]
        d = preds_root / row.meeting_id / "t_0.3" / "l_0.2"
        d.mkdir(parents=True, exist_ok=True)
        tg.write_textgrid(str(d / f"{row.chan_id}.TextGrid"), inst, xmax=duration)
        print(f"== {row.meeting_id}/{row.chan_id}: {len(inst)} predicted laughs")
    print(f"== inference: {fbank_cuda.launches - launches} fbank kernel launches")

    # 6. Evaluate
    stats = analyse(str(preds_root), transcript_dir=str(corpus.transcript_dir), force=True)
    print("== corpus-weighted evaluation:")
    print(format_rows(stats, SumStats._fields))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?", default="/tmp/lad_demo_torch")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    a = p.parse_args()
    main(a.workdir, a.device)
