"""The port's resident training paths (``Trainer.train_batch_resident``,
``train_k_steps_resident``, ``TrainLoop(steps_per_dispatch=K)``) and the
training CLIs end to end, on the CPU.

Inside the port the resident paths give the streamed path's numbers bit for
bit (the same rows, the same ops, dropout from (seed, global step)); K
steps from one call equal K single steps, also when a group is cut at a log
point.  Against JAX's resident step at dropout 0: the tolerances and the
parameter rule of tests/test_torch_train.py.  Then ``cli/create_data_df``
-> ``cli/compute_features`` -> ``cli/train --device cpu`` on the synthetic
corpus, streamed, resident and K = 4 (equal checkpoints), a SIGTERM
mid-epoch resumed through the CLI (equal to the uninterrupted run), and the
checkpoint read by the port's segment CLI.
"""

import contextlib
import csv
import io
import os
import signal

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from laughter_detection_icsi_tpu.data import dataset as jds
from laughter_detection_icsi_tpu.data import feature_cache as jfc
from laughter_detection_icsi_tpu_torch.cli import compute_features, create_data_df
from laughter_detection_icsi_tpu_torch.cli import segment_laughter, train
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.data import dataset as tds
from laughter_detection_icsi_tpu_torch.data import feature_cache as tfc
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train import TrainLoop, Trainer
from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401
from tests.test_torch_train import (  # noqa: F401
    ARCH, LOSS_TOL, SURE, UPDATE_TOL, flat, jax_grads, jax_side, port_trainer)
from tests.test_torch_train_loop import assert_same_run, restore_handlers  # noqa: F401

N_ROWS = 44


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A feature cache of two 12 s tracks (plain featurizer) and 44 rows
    over them, some of half a second (zero-padded windows)."""
    root = tmp_path_factory.mktemp("torch_resident")
    cache = tfc.FeatureCache(str(root / "feats"))
    r = np.random.default_rng(0)
    for c in ("chan0", "chan1"):
        wave = (r.standard_normal(16000 * 12) * 0.1).astype(np.float32)
        cache.add_track("Bmr021", c, wave, bucket_frames=1024, device="cpu")
    rows = []
    for i in range(N_ROWS):
        dur = 0.5 if i % 7 == 0 else 1.0
        start = round(float(r.uniform(0, 10.5)), 2)
        rows.append(dict(start=start, duration=dur, sub_start=start, sub_duration=dur,
                         audio_path=f"Bmr021/chan{i % 2}.sph", meeting_id="Bmr021",
                         chan_id=f"chan{i % 2}", label=int(r.uniform() > 0.5)))
    ds = tds.LadDataset(rows, cache)
    return dict(ds=ds, res=tds.ResidentLadDataset(ds, device="cpu"), rows=rows, root=root)


def dropout_trainer(**kw):
    return Trainer(zoo.build("ResNetBigger", dropout_rate=0.5, seed=1, **ARCH), device="cpu", **kw)


def test_train_batch_resident_equals_train_batch(split):
    a, b = dropout_trainer(), dropout_trainer()
    oa, ob = a.init(), b.init()
    for step, idx in enumerate(tds._epoch_slices(N_ROWS, 8, True, 3, False)[:3]):
        oa, ma = a.train_batch_resident(oa, split["res"], idx, 9, step)
        ob, mb = b.train_batch(ob, split["ds"]._assemble(idx), b.generator(9, step))
        for k in mb:
            assert torch.equal(ma[k], mb[k]), k
    assert_same_run(a, oa, b, ob)
    assert a.generator(9, 0) is not None
    assert Trainer(zoo.build("ResNetBigger", dropout_rate=0.0, **ARCH), device="cpu").generator(
        9, 0) is None


def test_k_steps_equal_single_steps(split):
    a, b = dropout_trainer(), dropout_trainer()
    oa, ob = a.init(), b.init()
    idx_mat = np.stack(tds._epoch_slices(N_ROWS, 8, True, 4, True)[:4])
    oa, km = a.train_k_steps_resident(oa, split["res"], idx_mat, 2, 10)
    assert all(v.shape == (4,) for v in km.values())
    for k, idx in enumerate(idx_mat):
        ob, m = b.train_batch_resident(ob, split["res"], idx, 2, 10 + k)
        for name in m:
            assert torch.equal(km[name][k], m[name]), name
    assert_same_run(a, oa, b, ob)
    with pytest.raises(ValueError, match="grad_accum == 1"):
        dropout_trainer(grad_accum=2).train_k_steps_resident(ob, split["res"], idx_mat, 0, 0)
    with pytest.raises(ValueError, match=r"\[K, B\]"):
        a.train_k_steps_resident(oa, split["res"], idx_mat[0], 0, 0)


def test_train_loop_k_steps_equal_one_step_a_call(split, tmp_path, monkeypatch):
    """K = 4 with log points every 3 steps: batches of 7 (six full, one of
    2) group as [3] up to the first log point, then [3], then the partial
    batch alone: the run equals the one-step-a-call run."""
    calls = []
    real = Trainer.train_k_steps_resident

    def counted(self, opt, res, idx_mat, seed, step0):
        calls.append((step0, len(idx_mat)))
        return real(self, opt, res, idx_mat, seed, step0)

    monkeypatch.setattr(Trainer, "train_k_steps_resident", counted)
    runs = {}
    for k in (1, 4):
        t = dropout_trainer()
        loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path / f"k{k}"), log_frequency=3,
                         steps_per_dispatch=k)
        batches = split["res"].index_batches(7, seed=5)
        opt, mean = loop.run_epoch(t.init(), batches, seed=3, verbose=False,
                                   val_batches_fn=lambda n: list(split["res"].index_batches(
                                       7, seed=1))[:n])
        runs[k] = (t, opt, mean, loop)
    assert calls == [(0, 3), (3, 3)]
    (t1, o1, m1, l1), (t4, o4, m4, l4) = runs[1], runs[4]
    assert_same_run(t1, o1, t4, o4)
    assert m4 == pytest.approx(m1, rel=1e-6)
    assert (l4.global_step, l4.epoch) == (l1.global_step, l1.epoch) == (7, 1)
    assert [r["global_step"] for r in l4.metrics_rows] == [3, 6]
    for name in ("last.ckpt.npz", "best.ckpt.npz"):
        a = ckpt.load_checkpoint(str(tmp_path / "k1" / name))["state_dict"]
        b = ckpt.load_checkpoint(str(tmp_path / "k4" / name))["state_dict"]
        assert all(torch.equal(a[key], b[key]) for key in a), name


def test_train_loop_k_steps_refusals(split, tmp_path):
    t = dropout_trainer(grad_accum=2)
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path), steps_per_dispatch=4)
    with pytest.raises(ValueError, match="requires grad_accum == 1"):
        loop.run_epoch(t.init(), split["res"].index_batches(8), verbose=False)
    t = dropout_trainer()
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path), steps_per_dispatch=4,
                     write_artifacts=False)
    with pytest.warns(RuntimeWarning, match="no K-step group formed"):
        loop.run_epoch(t.init(), split["ds"].batches(8, prefetch=0), verbose=False)


def test_resident_step_and_eval_match_jax(split, jax_side):
    jres = jds.ResidentLadDataset(jds.LadDataset(pd.DataFrame(split["rows"]),
                                                 jfc.FeatureCache(str(split["root"] / "feats"))))
    idx = tds._epoch_slices(N_ROWS, 8, True, 6, False)[0]
    batch = split["ds"]._assemble(idx)
    jt = jax_side["trainer"]
    p, s, o, jm = jt.train_batch_resident(jax_side["params"], jax_side["state"],
                                          jt.optimizer.init(jax_side["params"]), jres, idx,
                                          jax.random.PRNGKey(0), 0)
    port = port_trainer(jax_side)
    opt, m = port.train_batch_resident(port.init(), split["res"], idx, 0, 0)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=LOSS_TOL)
    for k in ("acc", "precision", "recall"):
        assert float(m[k]) == pytest.approx(float(jm[k]), abs=1e-7), k
    want = flat(p, s)
    sd = port.model.state_dict()
    for n in sd:
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[n].numpy(), want[n], atol=UPDATE_TOL, rtol=0, err_msg=n)
    jgrads = flat(jax_grads(jax_side, batch)[1])
    held = 0
    for k, v in port.params.items():
        sure = np.abs(jgrads[k]) > SURE
        got = v.detach().numpy()
        np.testing.assert_allclose(got[sure], want[k][sure], atol=UPDATE_TOL, rtol=0, err_msg=k)
        held += int(sure.sum())
    assert held >= 30
    marker = {"resident": split["res"], "idx": idx}
    fresh = port_trainer(jax_side)
    got = fresh.eval_batch(marker)
    streamed = fresh.eval_batch(batch)
    jev = jt.eval_batch(jax_side["params"], jax_side["state"], {"resident": jres, "idx": idx})
    for k in got:
        assert torch.equal(got[k], streamed[k]), k
        assert float(got[k]) == pytest.approx(float(jev[k]), abs=LOSS_TOL), k


# --------------------------------------------------------------------------- #
# The CLIs
# --------------------------------------------------------------------------- #


def _wave(seconds: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = np.arange(16000 * seconds) / 16000
    w = 0.3 * r.standard_normal(len(t)) * (0.05 + 0.6 * np.sin(2 * np.pi * 0.4 * t) ** 2)
    return (np.clip(w, -1, 1) * 32767).astype(np.int16)


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def corpus(synthetic_corpus, tmp_path_factory):
    """The synthetic corpus's four tracks as int16 WAV, its tables (3 laugh
    and 3 non-laugh samples per laugh) and its feature cache."""
    root = tmp_path_factory.mktemp("torch_train_cli")
    for i, (m, secs) in enumerate((("Btr001", 60), ("Bmr021", 100))):
        for c in ("chan0", "chan1"):
            (root / "signals" / m).mkdir(parents=True, exist_ok=True)
            audio.write_wav(str(root / "signals" / m / f"{c}.wav"), _wave(secs, 2 * i + len(c)),
                            16000)
    tdir = str(synthetic_corpus.transcript_dir)
    rc, out = run(create_data_df.main, ["--transcript_dir", tdir, "--data_dfs_dir",
                                        str(root / "data_dfs"), "--num_laugh_samples", "3",
                                        "--num_non_laugh_samples", "3"])
    assert rc == 0 and "train: 24 rows" in out and "dev: 12 rows" in out and "test: 0 rows" in out
    feats = ["--audio_dir", str(root / "signals"), "--transcript_dir", tdir,
             "--output_dir", str(root / "feats_tpu"), "--device", "cpu"]
    rc, out = run(compute_features.main, feats)
    assert rc == 0 and "done: 4 featurized, 0 cached, 0 missing" in out
    rc, out = run(compute_features.main, feats)
    assert rc == 0 and "done: 0 featurized, 4 cached, 0 missing" in out
    rc, out = run(compute_features.main, feats + ["--splits", "dev", "--dtype", "float16",
                                                  "--output_dir", str(root / "feats16")])
    assert rc == 0 and "done: 2 featurized, 0 cached, 0 missing" in out
    assert tfc.FeatureCache(str(root / "feats16")).has("Bmr021", "chan0", dtype=np.float16)
    return root


def train_argv(corpus, name, *flags):
    return ["--config", "resnet_base", "--checkpoint_dir", str(corpus / name), "--data_root",
            str(corpus), "--device", "cpu", "--batch_size", "4", *flags]


def state(corpus, name):
    return ckpt.load_checkpoint(str(corpus / name / "last.ckpt.npz"))


def test_cli_streamed_resident_and_k_steps_agree(corpus):
    outs = {}
    for name, flags in (("off", ["--device_cache", "off"]), ("on", ["--device_cache", "on"]),
                        ("k4", ["--device_cache", "on", "--steps_per_dispatch", "4"])):
        rc, outs[name] = run(train.main, train_argv(corpus, name, *flags))
        assert rc == 0 and "epoch 1 done" in outs[name]
    assert "device cache: 24 train windows resident" in outs["on"]
    assert "resident" not in outs["off"]
    ref = state(corpus, "off")
    assert (ref["epoch"], ref["global_step"]) == (1, 6)
    for name in ("on", "k4"):
        got = state(corpus, name)["state_dict"]
        assert all(torch.equal(got[k], ref["state_dict"][k]) for k in got), name
    with open(corpus / "off" / "train_params.csv") as f:
        assert list(csv.reader(f)) == [["num_train_samples", "num_dev_samples", "batch_size",
                                        "log_freq"], ["24", "12", "4", "900"]]
    # Relative epochs: a second run trains one more.
    rc, out = run(train.main, train_argv(corpus, "off", "--device_cache", "off"))
    assert rc == 0 and "resumed from step 6 (epoch 1)" in out
    assert (state(corpus, "off")["epoch"], state(corpus, "off")["global_step"]) == (2, 12)


def test_cli_sigterm_mid_epoch_resumes_to_the_uninterrupted_run(corpus, monkeypatch,
                                                                restore_handlers):
    real = Trainer.train_batch
    calls = []

    def signalling(self, *a, **kw):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *a, **kw)

    flags = ["--device_cache", "off", "--seed", "4"]
    rc, _ = run(train.main, train_argv(corpus, "whole", *flags))
    assert rc == 0
    monkeypatch.setattr(Trainer, "train_batch", signalling)
    rc, out = run(train.main, train_argv(corpus, "cut", *flags))
    assert rc == 0 and "preempted at step 3" in out and "exiting cleanly" in out
    cut = state(corpus, "cut")
    assert (cut["epoch"], cut["global_step"], cut["epoch_step"]) == (0, 3, 3)
    monkeypatch.setattr(Trainer, "train_batch", real)
    rc, out = run(train.main, train_argv(corpus, "cut", *flags))
    assert rc == 0 and "resumed from step 3 (epoch 0)" in out
    a, b = state(corpus, "whole"), state(corpus, "cut")
    assert (b["epoch"], b["global_step"]) == (a["epoch"], a["global_step"]) == (1, 6)
    assert all(torch.equal(a["state_dict"][k], b["state_dict"][k]) for k in a["state_dict"])
    for k in a["opt_state"].mu:
        assert torch.equal(a["opt_state"].mu[k], b["opt_state"].mu[k]), k


def test_cli_checkpoint_reads_in_the_segment_cli(corpus, tmp_path):
    rc, _ = run(train.main, train_argv(corpus, "seg", "--device_cache", "on"))
    assert rc == 0
    wav = str(tmp_path / "x.wav")
    audio.write_wav(wav, _wave(4, 9), 16000)
    rc, _ = run(segment_laughter.main, [
        "--model_path", str(corpus / "seg"), "--input_audio_file", wav, "--output_dir",
        str(tmp_path / "out"), "--thresholds", "0.0", "--min_lengths", "0.0",
        "--save_to_textgrid", "True", "--save_to_audio_files", "False", "--device", "cpu",
        "--chunk", "128", "--bucket_frames", "256"])
    assert rc == 0
    assert list((tmp_path / "out").rglob("*.TextGrid"))


@pytest.mark.parametrize("flags,error", [
    pytest.param(["--cpu_collectives", "gloo"], "has no effect without", id="flags0-item 7"),
    pytest.param(["--distributed"], "RANK", id="flags1-item 7"),
    pytest.param(["--num_processes", "2"], "require --coordinator_address",
                 id="flags2-item 7")])
def test_cli_refuses_what_is_not_ported(corpus, flags, error, capsys, monkeypatch):
    """JAX's checks of the multi-process flags, and a multi-process run
    without --data_parallel, refused before any featurization (the ids are
    these cases' from when the flags were refused as not ported)."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if flags == ["--distributed"]:  # bare --distributed reads torchrun's environment
        with pytest.raises(ValueError, match=error):
            train.main(train_argv(corpus, "refused", *flags))
    else:
        with pytest.raises(SystemExit) as e:
            train.main(train_argv(corpus, "refused", *flags))
        assert e.value.code == 2 and error in capsys.readouterr().err
    from laughter_detection_icsi_tpu_torch.parallel import distributed, mesh

    monkeypatch.setattr(distributed, "initialize_from_args", lambda args, parser: True)
    monkeypatch.setattr(mesh, "world", lambda: (0, 2))
    with pytest.raises(SystemExit, match="multi-host runs require --data_parallel"):
        train.main(train_argv(corpus, "refused", "--distributed"))
    assert not (corpus / "refused" / "last.ckpt.npz").exists()


def test_cli_trains_in_bfloat16(corpus):
    """``--precision bfloat16`` reaches the Trainer: the checkpoint holds
    float32 weights, buffers and Adam moments (the masters), which differ
    from the float32 run's from the same seed and batches."""
    for name, flags in (("bf16", ["--precision", "bfloat16"]), ("f32", [])):
        rc, out = run(train.main, train_argv(corpus, name, "--device_cache", "on", *flags))
        assert rc == 0 and "epoch 1 done" in out, name
    got, want = state(corpus, "bf16"), state(corpus, "f32")
    assert got["global_step"] == want["global_step"] == 6
    for k, v in got["state_dict"].items():
        assert v.dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32), k
        assert bool(torch.isfinite(v.float()).all()), k
    assert all(m.dtype == torch.float32 for m in got["opt_state"].mu.values())
    assert any(not torch.equal(v, want["state_dict"][k]) for k, v in got["state_dict"].items())


@pytest.mark.parametrize("cache", ["off", "on"])
def test_cli_log_points_validate_and_keep_the_best(corpus, cache, monkeypatch):
    """At a log point the CLI validates on the dev split (streamed batches,
    or the resident split's markers), writes the metric row and the best
    checkpoint: the preset logs every 3 steps here (the 24-row split's 6
    steps of 4 hold two log points)."""
    import dataclasses

    from laughter_detection_icsi_tpu_torch import config

    preset = config.MODEL_MAP["resnet_base"]
    monkeypatch.setitem(config.MODEL_MAP, "resnet_base", dataclasses.replace(preset, log_frequency=3))
    name = f"log_{cache}"
    rc, out = run(train.main, train_argv(corpus, name, "--device_cache", cache,
                                         "--val_batches_per_log", "2"))
    assert rc == 0 and "epoch 1 done" in out
    assert "step 3: " in out and "step 6: " in out and "val_loss=" in out
    with open(corpus / name / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["global_step"]) for r in rows] == [3, 6]
    assert all(np.isfinite(float(r["val_loss"])) for r in rows)
    best = ckpt.load_checkpoint(str(corpus / name / ckpt.BEST_NAME))
    assert best["global_step"] in (3, 6)
    assert best["best_val_loss"] == min(float(r["val_loss"]) for r in rows)


def test_cli_leaves_the_cudnn_flags_as_it_found_them(corpus, monkeypatch):
    """cli/train sets cuDNN's flags only on cuda (``CUDNN_FLAGS``, the
    exact resume there): on the CPU the run trains under the caller's
    flags, and main hands them back as it found them."""
    cudnn = torch.backends.cudnn
    seen = []
    run_epoch = TrainLoop.run_epoch

    def spy(self, *a, **kw):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return run_epoch(self, *a, **kw)

    monkeypatch.setattr(TrainLoop, "run_epoch", spy)
    assert train.CUDNN_FLAGS == (True, False)
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = False, True  # not cli/train's
        rc, out = run(train.main, train_argv(corpus, "flags", "--device_cache", "off"))
        assert rc == 0 and "epoch 1 done" in out
        assert seen == [(False, True)]
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def test_cli_guards(corpus, tmp_path):
    rc, out = run(train.main, train_argv(corpus, "compat", "--num_workers", "2",
                                         "--device_cache", "off"))
    assert rc == 0 and "note: --num_workers is accepted for compatibility and ignored" in out
    with pytest.raises(SystemExit):
        train.main(train_argv(corpus, "bad", "--batch_size", "0"))
    with pytest.raises(SystemExit, match="unknown splits: val"):
        compute_features.main(["--audio_dir", "a", "--transcript_dir", "t", "--output_dir", "o",
                               "--splits", "train,val", "--device", "cpu"])
    env = tmp_path / "bad.env"
    env.write_text("NUM_OF_LAUGH_SAMPLES=five\n")
    os.environ.pop("NUM_OF_LAUGH_SAMPLES", None)
    try:
        with pytest.raises(SystemExit, match="is not an integer"):
            create_data_df.main(["--data_dfs_dir", str(tmp_path), "--env_file", str(env)])
    finally:
        os.environ.pop("NUM_OF_LAUGH_SAMPLES", None)
