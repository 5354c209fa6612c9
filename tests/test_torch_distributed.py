"""The port's multi-process layer (parallel/{mesh,distributed,data_parallel}.py,
the sharded resident split, the preemption vote and the resume broadcast)
on two Gloo processes on the CPU, against JAX's ``DataParallelTrainer`` over
a 2-device mesh and against the port's own one-process big-batch step.

One spawn of two worker processes (tests/fixtures/torch_dist_worker.py, a
``file://`` rendezvous in ``tmp_path``, 60 s collective timeout, 180 s
process timeout) runs every multi-process case; the JAX reference runs in
this process on the conftest's 8-device CPU mesh.

Tolerances (tests/test_torch_train.py's): loss 1e-5, gradients 1e-4,
parameters after Adam 1e-6 (every element against JAX's Adam on the port's
gradients, and against JAX's step where JAX's gradient exceeds ``SURE``),
BatchNorm running statistics 1e-6.  Inside the port, where only the
rounding of BatchNorm's global sums differs from the one-process step, the
same tolerances; where the paths compute the same rows (resident K steps,
one step a call, streamed local rows) the numbers are equal.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.parallel import DataParallelTrainer as JDataParallelTrainer
from laughter_detection_icsi_tpu.parallel import data_sharding, make_mesh
from laughter_detection_icsi_tpu.train import Adam as JAdam
from laughter_detection_icsi_tpu_torch.data import audio
from laughter_detection_icsi_tpu_torch.data import dataset as tds
from laughter_detection_icsi_tpu_torch.data import feature_cache as tfc
from laughter_detection_icsi_tpu_torch.inference import InferenceSettings
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.parallel import (
    DataParallelTrainer, ShardedPipeline, distributed, mesh, row_block, shard_batch)
from laughter_detection_icsi_tpu_torch.train import Adam, Trainer
from laughter_detection_icsi_tpu_torch.train.checkpoint import state_dict_from_jax
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401
from tests.test_torch_train import (  # noqa: F401
    ARCH, GRAD_TOL, LOSS_TOL, SURE, UPDATE_TOL, flat, jax_grads, jax_side, make_batches)

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
SEED = 7
EPOCH_SEED = 4
N_ROWS = 37  # odd: the sharded split pads a row


def spawn(module: str, argv_of, tmp_path: Path, timeout: float = 180):
    """Run ``WORLD`` processes of ``python -m module`` (argv_of(rank) after
    the module) from the repo root; returns [(rc, stdout, stderr)], killing
    them all if one outlives ``timeout``."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, "-m", module, *map(str, argv_of(r))], cwd=REPO,
                              env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            logs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def sd_numpy(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def global_batches():
    return [make_batches(seed, 1, batch_size=16)[0] for seed in (201, 202, 203, 204)]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A feature cache of two 12 s tracks and N_ROWS rows over them."""
    root = tmp_path_factory.mktemp("torch_dist_split")
    cache = tfc.FeatureCache(str(root / "feats"))
    r = np.random.default_rng(1)
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
    idx_mat = np.stack(tds._epoch_slices(N_ROWS, 8, True, EPOCH_SEED, True)[:3])
    return dict(root=root, cache=str(root / "feats"), rows=rows, idx_mat=idx_mat,
                ds=tds.LadDataset(rows, cache))


@pytest.fixture(scope="module")
def ran(jax_side, split, tmp_path_factory):
    """The two workers' outputs ([rank 0's, rank 1's]) and what they were
    given."""
    tmp = tmp_path_factory.mktemp("torch_dist_run")
    w0 = {k: v.numpy() for k, v in state_dict_from_jax(jax_side["params"],
                                                        jax_side["state"]).items()}
    w1 = sd_numpy(zoo.build("ResNetBigger", dropout_rate=0.5, seed=1, **ARCH))
    batches = global_batches()
    arrays = {**{f"w0/{k}": v for k, v in w0.items()}, **{f"w1/{k}": v for k, v in w1.items()}}
    for i, b in enumerate(batches):
        arrays[f"x{i}"], arrays[f"y{i}"] = b["inputs"], b["is_laugh"]
    np.savez(tmp / "arrays.npz", **arrays)
    wavs = []
    for c, n in enumerate((3 * 16000, 3 * 16000, 3 * 16000 - 777)):
        wavs.append(str(tmp / f"chan{c}.wav"))
        audio.write_wav(wavs[-1], (np.random.default_rng(c).standard_normal(n) * 3000).astype(
            np.int16), 16000)
    spec = dict(arrays=str(tmp / "arrays.npz"), seed=SEED, epoch_seed=EPOCH_SEED,
                cache=split["cache"], rows=split["rows"], idx_mat=split["idx_mat"].tolist(),
                wavs=wavs)
    (tmp / "spec.json").write_text(json.dumps(spec))
    logs = spawn("tests.fixtures.torch_dist_worker",
                 lambda r: [r, WORLD, tmp / "rendezvous", tmp / "spec.json", tmp / f"out{r}.npz"],
                 tmp)
    assert all(rc == 0 for rc, _, _ in logs), logs
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]
    return dict(outs=outs, w0=w0, w1=w1, batches=batches, wavs=wavs)


def prefixed(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def test_two_processes_step_as_jaxs_data_parallel_trainer(ran, jax_side):
    batch = ran["batches"][0]
    jdp = JDataParallelTrainer(model=jax_side["model"], mesh=make_mesh(WORLD))
    p, s, _, jm = jdp.train_batch(jax_side["params"], jax_side["state"],
                                  jdp.optimizer.init(jax_side["params"]), batch, None)
    jloss, jgrads = jax_grads(jax_side, batch)
    jgrads, want = flat(jgrads), flat(p, s)
    r0, r1 = ran["outs"]
    for out in (r0, r1):
        assert float(out["jax/loss"]) == pytest.approx(jloss, abs=LOSS_TOL)
        assert float(out["jax/m/loss"]) == pytest.approx(float(jm["loss"]), abs=LOSS_TOL)
        for k in ("acc", "precision", "recall"):
            assert float(out[f"jax/m/{k}"]) == pytest.approx(float(jm[k]), abs=1e-7), k
    grads = prefixed(r0, "jax/grad/")
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k], atol=GRAD_TOL, rtol=0, err_msg=k)
        np.testing.assert_array_equal(g, r1[f"jax/grad/{k}"], err_msg=k)  # one all_reduce
    sd0, sd1 = prefixed(r0, "jax/sd/"), prefixed(r1, "jax/sd/")
    for n in sd0:
        np.testing.assert_array_equal(sd0[n], sd1[n], err_msg=n)  # replicated
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd0[n], want[n], atol=UPDATE_TOL, rtol=0, err_msg=n)
    start = {k: v for k, v in ran["w0"].items() if k in grads}
    redo, _ = JAdam().update(grads, JAdam().init(start), start)
    held = 0
    for k in grads:
        np.testing.assert_allclose(sd0[k], np.asarray(redo[k]), atol=UPDATE_TOL, rtol=0,
                                   err_msg=k)
        sure = np.abs(jgrads[k]) > SURE
        np.testing.assert_allclose(sd0[k][sure], want[k][sure], atol=UPDATE_TOL, rtol=0,
                                   err_msg=k)
        held += int(sure.sum())
    assert held >= 30


def big_batch_trainer(weights) -> Trainer:
    model = zoo.build("ResNetBigger", dropout_rate=0.5, **ARCH)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()}, strict=True)
    return Trainer(model, device="cpu")


def test_two_processes_with_dropout_equal_the_one_process_big_batch(ran):
    """Global BatchNorm and the global dropout mask: the two-process step
    is the one-process step on the global batch; BatchNorm over each
    process's rows alone would have moved the running statistics elsewhere.
    The parameters by tests/test_torch_train.py's rule, with its ``SURE``
    taken as that file took it, 16x the largest gradient difference,
    measured here: these weights' gradients are ~1e5x the reference
    init's, and so is their rounding noise (a conv bias in front of a
    BatchNorm, whose true gradient is 0, reads up to 4.3e-6), which Adam's
    first step turns into an lr-sized move.  The same noise is why a second
    step is not compared: two thread counts of the one-process step differ
    by 4e-4 in the third step's loss."""
    batch = ran["batches"][1]
    t = big_batch_trainer(ran["w1"])
    x, y = t._prep(batch)
    loss, _, grads = t.loss_and_grads(x, y, t.generator(SEED, 0))
    r0, r1 = ran["outs"]
    assert float(r0["drop/loss"]) == pytest.approx(float(loss), abs=LOSS_TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(r0[f"drop/grad/{k}"], g.numpy(), atol=GRAD_TOL, rtol=0,
                                   err_msg=k)
    sure_here = 16 * max(np.abs(r0[f"drop/grad/{k}"] - g.numpy()).max() for k, g in grads.items())
    assert sure_here < 1e-3
    t = big_batch_trainer(ran["w1"])
    start = {k: v.detach().clone() for k, v in t.params.items()}
    opt, m = t.train_batch(t.init(), batch, t.generator(SEED, 0))
    want = sd_numpy(t.model)
    redo = {k: v.clone() for k, v in start.items()}
    Adam().update({k: torch.from_numpy(r0[f"drop/grad/{k}"]) for k in grads},
                  Adam().init(redo), redo)
    held = 0
    for out in (r0, r1):
        assert float(out["drop/step_loss"]) == pytest.approx(float(m["loss"]), abs=LOSS_TOL)
        got = prefixed(out, "drop/sd/")
        for n in want:
            if n.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[n], want[n], atol=UPDATE_TOL, rtol=0, err_msg=n)
        for k, g in grads.items():
            np.testing.assert_allclose(got[k], redo[k].numpy(), atol=UPDATE_TOL, rtol=0,
                                       err_msg=k)
            sure = np.abs(g.numpy()) > sure_here
            np.testing.assert_allclose(got[k][sure], want[k][sure], atol=UPDATE_TOL, rtol=0,
                                       err_msg=k)
            held += int(sure.sum())
            np.testing.assert_allclose(out[f"drop/mu/{k}"], opt.mu[k].numpy(), atol=1e-7,
                                       rtol=0, err_msg=k)
    assert held >= 1000
    local = big_batch_trainer(ran["w1"])
    local.train_batch(local.init(), shard_batch(batch, 0, WORLD), local.generator(SEED, 0))
    rm = "bn1.running_mean"
    assert np.abs(sd_numpy(local.model)[rm] - want[rm]).max() > 100 * UPDATE_TOL


def test_sharded_resident_k_steps_equal_one_step_a_call_and_streamed_rows(ran, split):
    """Three steps of the three paths equal bit for bit (the same rows, the
    gather's sum adds only zeros); the streamed data-parallel step is held
    to the one-process step by the test above, and the first resident step
    and an eval here."""
    r0, r1 = ran["outs"]
    assert r0["res/rows"].tolist() == [0, 19, 19] and r1["res/rows"].tolist() == [19, 38, 19]
    for out in (r0, r1):
        for step in range(3):
            k, one, streamed = out[f"res/loss{step}"]
            assert k == one == streamed, step
        for other in ("res_1", "res_s"):
            a, b = prefixed(out, "res_k/"), prefixed(out, f"{other}/")
            assert a.keys() == b.keys()
            for n in a:
                np.testing.assert_array_equal(a[n], b[n], err_msg=f"{other} {n}")
    t = big_batch_trainer(ran["w1"])
    res = tds.ResidentLadDataset(split["ds"], device="cpu")
    ev = t.eval_batch({"resident": res, "idx": split["idx_mat"][0]})
    for i, k in enumerate(("acc", "precision", "recall", "loss")):
        assert r0["res/eval"][i] == pytest.approx(float(ev[k]), abs=LOSS_TOL), k
    _, m = t.train_batch_resident(t.init(), res, split["idx_mat"][0], SEED, 0)
    assert float(r0["res/loss0"][0]) == pytest.approx(float(m["loss"]), abs=LOSS_TOL)


def test_preemption_vote_is_a_disjunction_and_resume_carries_rank_zero(ran):
    r0, r1 = ran["outs"]
    for out in (r0, r1):
        assert out["votes"].tolist() == [True, False]
        # A signal on rank 1 alone: both stop at the first voting boundary.
        assert out["vote_stop"].tolist() == [3, 1, 3]
        assert out["resume/counters"].tolist() == [3, 17, 5, 0.25, 3]
    a, b = prefixed(r0, "resume/"), prefixed(r1, "resume/")
    assert a.keys() == b.keys()
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    assert np.abs(a["mu/conv1.weight"]).max() > 0  # three steps' moments, not a fresh state


def test_two_processes_classify_their_channels_as_one_process(ran):
    """Three channels (one 777 samples short) over two processes: four
    padded rows, two a process; each process's rows equal one process's
    rows bit for bit, and the calls that hand every channel to one process
    refuse."""
    model = zoo.build("ResNetBigger", dropout_rate=0.0, **ARCH)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ran["w1"].items()})
    pipe = ShardedPipeline(model, settings=InferenceSettings(chunk=128, bucket_frames=256),
                           device="cpu")
    want, _ = pipe.probs_for_meeting(ran["wavs"])
    r0, r1 = ran["outs"]
    assert sorted(k for k in r0 if k.startswith("probs/")) == ["probs/0", "probs/1", "probs/rows"]
    assert sorted(k for k in r1 if k.startswith("probs/")) == ["probs/2", "probs/rows"]
    for out in (r0, r1):
        assert out["probs/rows"][0] == 2
        assert out["refused"].tolist() == ["RuntimeError", "RuntimeError", "NotImplementedError"]
    for c, w in enumerate(want):
        np.testing.assert_array_equal((r0 if c < 2 else r1)[f"probs/{c}"], w, err_msg=str(c))


@pytest.mark.parametrize("w", [2, 3, 4])
def test_row_blocks_are_jaxs_device_blocks(w, monkeypatch):
    model = zoo.build("ResNetBigger", dropout_rate=0.0, **ARCH)
    for c in (1, 3, 4, 7):
        c_pad = -(-c // w) * w
        index_map = data_sharding(make_mesh(w)).devices_indices_map((c_pad, 1))
        devices = list(make_mesh(w).devices.flat)
        for rank, d in enumerate(devices):
            rows = index_map[d][0]
            want = (rows.start or 0, c_pad if rows.stop is None else rows.stop)
            assert row_block(c_pad, rank, w) == want, (c, rank)
            monkeypatch.setattr(mesh, "world", lambda: (rank, w))
            pipe = ShardedPipeline(model, device="cpu")
            assert pipe.local_channel_indices(c) == list(range(want[0], min(want[1], c)))
            probs = torch.arange(want[1] - want[0], dtype=torch.float32)[:, None]
            assert [(r, float(p[0])) for r, p in pipe.local_channels(probs, c)] == [
                (r, float(r - want[0])) for r in range(want[0], min(want[1], c))]
    with pytest.raises(ValueError, match="not divisible by mesh size"):
        row_block(7, 0, w)
    batch = {"inputs": np.arange(4 * w).reshape(4 * w, 1), "step": np.int32(3)}
    local = shard_batch(batch, w - 1, w)
    assert local["inputs"][:, 0].tolist() == list(range(4 * (w - 1), 4 * w))
    assert int(local["step"]) == 3


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cpu")
    distributed.add_cli_args(p)
    return p


def test_initialize_from_args_errors(capsys, monkeypatch):
    p = _parser()
    assert distributed.initialize_from_args(p.parse_args([]), p) is False
    assert not torch.distributed.is_initialized()
    assert mesh.world() == (0, 1) and not distributed.is_multi_process()
    for argv, msg in ((["--num_processes", "2"], "require --coordinator_address"),
                      (["--process_id", "1"], "require --coordinator_address"),
                      (["--cpu_collectives", "gloo"], "has no effect without")):
        with pytest.raises(SystemExit) as e:
            distributed.initialize_from_args(p.parse_args(argv), p)
        assert e.value.code == 2 and msg in capsys.readouterr().err, argv
    with pytest.raises(RuntimeError, match="no MPI backend"):
        distributed.initialize_from_args(p.parse_args(
            ["--coordinator_address", "127.0.0.1:1", "--num_processes", "1", "--process_id",
             "0", "--cpu_collectives", "mpi"]), p)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):  # bare --distributed reads torchrun's env
        distributed.initialize_from_args(p.parse_args(["--distributed"]), p)
    assert not torch.distributed.is_initialized()


def test_one_process_data_parallel_trainer_is_the_trainer():
    """No process group: the data-parallel step is Trainer's, bit for bit,
    and the votes and the resume are the identity."""
    batch = global_batches()[1]
    w = sd_numpy(zoo.build("ResNetBigger", dropout_rate=0.5, seed=2, **ARCH))
    a = big_batch_trainer(w)
    model = zoo.build("ResNetBigger", dropout_rate=0.5, **ARCH)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    b = DataParallelTrainer(model, device="cpu")
    oa, ma = a.train_batch(a.init(), batch, a.generator(1, 0))
    ob, mb = b.train_batch(b.init(), batch, b.generator(1, 0))
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert distributed.make_preemption_sync()(True) is True
    assert distributed.sync_resume(None, ob) is ob
    with pytest.raises(ValueError, match="single-device"):
        DataParallelTrainer(zoo.build("ResNetBigger", **ARCH), device="cpu", grad_accum=2)
