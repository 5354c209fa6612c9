"""The port's epoch loop (train/loop.py TrainLoop) and its checkpoints
(train/checkpoint.py) on the CPU: exact mid-epoch resume with dropout on,
preemption at a step boundary (also mid accumulation group, BatchNorm
buffers included), best checkpoints, metrics CSVs, and checkpoints crossing
between the port and the JAX package both ways.

Inside the port, interrupted + resumed training equals uninterrupted bit
for bit (the same ops on the CPU, dropout from (seed, global step)).
Against JAX: the tolerances of tests/test_torch_train.py.
"""

import os
import signal

import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.train import Adam as JAdam
from laughter_detection_icsi_tpu.train import TrainLoop as JTrainLoop
from laughter_detection_icsi_tpu.train import checkpoint as jckpt
from laughter_detection_icsi_tpu_torch.models import layers as L
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train import TrainLoop, Trainer, update_metrics_on_disk
from laughter_detection_icsi_tpu_torch.train import checkpoint as ckpt
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401
from tests.test_torch_train import (
    ARCH, LOSS_TOL, SURE, UPDATE_TOL, flat, jax_grads, jax_side, make_batches)  # noqa: F401


def toy_batches(seed, n, batch_size=16, t=12, f=8):
    """Positives carry a loud band: separable."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = (rng.uniform(size=batch_size) > 0.5).astype(np.float32)
        x = rng.standard_normal((batch_size, t, f)).astype(np.float32) * 0.1
        x[y > 0.5, :, :3] += 2.0
        out.append({"inputs": x, "is_laugh": y})
    return out


def mlp_trainer(grad_accum=1, dropout=0.5, seed=0):
    """A small MLP with BatchNorm and dropout, the same weights for a seed."""
    model = zoo.MLPModel(linear_layer_size=12 * 8, hid_dim1=32, hid_dim2=16,
                         dropout_rate=dropout)
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            L.linear_init(m, gen)
    return Trainer(model, device="cpu", grad_accum=grad_accum)


def assert_same_run(a: Trainer, oa, b: Trainer, ob):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert int(oa.step) == int(ob.step)
    for k in oa.mu:
        assert torch.equal(oa.mu[k], ob.mu[k]) and torch.equal(oa.nu[k], ob.nu[k]), k


def signalling(batches, kill_after, sig=signal.SIGTERM):
    for i, b in enumerate(batches):
        if i == kill_after:
            os.kill(os.getpid(), sig)
        yield b


@pytest.fixture
def restore_handlers():
    yield
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.default_int_handler)


@pytest.mark.parametrize("grad_accum,kill_after,stopped_at", [(1, 3, 4), (2, 2, 2)],
                         ids=["apply_boundary", "mid_accum_group"])
def test_preempted_and_resumed_equals_uninterrupted(tmp_path, restore_handlers, grad_accum,
                                                    kill_after, stopped_at):
    ref = mlp_trainer(grad_accum)
    loop_c = TrainLoop(trainer=ref, checkpoint_dir=str(tmp_path / "c"), log_frequency=0)
    oc, _ = loop_c.run_epoch(ref.init(), toy_batches(77, 10), seed=5, verbose=False)

    t = mlp_trainer(grad_accum)
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path / "i"), log_frequency=0)
    loop.install_preemption_handler()
    _, loss = loop.run_epoch(t.init(), signalling(toy_batches(77, 10), kill_after),
                             seed=5, verbose=False)
    # The step in flight finished; a partial group rolled back to its start.
    assert loop.preempted and np.isfinite(loss)
    assert (loop.global_step, loop.epoch, loop.epoch_step) == (stopped_at, 0, stopped_at)
    assert t.pending_micro_steps == 0

    t2 = mlp_trainer(grad_accum, seed=9)  # other weights: the checkpoint replaces them
    loop2 = TrainLoop(trainer=t2, checkpoint_dir=str(tmp_path / "i"), log_frequency=0)
    o2 = loop2.resume_if_possible(t2.init())
    assert (loop2.global_step, loop2.epoch, loop2.epoch_step) == (stopped_at, 0, stopped_at)
    assert int(o2.step) == stopped_at // grad_accum
    o2, _ = loop2.run_epoch(o2, toy_batches(77, 10), seed=5, verbose=False)
    assert (loop2.global_step, loop2.epoch, loop2.epoch_step) == (10, 1, 0)
    assert_same_run(t2, o2, ref, oc)


def test_periodic_save_mid_accum_group_resumes_exactly(tmp_path):
    ref = mlp_trainer(2)
    oc, _ = TrainLoop(trainer=ref, checkpoint_dir=str(tmp_path / "c"), log_frequency=0
                      ).run_epoch(ref.init(), toy_batches(91, 4), seed=5, verbose=False)
    t = mlp_trainer(2)
    # The log point at step 3 falls mid-group; then a hard kill.
    TrainLoop(trainer=t, checkpoint_dir=str(tmp_path / "i"), log_frequency=3
              ).run_epoch(t.init(), toy_batches(91, 3), seed=5, verbose=False)
    t2 = mlp_trainer(2, seed=9)
    loop2 = TrainLoop(trainer=t2, checkpoint_dir=str(tmp_path / "i"), log_frequency=0)
    o2 = loop2.resume_if_possible(t2.init())
    assert loop2.global_step == 2 and loop2.epoch_step == 2  # the apply boundary
    o2, _ = loop2.run_epoch(o2, toy_batches(91, 4), seed=5, verbose=False)
    assert_same_run(t2, o2, ref, oc)


def test_second_sigint_escalates(tmp_path, restore_handlers):
    loop = TrainLoop(trainer=mlp_trainer(), checkpoint_dir=str(tmp_path))
    loop.install_preemption_handler()
    os.kill(os.getpid(), signal.SIGINT)  # the first: a graceful stop
    assert loop.preempted
    with pytest.raises(KeyboardInterrupt):
        os.kill(os.getpid(), signal.SIGINT)


def test_best_checkpoint_matches_recorded_val_loss(tmp_path):
    """A log point mid-group validates the state it checkpoints: the
    buffers at the apply boundary."""
    t = mlp_trainer(2)
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path), log_frequency=3)
    val = lambda n: toy_batches(55, 2)
    loop.run_epoch(t.init(), toy_batches(66, 4), val_batches_fn=val, seed=2, verbose=False)
    row = next(r for r in loop.metrics_rows if r["global_step"] == 3)
    best = ckpt.find_best_checkpoint(str(tmp_path))
    loaded = ckpt.load_checkpoint(best)
    check = mlp_trainer(2)
    check.model.load_state_dict(loaded["state_dict"])
    assert check.eval_batches(val(2))["loss"] == pytest.approx(row["val_loss"], abs=1e-6)
    assert loaded["best_val_loss"] == pytest.approx(row["val_loss"], abs=1e-6)
    assert loaded["global_step"] == 2 and loaded["epoch_step"] == 2
    assert ckpt.find_resume_checkpoint(str(tmp_path)).endswith("last.ckpt.npz")


def test_metrics_csv_append_merge(tmp_path):
    path = str(tmp_path / "m.csv")
    update_metrics_on_disk([{"global_step": 2, "train_loss": 0.5},
                            {"global_step": 1, "train_loss": 0.7}], path)
    update_metrics_on_disk([{"global_step": 2, "train_loss": 0.4, "val_loss": 0.9}], path)
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines == ["global_step,train_loss,val_loss", "1,0.7,", "2,0.4,0.9"]
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_write_artifacts_false_writes_nothing(tmp_path):
    t = mlp_trainer()
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path / "ck"), log_frequency=5,
                     metrics_path=str(tmp_path / "metrics.csv"), write_artifacts=False)
    loop.run_epoch(t.init(), toy_batches(1, 10), val_batches_fn=lambda n: toy_batches(2, 2),
                   verbose=False)
    loop.flush_metrics()
    assert list(tmp_path.iterdir()) == [] and loop.metrics_rows == []
    assert loop.best_val_loss != float("inf")
    # With artifacts: each log point writes the checkpoint and its rows.
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path / "ck"), log_frequency=5,
                     metrics_path=str(tmp_path / "metrics.csv"))
    loop.run_epoch(t.init(), toy_batches(1, 10), val_batches_fn=lambda n: toy_batches(2, 2),
                   verbose=False)
    assert sorted(os.listdir(tmp_path / "ck")) == ["best.ckpt.npz", "last.ckpt.npz"]
    with open(tmp_path / "metrics.csv") as f:
        assert len(f.read().splitlines()) == 3


def test_entry_drops_a_stale_accum_group():
    t = mlp_trainer(4)
    opt = t.init()
    loop = TrainLoop(trainer=t, checkpoint_dir=None, log_frequency=0)
    start = {k: v.clone() for k, v in t.model.state_dict().items()}

    def exploding():
        for i, b in enumerate(toy_batches(5, 3)):
            if i == 2:
                raise RuntimeError("assembly error")
            yield b

    with pytest.raises(RuntimeError, match="assembly error"):
        loop.run_epoch(opt, exploding(), seed=1, verbose=False)
    assert t.pending_micro_steps == 2 and loop.global_step == 2
    o1, _ = loop.run_epoch(opt, toy_batches(9, 8), seed=2, verbose=False)
    assert t.pending_micro_steps == 0 and loop.global_step == 8
    ref = mlp_trainer(4)
    ref.model.load_state_dict(start)
    oc, _ = TrainLoop(trainer=ref, checkpoint_dir=None, log_frequency=0).run_epoch(
        ref.init(), toy_batches(9, 8), seed=2, verbose=False)
    assert_same_run(t, o1, ref, oc)


def test_epoch_end_applies_a_partial_group():
    t = mlp_trainer(2)
    loop = TrainLoop(trainer=t, checkpoint_dir=None, log_frequency=0)
    opt, _ = loop.run_epoch(t.init(), toy_batches(3, 3), verbose=False)
    assert int(opt.step) == 2 and t.pending_micro_steps == 0
    assert (loop.epoch, loop.epoch_step, loop.global_step) == (1, 0, 3)


def test_resume_with_a_changed_batch_partition_raises(tmp_path):
    t = mlp_trainer()
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path), log_frequency=0)
    loop.epoch_step = 6
    with pytest.raises(RuntimeError, match="batch partition changed"):
        loop.run_epoch(t.init(), toy_batches(1, 4), verbose=False)


def test_checkpoint_errors_and_old_writer_calls(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "missing.ckpt.npz"))
    assert ckpt.find_resume_checkpoint(str(tmp_path)) is None
    assert ckpt.find_best_checkpoint(str(tmp_path)) is None
    t = mlp_trainer()
    path = ckpt.save_checkpoint(str(tmp_path), t.model.state_dict())  # no Adam state
    loaded = ckpt.load_checkpoint(path)
    assert loaded["opt_state"] is None and loaded["epoch_step"] == 0
    bad = tmp_path / "bad.ckpt.npz"
    np.savez(bad, __meta__='{"format_version": 1, "epoch": 0}')
    with pytest.raises(ValueError, match="missing keys"):
        ckpt.load_checkpoint(str(bad))


def test_port_checkpoint_with_adam_state_loads_in_jax(tmp_path):
    t = mlp_trainer()
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path), log_frequency=0)
    opt, _ = loop.run_epoch(t.init(), toy_batches(4, 3), verbose=False)
    loop.save(opt, is_best=True)
    for name in ("last.ckpt.npz", "best.ckpt.npz"):
        loaded = jckpt.load_checkpoint(str(tmp_path / name))
        want = t.model.state_dict()
        got = jckpt.to_torch_state_dict(loaded["params"], loaded["state"])
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v.numpy())
        o = loaded["opt_state"]
        assert int(o["step"]) == 3
        for k in opt.mu:
            np.testing.assert_array_equal(np.asarray(jckpt.flatten_tree(o["mu"])[k]), opt.mu[k].numpy())
            np.testing.assert_array_equal(np.asarray(jckpt.flatten_tree(o["nu"])[k]), opt.nu[k].numpy())
        assert (loaded["epoch"], loaded["global_step"], loaded["epoch_step"]) == (1, 3, 0)


def test_jax_checkpoint_resumes_in_the_port_and_steps_alike(jax_side, tmp_path):
    """JAX trains two steps and checkpoints with its Adam state; the port
    resumes from that file, and its next step matches JAX's next step."""
    batches = make_batches(201, 3)
    jt = jax_side["trainer"]
    jloop = JTrainLoop(trainer=jt, checkpoint_dir=str(tmp_path), log_frequency=0)
    p, s = jax_side["params"], jax_side["state"]
    o = jt.optimizer.init(p)
    p, s, o, _ = jloop.run_epoch(p, s, o, batches[:2], verbose=False)
    jloop._save(p, s, o, is_best=False)
    p3, s3, o3, jm = jt.train_batch(p, s, o, batches[2], None)

    m = zoo.build("ResNetBigger", dropout_rate=0.0, **ARCH)
    port = Trainer(m, device="cpu")
    loop = TrainLoop(trainer=port, checkpoint_dir=str(tmp_path), log_frequency=0)
    opt = loop.resume_if_possible(port.init())
    assert (loop.epoch, loop.global_step, int(opt.step)) == (1, 2, 2)
    x, y = port._prep(batches[2])
    grads = port.loss_and_grads(x, y)[2]
    start = {k: v.detach().clone() for k, v in port.params.items()}
    port.model.load_state_dict(ckpt.load_checkpoint(str(tmp_path / "last.ckpt.npz"))["state_dict"])
    opt, mm = port.train_batch(opt, batches[2])
    assert float(mm["loss"]) == pytest.approx(float(jm["loss"]), abs=LOSS_TOL)
    want = flat(p3, s3)
    sd = port.model.state_dict()
    for n in sd:
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[n].numpy(), want[n], atol=UPDATE_TOL, rtol=0, err_msg=n)
    # JAX's gradient at the resumed weights picks the elements held to its
    # step; every element is held to JAX's Adam on the port's gradients.
    _, jg = jax_grads(dict(jax_side, params=p, state=s), batches[2])
    jg = flat(jg)
    redo, _ = JAdam().update({k: g.numpy() for k, g in grads.items()}, _jax_adam(o),
                             {k: v.numpy() for k, v in start.items()})
    for k, v in port.params.items():
        got = v.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(redo[k]), atol=UPDATE_TOL, rtol=0, err_msg=k)
        sure = np.abs(jg[k]) > SURE
        np.testing.assert_allclose(got[sure], want[k][sure], atol=UPDATE_TOL, rtol=0, err_msg=k)


def _jax_adam(o):
    """JAX's AdamState with its moments flattened to the port's keys."""
    from laughter_detection_icsi_tpu.train.optim import AdamState

    return AdamState(step=o.step, mu=jckpt.flatten_tree(o.mu), nu=jckpt.flatten_tree(o.nu))
