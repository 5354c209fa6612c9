"""The port's training step (train/optim.py, train/loop.py, models in train
mode) against the JAX package's on the CPU, from the same weights and
batches, at dropout 0 (the two draw different dropout bits).

The setting is tests/test_train_parity.py's: ResNetBigger with the filter
plan (8, 8, 8, 8) and a 24-feature head, the reference's normal(0, 0.01)
init (probabilities near 0.5: saturated sigmoids would amplify forward
noise ~1e4 through BCE's backward), [8, 100, 44] batches from a numpy seed.

Tolerances: loss 1e-5, gradients 1e-4, Adam 1e-6, BatchNorm running stats
1e-6.  Updated parameters: every element within 1e-6 of JAX's Adam applied
to the port's own gradients, and within 1e-6 of JAX's own step wherever
JAX's gradient exceeds 1e-6 (``SURE``, ~16x the largest gradient difference
measured, 6.0e-8).  Below that, Adam's first step, lr * g / (|g| + eps),
turns fp noise into an lr-sized move: at the reference init the gradients
are tiny (median |g| 1.7e-12, 0.22% of the elements above 1e-6, measured),
a conv bias in front of a BatchNorm has a true gradient of 0, and the two
frameworks' parameters differ by up to 4.1e-4 there (measured).  Larger
weights give larger gradients but miss the gradient and BatchNorm
tolerances (2e-4 and 2.6e-6 measured at kaiming-scaled weights).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu import models as jmodels
from laughter_detection_icsi_tpu.models.layers import reference_init as jax_reference_init
from laughter_detection_icsi_tpu.train import Adam as JAdam
from laughter_detection_icsi_tpu.train import Trainer as JTrainer
from laughter_detection_icsi_tpu.train import checkpoint as jckpt
from laughter_detection_icsi_tpu.train import optim as joptim
from laughter_detection_icsi_tpu.train.loop import batch_metrics as jbatch_metrics
from laughter_detection_icsi_tpu.train.loop import bce_loss as jbce
from laughter_detection_icsi_tpu_torch.models import layers as L
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train import (
    Adam, TrainLoop, Trainer, batch_metrics, bce_loss, clip_by_global_norm,
    global_norm, mean_eval_metrics, step_generator)
from laughter_detection_icsi_tpu_torch.train.checkpoint import (
    opt_state_from_jax, state_dict_from_jax)
from tests.fixtures.torch_weights import few_torch_threads  # noqa: F401

ARCH = dict(linear_layer_size=24, filter_sizes=(8, 8, 8, 8))
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-5, 1e-4, 1e-6
SURE = 1e-6  # a gradient this large outweighs the frameworks' fp noise


def make_batches(seed, n, batch_size=8):
    """Mildly separable, un-saturating data (tests/test_train_parity.py)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = (rng.uniform(size=batch_size) > 0.5).astype(np.float32)
        x = (rng.standard_normal((batch_size, 100, 44)) * 0.5).astype(np.float32)
        x[y > 0.5, :, :8] += 0.2
        out.append({"inputs": x, "is_laugh": y})
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model at the reference init, and module-scoped trainers
    (their jitted steps compile once for the file)."""
    jm = jmodels.build("ResNetBigger", dropout_rate=0.0, **ARCH)
    params, state = jm.init(jax.random.PRNGKey(3))
    params = jax_reference_init(params, jax.random.PRNGKey(4))
    return dict(model=jm, params=params, state=state,
                trainer=JTrainer(model=jm, optimizer=JAdam()),
                accum=JTrainer(model=jm, optimizer=JAdam(), grad_accum=2))


def port_trainer(jax_side, **kw):
    m = zoo.build("ResNetBigger", dropout_rate=0.0, **ARCH)
    m.load_state_dict(state_dict_from_jax(jax_side["params"], jax_side["state"]), strict=True)
    return Trainer(m, device="cpu", **kw)


def flat(params, state=None):
    return {k: np.asarray(v) for k, v in jckpt.to_torch_state_dict(params, state or {}).items()}


def jax_grads(jax_side, batch):
    jm, state = jax_side["model"], jax_side["state"]

    def loss_fn(p):
        probs, _ = jm.apply(p, state, jnp.asarray(batch["inputs"])[:, None], train=True)
        return jbce(probs, jnp.asarray(batch["is_laugh"]))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax_side["params"])
    return float(loss), grads


def test_bce_loss_and_saturated_gradient():
    p = np.array([1.0, 0.0, 1.0, 0.0, 0.5, 0.999999, 1e-45, 0.3], dtype=np.float32)
    y = np.array([1.0, 0.0, 0.0, 1.0, 1.0, 0.0, 1.0, 0.0], dtype=np.float32)
    tp = torch.tensor(p, requires_grad=True)
    loss = bce_loss(tp, torch.tensor(y))
    loss.backward()
    loss = loss.detach()
    jl, jg = jax.value_and_grad(lambda q: jbce(q, jnp.asarray(y)))(jnp.asarray(p))
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    assert np.isfinite(tp.grad.numpy()).all()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=0)


def test_batch_metrics_match_jax():
    rng = np.random.default_rng(7)
    cases = [(rng.uniform(size=32), (rng.uniform(size=32) > 0.5)),
             ([0.1, 0.2], [1.0, 0.0]),  # no positive prediction: precision 1
             ([0.9, 0.1], [0.0, 0.0])]  # no positive target: recall 1
    for probs, targets in cases:
        p = np.asarray(probs, np.float32)
        t = np.asarray(targets, np.float32)
        got = batch_metrics(torch.from_numpy(p), torch.from_numpy(t))
        want = jbatch_metrics(jnp.asarray(p), jnp.asarray(t))
        for k in ("acc", "precision", "recall"):
            assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-7), k


@pytest.mark.parametrize("grad_scale", [1e-3, 30.0], ids=["below_clip", "clipped"])
def test_adam_update_matches_jax_from_its_state(grad_scale):
    rng = np.random.default_rng(11)
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "b.weight": (7, 5)}
    draw = lambda s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    params = {k: draw(s, 0.1) for k, s in shapes.items()}
    grads = {k: draw(s, grad_scale) for k, s in shapes.items()}
    mu = {k: draw(s, 0.01) for k, s in shapes.items()}
    nu = {k: np.abs(draw(s, 1e-4)) for k, s in shapes.items()}
    jstate = joptim.AdamState(step=jnp.asarray(3, jnp.int32), mu=mu, nu=nu)
    jp, js = JAdam().update(grads, jstate, params)

    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = Adam().update({k: torch.from_numpy(v) for k, v in grads.items()},
                       opt_state_from_jax(jstate), tparams)
    assert int(ts.step) == int(js.step) == 4
    for k in shapes:
        np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jp[k]), atol=UPDATE_TOL, rtol=0)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), atol=1e-9, rtol=1e-6)
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    assert float(global_norm(tg)) == pytest.approx(float(joptim.global_norm(grads)), rel=1e-6)
    clipped = clip_by_global_norm(tg, 1.0)
    jclipped = joptim.clip_by_global_norm(grads, 1.0)
    for k in shapes:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]), rtol=1e-6, atol=1e-9)


def test_one_train_step_matches_jax(jax_side):
    batch = make_batches(101, 1)[0]
    jloss, jgrads = jax_grads(jax_side, batch)
    jgrads = flat(jgrads)
    port = port_trainer(jax_side)
    x, y = port._prep(batch)
    loss, _, grads = port.loss_and_grads(x, y)
    assert float(loss) == pytest.approx(jloss, abs=LOSS_TOL)
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], atol=GRAD_TOL, rtol=0, err_msg=k)

    jt = jax_side["trainer"]
    p, s, o, jm = jt.train_batch(jax_side["params"], jax_side["state"],
                                 jt.optimizer.init(jax_side["params"]), batch, None)
    stepped = port_trainer(jax_side)
    start = {k: v.detach().clone() for k, v in stepped.params.items()}
    opt, m = stepped.train_batch(stepped.init(), batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=LOSS_TOL)
    assert int(opt.step) == 1
    want = flat(p, s)
    sd = stepped.model.state_dict()
    for k in ("running_mean", "running_var"):
        keys = [n for n in sd if n.endswith(k)]
        assert keys
        for n in keys:
            np.testing.assert_allclose(sd[n].numpy(), want[n], atol=UPDATE_TOL, rtol=0, err_msg=n)
    assert all(int(sd[n]) == int(want[n]) for n in sd if n.endswith("num_batches_tracked"))
    # Every element against JAX's Adam on the port's own gradients; the
    # elements with a gradient above noise against JAX's step itself.
    redo, _ = JAdam().update({k: g.numpy() for k, g in grads.items()},
                             JAdam().init({k: v.numpy() for k, v in start.items()}),
                             {k: v.numpy() for k, v in start.items()})
    held = 0
    for k, v in stepped.params.items():
        got = v.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(redo[k]), atol=UPDATE_TOL, rtol=0, err_msg=k)
        sure = np.abs(jgrads[k]) > SURE
        np.testing.assert_allclose(got[sure], want[k][sure], atol=UPDATE_TOL, rtol=0, err_msg=k)
        held += int(sure.sum())
    assert held >= 30


def test_eight_step_loss_curve_matches_jax(jax_side):
    batches = make_batches(102, 8)
    jt = jax_side["trainer"]
    p, s = jax_side["params"], jax_side["state"]
    o = jt.optimizer.init(p)
    port = port_trainer(jax_side)
    opt = port.init()
    for b in batches:
        p, s, o, jm = jt.train_batch(p, s, o, b, None)
        opt, m = port.train_batch(opt, b)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=LOSS_TOL)
    assert int(opt.step) == int(o.step) == 8


def test_grad_accum_two_half_batches_matches_jax(jax_side):
    batch = make_batches(103, 1, batch_size=16)[0]
    halves = [{k: v[i * 8:(i + 1) * 8] for k, v in batch.items()} for i in range(2)]
    jt = jax_side["accum"]
    p, s = jax_side["params"], jax_side["state"]
    o = jt.optimizer.init(p)
    port = port_trainer(jax_side, grad_accum=2)
    opt = port.init()
    for h in halves:
        p, s, o, jm = jt.train_batch(p, s, o, h, None)
        opt, m = port.train_batch(opt, h)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=LOSS_TOL)
    assert int(opt.step) == int(o.step) == 1 and port.pending_micro_steps == 0
    want = flat(p, s)
    sd = port.model.state_dict()
    for n in sd:
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[n].numpy(), want[n], atol=UPDATE_TOL, rtol=0, err_msg=n)
    # One Adam step on half of each half-batch's gradient (train-mode BN
    # normalizes by batch statistics, so the running stats do not enter
    # the gradients): parameters as in test_one_train_step_matches_jax.
    grads = [flat(jax_grads(jax_side, h)[1]) for h in halves]
    held = 0
    for k, v in port.params.items():
        sure = np.abs(0.5 * grads[0][k] + 0.5 * grads[1][k]) > SURE
        got = v.detach().numpy()
        np.testing.assert_allclose(got[sure], want[k][sure], atol=UPDATE_TOL, rtol=0, err_msg=k)
        held += int(sure.sum())
    assert held >= 30


def test_eval_step_and_mean_eval_metrics_match_jax(jax_side):
    batches = make_batches(104, 3)
    jt = jax_side["trainer"]
    want = jt.eval_batches(jax_side["params"], jax_side["state"], batches)
    port = port_trainer(jax_side)
    got = port.eval_batches(batches)
    assert set(got) == set(want) == {"acc", "precision", "recall", "loss"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=LOSS_TOL), k
    assert mean_eval_metrics(port.eval_batch, []) == {}


def test_bn_train_rejects_one_value_per_channel():
    bn = torch.nn.BatchNorm1d(4)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        L.batch_norm(torch.randn(1, 4), bn, train=True)
    before = bn.running_var.clone()
    L.batch_norm(torch.randn(3, 4), bn, train=True)
    assert int(bn.num_batches_tracked) == 1 and not torch.equal(bn.running_var, before)


def test_dropout_needs_a_generator_and_scales_inverted():
    m = zoo.build("ResNetBigger", dropout_rate=0.5, **ARCH).train()
    x = torch.from_numpy(make_batches(105, 1)[0]["inputs"][:, None])
    with pytest.raises(ValueError, match="needs a generator"):
        m(x)
    a = m(x, generator=step_generator(0, 3, "cpu"))
    b = m(x, generator=step_generator(0, 3, "cpu"))
    c = m(x, generator=step_generator(0, 4, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    ones = torch.ones(200_000)
    kept = L.dropout(ones, 0.5, torch.Generator().manual_seed(1), train=True)
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert float(kept.mean()) == pytest.approx(1.0, abs=0.01)
    assert torch.equal(L.dropout(ones, 0.5, None, train=True), ones)


def test_reference_init_and_build_init():
    a = zoo.reference_init(zoo.build("ResNetBigger", **ARCH), seed=4)
    b = zoo.reference_init(zoo.build("ResNetBigger", **ARCH), seed=4)
    for (k, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), k
    w = torch.cat([p.detach().flatten() for p in a.parameters()])
    assert float(w.mean()) == pytest.approx(0.0, abs=1e-3)
    assert float(w.std()) == pytest.approx(0.01, rel=0.05)
    assert float(a.bn1.running_var.min()) == 1.0 and int(a.bn1.num_batches_tracked) == 0
    conv = zoo.build("ResNetBigger", **ARCH).conv1.weight.detach()
    assert float(conv.abs().max()) <= 1 / 3 and float(conv.std()) > 0.1  # fan_in 9


def test_transfer_dtype_bfloat16_rounds_inputs_on_host(jax_side):
    batch = make_batches(106, 1)[0]
    rounded = dict(batch, inputs=torch.from_numpy(batch["inputs"]).bfloat16().float().numpy())
    assert not np.array_equal(rounded["inputs"], batch["inputs"])
    bf = port_trainer(jax_side, transfer_dtype="bfloat16").eval_batch(batch)
    f32 = port_trainer(jax_side).eval_batch(rounded)
    assert float(bf["loss"]) == float(f32["loss"])


def test_unported_options_raise(jax_side, tmp_path):
    m = zoo.build("ResNetBigger", **ARCH)
    # bf16 training is ported (tests/test_torch_precision.py): it constructs.
    assert Trainer(m, device="cpu", compute_dtype="bfloat16").precision == "bfloat16"
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        Trainer(m, device="cpu", compute_dtype="half")
    with pytest.raises(ValueError, match="unknown transfer_dtype"):
        Trainer(m, device="cpu", transfer_dtype="bf16")
    t = Trainer(m, device="cpu")
    # The resident paths are ported (tests/test_torch_train_resident.py);
    # K steps a call still need grad_accum == 1, as in JAX.
    with pytest.raises(ValueError, match="grad_accum == 1"):
        Trainer(m, device="cpu", grad_accum=2).train_k_steps_resident(None, None, [[0]], 0, 0)
    assert TrainLoop(trainer=t, checkpoint_dir=str(tmp_path), steps_per_dispatch=2)
    # The multi-process vote (JAX's cadence): every preempt_vote_every
    # steps and at the epoch's end; a signal waits for the next vote.
    votes = []

    def vote(flag):
        votes.append((loop.global_step, flag))
        return flag

    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path), write_artifacts=False,
                     sync_preempt=vote, preempt_vote_every=3, log_frequency=0)
    batches = make_batches(107, 7)
    opt, _ = loop.run_epoch(t.init(), batches, verbose=False)
    assert votes == [(3, False), (6, False), (7, False)] and not loop.preempted
    votes.clear()
    loop._preempt_pending = True  # a signal during step 8
    opt, _ = loop.run_epoch(opt, batches, verbose=False)
    assert votes == [(9, True)] and loop.preempted and loop.global_step == 9
    assert int(opt.step) == 9
    # Without a vote the signal is the decision, at once.
    loop = TrainLoop(trainer=t, checkpoint_dir=str(tmp_path), write_artifacts=False,
                     log_frequency=0)
    loop._preempt_pending = True
    opt, _ = loop.run_epoch(opt, batches, verbose=False)
    assert loop.preempted and loop.global_step == 1


def test_trainer_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(zoo.build("ResNetBigger", **ARCH))
