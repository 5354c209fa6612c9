"""The port's model zoo and checkpoint loading against the JAX package, on
the same numpy-seeded weights (shared-stem inference:
tests/test_torch_shared_stem.py).

Tolerance: zoo forward within 1e-5 of ``zoo.build(...).apply(train=False)``
(float32 convs summed in another order than XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu.train import checkpoint as jckpt
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train import checkpoint as tckpt
from tests.fixtures.torch_weights import SMALL, both_models, numpy_weights

CASES = [
    ("ResNetBigger", SMALL),
    ("ResNet", dict(linear_layer_size=48)),
    ("ResNetNoBN", dict(linear_layer_size=48)),
    ("MLPModel", dict(linear_layer_size=100 * 44)),
]


def _forward_jax(jmodel, params, state, x):
    probs, _ = jmodel.apply(params, state, jnp.asarray(x), train=False)
    return np.asarray(probs)


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_state_dict_keys_match_jax(name, kw):
    _, params, state = numpy_weights(name, **kw)
    flat = {**jckpt.flatten_tree(params), **jckpt.flatten_tree(state)}
    sd = zoo.build(name, **kw).state_dict()
    assert sorted(sd) == sorted(flat)
    for k, v in sd.items():
        assert tuple(v.shape) == np.shape(flat[k]), k


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_forward_matches_jax(rng, name, kw):
    jmodel, params, state, tmodel = both_models(name, seed=1, **kw)
    x = rng.standard_normal((6, 1, 100, 44)).astype(np.float32)
    want = _forward_jax(jmodel, params, state, x)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_config_guards():
    with pytest.raises(ValueError, match="exactly 4 filter_sizes"):
        zoo.build("ResNetBigger", filter_sizes=(8, 8, 8))
    with pytest.raises(ValueError, match="hardcodes"):
        zoo.build("ResNet", filter_sizes=(64, 32, 16, 16))
    with pytest.raises(KeyError, match="unknown architecture"):
        zoo.build("VGG")
    mlp = zoo.build("MLPModel", linear_layer_size=48)
    with pytest.raises(ValueError, match="flattened window size"):
        mlp(torch.zeros(2, 1, 100, 44))


def test_build_is_seeded_and_keeps_global_rng():
    state = torch.random.get_rng_state()
    a = zoo.build("ResNetBigger", **SMALL).state_dict()
    b = zoo.build("ResNetBigger", **SMALL).state_dict()
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_npz_checkpoint_from_jax_loads(tmp_path, rng):
    # A checkpoint written by the JAX package's save_checkpoint (opt state
    # included) loads strictly and reproduces the JAX forward.
    jmodel, params, state = numpy_weights("ResNetBigger", seed=3, **SMALL)
    opt = {"mu": {"conv1": {"weight": np.ones((64, 1, 3, 3), np.float32)}}}
    path = jckpt.save_checkpoint(str(tmp_path), params, state, opt, epoch=4,
                                 global_step=17, best_val_loss=0.25)
    loaded = tckpt.load_checkpoint(path)
    assert (loaded["epoch"], loaded["global_step"], loaded["best_val_loss"]) == (4, 17, 0.25)
    sd = loaded["state_dict"]
    assert sd["bn1.num_batches_tracked"].dtype == torch.int64
    tmodel = zoo.build("ResNetBigger", **SMALL)
    tmodel.load_state_dict(sd, strict=True)
    x = rng.standard_normal((4, 1, 100, 44)).astype(np.float32)
    j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    want = _forward_jax(jmodel, j(params), j(state), x)
    with torch.inference_mode():
        np.testing.assert_allclose(tmodel(torch.from_numpy(x)).numpy(), want, atol=1e-5)
    with pytest.warns(UserWarning, match="no best checkpoint"):
        assert tckpt.resolve_checkpoint(str(tmp_path)) == path


def test_checkpoints_cross_both_ways(tmp_path):
    # Port save -> JAX load, and a reference-style .pth.tar -> port load.
    tmodel = zoo.build("ResNetBigger", **SMALL)
    sd = tmodel.state_dict()
    path = tckpt.save_checkpoint(str(tmp_path), sd)
    back = jckpt.load_checkpoint(path, host=True)
    flat = {**jckpt.flatten_tree(back["params"]), **jckpt.flatten_tree(back["state"])}
    assert sorted(flat) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(flat[k], v.numpy())
    assert flat["bn1.num_batches_tracked"].dtype == np.int32
    pth = tmp_path / "best.pth.tar"
    torch.save({"state_dict": sd, "epoch": 2, "global_step": 9}, pth)
    loaded = tckpt.load_checkpoint(str(pth))
    assert loaded["epoch"] == 2
    for k, v in sd.items():
        assert torch.equal(loaded["state_dict"][k], v)
    assert tckpt.resolve_checkpoint(str(tmp_path)) == str(pth)
