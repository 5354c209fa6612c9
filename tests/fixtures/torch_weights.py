"""Numpy-seeded weights shared by the JAX package and the PyTorch port in
the port's parity tests (tests/test_torch_*.py).

The two frameworks draw different numbers from the same seed, so weights
are made once in numpy and handed to both: as JAX ``(params, state)`` trees
and, through ``train.checkpoint.state_dict_from_jax``, as a torch state
dict.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laughter_detection_icsi_tpu import models as jax_models
from laughter_detection_icsi_tpu_torch.models import zoo
from laughter_detection_icsi_tpu_torch.train.checkpoint import state_dict_from_jax

#: Narrow ResNetBigger for CPU tests: (100, 44) windows leave a (3, 1) map
#: of 8 channels = a 24-feature head.
SMALL = dict(linear_layer_size=24, filter_sizes=(8, 8, 8, 8))


def _leaf(path: str, shape, rng: np.random.Generator, head_gain: float):
    leaf = path.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return np.asarray(rng.integers(0, 100), dtype=np.int32)
    if leaf == "running_mean":
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if leaf == "running_var":
        return (1.0 + 0.5 * rng.random(shape)).astype(np.float32)
    if len(shape) == 1:  # a bias, or a BN affine (its 1-D "weight")
        base = 1.0 if leaf == "weight" else 0.0
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    fan_in = int(np.prod(shape[1:]))
    w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
    if path.startswith("linear2") or path.startswith("linear3"):
        w = w * head_gain  # spreads the probabilities over (0, 1)
    return w.astype(np.float32)


def numpy_weights(arch: str, seed: int = 0, head_gain: float = 1.0, **kw):
    """(params, state) numpy trees for ``arch`` with the JAX model's tree
    structure, drawn from ``seed``."""
    model = jax_models.build(arch, dropout_rate=0.0, **kw)
    p0, s0 = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(tree, prefix=""):
        if isinstance(tree, dict):
            return {
                k: fill(v, f"{prefix}.{k}" if prefix else k)
                for k, v in sorted(tree.items())
            }
        return _leaf(prefix, tuple(tree.shape), rng, head_gain)

    return model, fill(p0), fill(s0)


def both_models(arch: str, seed: int = 0, head_gain: float = 1.0, **kw):
    """(jax_model, jax_params, jax_state, torch_model) on the same weights;
    the torch model is on the CPU in eval mode."""
    jmodel, params, state = numpy_weights(arch, seed, head_gain, **kw)
    tmodel = zoo.build(arch, dropout_rate=0.0, **kw)
    tmodel.load_state_dict(state_dict_from_jax(params, state), strict=True)
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return jmodel, to_j(params), to_j(state), tmodel


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads for the torch CPU work of a test module: the
    suite runs several pytest workers on one machine, and each worker's
    torch would otherwise spin up a thread per core and contend with the
    others.  A test module takes it with ``from tests.fixtures.torch_weights
    import few_torch_threads``."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nest(flat: dict) -> dict:
    """Dotted keys -> the JAX package's nested tree (jnp leaves)."""
    out: dict = {}
    for key, val in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return out


def calibrated_models(arch: str, windows: torch.Tensor, seed: int = 0,
                      head_gain: float = 1.0, **kw):
    """``both_models`` with the BatchNorm running statistics of ``windows``
    ([B, 1, window, F] float32): one train-mode forward of the port's model
    at momentum 1 sets each BatchNorm's statistics to its inputs' own, as a
    trained checkpoint's are.  Random weights with random statistics grow
    the activations through the stack (to ~70 at the last stage of the
    narrow ResNetBigger), where a bf16 rounding moves a probability several
    times more than it does in a checkpoint."""
    from laughter_detection_icsi_tpu_torch.models import layers

    jmodel, params, _, tmodel = both_models(arch, seed, head_gain, **kw)
    momentum, layers.BN_MOMENTUM = layers.BN_MOMENTUM, 1.0
    try:
        tmodel.train()
        with torch.no_grad():
            tmodel(windows)
    finally:
        layers.BN_MOMENTUM = momentum
        tmodel.eval()
    state = {k: v.numpy().astype(np.int32) if k.endswith("num_batches_tracked") else v.numpy()
             for k, v in tmodel.state_dict().items()
             if k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")}
    return jmodel, params, _nest(state), tmodel
