"""The port's optimizers (``repro_torch.training.optimizer``) against
the reference's ``src/repro/training/optimizer.py`` over three updates
of a small parameter tree, float32 and bfloat16 leaves.

The reference module is loaded by its path: importing the package
``repro.training`` would import its ``fl_loop``, which needs a JAX API
this environment's JAX lacks.  Parameters and state agree bit for bit
(the update in float32, one rounding to the parameters' dtype)."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.training import optimizer as TO

_PATH = (pathlib.Path(__file__).resolve().parents[1] / 'src' / 'repro'
         / 'training' / 'optimizer.py')
_spec = importlib.util.spec_from_file_location('reference_optimizer', _PATH)
RO = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RO)


def _tree(rng):
    return {'w': rng.randn(4, 6).astype(np.float32),
            'blocks': {'b': rng.randn(5).astype(np.float32),
                       'a': rng.randn(2, 3).astype(np.float32)}}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', ['sgd', 'momentum', 'adamw'])
def test_three_updates_match_reference(name, dtype):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    tp = tree.map(lambda a: torch.as_tensor(a).to(tdt), params)
    ref, port = RO.get_optimizer(name, 0.05), TO.get_optimizer(name, 0.05)
    rs, ts = ref.init(rp), port.init(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                             params)
        rp, rs = ref.update(jax.tree.map(jnp.asarray, grads), rs, rp)
        tp, ts = port.update(tree.map(torch.as_tensor, grads), ts, tp)
    assert jax.tree.structure(rp) == jax.tree.structure(
        tree.map(lambda t: 0, tp))
    for a, b in zip(tree.leaves(tp), jax.tree.leaves(rp)):
        assert a.dtype == tdt
        np.testing.assert_array_equal(a.to(torch.float32).numpy(),
                                      np.asarray(b, np.float32))
    if name != 'sgd':
        for a, b in zip(tree.leaves(ts), jax.tree.leaves(rs)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unknown_optimizer():
    with pytest.raises(KeyError):
        TO.get_optimizer('lion', 0.1)
