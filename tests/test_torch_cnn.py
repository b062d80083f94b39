"""The port's CNN against ``repro.models.cnn`` on the same weights
(``params_from_jax``) and inputs: logits, loss, and the flat per-client
gradient in ``ravel_pytree`` order.

Tolerance rtol 1e-4, atol 1e-6: the two frameworks sum the convolutions
in different orders in f32; the parameter layouts and the flat order are
exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call, grad_and_value, vmap

from repro.models import cnn as RC
from repro_torch.models import cnn as TC

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope='module')
def weights():
    params = RC.init_cnn(jax.random.PRNGKey(3))
    # non-zero biases so their layout is exercised too
    rng = np.random.RandomState(0)
    return {k: np.asarray(v) + (0.1 * rng.randn(*v.shape).astype(np.float32)
                                if k.endswith('_b') else 0.0)
            for k, v in params.items()}


def _images(b, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, b).astype(np.int32))


def _nchw(x):
    return torch.as_tensor(x).permute(0, 3, 1, 2).contiguous()


def test_param_count_and_flat_order(weights):
    flat_ref, _ = ravel_pytree({k: jnp.asarray(v) for k, v in weights.items()})
    assert flat_ref.shape[0] == TC.N_PARAMS == 62006
    model = TC.CNN()
    model.load_state_dict(TC.params_from_jax(weights))
    flat = TC.flat_from_module(model)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_ref))
    model2 = TC.module_from_flat(TC.CNN(), flat)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


def test_logits_and_loss_match_reference(weights):
    x, y = _images(8, seed=1)
    jp = {k: jnp.asarray(v) for k, v in weights.items()}
    model = TC.CNN()
    model.load_state_dict(TC.params_from_jax(weights))
    with torch.no_grad():
        logits = model(_nchw(x))
        loss = TC.cnn_loss(logits, torch.as_tensor(y, dtype=torch.int64))
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(RC.cnn_forward(jp, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        float(loss), float(RC.cnn_loss(jp, jnp.asarray(x), jnp.asarray(y))),
        rtol=RTOL, atol=ATOL)


def test_per_client_flat_gradients_match_reference(weights):
    k, b = 3, 6
    xs, ys = _images(k * b, seed=2)
    xs, ys = xs.reshape(k, b, 32, 32, 3), ys.reshape(k, b)
    jp = {kk: jnp.asarray(v) for kk, v in weights.items()}

    def one(x, y):
        loss, g = jax.value_and_grad(RC.cnn_loss)(jp, x, y)
        return loss, ravel_pytree(g)[0]
    rloss, rgrad = jax.vmap(one)(jnp.asarray(xs), jnp.asarray(ys))

    model = TC.CNN()
    model.load_state_dict(TC.params_from_jax(weights))
    flat = TC.flat_from_module(model)

    def client_loss(f, x, y):
        return TC.cnn_loss(functional_call(model, TC.module_params(f), (x,)),
                           y)
    grads, losses = vmap(grad_and_value(client_loss), in_dims=(None, 0, 0))(
        flat, _nchw(xs.reshape(k * b, 32, 32, 3)).reshape(k, b, 3, 32, 32),
        torch.as_tensor(ys, dtype=torch.int64))
    np.testing.assert_allclose(losses.numpy(), np.asarray(rloss),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads.numpy(), np.asarray(rgrad),
                               rtol=RTOL, atol=ATOL)
