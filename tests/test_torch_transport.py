"""The port's flat SP-FL transport against ``repro.core.transport.
spfl_aggregate`` for wire x channel x n_retx, with the port fed the
reference's own draws (quantizer uniforms, PRF seed words, Bernoulli
uniforms — ``test_torch_parity.draws_from_key``).

Contract: every integer output exact (packet verdicts, flips, CRC state,
resends, votes, measured bits); ``ghat`` within the reference's FMA-wobble
bound.  Also the bit-channel calibration ``ber_for_success``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import draws_from_key, ulp_atol
from repro.core import bitchannel as BC
from repro.core import transport as TR
from repro_torch.core import bitchannel as TBC
from repro_torch.core import transport as TTR

CASES = [('analytic', 'bernoulli', 0), ('analytic', 'bernoulli', 1),
         ('packed', 'bernoulli', 0), ('packed', 'bernoulli', 1),
         ('packed', 'bitlevel', 0), ('packed', 'bitlevel', 1)]


def _inputs(k, l, seed, per_client_gbar=False):
    rng = np.random.RandomState(seed)
    grads = (rng.randn(k, l) * 0.02).astype(np.float32)
    grads[0, :5] = 0.0
    shape = (k, l) if per_client_gbar else (l,)
    gbar = rng.uniform(0, 0.02, shape).astype(np.float32)
    q = np.linspace(0.35, 1.0, k).astype(np.float32)
    p = np.linspace(0.95, 0.3, k).astype(np.float32)
    return grads, gbar, q, p


@pytest.mark.parametrize('wire,channel,n_retx', CASES)
@pytest.mark.parametrize('k,l', [(4, 333), (6, 1000)])
def test_spfl_aggregate_matches_reference(wire, channel, n_retx, k, l):
    grads, gbar, q, p = _inputs(k, l, seed=k + l + n_retx)
    key = jax.random.PRNGKey(7 * k + n_retx)
    ghat_r, tel_r = TR.spfl_aggregate(
        jnp.asarray(grads), jnp.asarray(gbar), jnp.asarray(q), jnp.asarray(p),
        3, 64, key, n_retx=n_retx, wire=wire, round_idx=5, channel=channel)
    draws = draws_from_key(key, k, l, n_retx, channel)
    ghat, tel = TTR.spfl_aggregate(
        torch.as_tensor(grads), torch.as_tensor(gbar), torch.as_tensor(q),
        torch.as_tensor(p), 3, 64, draws, n_retx=n_retx, wire=wire,
        round_idx=5, channel=channel)
    for name, val in tel._asdict().items():
        ref = getattr(tel_r, name)
        assert (val is None) == (ref is None), name
        if val is not None:
            np.testing.assert_array_equal(val.numpy(), np.asarray(ref), name)
    q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)
    weight = tel.sign_ok.numpy() / q_eff
    np.testing.assert_allclose(
        ghat.numpy(), np.asarray(ghat_r), rtol=0,
        atol=ulp_atol(weight, np.abs(grads).max(axis=1), gbar) / k)
    if channel == 'bitlevel':                    # the channel did work
        assert int(tel.sign_flips.sum() + tel.mod_flips.sum()) > 0


def test_spfl_aggregate_per_client_gbar_and_floor():
    """Per-client compensation and the min_participation floor."""
    k, l = 5, 200
    grads, gbar, q, p = _inputs(k, l, seed=3, per_client_gbar=True)
    key = jax.random.PRNGKey(11)
    for floor in (0.0, 0.9):
        ghat_r, tel_r = TR.spfl_aggregate(
            jnp.asarray(grads), jnp.asarray(gbar), jnp.asarray(q),
            jnp.asarray(p), 3, 64, key, wire='packed', channel='bitlevel',
            min_participation=floor)
        ghat, tel = TTR.spfl_aggregate(
            torch.as_tensor(grads), torch.as_tensor(gbar), torch.as_tensor(q),
            torch.as_tensor(p), 3, 64,
            draws_from_key(key, k, l, 0, 'bitlevel'), wire='packed',
            channel='bitlevel', min_participation=floor)
        np.testing.assert_array_equal(tel.mod_ok.numpy(),
                                      np.asarray(tel_r.mod_ok))
        np.testing.assert_allclose(
            ghat.numpy(), np.asarray(ghat_r), rtol=0,
            atol=ulp_atol(tel.sign_ok.numpy() / q, np.abs(grads).max(1),
                          gbar) / k)


def test_bitlevel_requires_packed_wire():
    k, l = 2, 10
    draws = TTR.Draws(torch.zeros(k, l))
    with pytest.raises(ValueError):
        TTR.spfl_aggregate(torch.zeros(k, l), torch.zeros(l), torch.ones(k),
                           torch.ones(k), 3, 64, draws, wire='analytic',
                           channel='bitlevel')


@pytest.mark.parametrize('n_words', [21, 99, 513, 1943, 5822, 2 ** 20])
def test_ber_for_success_accuracy_and_reference(n_words):
    """The calibration chain log -> expm1 -> log1p -> expm1 in f32.

    Against the same closed form evaluated in float64 the port stays
    within 3 ulp across the operating range prob in [1e-3, 1]: four f32
    stages each round once (PyTorch's are within 0.51 ulp) and the log1p
    stage amplifies; toward the 2^-32 fold floor it is ill-conditioned
    and no f32 evaluation is that close.  Against the reference it differs by up to
    12 ulp: XLA's CPU f32 expm1 is off by up to 5 ulp where PyTorch's is
    within 0.51 (measured over [-0.7, 0]), and the chain amplifies it.
    The per-stage kernel tests therefore feed both sides the same BER."""
    prob = np.concatenate([np.logspace(-9, 0, 400), np.linspace(0, 1, 401),
                           [2.0 ** -33, 0.0, 1.0]]).astype(np.float32)
    got = TBC.ber_for_success(torch.as_tensor(prob), n_words).numpy()
    p64 = prob.astype(np.float64)
    with np.errstate(divide='ignore'):
        rm1 = np.maximum(2 * np.expm1(np.log(p64) / 32), -1.0)
        exact = -0.5 * np.expm1(np.log1p(rm1) / n_words)
    ulp = np.spacing(np.maximum(np.abs(exact), 1e-38).astype(np.float32))
    op = prob >= 1e-3
    assert np.all(np.abs(got - exact)[op] <= 3 * ulp[op])
    ref = np.asarray(BC.ber_for_success(jnp.asarray(prob), n_words))
    rulp = np.spacing(np.maximum(np.abs(ref), 1e-38).astype(np.float32))
    assert np.all(np.abs(got - ref) <= 12 * rulp)
    assert list(got[-3:]) == list(ref[-3:]) == [0.5, 0.5, 0.0]
    back = TBC.fold_pass_prob(torch.as_tensor(got), n_words).numpy()
    ref_back = np.asarray(BC.fold_pass_prob(jnp.asarray(ref), n_words))
    np.testing.assert_allclose(back, ref_back, rtol=1e-5, atol=1e-7)
