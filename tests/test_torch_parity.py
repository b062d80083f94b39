"""Shared helpers of the PyTorch port's parity tests, and tests of them.

The port takes its random inputs explicitly; these helpers derive them
from a reference JAX key exactly as the reference transport derives its
own draws, so both sides see the same uniforms and PRF seed words.  The
other ``test_torch_*`` files import them from here.
"""
import jax
import numpy as np
import pytest
import torch

from repro.wire import corrupt as WC
from repro_torch.core.transport import Draws
from repro_torch.kernels import ops as tops


def words_np(t):
    """int32 word tensor -> numpy uint32 (same bit pattern)."""
    return t.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def seeds(key):
    """The reference's two uint32 PRF seed words of ``key``."""
    return tuple(int(s) for s in np.asarray(WC.seeds_from_key(key)))


def ulp_atol(weight, gmax, gbar):
    """The reference's FMA-wobble bound (tests/test_packed_hotpath.py):
    4 eps x sum_k w_k max(gmax_k, max gbar)."""
    scale = float(np.sum(np.asarray(weight, np.float32)
                         * np.maximum(np.asarray(gmax, np.float32),
                                      np.max(np.asarray(gbar)))))
    return 4 * np.finfo(np.float32).eps * max(scale, 1.0)


def draws_from_key(key, k, l, n_retx, channel):
    """The draws ``repro.core.transport.spfl_aggregate(..., key)`` makes."""
    kq, ko = jax.random.split(key)
    rand = torch.as_tensor(np.array(jax.random.uniform(kq, (k, l))))
    if channel == 'bitlevel':
        ks, kv = jax.random.split(ko)
        sign = [seeds(ks)] + [seeds(jax.random.fold_in(ks, a))
                              for a in range(1, n_retx + 1)]
        # the modulus stream's pair, then one per sign attempt
        return Draws(rand, seeds=tops.seed_words([seeds(kv)] + sign, 'cpu'))
    if n_retx == 0:
        k1, k2 = jax.random.split(ko)
        sign_u = jax.random.uniform(k1, (k,))[None]
        mod_u = jax.random.uniform(k2, (k,))
    else:
        ks, km = jax.random.split(ko)
        sign_u = jax.random.uniform(ks, (n_retx + 1, k))
        mod_u = jax.random.uniform(km, (k,))
    return Draws(rand, sign_u=torch.as_tensor(np.array(sign_u)),
                 mod_u=torch.as_tensor(np.array(mod_u)))


def baseline_draws_from_key(kind, key, k, l, channel):
    """The draws ``repro.core.transport``'s baseline ``kind`` makes from
    ``key``: dds splits (quantizer, fate), onebit draws its fate from the
    key itself, scheduling splits (Rayleigh, fate, quantizer) and
    error_free quantizes with the key.  The packet fate is one uniform a
    client, drawn as ``uniform(ko, (K,))`` ('bernoulli') or
    ``simulate_attempts(ko, q, 0)``'s ``uniform(ko, (1, K))``
    ('bitlevel'); both give the same numbers, kept as (1, K)."""
    def t(a):
        return torch.as_tensor(np.array(a))

    if kind == 'error_free':
        return Draws(t(jax.random.uniform(key, (k, l))))
    h2 = rand = None
    if kind == 'dds':
        kq, ko = jax.random.split(key)
        rand = t(jax.random.uniform(kq, (k, l)))
    elif kind == 'onebit':
        ko = key
    elif kind == 'scheduling':
        kh, ko, kq = jax.random.split(key, 3)
        h2 = t(jax.random.exponential(kh, (k,)))
        rand = t(jax.random.uniform(kq, (k, l)))
    else:
        raise ValueError(kind)
    if channel == 'bitlevel':
        fate_u = jax.random.uniform(ko, (1, k))
    else:
        fate_u = jax.random.uniform(ko, (k,))[None]
    return Draws(rand, fate_u=t(fate_u), h2=h2)


def test_words_np_keeps_the_bit_pattern():
    words = torch.tensor([0, 1, -1, -(2 ** 31), 2 ** 31 - 1],
                         dtype=torch.int32)
    np.testing.assert_array_equal(
        words_np(words),
        np.array([0, 1, 2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1], np.uint32))


@pytest.mark.parametrize('seed', [0, 7, 123456])
def test_seeds_are_the_references_uint32_words(seed):
    key = jax.random.PRNGKey(seed)
    got = seeds(key)
    assert len(got) == 2 and all(0 <= s < 2 ** 32 for s in got)
    assert list(got) == [int(s) for s in np.asarray(WC.seeds_from_key(key))]


@pytest.mark.parametrize('channel', ['bernoulli', 'bitlevel'])
@pytest.mark.parametrize('n_retx', [0, 1])
def test_draws_from_key_layout(channel, n_retx):
    k, l = 3, 70
    draws = draws_from_key(jax.random.PRNGKey(5), k, l, n_retx, channel)
    assert draws.rand.shape == (k, l) and draws.rand.dtype == torch.float32
    assert 0.0 <= float(draws.rand.min()) and float(draws.rand.max()) < 1.0
    if channel == 'bitlevel':
        assert draws.sign_u is None and draws.mod_u is None
        assert draws.seeds.dtype == torch.int32
        streams = [tuple(r) for r in draws.seeds.tolist()]
        assert len(streams) == n_retx + 2 and len(set(streams)) == n_retx + 2
    else:
        assert draws.seeds is None
        assert tuple(draws.sign_u.shape) == (n_retx + 1, k)
        assert tuple(draws.mod_u.shape) == (k,)


@pytest.mark.parametrize('kind', ['dds', 'onebit', 'scheduling', 'error_free'])
@pytest.mark.parametrize('channel', ['bernoulli', 'bitlevel'])
def test_baseline_draws_from_key_layout(kind, channel):
    k, l = 5, 70
    key = jax.random.PRNGKey(9)
    draws = baseline_draws_from_key(kind, key, k, l, channel)
    assert (draws.rand is None) == (kind == 'onebit')
    if draws.rand is not None:
        assert tuple(draws.rand.shape) == (k, l)
    assert (draws.h2 is None) == (kind != 'scheduling')
    if kind == 'error_free':
        assert draws.fate_u is None
        return
    assert tuple(draws.fate_u.shape) == (1, k)
    # the other channel's fate draws the same numbers
    other = 'bitlevel' if channel == 'bernoulli' else 'bernoulli'
    again = baseline_draws_from_key(kind, key, k, l, other)
    assert torch.equal(again.fate_u, draws.fate_u)
