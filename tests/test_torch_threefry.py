"""The port's Threefry-2x32 keys (``repro_torch.core.threefry``) against
``jax.random`` with jax's defaults (threefry2x32, partitionable):
``threefry2x32``, ``key``, ``fold_in``, ``split``, ``bits`` and
``uniform`` bit for bit, over drawn seeds and data (the n - j wrap-around
of the shadowing lags and data >= 2^31 included); ``normal`` within
3 ulp of ``jax.random.normal`` and bit for bit on >= 99% of 4,000 draws
(XLA's float32 ``log1p`` inside its ``ErfInv`` is not PyTorch's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from _hypothesis_compat import given, settings, st
from repro_torch.core import threefry as TF

SEEDS = st.integers(min_value=0, max_value=2 ** 32 - 1)
WORDS = st.integers(min_value=0, max_value=2 ** 32 - 1)


def _words(key):
    """A jax key's two uint32 words as int64."""
    return np.asarray(key).astype(np.uint32).astype(np.int64)


def _key(words):
    return jnp.asarray(np.asarray(words, np.uint32))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_jax_runs_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@settings(max_examples=25, deadline=None)
@given(k0=WORDS, k1=WORDS, x0=WORDS, x1=WORDS)
def test_threefry2x32_matches_jax(k0, k1, x0, x1):
    want = jax_prng.threefry_2x32(_key([k0, k1]), _key([x0, x1]))
    got = TF.threefry2x32(k0, k1, x0, x1)
    assert [int(g) for g in got] == [int(w) for w in np.asarray(want)]


def test_threefry2x32_batched_lanes_match_jax():
    rng = np.random.RandomState(0)
    k = rng.randint(0, 2 ** 32, 2, dtype=np.uint64)
    x = rng.randint(0, 2 ** 32, (2, 64), dtype=np.uint64)
    want = np.asarray(jax_prng.threefry_2x32(
        _key(k), _key(x.reshape(-1)))).reshape(2, 64)
    got = TF.threefry2x32(int(k[0]), int(k[1]),
                          torch.as_tensor(x[0].astype(np.int64)),
                          torch.as_tensor(x[1].astype(np.int64)))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]),
                                  want.astype(np.int64))


@settings(max_examples=25, deadline=None)
@given(seed=SEEDS)
def test_key_matches_prngkey(seed):
    np.testing.assert_array_equal(TF.key(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1), data=WORDS)
def test_fold_in_matches_jax(seed, data):
    want = _words(jax.random.fold_in(jax.random.PRNGKey(seed),
                                     np.uint32(data)))
    np.testing.assert_array_equal(TF.fold_in(TF.key(seed), data).numpy(),
                                  want)


@pytest.mark.parametrize('n', [0, 1, 31, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_wraps_like_uint32_lags(n):
    """The shadowing track folds (n - j) mod 2^32: lags below round 0 wrap
    around, and data past 2^31 stays unsigned."""
    base = jax.random.PRNGKey(7)
    want = np.stack([_words(jax.random.fold_in(
        base, np.uint32((n - j) % 2 ** 32))) for j in range(32)])
    lags = (n - torch.arange(32)) & TF.MASK32
    np.testing.assert_array_equal(TF.fold_in(TF.key(7), lags).numpy(), want)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1),
       num=st.integers(min_value=1, max_value=9))
def test_split_matches_jax(seed, num):
    want = _words(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(TF.split(TF.key(seed), num).numpy(), want)


def test_split_chain_matches_jax():
    """The training loop's per-round ``key, kr = split(key)``."""
    key, tkey = jax.random.PRNGKey(0), TF.key(0)
    for _ in range(6):
        key, kr = jax.random.split(key)
        tkey, tkr = TF.split(tkey)
        np.testing.assert_array_equal(tkr.numpy(), _words(kr))
        np.testing.assert_array_equal(tkey.numpy(), _words(key))


@pytest.mark.parametrize('shape', [(), (4,), (3, 5), (2, 3, 7)])
def test_bits_matches_jax(shape):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(TF.bits(TF.key(11), shape).numpy(),
                                  want.astype(np.int64))


def test_batched_keys_draw_each_keys_bits():
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    want = np.stack([np.asarray(jax.random.bits(k, (4,), jnp.uint32))
                     for k in keys]).astype(np.int64)
    got = TF.bits(torch.as_tensor(_words(keys)), (4,))
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1),
       lo=st.floats(-4.0, 0.0, width=32), span=st.floats(0.5, 8.0, width=32))
def test_uniform_matches_jax(seed, lo, span):
    hi = float(np.float32(lo + span))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(key, (257,), minval=lo, maxval=hi))
    got = TF.uniform(TF.key(seed), (257,), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)


def test_per_id_scalar_uniforms_match_vmapped_jax():
    """The population's per-device pattern: uniform(fold_in(k, id), ())
    over ids up to 999,999, and past 2^31."""
    k = jax.random.fold_in(jax.random.PRNGKey(7), 0x917A)
    ids = np.concatenate([np.arange(0, 1_000_000, 997),
                          [2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    want = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(k, i), ()))(jnp.asarray(ids))
    got = TF.uniform(TF.fold_in(torch.as_tensor(_words(k)),
                                torch.as_tensor(ids.astype(np.int64))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_normal_within_3_ulp_and_mostly_bit_for_bit():
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.normal(key, (4000,)))
    got = TF.normal(TF.key(7), (4000,)).numpy()
    ulps = _ulps(got, want)
    assert ulps.max() <= 3
    assert (ulps == 0).mean() >= 0.99


def test_erfinv_is_xlas_polynomial_not_torchs():
    """The port follows XLA's float32 ErfInv: torch.erfinv is tens of ulp
    away from it on the same uniforms."""
    u = TF.uniform(TF.key(3), (4000,), float(np.nextafter(
        np.float32(-1), np.float32(1))), 1.0)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    assert _ulps(TF.erfinv32(u).numpy(), want).max() <= 3
    assert _ulps(torch.erfinv(u).numpy(), want).max() > 3


def test_erfinv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0], dtype=torch.float32)
    out = TF.erfinv32(x).numpy()
    assert out[0] == -np.inf and out[1] == np.inf and out[2] == 0.0
