"""The port's block fading and the rest of ``repro_torch.core.channel``
against ``repro.core.channel`` on the same standard normals and Exp(1)
draws.

Tolerances: the reference's scanned AR(1) step is contracted by XLA into
fma(rho, z, f32(c e)), which the port emulates, so the track z is bit for
bit; ``10 ** x`` in float32 is XLA's own approximation, which the port's
float64 power rounded once meets on ~99.9% of arguments and never by
more than 1 ulp.  So the shadowing factor 10^(4 z / 10) is within 1 ulp
and bit for bit on at least 99% of entries; a gain is that factor times
the base gain, rounded once more, so a factor 1 ulp off can put the gain
2 ulp off (when the product's mantissa lies in a lower half-binade), and
gains are held to 2 ulp and 99% bit for bit.  The capacities' log2 is
XLA's or PyTorch's float32 one (within an ulp of each other): rtol 4 eps.
Outcome booleans are exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as RefFLConfig
from repro.core import channel as C
from repro_torch.configs.base import FLConfig
from repro_torch.core import channel as TC

EPS = np.finfo(np.float32).eps
FL_REF = RefFLConfig()
FL = FLConfig(**dataclasses.asdict(FL_REF))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _base(k, seed):
    rng = np.random.RandomState(seed)
    return (10.0 ** rng.uniform(-9, -6, k)).astype(np.float32)


@pytest.mark.parametrize('rho', [0.9, 0.5, 0.0])
@pytest.mark.parametrize('ones', [True, False], ids=['factor', 'gains'])
def test_trajectory_matches_reference(rho, ones):
    n_rounds, k = 200, 20
    key = jax.random.PRNGKey(int(rho * 10) + 3)
    base = np.ones(k, np.float32) if ones else _base(k, 5)
    ref = np.asarray(C.block_fading_trajectory(key, jnp.asarray(base),
                                               n_rounds, rho=rho))
    eps = torch.as_tensor(np.array(jax.random.normal(key, (n_rounds, k))))
    got = TC.block_fading_trajectory(eps, torch.as_tensor(base), rho=rho)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n_rounds, k)
    u = _ulps(got.numpy(), ref)
    assert u.max() <= (1 if ones else 2)
    assert (u == 0).mean() >= 0.99


def test_trajectory_single_round_is_the_static_gain_shadowed():
    base = _base(4, 1)
    eps = torch.tensor([[0.5, -1.0, 0.0, 2.0]])
    got = TC.block_fading_trajectory(eps, torch.as_tensor(base))
    ref = C.block_fading_trajectory(jax.random.PRNGKey(0),
                                    jnp.asarray(base), 1)
    assert tuple(got.shape) == tuple(ref.shape) == (1, 4)
    assert got[0, 2] == float(base[2])        # z = 0: no shadowing


@pytest.mark.parametrize('k', [4, 20])
def test_shadow_init_step_gains_match_reference(k):
    key = jax.random.PRNGKey(k)
    k0, k1 = jax.random.split(key)
    z_r = C.shadow_init(k0, k)
    z = TC.shadow_init(torch.as_tensor(np.array(
        jax.random.normal(k0, (k,), jnp.float32))))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_r))
    for step in range(5):
        ks = jax.random.fold_in(k1, step)
        z_r = C.shadow_step(ks, z_r, rho=0.8)
        e = torch.as_tensor(np.array(jax.random.normal(ks, (k,),
                                                       jnp.float32)))
        z = TC.shadow_step(e, z, rho=0.8)
        np.testing.assert_array_equal(z.numpy(), np.asarray(z_r))
    base = _base(k, 2)
    got = TC.shadow_gains(torch.as_tensor(base), z).numpy()
    ref = np.asarray(C.shadow_gains(jnp.asarray(base), z_r))
    assert _ulps(got, ref).max() <= 2
    ones = np.ones(k, np.float32)
    assert _ulps(TC.shadow_gains(torch.as_tensor(ones), z).numpy(),
                 np.asarray(C.shadow_gains(jnp.asarray(ones), z_r))
                 ).max() <= 1


def _link(k, seed):
    rng = np.random.RandomState(seed)
    alpha = rng.uniform(0.05, 0.95, k).astype(np.float32)
    alpha[0], alpha[-1] = 0.0, 1.0                # both edge cases
    beta = np.full(k, 1.0 / k, np.float32)
    p_w = np.full(k, FL.tx_power_w, np.float32)
    gain = (10.0 ** rng.uniform(-14.5, -13.0, k)).astype(np.float32)
    h2 = rng.exponential(size=k).astype(np.float32)
    return alpha, beta, p_w, gain, h2


def test_capacities_match_reference():
    args = _link(16, 3)
    for name in ('sign_capacity', 'modulus_capacity'):
        ref = np.asarray(getattr(C, name)(*map(jnp.asarray, args), FL_REF))
        got = getattr(TC, name)(*map(torch.as_tensor, args), FL).numpy()
        np.testing.assert_allclose(got, ref, rtol=4 * EPS, atol=0)
    assert np.asarray(C.sign_capacity(*map(jnp.asarray, args),
                                      FL_REF))[0] == 0.0


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_simulate_outcomes_fading_matches_reference(seed):
    k, dim = 64, 2000
    alpha, beta, p_w, gain, _ = _link(k, seed)
    key = jax.random.PRNGKey(seed)
    ok_r = C.simulate_outcomes_fading(key, *map(jnp.asarray,
                                                (alpha, beta, p_w, gain)),
                                      dim, FL_REF)
    k1, k2 = jax.random.split(key)
    h2_s, h2_v = (torch.as_tensor(np.array(jax.random.exponential(kk, (k,))))
                  for kk in (k1, k2))
    ok = TC.simulate_outcomes_fading(h2_s, h2_v,
                                     *map(torch.as_tensor,
                                          (alpha, beta, p_w, gain)),
                                     dim, FL)
    for got, ref in zip(ok, ok_r):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    sign_ok, mod_ok = (o.numpy() for o in ok)
    assert not sign_ok[0] and not mod_ok[-1]
    assert 0 < sign_ok.sum() < k and 0 < mod_ok.sum() < k


def test_own_trajectory_statistics_match_shadowing_model():
    """The port's generator-driven trajectory: log-normal marginals with
    the requested dB spread, lag-1 autocorrelation tracking rho, and
    i.i.d. rounds at rho = 0 (the bounds of tests/test_channel.py)."""
    gen = torch.Generator().manual_seed(11)
    base = torch.full((8,), 1e-8)
    std_db = 4.0
    eps = torch.randn((500, 8), generator=gen)

    def lag1(t):
        z = 10.0 * np.log10(t.double().numpy() / 1e-8) / std_db
        return z, np.mean([np.corrcoef(z[:-1, i], z[1:, i])[0, 1]
                           for i in range(8)])

    z, r1 = lag1(TC.block_fading_trajectory(eps, base, rho=0.9,
                                            shadow_std_db=std_db))
    db = z * std_db
    assert abs(db.mean()) < 1.0
    assert abs(db.std() - std_db) < 1.0
    assert 0.8 < r1 < 0.97
    _, r0 = lag1(TC.block_fading_trajectory(eps, base, rho=0.0,
                                            shadow_std_db=std_db))
    assert abs(r0) < 0.15
