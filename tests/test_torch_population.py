"""The port's population module (``repro_torch.population``) against the
reference's (``repro.population``) on the same key words and ids.

Stated tolerances:

* bit for bit: ``permuted_ids`` (N from 7 to 2^31; a bijection on small
  N), the cohort's ids, ``present``, power budgets, byzantine membership
  and shard ids under both samplers, the availability classes, and the
  placement (distances);
* gains without shadowing within 1 ulp (XLA's float32 power is not
  correctly rounded; a float64 power rounded once meets it on >= 99% of
  ids), with shadowing within 8 ulp;
* ``shadow_at`` bit for bit when fed the reference's innovations; on its
  own normals (each within 3 ulp of jax's) within 4 ulp of the window's
  largest |innovation|.

Also the reference's statistical contracts on the port's own draws, and
the pinned cohort ids that ``chip_smoke.py`` phase 9 checks."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as RefFLConfig
from repro.population import population as RP
from repro_torch.configs.base import FLConfig
from repro_torch.core import threefry as TF
from repro_torch.population import population as TP

EPS32 = float(np.finfo(np.float32).eps)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _words(key):
    return torch.as_tensor(np.asarray(key).astype(np.uint32).astype(np.int64))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _fls(**kw):
    base = dict(population_n=1000, cohort_size=8, attack='signflip')
    base.update(kw)
    return RefFLConfig(**base), FLConfig(**base)


IDS = np.concatenate([np.arange(0, 999_983, 1747), [2 ** 31 - 1, 2 ** 31,
                                                     2 ** 32 - 1]])


def test_population_key_and_stream_keys():
    base = RP.population_key(3)
    np.testing.assert_array_equal(TP.population_key(3).numpy(),
                                  _words(base).numpy())
    streams = TP.stream_keys(TP.population_key(3))
    assert list(streams) == list(TP.STATIC_FOLDS)
    for fold, key in streams.items():
        np.testing.assert_array_equal(
            key.numpy(), _words(jax.random.fold_in(base, fold)).numpy())


def test_constants_are_the_references():
    """The fold constants, window, oversampling, power classes and the
    Feistel round function's constants (murmur3's, as wire.corrupt's)."""
    from repro_torch.wire import corrupt as TWC
    for name in ('POPULATION_FOLD', 'PLACEMENT_FOLD', 'POWER_FOLD',
                 'AVAIL_FOLD', 'SHADOW_FOLD', 'BYZ_ID_FOLD', 'COHORT_FOLD',
                 'ARRIVAL_FOLD', 'SHADOW_WINDOW', 'OVERSAMPLE',
                 'POWER_CLASS_DB', 'COHORT_SAMPLERS', '_FEISTEL_ROUNDS',
                 '_WALK_STEPS', '_GOLDEN'):
        assert getattr(TP, name) == getattr(RP, name), name
    assert (TWC._MIX1, TWC._MIX2) == (RP._MIX1, RP._MIX2)


@pytest.mark.parametrize('n_pop', [7, 37, 64, 1000, 10 ** 6, 2 ** 31])
def test_permuted_ids_bit_for_bit(n_pop):
    for seed in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0xC040)
        pos = np.arange(min(n_pop, 160), dtype=np.uint32)
        want = np.asarray(RP.permuted_ids(key, jnp.asarray(pos), n_pop))
        got = TP.permuted_ids(_words(key), torch.as_tensor(
            pos.astype(np.int64)), n_pop)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize('n_pop', [7, 37, 64, 1000])
def test_permuted_ids_is_a_bijection(n_pop):
    for seed in range(3):
        ids = TP.permuted_ids(TF.key(seed), torch.arange(n_pop), n_pop)
        assert sorted(ids.tolist()) == list(range(n_pop))


def test_permuted_ids_refuses_out_of_range_populations():
    for n_pop in (0, 2 ** 31 + 1):
        with pytest.raises(ValueError, match='population size'):
            TP.permuted_ids(TF.key(0), torch.arange(4), n_pop)


def test_per_device_state_bit_for_bit():
    base, tbase = RP.population_key(1), TP.population_key(1)
    ids = jnp.asarray(IDS.astype(np.uint32))
    tids = torch.as_tensor(IDS)
    np.testing.assert_array_equal(
        TP.device_distances(tbase, tids, 500.0).numpy(),
        np.asarray(RP.device_distances(base, ids, 500.0)))
    for w in (1e-3, 10 ** -0.4 / 1e3):
        np.testing.assert_array_equal(
            TP.device_power_w(tbase, tids, w).numpy(),
            np.asarray(RP.device_power_w(base, ids, w)))
    for a in (0.0, 0.3, 0.65):
        np.testing.assert_array_equal(
            TP.device_availability(tbase, tids, a).numpy(),
            np.asarray(RP.device_availability(base, ids, a)))
    for frac in (0.0, 0.25, 0.5):
        np.testing.assert_array_equal(
            TP.byzantine_ids(tbase, tids, frac).numpy(),
            np.asarray(RP.byzantine_ids(base, ids, frac)))


def test_shard_ids_bit_for_bit():
    for s in (1, 6, 64):
        np.testing.assert_array_equal(
            TP.shard_ids(torch.as_tensor(IDS), s).numpy(),
            np.asarray(RP.shard_ids(jnp.asarray(IDS.astype(np.uint32)), s)))


def test_gains_within_an_ulp_without_shadowing():
    ref_fl, fl = _fls(population_n=10 ** 6)
    base, tbase = RP.population_key(0), TP.population_key(0)
    ids = IDS[:-3]
    want = np.asarray(RP.cohort_gains(base, jnp.asarray(ids.astype(
        np.uint32)), 5, ref_fl))
    got = TP.cohort_gains(tbase, torch.as_tensor(ids), 5, fl).numpy()
    ulps = _ulps(got, want)
    assert ulps.max() <= 1 and (ulps == 0).mean() >= 0.99


def test_gains_with_shadowing_within_8_ulp():
    ref_fl, fl = _fls(population_n=10 ** 6)
    base, tbase = RP.population_key(0), TP.population_key(0)
    ids = IDS[:200]
    for n in (0, 7):
        want = np.asarray(RP.cohort_gains(base, jnp.asarray(ids.astype(
            np.uint32)), n, ref_fl, shadowing=True))
        got = TP.cohort_gains(tbase, torch.as_tensor(ids), n, fl,
                              shadowing=True).numpy()
        assert _ulps(got, want).max() <= 8


def _reference_innovations(base, ids, n):
    """The reference's (W, |ids|) normals of ``shadow_at``."""
    kd = jax.random.fold_in(base, RP.SHADOW_FOLD)
    keys = jax.vmap(lambda i: jax.random.fold_in(kd, i))(ids)
    js = jnp.arange(RP.SHADOW_WINDOW, dtype=jnp.uint32)
    return np.asarray(jax.vmap(lambda j: jax.vmap(
        lambda k: jax.random.normal(jax.random.fold_in(
            k, jnp.uint32(n) - j), ()))(keys))(js))


@pytest.mark.parametrize('n', [0, 3, 40, 2 ** 32 - 1])
def test_shadow_at(n):
    base, tbase = RP.population_key(2), TP.population_key(2)
    ids = jnp.arange(0, 6400, 100, dtype=jnp.uint32)
    want = np.asarray(RP.shadow_at(base, ids, n))
    eps = _reference_innovations(base, ids, n)
    fed = TP._shadow_from_eps(torch.as_tensor(eps.copy()), 0.9,
                              TP.SHADOW_WINDOW)
    np.testing.assert_array_equal(fed.numpy(), want)
    got = TP.shadow_at(tbase, torch.as_tensor(np.asarray(ids).astype(
        np.int64)), n).numpy()
    atol = 4 * EPS32 * np.abs(eps).max(axis=0)
    assert (np.abs(got - want) <= atol).all()


@pytest.mark.parametrize('sampler,n_pop,k', [
    ('uniform', 10 ** 6, 20), ('uniform', 37, 8),
    ('availability', 10 ** 6, 20), ('availability', 20, 20),
    ('availability', 40, 32)])
def test_cohorts_bit_for_bit(sampler, n_pop, k):
    """Both samplers over a chain of round keys: ids, present, p_w,
    byzantine membership and shard ids bit for bit; the gains of the
    batched draw within 8 ulp (shadowed)."""
    ref_fl, fl = _fls(population_n=n_pop, cohort_size=k,
                      cohort_sampler=sampler, availability_min=0.0)
    base, tbase = RP.population_key(0), TP.population_key(0)
    streams = TP.stream_keys(tbase)
    key = jax.random.PRNGKey(4)
    ragged = False
    for r in range(4):
        key, kr = jax.random.split(key)
        c = RP.sample_cohort(kr, base, ref_fl)
        got = TP.sample_cohort(_words(kr), tbase, fl)
        d = TP.draw_cohort(_words(kr), streams, fl, n=r, shadowing=True,
                           byzantine=True)
        for cohort in (got, d.cohort):
            np.testing.assert_array_equal(cohort.ids.numpy(),
                                          np.asarray(c.ids).astype(np.int64))
            np.testing.assert_array_equal(cohort.present.numpy(),
                                          np.asarray(c.present))
            np.testing.assert_array_equal(cohort.p_w.numpy(),
                                          np.asarray(c.p_w))
        np.testing.assert_array_equal(
            d.byzantine.numpy(),
            np.asarray(RP.byzantine_ids(base, c.ids, ref_fl.attack_frac)))
        np.testing.assert_array_equal(
            TP.shard_ids(got.ids, 6).numpy(),
            np.asarray(RP.shard_ids(c.ids, 6)))
        want_g = np.asarray(RP.cohort_gains(base, c.ids, jnp.uint32(r),
                                            ref_fl, shadowing=True))
        assert _ulps(d.gains.numpy(), want_g).max() <= 8
        ragged |= not bool(got.present.all())
    if sampler == 'availability' and n_pop < 4 * k:
        assert ragged


def test_unknown_sampler_and_oversized_cohort_raise():
    _, fl = _fls(cohort_sampler='typo')
    with pytest.raises(ValueError, match='cohort_sampler'):
        TP.sample_cohort(TF.key(0), TP.population_key(0), fl)
    _, fl = _fls(cohort_size=2000)
    with pytest.raises(ValueError, match='cohort_size'):
        TP.sample_cohort(TF.key(0), TP.population_key(0), fl)


def test_combine_active():
    a = torch.tensor([True, False, True])
    b = torch.tensor([True, True, False])
    assert TP.combine_active(None, None) is None
    assert TP.combine_active(a, None) is a
    assert TP.combine_active(None, b) is b
    assert TP.combine_active(a, b).tolist() == [True, False, False]


# ---------------------------------------------------------------------------
# the reference's statistical contracts, on the port's own draws
# ---------------------------------------------------------------------------

def test_shadow_statistics():
    """Unit marginal variance (within 0.05) and lag-1 correlation ~ rho."""
    base = TP.population_key(0)
    ids = torch.arange(200)
    z = np.stack([TP.shadow_at(base, ids, n).numpy()
                  for n in range(64, 164)])          # (100 rounds, 200)
    assert abs(z.mean()) < 0.05
    assert abs(z.std() - 1.0) < 0.05
    r1 = np.mean([np.corrcoef(z[:-1, i], z[1:, i])[0, 1]
                  for i in range(200)])
    assert 0.82 < r1 < 0.95


def test_availability_sampler_is_importance_weighted():
    _, fl = _fls(population_n=40, cohort_size=8,
                 cohort_sampler='availability', availability_min=0.05)
    base = TP.population_key(0)
    streams = TP.stream_keys(base)
    counts = np.zeros(40)
    for n in range(300):
        kr = TF.fold_in(TF.key(7), n)
        c = TP.draw_cohort(kr, streams, fl, gains=False).cohort
        counts[c.ids[c.present].numpy()] += 1
    avail = TP.device_availability(base, torch.arange(40), 0.05).numpy()
    lo = counts[avail < np.median(avail)].mean()
    hi = counts[avail >= np.median(avail)].mean()
    assert hi > 1.3 * lo


@pytest.mark.parametrize('sampler', ['uniform', 'availability'])
def test_every_device_reachable_and_ids_distinct(sampler):
    _, fl = _fls(population_n=50, cohort_size=10, cohort_sampler=sampler)
    streams = TP.stream_keys(TP.population_key(0))
    seen = set()
    for n in range(120):
        c = TP.draw_cohort(TF.fold_in(TF.key(4), n), streams, fl,
                           gains=False).cohort
        assert len(set(c.ids.tolist())) == 10
        pr = c.present.numpy()
        assert not np.any(~pr[:-1] & pr[1:])   # arrivals packed first
        seen.update(c.ids[c.present].tolist())
        if len(seen) == 50:
            break
    assert seen == set(range(50))


# ---------------------------------------------------------------------------
# the literal chip_smoke.py phase 9 checks on the card
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pinned_cohort_ids_are_the_references_chain():
    """Rounds 0-2's cohort ids of seed 0, N = 10^6, K = 20 (uniform): the
    reference's ``key, kr = split(key)`` chain through its
    ``sample_cohort``, and the port's."""
    pinned = _chip_smoke().POP_UNIFORM_IDS
    fl = RefFLConfig(population_n=10 ** 6, cohort_size=20)
    key, base = jax.random.PRNGKey(0), RP.population_key(0)
    tkey, tbase = TF.key(0), TP.population_key(0)
    assert len(pinned) == 3
    for want in pinned:
        key, kr = jax.random.split(key)
        assert np.asarray(RP.sample_cohort(kr, base, fl).ids).tolist() == want
        tkey, tkr = TF.split(tkey)
        assert TP.sample_cohort(tkr, tbase, FLConfig(
            population_n=10 ** 6, cohort_size=20)).ids.tolist() == want
