"""Slice 12 as a whole: population cohorts in the port's host loop
against the reference composed from its own modules
(``repro.population``, ``repro.core.transport``, ``repro.models.cnn``;
never ``repro.training.fl_loop``).

Contract: a run's cohorts are the reference chain's round for round
(``key = PRNGKey(seed)``; ``key, kr = split(key)``;
``sample_cohort(kr, population_key(seed), fl)``); one round given the
same draws, cohort and gains equals the reference's transport on the
port's gradients, every integer and boolean bit for bit (ragged rows and
a byzantine cohort included) and ĝ within the FMA-wobble bound over the
present clients; the gradients are the reference CNN's on the cohort's
shards (rtol 1e-4); the solve sees the cohort's float32 gains and
budgets in float64; and the guard rails raise the reference's
messages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_parity import draws_from_key, ulp_atol
from repro.configs.base import FLConfig as RefFLConfig
from repro.core import transport as TR
from repro.models import cnn as RC
from repro.population import population as RP
from repro_torch import adversary as TA
from repro_torch import population as TP
from repro_torch.configs.base import FLConfig
from repro_torch.data import (
    dirichlet_partition, load_image_dataset, stack_client_data,
)
from repro_torch.training import fl_loop
from repro_torch.training.fl_loop import FLSimulator

K, N, S, PER_DEVICE = 4, 1000, 6, 16


@pytest.fixture(scope='module')
def data():
    (x, y), (tx, ty) = load_image_dataset(seed=0)
    parts = dirichlet_partition(y, S, PER_DEVICE, 0.5, 0)
    cx, cy = stack_client_data(x, y, parts)
    return cx, cy, tx[:64], ty[:64]


def _fl(**kw):
    base = dict(n_devices=K, population_n=N, cohort_size=K,
                population_shards=S, allocation_backend='jax',
                allocator='uniform', wire='packed', channel='bitlevel',
                tx_power_dbm=-40.0, telemetry_flush_every=2)
    base.update(kw)
    return FLConfig(**base)


def _sim(data, **kw):
    return FLSimulator(_fl(**kw), *data, device='cpu')


def _chain(fl, rounds, seed=0):
    ref_fl = RefFLConfig(**dataclasses.asdict(fl))
    key, base = jax.random.PRNGKey(seed), RP.population_key(seed)
    out = []
    for _ in range(rounds):
        key, kr = jax.random.split(key)
        out.append(RP.sample_cohort(kr, base, ref_fl))
    return out


@pytest.mark.parametrize('kw', [
    dict(), dict(cohort_sampler='availability', population_n=K),
    dict(allocation_cadence='per_round', attack='signflip', screen=True)])
def test_run_samples_the_reference_chain(data, kw):
    sim = _sim(data, **kw)
    hist = sim.run(3)
    want = _chain(sim.fl, 3)
    assert len(sim.records) == 3 and sim.host_solver_calls == 0
    for rec, c in zip(sim.records, want):
        np.testing.assert_array_equal(rec.cohort_ids,
                                      np.asarray(c.ids).astype(np.int64))
        if sim.fl.cohort_sampler == 'availability':
            np.testing.assert_array_equal(rec.active, np.asarray(c.present))
    assert all(np.isfinite(hist.loss))
    ragged = sim.fl.cohort_sampler == 'availability'
    assert len(hist.participation_frac) == (3 if ragged else 0)
    if ragged:
        assert hist.participation_frac == [
            float(np.mean(np.asarray(c.present), dtype=np.float32))
            for c in want]


def _reference_cohort(fl, kr, n):
    """The reference's cohort of round key ``kr`` at round ``n``, its
    gains and byzantine membership, as the port's host draw."""
    ref_fl = RefFLConfig(**dataclasses.asdict(fl))
    base = RP.population_key(fl.seed)
    c = RP.sample_cohort(kr, base, ref_fl)
    gains = RP.cohort_gains(base, c.ids, jnp.uint32(n), ref_fl,
                            shadowing=fl.allocation_cadence == 'per_round')
    byz = (RP.byzantine_ids(base, c.ids, fl.attack_frac)
           if fl.attack != 'none' else None)

    def t(x):
        return None if x is None else torch.as_tensor(np.array(x))

    cohort = TP.Cohort(t(np.asarray(c.ids).astype(np.int64)), t(c.present),
                       t(c.p_w))
    return TP.CohortDraw(cohort, t(gains), t(byz)), c, byz


KNOBS = {
    'uniform': dict(),
    'ragged': dict(cohort_sampler='availability', population_n=K,
                   availability_min=0.1),
    'byzantine_screen': dict(attack='signflip', attack_frac=0.5,
                             screen=True, allocation_cadence='per_round'),
    'ragged_dropout_retx': dict(cohort_sampler='availability',
                                population_n=K, availability_min=0.1,
                                dropout_rate=0.3, transport='spfl_retx'),
    'scaled_attack': dict(attack='scaled', attack_frac=0.5),
}


@pytest.mark.parametrize('knob', sorted(KNOBS))
def test_round_matches_reference_composition(data, knob):
    """Two rounds given the reference's cohort, gains and draws: the
    port's round against the reference's transport on the port's
    gradients, q and p."""
    sim = _sim(data, **KNOBS[knob])
    fl = sim.fl
    n_retx = 1 if fl.transport == 'spfl_retx' else 0
    flat0, unravel = ravel_pytree(RC.init_cnn(jax.random.PRNGKey(0)))
    sim.params = torch.as_tensor(np.array(flat0))
    xs_all = np.asarray(sim.client_x.movedim(-3, -1).numpy())
    ys_all = sim.client_y.numpy().astype(np.int32)
    ragged_seen = byz_seen = False
    for r in range(2):
        kr = jax.random.fold_in(jax.random.PRNGKey(90), r)
        draw, c, byz = _reference_cohort(fl, kr, r)
        key = jax.random.PRNGKey(60 + r)
        u = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(key, 1), (K,))))
        gbar_np = sim.gbar.numpy().copy()
        params_np = sim.params.numpy().copy()
        straggler = sim.straggler.clone()
        res = sim.round_step(draws_from_key(key, K, sim.dim, n_retx,
                                            fl.channel),
                             straggler_u=u, cohort=draw)
        # the data: the reference CNN on the cohort's shards
        shards = np.asarray(RP.shard_ids(c.ids, S))

        def one(params, x, y):
            return ravel_pytree(jax.grad(RC.cnn_loss)(params, x, y))[0]

        rgrads = jax.vmap(one, in_axes=(None, 0, 0))(
            unravel(jnp.asarray(params_np)), jnp.asarray(xs_all[shards]),
            jnp.asarray(ys_all[shards]))
        np.testing.assert_allclose(res.grads.numpy(), np.asarray(rgrads),
                                   rtol=1e-4, atol=1e-6)
        # the solve's problem: the cohort's f32 gains and budgets in f64
        prob = res.stats['prob']
        np.testing.assert_array_equal(
            prob.gains.numpy(), np.asarray(draw.gains, np.float64))
        np.testing.assert_array_equal(
            prob.p_w.numpy(), np.asarray(c.p_w).astype(np.float64))
        # the transport: arrivals compose with the straggler chain
        present = (np.asarray(c.present)
                   if fl.cohort_sampler == 'availability' else None)
        active = present
        if fl.dropout_rate > 0:
            _, s_act = TA.straggler_step(u, straggler, fl.dropout_rate,
                                         fl.straggler_stickiness)
            active = TP.combine_active(
                None if present is None else torch.as_tensor(present.copy()),
                s_act).numpy()
        q, p = res.telemetry.q.numpy(), res.telemetry.p.numpy()
        ghat_r, tel_r = TR.spfl_aggregate(
            jnp.asarray(res.grads.numpy()), jnp.asarray(gbar_np),
            jnp.asarray(q), jnp.asarray(p), fl.quant_bits, fl.b0_bits, key,
            n_retx=n_retx, wire=fl.wire, round_idx=r, channel=fl.channel,
            attack=fl.attack, byz_mask=byz, attack_scale=fl.attack_scale,
            active=None if active is None else jnp.asarray(active),
            screen=fl.screen, screen_z=fl.screen_z)
        tel = res.telemetry
        for name in ('sign_ok', 'mod_ok', 'accepted', 'payload_bits',
                     'retransmissions', 'sign_flips', 'mod_flips',
                     'sign_crc_ok', 'mod_crc_ok', 'retx_attempts',
                     'sign_votes', 'active', 'suspect'):
            val, ref = getattr(tel, name), getattr(tel_r, name)
            assert (val is None) == (ref is None), name
            if val is not None:
                np.testing.assert_array_equal(val.numpy(), np.asarray(ref),
                                              name)
        np.testing.assert_array_equal(tel.cohort_ids.numpy(),
                                      np.asarray(c.ids).astype(np.int64))
        q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)
        weight = tel.sign_ok.numpy() / q_eff
        live = np.ones(K, bool) if active is None else active.copy()
        if tel.suspect is not None:
            weight = weight * ~tel.suspect.numpy()
            live &= ~tel.suspect.numpy()
        np.testing.assert_allclose(
            res.ghat.numpy(), np.asarray(ghat_r), rtol=0,
            atol=ulp_atol(weight, np.abs(res.grads.numpy()).max(1),
                          gbar_np) / max(live.sum(), 1))
        ragged_seen |= present is not None and not present.all()
        byz_seen |= byz is not None and bool(np.asarray(byz).any())
    if fl.cohort_sampler == 'availability':
        assert ragged_seen
    if fl.attack != 'none':
        assert byz_seen


def _sim_args(fl):
    rng = np.random.RandomState(0)
    s = fl.population_shards
    return (fl, rng.randn(s, 2, 32, 32, 3).astype('f4'),
            rng.randint(0, 10, (s, 2)),
            rng.randn(4, 32, 32, 3).astype('f4'), rng.randint(0, 10, 4))


@pytest.mark.parametrize('kw,match', [
    (dict(cohort_size=2000), 'cohort_size'),
    (dict(transport='dds'), 'transport|spfl'),
    (dict(allocation_backend='numpy'), 'jax'),
    (dict(compensation='last_local'), 'last_local'),
    (dict(attack='labelflip'), 'labelflip'),
    (dict(cohort_sampler='availability', transport='error_free'),
     'ragged'),
    (dict(cohort_sampler='typo'), 'cohort_sampler'),
])
def test_population_validation(kw, match):
    fl = _fl(**kw)
    with pytest.raises(ValueError, match=match):
        FLSimulator(*_sim_args(fl), device='cpu')


def test_population_no_longer_raises_not_implemented():
    sim = FLSimulator(*_sim_args(_fl()), device='cpu')
    assert sim.K == K and sim.client_x.shape[0] == S
    assert sim.byz_mask is None
    assert not any(unsupported(sim.fl)
                   for unsupported, _ in fl_loop._NOT_YET)


def test_error_free_population_round(data):
    """error_free with the uniform sampler: the cohort's shards, no
    solve, no gains drawn."""
    sim = _sim(data, transport='error_free')
    hist = sim.run(2)
    want = _chain(sim.fl, 2)
    for rec, c in zip(sim.records, want):
        np.testing.assert_array_equal(rec.cohort_ids,
                                      np.asarray(c.ids).astype(np.int64))
    assert all(np.isnan(hist.alloc_iters)) and len(hist.sign_agreement) == 2
