"""Slice 11 as a whole: byzantine clients, stragglers and packed-domain
screening in the port's transport and host loop, against the reference
composed from its own modules (``repro.core.transport``,
``repro.adversary``; never ``repro.training.fl_loop``), given the same
draws, byzantine mask and straggler uniforms.

Contract: every integer and boolean of the round bit for bit (forged
frames, received words through the CRC verdicts and flip counts, the
majority vote behind ``suspect``, ``active``, ``sign_votes``); ĝ within
the reference's FMA-wobble bound over the present clients; ``suspicion``
within the log tolerance of ``tests/test_torch_adversary.py``.  Also the
reference's own contracts on the port: a benign screen is bit-exact, a
dropped client's gradient is a no-op, ``active`` all true equals
``active=None``; the history's ``participation_frac`` and
``suspect_frac``; and a run with the knobs off draws what it drew
before."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_adversary import suspicion_atol
from test_torch_parity import draws_from_key, ulp_atol
from repro import adversary as RA
from repro.configs.base import FLConfig as RefFLConfig
from repro.core import transport as TR
from repro.models import cnn as RC
from repro_torch import adversary as TA
from repro_torch.configs.base import FLConfig
from repro_torch.core import transport as TTR
from repro_torch.data import (
    dirichlet_partition, load_image_dataset, stack_client_data,
)
from repro_torch.training.fl_loop import FLSimulator

K, L = 8, 300
WIRES = [('analytic', 'bernoulli'), ('packed', 'bernoulli'),
         ('packed', 'bitlevel')]
DROPPED = np.array([True, False, True, True, True, False, True, True])


def _inputs(seed):
    rng = np.random.RandomState(seed)
    common = rng.randn(L)
    grads = ((common[None, :] + 0.3 * rng.randn(K, L)) * 0.01).astype(
        np.float32)
    gbar = np.abs(rng.randn(L) * 0.01).astype(np.float32)
    q = np.linspace(0.55, 1.0, K).astype(np.float32)
    p = np.linspace(1.0, 0.55, K).astype(np.float32)
    return grads, gbar, q, p


def _ref(grads, gbar, q, p, key, **kw):
    return TR.spfl_aggregate(jnp.asarray(grads), jnp.asarray(gbar),
                             jnp.asarray(q), jnp.asarray(p), 3, 64, key,
                             round_idx=5, **kw)


def _port(grads, gbar, q, p, key, wire, channel, n_retx=0, active=None,
          byz_mask=None, **kw):
    draws = draws_from_key(key, grads.shape[0], grads.shape[1], n_retx,
                           channel)
    return TTR.spfl_aggregate(
        torch.as_tensor(grads), torch.as_tensor(gbar), torch.as_tensor(q),
        torch.as_tensor(p), 3, 64, draws, n_retx=n_retx, wire=wire,
        round_idx=5, channel=channel,
        active=None if active is None else torch.as_tensor(active),
        byz_mask=None if byz_mask is None else torch.as_tensor(np.array(byz_mask)),
        **kw)


def _check_round(ghat, tel, ghat_r, tel_r, grads, gbar, q, n_retx,
                 header_gmax):
    """Every telemetry field as the reference's (integers exact,
    suspicion within the log tolerance); ĝ within the FMA bound over the
    present clients."""
    for name, val in tel._asdict().items():
        ref = getattr(tel_r, name, None)
        assert (val is None) == (ref is None), name
        if val is None:
            continue
        if name == 'suspicion':
            np.testing.assert_allclose(
                val.numpy(), np.asarray(ref), rtol=4 * np.finfo(np.float32).eps,
                atol=suspicion_atol(header_gmax))
        else:
            np.testing.assert_array_equal(val.numpy(), np.asarray(ref), name)
    q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)
    weight = tel.sign_ok.numpy() / q_eff
    present = np.ones(grads.shape[0], bool)
    if tel.active is not None:
        present &= tel.active.numpy()
    if tel.suspect is not None:
        weight = weight * ~tel.suspect.numpy()
        present &= ~tel.suspect.numpy()
    np.testing.assert_allclose(
        ghat.numpy(), np.asarray(ghat_r), rtol=0,
        atol=ulp_atol(weight, header_gmax, gbar) / max(present.sum(), 1))


@pytest.mark.parametrize('screen', [False, True])
@pytest.mark.parametrize('n_retx', [0, 1])
@pytest.mark.parametrize('wire,channel', WIRES)
@pytest.mark.parametrize('attack', ['none', 'signflip', 'scaled'])
@pytest.mark.parametrize('dropout', [False, True])
def test_spfl_aggregate_matches_reference(attack, wire, channel, n_retx,
                                          screen, dropout):
    grads, gbar, q, p = _inputs(seed=3)
    key = jax.random.PRNGKey(11 + n_retx)
    mask = np.asarray(RA.byzantine_mask(0, K, 0.25))
    active = DROPPED if dropout else None
    kw = dict(attack=attack, attack_scale=10.0, screen=screen, screen_z=4.0)
    ghat_r, tel_r = _ref(
        grads, gbar, q, p, key, n_retx=n_retx, wire=wire, channel=channel,
        byz_mask=jnp.asarray(mask),
        active=None if active is None else jnp.asarray(active), **kw)
    ghat, tel = _port(grads, gbar, q, p, key, wire, channel, n_retx,
                      active=active, byz_mask=mask, **kw)
    header_gmax = np.abs(grads).max(1) * np.where(
        mask & (attack == 'scaled'), np.float32(10.0), np.float32(1.0))
    _check_round(ghat, tel, ghat_r, tel_r, grads, gbar, q, n_retx,
                 header_gmax)


@pytest.mark.parametrize('n_retx', [0, 1])
@pytest.mark.parametrize('wire,channel', WIRES)
def test_reference_contracts_hold_on_the_port(wire, channel, n_retx):
    """A benign screen is bit-exact; a dropped client's gradient is a
    no-op (±1e6 in its rows); ``active`` all true equals None."""
    grads, gbar, q, p = _inputs(seed=5)
    key = jax.random.PRNGKey(21)
    kw = dict(wire=wire, channel=channel, n_retx=n_retx)
    g0, t0 = _port(grads, gbar, q, p, key, **kw)
    g1, t1 = _port(grads, gbar, q, p, key, screen=True, **kw)
    assert torch.equal(g0, g1) and not bool(t1.suspect.any())
    assert t0.suspect is None

    ga, ta = _port(grads, gbar, q, p, key, active=DROPPED, screen=True, **kw)
    bad = grads.copy()
    bad[1], bad[5] = 1e6, -1e6
    gb, tb = _port(bad, gbar, q, p, key, active=DROPPED, screen=True, **kw)
    assert torch.equal(ga, gb)
    np.testing.assert_array_equal(ta.active.numpy(), DROPPED)
    assert not (ta.sign_ok.numpy() | ta.mod_ok.numpy())[~DROPPED].any()

    gf, _ = _port(grads, gbar, q, p, key, active=np.ones(K, bool), **kw)
    assert torch.equal(gf, g0)


@pytest.mark.parametrize('attack,wire', [('signflip', 'packed'),
                                         ('scaled', 'packed'),
                                         ('scaled', 'analytic')])
def test_attacks_are_screened(attack, wire):
    """The reference's screening contract on the port (every packet
    arrives): the screen flags exactly the byzantine clients, and the
    screened aggregate of a sign flip lies closer to the honest one than
    the unscreened."""
    grads, gbar, _, _ = _inputs(seed=0)
    ones = np.ones(K, np.float32)
    key = jax.random.PRNGKey(0)
    mask = np.asarray(RA.byzantine_mask(0, K, 0.25))
    kw = dict(wire=wire, channel='bernoulli', byz_mask=mask, attack=attack,
              attack_scale=50.0)
    honest, _ = _port(grads, gbar, ones, ones, key, wire, 'bernoulli')
    attacked, _ = _port(grads, gbar, ones, ones, key, **kw)
    screened, tel = _port(grads, gbar, ones, ones, key, screen=True, **kw)
    np.testing.assert_array_equal(tel.suspect.numpy(), mask)
    assert (float(torch.linalg.norm(screened - honest))
            < 0.5 * float(torch.linalg.norm(attacked - honest)))


def test_min_participation_after_active():
    """The floor counts the moduli that survive the active mask."""
    grads, gbar, q, p = _inputs(seed=6)
    q, p = np.ones(K, np.float32), np.ones(K, np.float32)
    key = jax.random.PRNGKey(3)
    for m, want_any in ((0.75, True), (0.8, False)):   # 6 of 8 present
        kw = dict(wire='packed', channel='bernoulli', min_participation=m)
        ghat_r, tel_r = _ref(grads, gbar, q, p, key,
                             active=jnp.asarray(DROPPED), **kw)
        ghat, tel = _port(grads, gbar, q, p, key, active=DROPPED, **kw)
        assert bool(tel.mod_ok.any()) == want_any
        _check_round(ghat, tel, ghat_r, tel_r, grads, gbar, q, 0,
                     np.abs(grads).max(1))


def test_unknown_attack_raises():
    grads, gbar, q, p = _inputs(seed=1)
    with pytest.raises(ValueError, match='attack'):
        _port(grads, gbar, q, p, jax.random.PRNGKey(0), 'analytic',
              'bernoulli', attack='bitrot')


# ---------------------------------------------------------------------------
# the host loop
# ---------------------------------------------------------------------------

SIM_K, PER_DEVICE = 4, 16


@pytest.fixture(scope='module')
def data():
    (x, y), (tx, ty) = load_image_dataset(seed=0)
    parts = dirichlet_partition(y, SIM_K, PER_DEVICE, 0.5, 0)
    cx, cy = stack_client_data(x, y, parts)
    return cx, cy, tx[:64], ty[:64]


def _sim(data, **kw):
    fl = FLConfig(n_devices=SIM_K, allocator='uniform', tx_power_dbm=-40.0,
                  **kw)
    return FLSimulator(fl, *data, device='cpu')


KNOBS = {
    'signflip_screen': dict(attack='signflip', screen=True, wire='packed',
                            channel='bitlevel'),
    'scaled_screen_retx': dict(attack='scaled', screen=True, wire='packed',
                               channel='bitlevel', transport='spfl_retx'),
    'dropout': dict(dropout_rate=0.3, straggler_stickiness=0.5,
                    wire='packed', channel='bitlevel'),
    'dropout_screen_analytic': dict(attack='signflip', screen=True,
                                    dropout_rate=0.3),
    'labelflip': dict(attack='labelflip', wire='packed', channel='bitlevel'),
}


@pytest.mark.parametrize('knob', sorted(KNOBS))
def test_host_loop_rounds_match_reference_composition(data, knob):
    """Two rounds of the port's ``FLSimulator`` per knob, each against
    the reference's transport (and straggler chain) on the port's
    gradients, with the same draws, mask and straggler uniforms."""
    sim = _sim(data, **KNOBS[knob])
    fl = sim.fl
    ref_fl = RefFLConfig(**dataclasses.asdict(fl))
    n_retx = 1 if fl.transport == 'spfl_retx' else 0
    perm = torch.randperm(SIM_K, generator=torch.Generator().manual_seed(
        fl.seed + TA.BYZ_FOLD))
    if fl.attack == 'none':
        assert sim.byz_mask is None
    else:
        assert torch.equal(sim.byz_mask, TA.byzantine_mask(
            SIM_K, fl.attack_frac, perm))
    mask = None if sim.byz_mask is None else jnp.asarray(sim.byz_mask.numpy())
    if fl.attack == 'labelflip':
        want_y = RA.flip_labels(jnp.asarray(data[1]), mask,
                                int(data[1].max()) + 1)
        np.testing.assert_array_equal(sim.client_y.numpy(), np.asarray(want_y))
        assert int(sim.byz_mask.sum()) == 1
        assert (sim.client_y.numpy() != data[1])[sim.byz_mask.numpy()].any()
        _check_grads_with_labels(sim, np.asarray(want_y))
    state = RA.straggler_init(SIM_K)
    for r in range(2):
        gbar_np = sim.gbar.numpy().copy()
        key = jax.random.PRNGKey(70 + r)
        k_str = jax.random.fold_in(key, RA.STRAGGLER_FOLD)
        u = torch.as_tensor(np.array(jax.random.uniform(k_str, (SIM_K,))))
        draws = draws_from_key(key, SIM_K, sim.dim, n_retx, fl.channel)
        res = sim.round_step(draws, straggler_u=u)
        active = None
        if fl.dropout_rate > 0:
            state, active = RA.straggler_step(k_str, state, fl.dropout_rate,
                                              fl.straggler_stickiness)
        q = res.telemetry.q.numpy()
        ghat_r, tel_r = TR.spfl_aggregate(
            jnp.asarray(res.grads.numpy()), jnp.asarray(gbar_np),
            jnp.asarray(q), jnp.asarray(res.telemetry.p.numpy()),
            ref_fl.quant_bits, ref_fl.b0_bits, key, n_retx=n_retx,
            wire=fl.wire, round_idx=r, channel=fl.channel, attack=fl.attack,
            byz_mask=mask, attack_scale=fl.attack_scale, active=active,
            screen=fl.screen, screen_z=fl.screen_z)
        tel = res.telemetry._replace(q=None, p=None, round_idx=None,
                                     alloc_objective=None, alloc_iters=None,
                                     alloc_exit_reason=None)
        gmax = np.abs(res.grads.numpy()).max(1)
        if fl.attack == 'scaled':
            gmax = gmax * np.where(sim.byz_mask.numpy(), np.float32(10.0),
                                   np.float32(1.0))
        _check_round(res.ghat, tel, ghat_r, tel_r, res.grads.numpy(),
                     gbar_np, q, n_retx, gmax)
        if active is not None:
            np.testing.assert_array_equal(sim.straggler.numpy(),
                                          np.asarray(state))


def _check_grads_with_labels(sim, labels):
    """The simulator's gradients equal the reference CNN's on the same
    parameters and the flipped labels (rtol 1e-4: conv summation order)."""
    _, unravel = ravel_pytree(RC.init_cnn(jax.random.PRNGKey(0)))
    xs = jnp.asarray(sim.client_x.movedim(-3, -1).numpy())

    def one(params, x, y):
        return ravel_pytree(jax.grad(RC.cnn_loss)(params, x, y))[0]

    want = jax.vmap(one, in_axes=(None, 0, 0))(
        unravel(jnp.asarray(sim.params.numpy())), xs,
        jnp.asarray(labels.astype(np.int32)))
    _, grads = sim.client_grads(sim.params)
    np.testing.assert_allclose(grads.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-6)


def test_history_fractions(data):
    sim = _sim(data, dropout_rate=0.4, screen=True, attack='scaled',
               attack_scale=50.0, wire='packed', channel='bitlevel')
    hist = sim.run(2)
    assert hist.participation_frac == [
        float(np.mean(r.active)) for r in sim.records]
    assert hist.suspect_frac == [float(np.mean(r.suspect))
                                 for r in sim.records]
    assert all(r.suspicion.shape == (SIM_K,) for r in sim.records)
    base = _sim(data, dropout_rate=0.4, screen=True, transport='dds')
    hb = base.run(2)
    assert len(hb.participation_frac) == len(hb.suspect_frac) == 2
    assert np.isnan(hb.participation_frac).all()
    assert np.isnan(hb.suspect_frac).all()
    off = _sim(data, wire='packed')
    ho = off.run(1)
    assert ho.participation_frac == [] and ho.suspect_frac == []


def test_knobs_off_draw_what_they_drew_before(data):
    """The item-8 knobs draw only from their own generators: with them
    off the straggler generator stays untouched and no permutation is
    drawn, and with them on the simulator's own generators end a run in
    the same state as with them off."""
    off = _sim(data, wire='packed', channel='bitlevel')
    on = _sim(data, wire='packed', channel='bitlevel', attack='signflip',
              screen=True, dropout_rate=0.25)
    fresh = torch.Generator().manual_seed(off.fl.seed + TA.STRAGGLER_FOLD)
    for sim in (off, on):
        sim.run(2)
    assert off.byz_mask is None
    assert torch.equal(off.straggler_gen.get_state(), fresh.get_state())
    assert not torch.equal(on.straggler_gen.get_state(), fresh.get_state())
    assert torch.equal(off.host_gen.get_state(), on.host_gen.get_state())
    assert torch.equal(off.gen.get_state(), on.gen.get_state())
    for rec in off.records:
        assert rec.active is None and rec.suspect is None
