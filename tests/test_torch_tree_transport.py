"""The port's tree transports (``spfl_aggregate_tree``,
``error_free_aggregate_tree``, ``tree_client_stats``, ``delta_sq_tree``)
against ``repro.core.transport``'s on the same gradient trees, with the
port fed the reference's own draws
(``test_torch_parity.tree_draws_from_key``).

The trees hold leaves whose lengths are not multiples of 32 and one of
length 1, under keys in an order other than the sorted one, so the draws
bind to ``jax.tree.flatten``'s leaf order.  Contract: every integer
output exact (packet verdicts, flips, CRC state, resends, participation,
suspects, measured bits), and the screen's suspicion too; ĝ within the
reference's FMA-wobble bound (bfloat16's rounding with
``uplink_reduce_dtype='bfloat16'``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import tree_draws_from_key, ulp_atol
from repro.configs.base import FLConfig as RFL
from repro.core import transport as TR
from repro_torch import tree
from repro_torch.configs.base import FLConfig
from repro_torch.core import transport as TTR

K = 4
SHAPES = {'zeta': (3, 37), 'alpha': (1,), 'mid': {'w': (64,), 'b': (5, 7)},
          'big': (40, 33)}
CASES = [('analytic', 'bernoulli', 0), ('analytic', 'bernoulli', 1),
         ('packed', 'bernoulli', 0), ('packed', 'bernoulli', 1),
         ('packed', 'bitlevel', 0), ('packed', 'bitlevel', 1)]


def _grads(seed, scale=0.02):
    rng = np.random.RandomState(seed)
    g = jax.tree.map(lambda s: (rng.randn(K, *s) * scale).astype(np.float32),
                     SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    g['big'][0, 0, :5] = 0.0          # zeros quantize to knob 0, sign +1
    g['big'][1, 3, 7] = -0.0
    return g


def _gbar(seed, per_client=False):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: rng.uniform(0, 0.02, ((K,) if per_client else ()) + s)
        .astype(np.float32), SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _sizes():
    return [int(np.prod(s)) for s in jax.tree.leaves(
        SHAPES, is_leaf=lambda x: isinstance(x, tuple))]


def _q_p():
    return (np.linspace(0.35, 1.0, K).astype(np.float32),
            np.linspace(0.95, 0.3, K).astype(np.float32))


def _cfgs(**kw):
    ref = RFL(n_devices=K, **kw)
    return ref, FLConfig(**dataclasses.asdict(ref))


def _jt(t):
    return jax.tree.map(jnp.asarray, t)


def _tt(t):
    return tree.map(torch.as_tensor, t)


def _same_telemetry(tel, tel_r):
    for name, val in tel._asdict().items():
        ref = getattr(tel_r, name)
        assert (val is None) == (ref is None), name
        if val is not None:
            np.testing.assert_array_equal(np.asarray(val), np.asarray(ref),
                                          name)


def _ghat_close(ghat, ghat_r, tel, q_eff, g_max, gbar, k_eff, rel=None):
    weight = tel.sign_ok.numpy() / q_eff
    gb_max = max(float(np.max(np.abs(b))) for b in jax.tree.leaves(gbar))
    atol = ulp_atol(weight, g_max, np.asarray(gb_max)) / k_eff
    if rel is not None:                  # a bfloat16 reduction's rounding
        scale = float(np.sum(weight * np.maximum(g_max, gb_max)))
        atol = rel * scale / k_eff
    got, want = tree.leaves(ghat), jax.tree.leaves(ghat_r)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


def _both(grads, gbar, q, p, key, round_idx=None, n_retx=0, ref_kw=None,
          port_kw=None, **fl_kw):
    rfl, fl = _cfgs(**fl_kw)
    ghat_r, stats_r, tel_r = TR.spfl_aggregate_tree(
        _jt(grads), _jt(gbar), jnp.asarray(q), jnp.asarray(p), rfl, key,
        n_retx=n_retx, round_idx=round_idx, **(ref_kw or {}))
    draws = tree_draws_from_key(key, _sizes(), K, n_retx, fl.channel,
                                round_idx=round_idx)
    ghat, stats, tel = TTR.spfl_aggregate_tree(
        _tt(grads), _tt(gbar), torch.as_tensor(q), torch.as_tensor(p), fl,
        draws, n_retx=n_retx, **(port_kw or {}))
    return (ghat, stats, tel), (ghat_r, stats_r, tel_r)


@pytest.mark.parametrize('wire,channel,n_retx', CASES)
def test_spfl_tree_matches_reference(wire, channel, n_retx):
    grads, gbar = _grads(1), _gbar(2)
    q, p = _q_p()
    (ghat, stats, tel), (ghat_r, stats_r, tel_r) = _both(
        grads, gbar, q, p, jax.random.PRNGKey(3 + n_retx), round_idx=5,
        n_retx=n_retx, wire=wire, channel=channel)
    _same_telemetry(tel, tel_r)
    np.testing.assert_array_equal(stats['g_min'].numpy(), stats_r['g_min'])
    np.testing.assert_array_equal(stats['g_max'].numpy(), stats_r['g_max'])
    assert stats['dim'] == stats_r['dim'] == sum(_sizes())
    np.testing.assert_allclose(stats['g2'].numpy(), stats_r['g2'],
                               rtol=1e-6)
    q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)
    _ghat_close(ghat, ghat_r, tel, q_eff, stats['g_max'].numpy(), gbar, K)
    if channel == 'bitlevel':                    # the channel did work
        assert int(tel.sign_flips.sum() + tel.mod_flips.sum()) > 0
        assert not bool((tel.mod_ok & tel.sign_crc_ok).all())


@pytest.mark.parametrize('wire', ['analytic', 'packed'])
def test_spfl_tree_per_client_gbar_and_floor(wire):
    """Per-client (last_local) ḡ leaves and the min_participation
    floor, which here drops every modulus packet."""
    grads, gbar = _grads(4), _gbar(5, per_client=True)
    q, p = _q_p()
    channel = 'bitlevel' if wire == 'packed' else 'bernoulli'
    kw = dict(min_participation=0.9)
    (ghat, _, tel), (ghat_r, _, tel_r) = _both(
        grads, gbar, q, p, jax.random.PRNGKey(6), ref_kw=kw, port_kw=kw,
        wire=wire, channel=channel)
    _same_telemetry(tel, tel_r)
    assert not bool(tel.mod_ok.any())
    _ghat_close(ghat, ghat_r, tel, q, np.zeros(K, np.float32), gbar, K)


@pytest.mark.parametrize('wire', ['analytic', 'packed'])
def test_spfl_tree_signflip(wire):
    grads, gbar = _grads(7), _gbar(8)
    q, p = _q_p()
    byz = np.array([False, True, False, True])
    (ghat, stats, tel), (ghat_r, _, tel_r) = _both(
        grads, gbar, q, p, jax.random.PRNGKey(9),
        ref_kw=dict(attack='signflip', byz_mask=jnp.asarray(byz)),
        port_kw=dict(attack='signflip', byz_mask=torch.as_tensor(byz)),
        wire=wire, channel='bitlevel' if wire == 'packed' else 'bernoulli')
    _same_telemetry(tel, tel_r)
    _ghat_close(ghat, ghat_r, tel, q, stats['g_max'].numpy(), gbar, K)


def test_spfl_tree_scaled_and_screen():
    """'scaled' liars quantize honestly and report 1000x ranges; the
    norm-report screen drops them (gate 0, the mean over the rest)."""
    k_byz = np.array([False, False, True, False])
    grads, gbar = _grads(10), _gbar(11)
    q, p = np.ones(K, np.float32), np.ones(K, np.float32)
    kw = dict(attack='scaled', attack_scale=1000.0, screen=True)
    (ghat, stats, tel), (ghat_r, _, tel_r) = _both(
        grads, gbar, q, p, jax.random.PRNGKey(12),
        ref_kw=dict(kw, byz_mask=jnp.asarray(k_byz)),
        port_kw=dict(kw, byz_mask=torch.as_tensor(k_byz)), wire='packed',
        channel='bitlevel')
    _same_telemetry(tel, tel_r)
    assert tel.suspect.numpy().tolist() == k_byz.tolist()
    _ghat_close(ghat, ghat_r, tel, q, stats['g_max'].numpy(), gbar, K - 1)


@pytest.mark.parametrize('wire', ['analytic', 'packed'])
def test_spfl_tree_stragglers(wire):
    active = np.array([True, False, True, True])
    grads, gbar = _grads(13), _gbar(14)
    q, p = _q_p()
    (ghat, stats, tel), (ghat_r, _, tel_r) = _both(
        grads, gbar, q, p, jax.random.PRNGKey(15),
        ref_kw=dict(active=jnp.asarray(active)),
        port_kw=dict(active=torch.as_tensor(active)), wire=wire,
        channel='bernoulli')
    _same_telemetry(tel, tel_r)
    assert not bool(tel.sign_ok[1]) and not bool(tel.mod_ok[1])
    _ghat_close(ghat, ghat_r, tel, q, stats['g_max'].numpy(), gbar, K - 1)


def test_spfl_tree_bfloat16_uplink_reduce():
    grads, gbar = _grads(16), _gbar(17)
    q, p = _q_p()
    (ghat, stats, tel), (ghat_r, _, tel_r) = _both(
        grads, gbar, q, p, jax.random.PRNGKey(18), wire='analytic',
        uplink_reduce_dtype='bfloat16')
    _same_telemetry(tel, tel_r)
    _ghat_close(ghat, ghat_r, tel, q, stats['g_max'].numpy(), gbar, K,
                rel=2.0 ** -7)


def test_spfl_tree_bfloat16_gradients():
    """bf16 gradient leaves are cast to float32 leaf by leaf before the
    quantizer (the full-width model's case)."""
    grads = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                         _grads(19))
    gbar = _gbar(20)
    q, p = _q_p()
    rfl, fl = _cfgs(wire='packed', channel='bitlevel')
    key = jax.random.PRNGKey(21)
    ghat_r, _, tel_r = TR.spfl_aggregate_tree(
        _jt(grads), _jt(gbar), jnp.asarray(q), jnp.asarray(p), rfl, key)
    draws = tree_draws_from_key(key, _sizes(), K, 0, 'bitlevel')
    tgrads = tree.map(lambda a: torch.as_tensor(np.asarray(a, np.float32))
                      .to(torch.bfloat16), grads)
    ghat, stats, tel = TTR.spfl_aggregate_tree(
        tgrads, _tt(gbar), torch.as_tensor(q), torch.as_tensor(p), fl,
        draws)
    _same_telemetry(tel, tel_r)
    _ghat_close(ghat, ghat_r, tel, q, stats['g_max'].numpy(), gbar, K)


@pytest.mark.parametrize('wire', ['analytic', 'packed'])
def test_error_free_tree_matches_reference(wire):
    grads = _grads(22)
    rfl, fl = _cfgs(wire=wire)
    key = jax.random.PRNGKey(23)
    ghat_r, _, tel_r = TR.error_free_aggregate_tree(_jt(grads), rfl, key,
                                                    round_idx=2)
    draws = tree_draws_from_key(key, _sizes(), K, 0, 'bernoulli',
                                round_idx=2, kind='error_free')
    ghat, stats, tel = TTR.error_free_aggregate_tree(_tt(grads), fl, draws)
    _same_telemetry(tel, tel_r)
    _ghat_close(ghat, ghat_r, tel, np.ones(K, np.float32),
                stats['g_max'].numpy(), {'z': np.zeros(1)}, K)


def test_stats_and_delta_sq():
    grads = _grads(24, scale=3.0)
    stats_r = TR.tree_client_stats(_jt(grads))
    stats = TTR.tree_client_stats(_tt(grads))
    np.testing.assert_array_equal(stats['g_min'].numpy(), stats_r['g_min'])
    np.testing.assert_array_equal(stats['g_max'].numpy(), stats_r['g_max'])
    np.testing.assert_allclose(stats['g2'].numpy(), stats_r['g2'], rtol=1e-6)
    np.testing.assert_array_equal(TTR.delta_sq_tree(stats, 3).numpy(),
                                  np.asarray(TR.delta_sq_tree(stats_r, 3)))


def test_sharded_collective_names_its_roadmap_item():
    """The sharded collective runs (a one-rank mesh: bit for bit the
    gathered call; more ranks in ``test_torch_sharded.py``) and refuses
    only what the reference refuses, with its messages: the analytic
    wire and a missing mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    _, fl = _cfgs(wire='packed', collective='sharded')
    draws = TTR.make_tree_draws(K, _sizes(), 0, 'bernoulli', 'cpu',
                                torch.Generator().manual_seed(0),
                                torch.Generator().manual_seed(1))
    draws = draws._replace(rand=list(draws.rand))
    q = torch.full((K,), 0.7)
    with pytest.raises(ValueError, match='requires a mesh'):
        TTR.spfl_aggregate_tree(_tt(_grads(0)), _tt(_gbar(0)), q, q, fl,
                                draws)
    with pytest.raises(ValueError, match='requires a mesh'):
        TTR.error_free_aggregate_tree(_tt(_grads(0)), fl, draws)
    _, analytic = _cfgs(collective='sharded')
    with pytest.raises(ValueError, match="requires wire='packed'"):
        TTR.spfl_aggregate_tree(_tt(_grads(0)), _tt(_gbar(0)), q, q,
                                analytic, draws, mesh=make_host_mesh())
    mesh = make_host_mesh()
    _, gather = _cfgs(wire='packed')
    a, _, ta = TTR.spfl_aggregate_tree(_tt(_grads(0)), _tt(_gbar(0)), q, q,
                                       gather, draws)
    b, _, tb = TTR.spfl_aggregate_tree(_tt(_grads(0)), _tt(_gbar(0)), q, q,
                                       fl, draws, mesh=mesh)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(ta.sign_ok, tb.sign_ok)
    a, _, _ = TTR.error_free_aggregate_tree(_tt(_grads(0)), gather, draws)
    b, _, _ = TTR.error_free_aggregate_tree(_tt(_grads(0)), fl, draws,
                                            mesh=mesh)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)


def test_make_tree_draws_layout():
    gen = torch.Generator().manual_seed(0)
    host = torch.Generator().manual_seed(1)
    sizes = _sizes()
    d = TTR.make_tree_draws(K, sizes, 1, 'bitlevel', 'cpu', gen, host)
    assert len(d.rand) == len(sizes)
    assert [tuple(d.rand[i].shape) for i in range(len(sizes))] == \
        [(K, n) for n in sizes]
    assert tuple(d.seeds.shape) == (3, len(sizes) + 1, 2)
    assert d.seeds.dtype == torch.int32
    b = TTR.make_tree_draws(K, sizes, 0, 'bernoulli', 'cpu', gen, host)
    assert tuple(b.sign_u.shape) == (1, K) and tuple(b.mod_u.shape) == (K,)
    e = TTR.make_tree_draws(K, sizes, 0, 'bitlevel', 'cpu', gen, host,
                            kind='error_free')
    assert e.seeds is None and e.sign_u is None
