"""The LLM-scale slice of the port end to end on the CPU: one
``training.distributed.make_fl_train_step`` step of a narrowed reduced
smollm against the reference's step composed here (``repro.models.transformer.
loss_fn`` under ``jax.vmap(jax.value_and_grad)``,
``repro.core.transport.spfl_aggregate_tree`` and the update of
``repro/training/distributed.py``, which cannot be imported here), the
``launch.train`` host loop, the knobs that still raise, and the host
loop's ``collective='sharded'`` (it runs as 'gather').

Contract of the step: the packet verdicts and measured bits exact
(given the same draws they do not depend on the gradients);
the losses within 1e-5 relative; the port's transport on the
reference's own gradients within the FMA-wobble bound; and the whole
step's update within it wherever the two frameworks' float32 gradients
(rtol 1e-4 apart) round to the same knob, one knob step of the client
where a stochastic rounding lands on the other side (a few coordinates
in 10^4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import tree_draws_from_key, ulp_atol
from repro.configs import registry as RR
from repro.configs.base import FLConfig as RFL
from repro.core import allocation as RAL
from repro.core import transport as TR
from repro.models import transformer as RT
from repro_torch import tree
from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import transport as TTR
from repro_torch.launch import train as LT
from repro_torch.models import transformer as TT
from repro_torch.obs import read_jsonl
from repro_torch.training import distributed as TD
from repro_torch.training import fl_loop

K, LR = 3, 0.05
ARCH = 'smollm-135m-reduced'
# the reduced smollm made narrower for the step against the reference's
# (the reference's bit channel runs its Pallas kernel in interpret mode)
NARROW = dict(name='smollm-135m-narrow', d_model=64, head_dim=16, d_ff=96,
              vocab_size=160)


def _narrow(get):
    return dataclasses.replace(get(ARCH), **NARROW)


@pytest.fixture(scope='module')
def reference_step():
    """The reference's step on the narrowed reduced smollm, K = 3 clients
    of (2, 17) tokens, a non-zero ḡ, (q, p) < 1 on the packed wire with
    Bernoulli packet fates (the bit channel's tree passes are held to the
    reference in ``test_torch_tree_transport.py``).  The transport runs
    under ``jax.jit``: one compilation instead of one per eager op."""
    cfg = _narrow(RR.get_arch)
    params = RT.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, (K, 2, 17)).astype(np.int32)
    gbar = jax.tree.map(
        lambda p: (np.abs(rng.randn(*p.shape)) * 1e-3).astype(np.float32),
        params)
    q = np.array([0.6, 0.9, 1.0], np.float32)
    p = np.array([0.8, 0.5, 0.95], np.float32)
    rfl = RFL(n_devices=K, learning_rate=LR, wire='packed',
              channel='bernoulli')
    key = jax.random.PRNGKey(11)
    one = jax.value_and_grad(lambda pp, t: RT.loss_fn(pp, cfg, t))
    losses, grads = jax.jit(jax.vmap(one, in_axes=(None, 0)))(
        params, jnp.asarray(toks))
    ghat, stats, diag = jax.jit(
        lambda g, gb, q_, p_, k_: TR.spfl_aggregate_tree(g, gb, q_, p_, rfl,
                                                         k_))(
        grads, jax.tree.map(jnp.asarray, gbar), jnp.asarray(q),
        jnp.asarray(p), key)
    # distributed.py's update: f32 step cast back, ḡ = |ĝ|
    new_params = jax.tree.map(
        lambda pp, g: (pp.astype(jnp.float32) - LR * g).astype(pp.dtype),
        params, ghat)
    new_gbar = jax.tree.map(jnp.abs, ghat)
    return dict(cfg=cfg, params=params, toks=toks, gbar=gbar, q=q, p=p,
                rfl=rfl, key=key, losses=np.asarray(losses), grads=grads,
                ghat=ghat, stats=stats, diag=diag, new_params=new_params,
                new_gbar=new_gbar)


def _port_inputs(r):
    fl = FLConfig(**dataclasses.asdict(r['rfl']))
    sizes = [int(np.prod(x.shape)) for x in jax.tree.leaves(r['params'])]
    draws = tree_draws_from_key(r['key'], sizes, K, 0, 'bernoulli')
    return (fl, TT.params_from_reference(r['params']),
            tree.map(torch.as_tensor, r['gbar']), torch.as_tensor(r['q']),
            torch.as_tensor(r['p']), draws)


def _same_telemetry(tel, tel_r, skip=()):
    for name, val in tel._asdict().items():
        ref = getattr(tel_r, name)
        if name in skip:
            continue
        assert (val is None) == (ref is None), name
        if val is not None:
            np.testing.assert_array_equal(np.asarray(val), np.asarray(ref),
                                          name)


def test_transport_on_reference_gradients(reference_step):
    r = reference_step
    fl, _, gbar, q, p, draws = _port_inputs(r)
    grads = tree.map(lambda a: torch.as_tensor(np.array(a)), r['grads'])
    ghat, stats, tel = TTR.spfl_aggregate_tree(grads, gbar, q, p, fl, draws)
    _same_telemetry(tel, r['diag'])
    assert not bool((tel.sign_ok & tel.mod_ok).all())   # packets were lost
    weight = tel.sign_ok.numpy() / r['q']
    gb_max = max(float(b.max()) for b in jax.tree.leaves(r['gbar']))
    atol = ulp_atol(weight, stats['g_max'].numpy(), np.asarray(gb_max)) / K
    for a, b in zip(tree.leaves(ghat), jax.tree.leaves(r['ghat'])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


def test_fl_train_step_matches_reference_step(reference_step):
    r = reference_step
    fl, params, gbar, q, p, draws = _port_inputs(r)
    step = TD.make_fl_train_step(_narrow(get_arch), fl, 'spfl')
    new_params, new_gbar, m = step(
        params, {'tokens': torch.as_tensor(r['toks'])}, gbar, q, p, draws)
    np.testing.assert_allclose(m['client_losses'].numpy(), r['losses'],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m['loss']), r['losses'].mean(),
                               rtol=1e-5)
    np.testing.assert_allclose(m['g_norm_sq'].numpy(), r['stats']['g2'],
                               rtol=1e-4)
    np.testing.assert_allclose(m['g_max'].numpy(), r['stats']['g_max'],
                               rtol=1e-4)
    # the channel's outcomes depend on (q, p) and the seed words only
    _same_telemetry(m['telemetry'], r['diag'].with_allocation(r['q'], r['p']))
    for name in ('payload_bits', 'retransmissions', 'sign_ok_frac',
                 'mod_ok_frac', 'q_mean', 'p_mean'):
        assert name in m
    np.testing.assert_array_equal(m['sign_ok'].numpy(),
                                  np.asarray(r['diag'].sign_ok))
    # the update: within the FMA bound where the knobs agree, else one
    # knob step (x lr / q / K) of the client that rounded the other way
    weight = m['sign_ok'].numpy() / r['q']
    step_k = (m['g_max'] - m['g_min']).numpy() / 7.0
    one_knob = LR * float(np.max(weight * step_k)) / K * 1.01
    fma = LR * ulp_atol(weight, m['g_max'].numpy(), np.asarray(1e-2)) / K
    off, total = 0, 0
    for a, b, ref_p in zip(tree.leaves(new_params),
                           jax.tree.leaves(r['new_params']),
                           jax.tree.leaves(r['params'])):
        d = np.abs(a.numpy() - np.asarray(b))
        tol = fma + 1e-6 * np.abs(np.asarray(ref_p))
        assert float(d.max()) <= one_knob + float(tol.max())
        off += int(np.sum(d > tol))
        total += d.size
    assert off <= 1e-3 * total, (off, total)
    for a, b in zip(tree.leaves(new_gbar), jax.tree.leaves(r['new_gbar'])):
        assert a.dtype == torch.float32
        assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) <= \
            one_knob / LR


def test_error_free_step_and_standard_step(reference_step):
    r = reference_step
    fl, params, _, _, _, _ = _port_inputs(r)
    sizes = [int(np.prod(x.shape)) for x in jax.tree.leaves(r['params'])]
    draws = tree_draws_from_key(r['key'], sizes, K, 0, 'bernoulli',
                                kind='error_free')
    toks = torch.as_tensor(r['toks'])
    ones = torch.ones(K)
    cfg = _narrow(get_arch)
    step = TD.make_fl_train_step(cfg, fl, 'error_free')
    new_params, new_gbar, m = step(params, {'tokens': toks},
                                   TD.init_gbar(params), ones, ones, draws)
    assert bool(m['sign_ok'].all()) and bool(m['mod_ok'].all())
    assert float(m['payload_bits']) == float(K * 32 * (
        sum(-(-n // 32) * 4 for n in sizes) + 4 + 7 + 2))
    assert all(bool(torch.isfinite(x).all()) for x in tree.leaves(new_params))
    std_params, sm = TD.make_standard_train_step(cfg, fl)(
        params, {'tokens': toks[0]})
    np.testing.assert_allclose(float(sm['loss']), r['losses'][0], rtol=1e-5)
    assert float(sm['g_norm_sq']) > 0.0
    np.testing.assert_allclose(
        float(TD.make_eval_step(cfg)(params, {'tokens': toks[0]})),
        r['losses'][0], rtol=1e-5)


def test_llm_knobs_not_ported_yet_name_item_12():
    """The knobs of ROADMAP Queue 1 item 12 are ported: the sharded
    collective, fused LLM rounds and population mode run, and refuse only
    what the reference refuses, with its messages (no mesh for a
    'sharded' step; the host solver in a fused round; the analytic wire
    under 'sharded')."""
    cfg = get_arch(ARCH)
    with pytest.raises(ValueError, match='needs the mesh passed into '
                       'make_fl_train_step'):
        TD.make_fl_train_step(cfg, FLConfig(collective='sharded'))
    for make in (TD.make_fused_fl_round, TD.make_fused_fl_scan):
        args = (cfg, FLConfig()) if make is TD.make_fused_fl_round else (
            cfg, FLConfig(round_fusion='scan'), None, None)
        with pytest.raises(ValueError, match="allocation_backend='jax'"):
            make(*args)
    base = dict(arch=ARCH, steps=1, clients=2, batch=1, seq=8,
                transport_kind='spfl', allocator='uniform', lr=LR,
                bandwidth_hz=10e9, tx_power_dbm=-4.0, device='cpu')
    with pytest.raises(ValueError, match="requires wire='packed'"):
        LT.run(**base, collective='sharded')
    for kw in (dict(round_fusion='scan'), dict(round_fusion='eager'),
               dict(population_n=100), dict(collective='sharded',
                                            wire='packed')):
        hist = LT.run(**base, **kw)
        assert len(hist['loss']) == 1 and np.isfinite(hist['loss'][0])


def test_client_batch_shapes():
    shapes = TD.client_batch_shapes(get_arch(ARCH), 4, 8, 16)
    assert shapes == {'tokens': ((4, 2, 16), torch.int32)}
    with pytest.raises(ValueError):
        TD.client_batch_shapes(get_arch(ARCH), 3, 8, 16)


@pytest.mark.parametrize('backend', ['numpy', 'jax'])
def test_launcher_host_loop(backend, tmp_path, monkeypatch):
    """Three steps of the reduced smollm on the CPU: finite losses, the
    solve from step 1 on the previous step's report (v by the
    reference's sqrt(g2 gb2) / 10), (q, p) the reference's host solver's
    on that report, and one JSONL row a step."""
    reports, metrics = [], []
    solve = LT._allocate

    def spy(fl, allocator, g2, gb2, v, d2, *rest):
        q, p = solve(fl, allocator, g2, gb2, v, d2, *rest)
        reports.append((fl, allocator, g2, gb2, v, d2, rest, q, p))
        return q, p

    make_step = TD.make_fl_train_step

    def spy_step(*a, **k):
        step = make_step(*a, **k)

        def wrapped(*args):
            out = step(*args)
            metrics.append({n: out[2][n] for n in ('g_norm_sq', 'g_min',
                                                   'g_max')})
            return out
        return wrapped

    monkeypatch.setattr(LT, '_allocate', spy)
    monkeypatch.setattr(LT.dist, 'make_fl_train_step', spy_step)
    path = str(tmp_path / 'llm.jsonl')
    hist = LT.run(ARCH, steps=3, clients=K, batch=2, seq=16,
                  transport_kind='spfl', allocator='barrier', lr=LR,
                  bandwidth_hz=10e9, tx_power_dbm=-4.0, wire='packed',
                  allocation_backend=backend, telemetry_path=path,
                  device='cpu')
    assert len(hist['loss']) == 3 and all(np.isfinite(hist['loss']))
    assert hist['q'][0] == 1.0 and hist['p'][0] == 1.0
    assert len(reports) == 2                  # steps 1 and 2 solve
    for n, (fl, allocator, g2, gb2, v, d2, rest, q, p) in enumerate(reports):
        prev = metrics[n]
        g2_k = prev['g_norm_sq'].numpy()
        np.testing.assert_array_equal(g2, g2_k.astype(np.float64))
        assert gb2.max() > 0 and np.all(gb2 == gb2[0])
        np.testing.assert_array_equal(
            v, (np.sqrt(g2_k * float(gb2[0])) * 0.1).astype(np.float64))
        np.testing.assert_array_equal(d2, TTR.delta_sq_tree(
            {'g_min': prev['g_min'], 'g_max': prev['g_max'],
             'dim': get_arch(ARCH).param_count()},
            3).numpy().astype(np.float64))
        assert bool(((q > 0) & (q <= 1)).all()) and bool(
            ((p >= 0) & (p <= 1)).all())
        # the reference's host solver on the same report
        gains, p_w, dim = rest[0], rest[1], rest[2]
        rfl = RFL(**{f.name: getattr(fl, f.name)
                     for f in dataclasses.fields(fl)})
        sol = RAL.solve(RAL.problem_from_stats(g2, gb2, v, d2, gains, p_w,
                                               dim, rfl), allocator)
        np.testing.assert_allclose(q.numpy(), sol.q.astype(np.float32),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(p.numpy(), sol.p.astype(np.float32),
                                   rtol=0, atol=1e-6)
    manifest, rows = read_jsonl(path)
    assert manifest['config']['wire'] == 'packed'
    assert [row['round'] for row in rows] == [0, 1, 2]
    assert [row['loss'] for row in rows] == hist['loss']


def _sim_data(k):
    rng = np.random.RandomState(0)
    x = rng.randn(k, 6, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, (k, 6)).astype(np.int32)
    return x, y, x[0], y[0]


def test_host_loop_sharded_collective_is_gather_bit_for_bit():
    """The reference's FLSimulator never reads ``collective``; the port's
    runs 'sharded' as 'gather', bit for bit."""
    data = _sim_data(4)
    runs = []
    for collective in ('gather', 'sharded'):
        fl = FLConfig(n_devices=4, wire='packed', channel='bitlevel',
                      allocator='uniform', collective=collective)
        sim = fl_loop.FLSimulator(fl, *data, device='cpu')
        hist = sim.run(2)
        runs.append((sim, hist))
    (a, ha), (b, hb) = runs
    assert torch.equal(a.params, b.params)
    for name, va in ha.as_dict().items():
        if name.endswith('time_s'):
            continue
        np.testing.assert_array_equal(va, hb.as_dict()[name], name)
