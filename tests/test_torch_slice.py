"""The port's slice as a whole: rounds of its ``FLSimulator`` against the
same rounds composed from the reference's modules (CNN gradients ->
``repro.core.allocation.solve`` on the same per-client stats ->
``repro.core.transport.spfl_aggregate`` packed + bit-level -> SGD update),
with the same parameters and the same draws.

The reference transport is fed the port's gradients, so the comparison
of every integer in the round's telemetry is exact; the gradients
themselves agree to rtol 1e-4 (conv summation order), the aggregate to
the reference's FMA-wobble bound, and the updated parameters to rtol
1e-4.  Also: the simulator runs end to end on the CPU, the knobs the port
does not run yet raise, and the default device is the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from test_torch_parity import draws_from_key, ulp_atol
from repro.configs.base import FLConfig as RefFLConfig
from repro.core import allocation as RA
from repro.core import transport as TR
from repro.models import cnn as RC
from repro_torch.configs.base import FLConfig
from repro_torch.device import resolve
from repro_torch.training.fl_loop import FLSimulator, build_simulator
from repro_torch.wire import format as tfmt

K, PER_DEVICE = 4, 16


def test_rounds_match_reference_composition():
    ref_fl = RefFLConfig(n_devices=K, wire='packed', channel='bitlevel',
                         transport='spfl_retx', tx_power_dbm=-40.0,
                         allocation_max_iters=1)
    sim = build_simulator(FLConfig(**dataclasses.asdict(ref_fl)),
                          per_device=PER_DEVICE, n_test=64, device='cpu')
    flat0, unravel = ravel_pytree(RC.init_cnn(jax.random.PRNGKey(0)))
    sim.params = torch.as_tensor(np.array(flat0))
    xs = jnp.asarray(sim.client_x.movedim(-3, -1).numpy())
    ys = jnp.asarray(sim.client_y.numpy().astype(np.int32))

    def one(params, x, y):
        loss, g = jax.value_and_grad(RC.cnn_loss)(params, x, y)
        return loss, ravel_pytree(g)[0]

    flips = 0
    for r in range(2):
        params_np = sim.params.numpy().copy()
        gbar_np = sim.gbar.numpy().copy()
        _, rgrads = jax.vmap(one, in_axes=(None, 0, 0))(
            unravel(jnp.asarray(params_np)), xs, ys)
        key = jax.random.PRNGKey(50 + r)
        res = sim.round_step(draws_from_key(key, K, sim.dim, 1, 'bitlevel'))
        np.testing.assert_allclose(res.grads.numpy(), np.asarray(rgrads),
                                   rtol=1e-4, atol=1e-6)

        st = res.stats
        prob = RA.problem_from_stats(st['g2'], st['gb2'], st['v'], st['d2'],
                                     sim.gains, sim.p_w, sim.dim, ref_fl)
        if r == 0:
            assert st['gb2'].max() == 0.0        # no history: uniform
            sol = RA.solve(prob, 'uniform')
        else:
            sol = RA.solve(prob, 'alternating', max_iters=1)
        np.testing.assert_array_equal(res.allocation.q, sol.q)
        np.testing.assert_array_equal(res.allocation.p, sol.p)
        assert res.allocation.objective == sol.objective

        ghat_r, tel_r = TR.spfl_aggregate(
            jnp.asarray(res.grads.numpy()), jnp.asarray(gbar_np),
            jnp.asarray(sol.q), jnp.asarray(sol.p), ref_fl.quant_bits,
            ref_fl.b0_bits, key, n_retx=1, wire='packed', round_idx=r,
            channel='bitlevel')
        tel = res.telemetry
        for name in ('sign_ok', 'mod_ok', 'accepted', 'payload_bits',
                     'retransmissions', 'sign_flips', 'mod_flips',
                     'sign_crc_ok', 'mod_crc_ok', 'retx_attempts',
                     'sign_votes'):
            np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                          np.asarray(getattr(tel_r, name)),
                                          name)
        assert tel.round_idx == r
        flips += int(tel.sign_flips.sum() + tel.mod_flips.sum())
        q_eff = 1.0 - (1.0 - np.asarray(sol.q, np.float32)) ** 2
        np.testing.assert_allclose(
            res.ghat.numpy(), np.asarray(ghat_r), rtol=0,
            atol=ulp_atol(tel.sign_ok.numpy() / q_eff,
                          np.abs(res.grads.numpy()).max(1), gbar_np) / K)

        new_ref = jax.tree.map(lambda p, g: p - ref_fl.learning_rate * g,
                               unravel(jnp.asarray(params_np)),
                               unravel(ghat_r))
        np.testing.assert_allclose(sim.params.numpy(),
                                   np.asarray(ravel_pytree(new_ref)[0]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(sim.gbar.numpy(),
                                      np.abs(res.ghat.numpy()))
    assert flips > 0                    # the bit channel really flipped


def test_simulator_runs_on_cpu_with_measured_payload():
    fl = FLConfig(n_devices=K, wire='packed', channel='bitlevel')
    sim = build_simulator(fl, per_device=PER_DEVICE, n_test=64, device='cpu')
    hist = sim.run(2, compute_bound=True)
    assert len(hist.loss) == 2 and all(np.isfinite(hist.loss))
    assert all(np.isfinite(hist.bound))
    assert hist.payload_bits == [float(tfmt.measured_uplink_bits(
        sim.dim, fl.quant_bits, K))] * 2
    assert len(hist.sign_agreement) == 2 and len(sim.records) == 2
    assert 0.0 <= hist.test_acc[-1] <= 1.0


@pytest.mark.parametrize('kw', [
    dict(allocation_backend='jax', population_n=1000, round_fusion='eager'),
    dict(round_fusion='eager'), dict(round_fusion='scan'),
    dict(collective='sharded'),
    dict(telemetry_path='t.jsonl', collective='sharded')])
def test_unsupported_knobs_raise(kw):
    """Only ``collective='sharded'`` is still unported (it raises, naming
    its ROADMAP item); fused rounds build, and refuse the host solver of
    an allocating transport when they run, with the reference's
    message."""
    if kw.get('collective') == 'sharded':
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            _tiny_simulator(FLConfig(**kw))
        return
    sim = _tiny_simulator(FLConfig(**kw))
    assert sim.fl.round_fusion in ('eager', 'scan')
    if kw.get('allocation_backend') != 'jax':
        with pytest.raises(ValueError, match="allocation_backend='jax'"):
            sim.run(1)


def test_bitlevel_needs_packed_wire():
    with pytest.raises(ValueError):
        _tiny_simulator(FLConfig(channel='bitlevel'))


def _tiny_simulator(fl):
    """A simulator on one image per client (``build_simulator`` passes
    through the same constructor after making the full data set)."""
    x = np.zeros((fl.n_devices, 1, 32, 32, 3), np.float32)
    y = np.zeros((fl.n_devices, 1), np.int32)
    return FLSimulator(fl, x, y, x[0], y[0], device='cpu')


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    with pytest.raises(RuntimeError, match='CUDA'):
        resolve()
    with pytest.raises(RuntimeError, match='CUDA'):
        build_simulator(FLConfig())
    assert resolve('cpu') == torch.device('cpu')
