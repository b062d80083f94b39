"""The port's host loop under per-round fading and with the paper's
baselines, against the reference's modules composed the same way:

* per-round cadence, 'numpy' backend: rounds through ``round_step(gains=
  ...)`` on the reference's own trajectory rows (``repro.core.channel``),
  against ``repro.core.allocation`` solving the same stats on that row in
  float64 and ``repro.core.transport.spfl_aggregate`` — q and p bit for
  bit, every telemetry integer exact, the aggregate within ``ulp_atol``;
* per-round cadence, 'jax' backend (the plain solver on the CPU) at K=4,
  within the engine-parity contract of the reference's host solve of the
  same problem;
* one round of each baseline through ``round_step`` against the
  reference's transport on the same gradients and draws;
* the 'jax' problem's float32-rounded budgets, the run's trajectory,
  ``host_solver_calls``, bit-identical histories from one seed, and the
  seeded-random compensation.

The simulators here run on small random images (K=4, 8 images a client):
the checks are of the loop, not of learning."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_allocation_jax import assert_parity
from test_torch_parity import (baseline_draws_from_key, draws_from_key,
                               ulp_atol)
from repro.configs.base import FLConfig as RefFLConfig
from repro.core import allocation as RA
from repro.core import channel as C
from repro.core import transport as TR
from repro_torch.configs.base import FLConfig
from repro_torch.core import channel as TC
from repro_torch.training.fl_loop import FADING_SEED_OFFSET, FLSimulator

K, PER_DEVICE = 4, 8


def _sim(fl, seed=0):
    """A simulator on random images (the constructor ``build_simulator``
    calls after making its data set)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (fl.n_devices, PER_DEVICE, 32, 32, 3))
    y = rng.randint(0, 10, (fl.n_devices, PER_DEVICE))
    return FLSimulator(fl, x.astype(np.float32), y, x[0], y[0], seed=seed,
                       device='cpu')


def _configs(**kw):
    ref = RefFLConfig(n_devices=K, **kw)
    return ref, FLConfig(**dataclasses.asdict(ref))


def test_per_round_numpy_rounds_match_reference_composition():
    ref_fl, fl = _configs(wire='packed', channel='bitlevel',
                          tx_power_dbm=-40.0, allocation_max_iters=1,
                          allocation_cadence='per_round')
    sim = _sim(fl)
    traj = np.asarray(C.block_fading_trajectory(
        jax.random.PRNGKey(8), jnp.asarray(sim.gains, jnp.float32), 2))
    assert not np.array_equal(traj[0], traj[1])
    for r in range(2):
        gbar_np = sim.gbar.numpy().copy()
        key = jax.random.PRNGKey(70 + r)
        row = np.asarray(traj[r], np.float64)
        res = sim.round_step(draws_from_key(key, K, sim.dim, 0, 'bitlevel'),
                             gains=row)
        st = res.stats
        prob = RA.problem_from_stats(st['g2'], st['gb2'], st['v'], st['d2'],
                                     row, sim.p_w, sim.dim, ref_fl)
        np.testing.assert_array_equal(res.stats['prob'].gains, row)
        sol = (RA.solve(prob, 'uniform') if r == 0
               else RA.solve(prob, 'alternating', max_iters=1))
        np.testing.assert_array_equal(res.allocation.q, sol.q)
        np.testing.assert_array_equal(res.allocation.p, sol.p)
        assert res.allocation.objective == sol.objective
        ghat_r, tel_r = TR.spfl_aggregate(
            jnp.asarray(res.grads.numpy()), jnp.asarray(gbar_np),
            jnp.asarray(sol.q), jnp.asarray(sol.p), fl.quant_bits,
            fl.b0_bits, key, wire='packed', round_idx=r, channel='bitlevel')
        for name in ('sign_ok', 'mod_ok', 'payload_bits', 'sign_flips',
                     'mod_flips', 'sign_votes'):
            np.testing.assert_array_equal(
                getattr(res.telemetry, name).numpy(),
                np.asarray(getattr(tel_r, name)), name)
        np.testing.assert_allclose(
            res.ghat.numpy(), np.asarray(ghat_r), rtol=0,
            atol=ulp_atol(res.telemetry.sign_ok.numpy()
                          / np.asarray(sol.q, np.float32),
                          np.abs(res.grads.numpy()).max(1), gbar_np) / K)
    assert sim.host_solver_calls == 2


def test_per_round_jax_solve_within_engine_parity():
    """The on-device path's round-1 problem on its trajectory row, solved
    by the plain solver, against the reference's host solve of the same
    problem (alternating, one outer iteration)."""
    ref_fl, fl = _configs(allocation_backend='jax', tx_power_dbm=-22.0,
                          allocation_cadence='per_round',
                          allocation_max_iters=1)
    sim = _sim(fl, seed=1)
    kept = []
    allocate = sim.allocate_on_device

    def keep(grads, gbar, gains=None):
        sol, stats = allocate(grads, gbar, gains)
        kept.append((sol, stats, gains))
        return sol, stats

    sim.allocate_on_device = keep
    sim.run(2)
    assert sim.host_solver_calls == 0
    sol, stats, gains = kept[1]
    assert torch.equal(gains, sim.trajectory[1])
    assert not torch.equal(sim.trajectory[0], sim.trajectory[1])
    np.testing.assert_array_equal(stats['prob'].gains.numpy(),
                                  sim.trajectory[1].numpy())
    host = {f: stats[f].numpy() for f in ('g2', 'gb2', 'v', 'd2')}
    prob = RA.problem_from_stats(host['g2'], host['gb2'], host['v'],
                                 host['d2'], sim.trajectory[1].numpy(),
                                 sim.p_w_dev.numpy(), sim.dim, ref_fl)
    ref = RA.solve(prob, 'alternating', max_iters=1)
    got = {f: getattr(sol, f).numpy() for f in sol._fields}
    assert_parity(ref, got, 'alternating')


def test_jax_problem_has_the_references_float32_budgets():
    """The reference's on-device path builds its problem from
    float64(float32(p_w)); so does the port's."""
    ref_fl, fl = _configs(allocation_backend='jax', allocator='uniform')
    sim = _sim(fl)
    _, grads = sim.client_grads(sim.params)
    _, stats = sim.allocate_on_device(grads, sim.gbar)
    host = {f: stats[f].numpy() for f in ('g2', 'gb2', 'v', 'd2')}
    p_w32 = np.asarray(jnp.asarray(sim.p_w, jnp.float32), np.float64)
    ref = RA.problem_from_stats(host['g2'], host['gb2'], host['v'],
                                host['d2'], sim.gains, p_w32, sim.dim,
                                ref_fl)
    got = stats['prob'].p_w.numpy()
    np.testing.assert_array_equal(got, ref.p_w)
    assert not np.array_equal(got, sim.p_w)    # the rounding matters


@pytest.mark.parametrize('kind', ['dds', 'onebit', 'scheduling',
                                  'error_free'])
def test_baseline_round_matches_reference(kind):
    wire = 'packed' if kind == 'error_free' else 'analytic'
    channel = 'bernoulli' if kind == 'error_free' else 'bitlevel'
    ref_fl, fl = _configs(transport=kind, wire=wire, channel=channel,
                          tx_power_dbm=-50.0)
    sim = _sim(fl, seed=2)
    params = sim.params.clone()
    key = jax.random.PRNGKey(5)
    res = sim.round_step(baseline_draws_from_key(kind, key, K, sim.dim,
                                                 channel))
    assert res.allocation is None and res.stats is None
    grads = jnp.asarray(res.grads.numpy())
    gains = jnp.asarray(sim.gains, jnp.float32)
    p_w = jnp.asarray(sim.p_w, jnp.float32)
    beta = jnp.full((K,), 1.0 / K)
    if kind == 'dds':
        ghat_r, tel_r = TR.dds_aggregate(grads, beta, gains, p_w, ref_fl, key)
    elif kind == 'onebit':
        ghat_r, tel_r = TR.onebit_aggregate(grads, beta, gains, p_w, ref_fl,
                                            key)
    elif kind == 'scheduling':
        ghat_r, tel_r = TR.scheduling_aggregate(grads, gains, p_w, ref_fl,
                                                key)
    else:
        ghat_r, tel_r = TR.error_free_aggregate(grads, ref_fl, key,
                                                round_idx=0)
    tel = res.telemetry
    for name in ('sign_ok', 'mod_ok', 'accepted', 'payload_bits',
                 'retransmissions', 'sign_votes'):
        want = getattr(tel_r, name)
        if want is None:
            assert getattr(tel, name) is None, name
        else:
            np.testing.assert_array_equal(getattr(tel, name).numpy(),
                                          np.asarray(want), name)
    assert torch.equal(tel.q, torch.ones(K)) and tel.alloc_objective is None
    ok = tel.accepted.numpy()
    assert ok.any()
    gmax = np.abs(res.grads.numpy()).max(1)
    w = np.ones(K) / K if kind == 'error_free' else ok / ok.sum()
    atol = ulp_atol(w, gmax, np.zeros(1))
    if kind == 'onebit':
        # the per-client mean of l values, summed in another order
        atol += float(np.sum(w * sim.dim * np.finfo(np.float32).eps * gmax))
    np.testing.assert_allclose(res.ghat.numpy(), np.asarray(ghat_r), rtol=0,
                               atol=atol)
    assert torch.equal(sim.params, params - fl.learning_rate * res.ghat)
    assert torch.equal(sim.gbar, torch.abs(res.ghat))


def test_dds_runs_on_the_bit_channel_with_the_analytic_wire():
    fl = FLConfig(n_devices=K, transport='dds', channel='bitlevel',
                  tx_power_dbm=-50.0)
    sim = _sim(fl, seed=3)
    hist = sim.run(2, compute_bound=True)
    assert all(np.isfinite(hist.loss)) and hist.bound == []
    assert hist.sign_agreement == [] and sim.host_solver_calls == 0
    assert hist.payload_bits == [float(K * (sim.dim * 4 + 64))] * 2
    assert all(np.isnan(hist.alloc_iters))


def test_per_round_runs_are_deterministic_and_count_host_solves():
    for backend, calls in (('numpy', 3), ('jax', 0)):
        fl = FLConfig(n_devices=K, allocator='uniform', tx_power_dbm=-30.0,
                      allocation_backend=backend, wire='packed',
                      allocation_cadence='per_round')
        hists = []
        for _ in range(2):
            sim = _sim(fl)
            hists.append(sim.run(3))
            assert sim.host_solver_calls == calls
        h, h2 = hists
        assert h.as_dict() | {'alloc_time_s': 0, 'round_time_s': 0} == \
            h2.as_dict() | {'alloc_time_s': 0, 'round_time_s': 0}
        assert len(h.sign_agreement) == 3
        # the fading moves the allocation from round to round
        assert len(set(h.q_mean)) == 3
        gen = torch.Generator().manual_seed(fl.seed + FADING_SEED_OFFSET)
        want = TC.block_fading_trajectory(
            torch.randn((3, K), generator=gen),
            torch.as_tensor(sim.gains, dtype=torch.float32))
        assert torch.equal(sim.trajectory, want.double())


def test_seeded_random_compensation_rolls_as_before():
    fl = FLConfig(n_devices=K, allocator='uniform',
                  compensation='seeded_random')
    sim = _sim(fl)
    assert not sim.gbar.any()
    for n in range(2):
        sim.round_step(n=n)
        gen = torch.Generator().manual_seed((fl.seed + 99) * 1_000_003 + n)
        want = torch.abs(torch.randn(sim.dim, generator=gen)) * 0.01
        assert torch.equal(sim.gbar, want)
    assert sim.comp.round_idx == 2
