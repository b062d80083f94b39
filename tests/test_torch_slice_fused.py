"""The port's fused rounds (``round_fusion`` 'eager' and 'scan') against
themselves and the host loop, on the CPU at K = 4, narrow data (the
port's mirror of the reference's ``tests/test_fused_scan.py``): 'scan'
equals 'eager' bit for bit; a transport that solves nothing equals the
host loop bit for bit; spfl equals it given the same (q, p); a segment
makes no host read; the ring flushes across ragged segments; the
refusals.  Every comparison here is exact."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.data import (
    dirichlet_partition, load_image_dataset, stack_client_data,
)
from repro_torch.training import fl_loop
from repro_torch.training.fl_loop import FLSimulator

K, PER_DEVICE, SHARDS = 4, 8, 6


@pytest.fixture(scope='module')
def data():
    (x, y), (tx, ty) = load_image_dataset(seed=0)
    out = {}
    for k in (K, 8, SHARDS):
        parts = dirichlet_partition(y, k, PER_DEVICE, 0.5, 0)
        cx, cy = stack_client_data(x, y, parts)
        out[k] = (cx, cy, tx[:32], ty[:32])
    return out


def _fl(**kw):
    base = dict(n_devices=K, allocation_backend='jax', allocator='uniform',
                wire='packed', channel='bitlevel', telemetry_flush_every=2)
    base.update(kw)
    return FLConfig(**base)


def _sim(data, fl):
    k = fl.population_shards if fl.population_n else fl.n_devices
    return FLSimulator(fl, *data[k], device='cpu')


def _run(data, rounds=3, **kw):
    sim = _sim(data, _fl(**kw))
    return sim, sim.run(rounds)


def _same_records(a, b, skip=()):
    assert len(a.records) == len(b.records)
    for ra, rb in zip(a.records, b.records):
        for f in ra._fields:
            if f in skip:
                continue
            x, y = getattr(ra, f), getattr(rb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                              err_msg=f)


def _same_history(ha, hb, skip=('round_time_s', 'alloc_time_s')):
    for f, va in ha.as_dict().items():
        if f not in skip:
            np.testing.assert_array_equal(np.asarray(va),
                                          np.asarray(getattr(hb, f)),
                                          err_msg=f)


CONFIGS = {
    'bitlevel': dict(),
    'retx_low_power': dict(transport='spfl_retx', tx_power_dbm=-40.0),
    'bernoulli_packed': dict(channel='bernoulli'),
    'analytic_last_local': dict(wire='analytic', channel='bernoulli',
                                compensation='last_local'),
    'seeded_random': dict(compensation='seeded_random'),
    'zeros': dict(compensation='zeros'),
    'signflip_screen_dropout': dict(n_devices=8, attack='signflip',
                                    screen=True, dropout_rate=0.25),
    'benign_screen': dict(screen=True, min_participation=0.5),
    'scaled_per_round': dict(attack='scaled', screen=True,
                             allocation_cadence='per_round'),
    'population': dict(population_n=1000, cohort_size=K,
                       population_shards=SHARDS, attack='signflip',
                       cohort_sampler='availability'),
    'alternating': dict(allocator='alternating', allocation_max_iters=1),
}


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_scan_equals_eager(data, name):
    """Every record field, the history and the parameters of 'scan' equal
    'eager''s bit for bit (same body, one graph a segment against one a
    round)."""
    kw = CONFIGS[name]
    se, he = _run(data, round_fusion='eager', **kw)
    ss, hs = _run(data, round_fusion='scan', **kw)
    assert torch.equal(se.params, ss.params)
    assert torch.equal(se.gbar, ss.gbar)
    _same_records(se, ss)
    _same_history(he, hs)
    assert len(hs.loss) == 2 and hs.alloc_time_s == [0.0] * 3
    assert all(np.isfinite(hs.loss))


@pytest.mark.parametrize('transport', ['error_free', 'dds', 'scheduling',
                                       'onebit'])
@pytest.mark.parametrize('mode', ['eager', 'scan'])
def test_non_allocating_fused_run_is_the_host_loop(data, transport, mode):
    """A fused run of a transport that solves nothing draws what the host
    loop draws and equals it bit for bit: records, parameters and ḡ (the
    history's evaluations differ only in where they fall)."""
    kw = dict(transport=transport, channel='bitlevel')
    host, hh = _run(data, rounds=4, **kw)
    fused, hf = _run(data, rounds=4, round_fusion=mode, **kw)
    assert torch.equal(host.params, fused.params)
    assert torch.equal(host.gbar, fused.gbar)
    _same_records(host, fused, skip=('round_idx',))
    assert [int(r.round_idx) for r in fused.records] == [0, 1, 2, 3]
    assert hh.payload_bits == hf.payload_bits
    # the host loop evaluates every round, the fused run at boundaries
    assert hf.loss == [hh.loss[1], hh.loss[3]]


def _host_with_f32_solve(sim):
    """The host loop's step 2 replaced by the fused round's float32 solve
    (same (q, p) as the fused run)."""
    def solve(grads, gains, p_w=None):
        if gains is not None:
            gains = torch.as_tensor(gains, dtype=torch.float64)
        return sim._solve_f32(grads, gains, p_w)
    sim._solve = solve
    return sim


@pytest.mark.parametrize('kw', [
    dict(), dict(transport='spfl_retx', tx_power_dbm=-40.0),
    dict(allocation_cadence='per_round', attack='signflip', screen=True,
         dropout_rate=0.25)], ids=['spfl', 'retx', 'per_round_adversary'])
def test_allocating_fused_run_is_the_host_loop_given_its_q_p(data, kw):
    """spfl/spfl_retx fused differ from the host loop only through the
    float32 solve: the host loop handed the same (q, p) gives every record
    field and the parameters bit for bit."""
    fl = _fl(**kw)
    host = _host_with_f32_solve(_sim(data, fl))
    host.run(3)
    fused = _sim(data, dataclasses.replace(fl, round_fusion='scan'))
    fused.run(3)
    assert torch.equal(host.params, fused.params)
    _same_records(host, fused, skip=('round_idx',))


def test_fused_spfl_differs_from_host_loop_only_in_the_solve(data):
    """Without the swap, the fused spfl run's integers (packets, flips,
    payload) and its f32 (q, p) are the host loop's f64 ones up to
    float32 rounding at this operating point."""
    kw = dict(transport='spfl_retx', tx_power_dbm=-40.0)
    host, hh = _run(data, **kw)
    fused, hf = _run(data, round_fusion='scan', **kw)
    np.testing.assert_allclose(hf.q_mean, hh.q_mean, rtol=1e-5)
    np.testing.assert_allclose(hf.p_mean, hh.p_mean, rtol=1e-5)
    assert hf.payload_bits[0] == hh.payload_bits[0]


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Host reads of a tensor raise (the CPU twin of
    ``jax.transfer_guard('disallow')``)."""
    def refuse(*_, **__):
        raise AssertionError('a host read inside a fused segment')
    with monkeypatch.context() as m:
        for name in ('item', 'tolist', 'cpu', 'numpy'):
            m.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize('kw', [
    dict(), dict(allocator='alternating', allocation_max_iters=1),
    dict(transport='error_free'), dict(attack='signflip', screen=True,
                                        dropout_rate=0.25)],
    ids=['uniform', 'alternating_gate', 'error_free', 'adversary'])
@pytest.mark.parametrize('mode', ['eager', 'scan'])
def test_a_segment_makes_no_host_read(data, monkeypatch, kw, mode):
    """The launch of every segment (its upload and rounds) runs with host
    reads made to raise; the alternating allocator's round-0 guard is the
    solver's gate (round 0 uniform: 0 iterations; round 1 solves)."""
    sim = _sim(data, _fl(round_fusion=mode, **kw))
    entered = []

    def guard():
        entered.append(1)
        return _no_host_reads(monkeypatch)
    sim.segment_guard = guard
    hist = sim.run(3)
    assert len(entered) == 2 and len(sim.records) == 3
    if kw.get('allocator') == 'alternating':
        assert hist.alloc_iters[0] == 0.0 and hist.alloc_iters[1] >= 1.0


@pytest.mark.parametrize('flush,seg,rounds,segments', [
    (2, 0, 5, [2, 2, 1]), (8, 0, 3, [3]), (2, 3, 5, [3, 2]),
    (1, 0, 2, [1, 1])])
def test_ring_flushes_across_ragged_segments(data, tmp_path, flush, seg,
                                              rounds, segments):
    """Segments of ``scan_segment_rounds`` (default
    ``telemetry_flush_every``) with a ragged tail: every round's record
    flushed once, in order, to the history and the sink; one evaluation a
    segment; round times the segment's wall time over its rounds."""
    path = tmp_path / 't.jsonl'
    sim = _sim(data, _fl(round_fusion='scan', telemetry_flush_every=flush,
                         scan_segment_rounds=seg, telemetry_path=str(path)))
    hist = sim.run(rounds)
    assert [int(r.round_idx) for r in sim.records] == list(range(rounds))
    assert len(hist.loss) == len(segments) == len(hist.test_acc)
    assert len(hist.payload_bits) == rounds == len(hist.round_time_s)
    start = 0
    for m in segments:
        assert len(set(hist.round_time_s[start:start + m])) == 1
        start += m
    from repro_torch.obs import sink
    manifest, rows = sink.read_jsonl(str(path))
    assert [r['round'] for r in rows] == list(range(rounds))
    assert manifest['round_fusion'] == 'scan'
    # a second run goes on from the simulator's round
    sim.run(1)
    assert int(sim.records[-1].round_idx) == rounds


def test_warm_up_leaves_no_trace(data):
    """The capture's warm-up round runs on scratch copies: a fused run of
    one round equals the host loop's first round (error_free, bit for
    bit), so no generator moved and no carry changed."""
    host, _ = _run(data, rounds=1, transport='error_free')
    fused, _ = _run(data, rounds=1, transport='error_free',
                    round_fusion='eager')
    assert torch.equal(host.params, fused.params)
    assert torch.equal(host.gen.get_state(), fused.gen.get_state())
    assert torch.equal(host.host_gen.get_state(),
                       fused.host_gen.get_state())


@pytest.mark.parametrize('fl_kw,run_kw,match', [
    (dict(round_fusion='scan'), dict(compute_bound=True), 'compute_bound'),
    (dict(round_fusion='eager', allocation_backend='numpy'), {},
     "allocation_backend='jax'"),
    (dict(round_fusion='loop'), {}, 'none|eager|scan')])
def test_refusals(data, fl_kw, run_kw, match):
    """The reference's refusals, with its messages: the Theorem-1 bound,
    the host solver on an allocating transport, an unknown mode."""
    sim = _sim(data, _fl(**fl_kw))
    with pytest.raises(ValueError, match=match):
        sim.run(1, **run_kw)


def test_only_the_sharded_collective_is_not_yet_ported():
    """The host loop runs every knob ('sharded' as 'gather', as the
    reference's loop does); the sharded collective is ported on the
    LLM-scale step too: it builds with a mesh and refuses only a missing
    one, as the reference does, and so do its fused rounds."""
    assert fl_loop._NOT_YET == ()
    for mode in ('eager', 'scan'):
        fl_loop.check_supported(FLConfig(round_fusion=mode,
                                         allocation_backend='jax'))
    fl_loop.check_supported(FLConfig(collective='sharded'))
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import distributed
    cfg = get_arch('smollm-135m-reduced')
    with pytest.raises(ValueError, match='needs the mesh'):
        distributed.make_fl_train_step(cfg, FLConfig(collective='sharded'))
    with pytest.raises(ValueError, match='needs the mesh'):
        distributed.make_fused_fl_round(
            cfg, FLConfig(collective='sharded', allocation_backend='jax'))
    assert callable(distributed.make_fused_fl_round(
        cfg, FLConfig(collective='sharded', allocation_backend='jax'),
        mesh=make_host_mesh()))


def test_fused_rounds_take_deterministic_cudnn(data):
    """Fused rounds run the gradient pass under deterministic cuDNN (a
    replay must equal an eager round bit for bit on the card); the host
    loop does not set it unless asked and leaves the process-wide flag as
    the caller set it, and the flag is restored after each pass that
    sets it."""
    before = torch.backends.cudnn.deterministic
    assert _sim(data, _fl(round_fusion='scan')).deterministic
    host = _sim(data, _fl())
    assert not host.deterministic
    seen = []
    host._client_grads = lambda *a: seen.append(
        torch.backends.cudnn.deterministic) or (torch.zeros(1),
                                                torch.zeros(1))
    try:
        for caller in (True, False):
            torch.backends.cudnn.deterministic = caller
            host.client_grads(host.params)
            assert torch.backends.cudnn.deterministic == caller
        host.deterministic = True
        host.client_grads(host.params)
        assert not torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = before
    assert seen == [True, False, True]


def test_a_later_run_reuses_the_buffers_and_goes_on(data):
    """A later fused run keeps the first one's buffers (on the card its
    graphs too) and goes on from its round: runs of 2 and 2 rounds give
    one run of 4's records and parameters bit for bit (segments of 2).
    The carry is the simulator's own tensor throughout; assigning
    ``sim.params`` copies into it."""
    one = _sim(data, _fl(round_fusion='scan'))
    one.run(4)
    two = _sim(data, _fl(round_fusion='scan'))
    params, gbar = two.params, two.gbar
    two.run(2)
    state = two._fused
    two.run(2)
    assert two._fused is state
    assert two.params is params and two.gbar is gbar
    assert torch.equal(one.params, two.params)
    assert torch.equal(one.gbar, two.gbar)
    _same_records(one, two)
    two.params = torch.zeros_like(params)
    assert two.params is params and not bool(params.any())
