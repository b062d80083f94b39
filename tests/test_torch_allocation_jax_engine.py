"""The port's eq. (28) engine as an engine, on the CPU through the plain
version: a batched solve equals a loop of single solves bit for bit, a
ragged padded batch equals the unpadded solves bit for bit, the early
exit equals the fixed-trip loops bit for bit (and the dual bisection's
frozen exit its fixed 60 trips, in float64 and float32), and the
simulator runs
with ``allocation_backend='jax'`` (its round against the 'numpy'
backend's is in ``test_torch_allocation_jax_exits.py``, for time)."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_allocation_jax import problems
from repro_torch.configs.base import FLConfig
from repro_torch.core import allocation_jax as AJ
from repro_torch.training import fl_loop
from repro_torch.training.fl_loop import build_simulator

K, PER_DEVICE = 4, 16


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """Small tensors: one intra-op thread (the suite runs in several
    workers, and more threads only contend), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(got, want, k=None):
    """Every output of two solves equal bit for bit (NaN where NaN), on
    the first ``k`` clients."""
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if k is not None and name in ('alpha', 'beta', 'q', 'p'):
            a = a[..., :k]
        assert a.dtype == b.dtype, name
        assert torch.equal(a.nan_to_num(123.0), b.nan_to_num(123.0)), name
        assert torch.equal(a.isnan(), b.isnan()), name


# ---------------------------------------------------------------------------
# (b) batching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('method,max_iters', [('alternating', 1),
                                              ('barrier', 2)])
def test_batches_equal_single_solves_bit_for_bit(method, max_iters):
    """A ragged batch (zero-padded to K = 6 with a mask) equals the single,
    unpadded solves; so does a batch of one size (no mask), checked on
    the barrier method, whose solves cost less on the CPU (the
    alternating batch has two problems)."""
    probs = [problems(4, -10.0, 5)[1], problems(6, -22.0, 6)[1]]
    if method == 'barrier':
        probs.append(problems(4, -30.0, 7)[1])
    singles = [AJ.solve_traceable(AJ.from_reference(p, device='cpu'),
                                  method, max_iters=max_iters)
               for p in probs]
    if method == 'barrier':
        same = AJ.stack_problems([probs[0], probs[2]], device='cpu')
        assert same.mask is None
        sol = AJ.solve_batched(same, method, max_iters=max_iters)
        for i, one in zip((0, 1), (singles[0], singles[2])):
            assert_same(AJ.JaxAllocation(*(x[i] for x in sol)), one)
    ragged = AJ.stack_problems(probs, device='cpu')
    assert ragged.mask is not None and tuple(ragged.A.shape) == (len(probs),
                                                                 6)
    sol = AJ.solve_batched(ragged, method, max_iters=max_iters)
    for i, (p, one) in enumerate(zip(probs, singles)):
        assert_same(AJ.JaxAllocation(*(x[i] for x in sol)), one, p.n)


# ---------------------------------------------------------------------------
# (c) the early exit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('method,max_iters', [('barrier', 2),
                                              ('alternating', 1)])
def test_early_exit_equals_the_fixed_trip_loops(method, max_iters):
    prob = AJ.from_reference(problems(4, -18.0, 9)[1], device='cpu')
    early = AJ.solve_traceable(prob, method, max_iters=max_iters,
                               early_exit=True)
    fixed = AJ.solve_traceable(prob, method, max_iters=max_iters,
                               early_exit=False)
    assert_same(early, fixed)


@pytest.fixture
def bisections(monkeypatch):
    """Count the trips of every dual bisection loop of the plain version
    (``_dual``'s ``_bounded_fori`` of BISECT_STEPS), and with ``fixed``
    set run them as their fixed-trip form: no frozen exit, every frozen
    trip run.  -> a dict: 'trips' (one entry a loop), 'fixed'."""
    fori = AJ._bounded_fori
    out = {'trips': [], 'fixed': False}

    def loop(n, body, init, stop, early_exit):
        if n != AJ.BISECT_STEPS:
            return fori(n, body, init, stop, early_exit)
        out['trips'].append(0)

        def counted(i, carry):
            out['trips'][-1] += 1
            return body(i, carry)
        return fori(n, counted, init, stop, early_exit and not out['fixed'])

    monkeypatch.setattr(AJ, '_bounded_fori', loop)
    return out


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('method', AJ.METHODS)
def test_frozen_bisection_exit_changes_no_output_bit(bisections, method,
                                                     dtype):
    """A ragged batch (K = 4 and 6, zero-padded; the eq. (27)
    coefficients scaled by 1e6, which puts the dual price within a
    decade of the bracket's top, so that a float64 bracket freezes
    within the 60 trips too): every output of the solve with the dual
    bisection's frozen exit equals that of its fixed-trip form bit for
    bit; on the alternating method the exit leaves every bisection
    before its 60th trip (float32 brackets within ~28, float64 ones
    within ~57)."""
    probs = [problems(4, -10.0, 5)[1], problems(6, -22.0, 6)[1]]
    batch = AJ.stack_problems(probs, dtype=dtype, device='cpu')
    batch = batch._replace(**{f: getattr(batch, f) * 1e6 for f in 'ABCD'})
    early = AJ.solve_batched(batch, method, max_iters=1)
    bisections['fixed'] = True
    fixed = AJ.solve_batched(batch, method, max_iters=1)
    assert_same(early, fixed)
    n = len(bisections['trips']) // 2
    if method == 'alternating':
        assert n > 0 and bisections['trips'][n:] == [AJ.BISECT_STEPS] * n
        assert max(bisections['trips'][:n]) < (
            30 if dtype == torch.float32 else AJ.BISECT_STEPS)
    else:
        assert n == 0


# ---------------------------------------------------------------------------
# (g) the simulator with the jax backend
# ---------------------------------------------------------------------------

def test_jax_backend_runs_and_refuses_the_bound():
    fl = FLConfig(n_devices=K, wire='packed', channel='bitlevel',
                  allocation_backend='jax', allocator='barrier',
                  allocation_max_iters=1)
    sim = build_simulator(fl, per_device=PER_DEVICE, n_test=64,
                          device='cpu')
    with pytest.raises(ValueError, match='compute_bound'):
        sim.run(1, compute_bound=True)
    hist = sim.run(2)
    assert all(np.isfinite(hist.loss)) and len(sim.records) == 2
    assert hist.alloc_iters == [0.0, 1.0]
    assert all(np.isfinite(hist.q_mean)) and all(np.isfinite(hist.p_mean))


def test_check_supported_takes_the_jax_backend():
    fl_loop.check_supported(FLConfig(allocation_backend='jax'))
    assert not hasattr(fl_loop, '_NOT_YET')   # nothing is left unported
    # population mode runs on the 'jax' backend only
    fl_loop.check_supported(FLConfig(allocation_backend='jax',
                                     population_n=100))
    with pytest.raises(ValueError, match="allocation_backend='jax'"):
        fl_loop.check_supported(FLConfig(population_n=100))
    # fused rounds run on the 'jax' backend (ROADMAP Queue 1 item 11)
    fl_loop.check_supported(FLConfig(allocation_backend='jax',
                                     round_fusion='scan'))
    with pytest.raises(ValueError, match='allocation_backend'):
        fl_loop.check_supported(FLConfig(allocation_backend='cvx'))
    assert dataclasses.asdict(FLConfig())['allocation_backend'] == 'numpy'
