"""The port's eq. (28) engine as an engine, on the CPU through the plain
version: a batched solve equals a loop of single solves bit for bit, a
ragged padded batch equals the unpadded solves bit for bit, the early
exit equals the fixed-trip loops bit for bit, and the simulator runs
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
    assert not any('item 7' in message for _, message in fl_loop._NOT_YET)
    # population mode runs on the 'jax' backend only
    fl_loop.check_supported(FLConfig(allocation_backend='jax',
                                     population_n=100))
    with pytest.raises(ValueError, match="allocation_backend='jax'"):
        fl_loop.check_supported(FLConfig(population_n=100))
    with pytest.raises(NotImplementedError, match='item 11'):
        fl_loop.check_supported(FLConfig(allocation_backend='jax',
                                         round_fusion='scan'))
    with pytest.raises(ValueError, match='allocation_backend'):
        fl_loop.check_supported(FLConfig(allocation_backend='cvx'))
    assert dataclasses.asdict(FLConfig())['allocation_backend'] == 'numpy'
