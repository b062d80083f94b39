"""The port's on-device eq. (28) engine (``repro_torch.core.allocation_jax``)
against the reference's NumPy solver, on the CPU through the plain version.

``repro.core.allocation_jax`` does not import under the installed jax, so
the oracle is the reference's host solver ``repro.core.allocation.solve``,
held to the engine-parity contract of ``src/repro/core/README.md``
("Precision / tolerance contract"; ``tests/test_allocation_jax.py``):

* alternating (SCA, contractive): objective rtol 1e-8, alpha/beta atol
  1e-4, q/p atol 1e-6, and the same ``iters_used`` and ``exit_reason``;
* barrier (~1000 PGD steps with discrete backtracking): objective rtol
  2e-5, alpha/beta atol 5e-3, q/p atol 1e-4;
* uniform: exact to rtol 1e-12.

Inputs are made with NumPy from a seed.  The parity grid is method x
K in {4, 8} x power in {-4, -14, -24, -34} dBm at ``max_iters=2``, each
method's problems solved in one ragged ``solve_batched`` call (zero
padded to K = 8); the alternating half at -14 and -24 dBm is in
``test_torch_allocation_jax_grid.py``, so that each file's host solves
take about as long.  Also here: the constructors against the reference's, and
the kernel wrapper's CPU path.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as RefFLConfig
from repro.core import allocation as RA
from repro_torch.configs.base import FLConfig
from repro_torch.core import allocation as PA
from repro_torch.core import allocation_jax as AJ
from repro_torch.kernels import ops

TOL = {
    'alternating': dict(obj_rtol=1e-8, ab_atol=1e-4, qp_atol=1e-6),
    'barrier': dict(obj_rtol=2e-5, ab_atol=5e-3, qp_atol=1e-4),
}
POWERS = (-4.0, -14.0, -24.0, -34.0)


def allocation_stats(k, power_dbm, seed, dim=60000):
    """Per-client stats, gains and budgets of one problem, made with NumPy
    from ``seed`` (the recipe of tests/test_allocation_jax.py, with the
    distances drawn uniformly in the 500 m annulus by NumPy)."""
    fl = dataclasses.replace(FLConfig(), tx_power_dbm=power_dbm)
    rng = np.random.RandomState(seed)
    u = rng.uniform(0.0, 1.0, k)
    dist = np.sqrt(10.0 ** 2 + (500.0 ** 2 - 10.0 ** 2) * u).astype(
        np.float32)
    gains = dist ** (-fl.path_loss_exp)
    p_w = np.full(k, fl.tx_power_w)
    g2 = np.abs(rng.randn(k)) + 0.2
    gb2 = np.abs(rng.randn(k)) * 0.4 + 0.05
    v = np.sqrt(g2 * gb2) * rng.uniform(0, 1, k)
    d2 = np.abs(rng.randn(k)) * 0.05
    return (g2, gb2, v, d2, gains, p_w, dim), fl


def problems(k, power_dbm, seed, dim=60000):
    """(reference host problem, port host problem) on the same inputs."""
    stats, fl = allocation_stats(k, power_dbm, seed, dim)
    ref_fl = RefFLConfig(**dataclasses.asdict(fl))
    return (RA.problem_from_stats(*stats, ref_fl),
            PA.problem_from_stats(*stats, fl))


def grid(powers):
    """The parity grid's problems for ``powers``: K in {4, 8}."""
    return [problems(k, p, seed=10 * k + int(-p))
            for k in (4, 8) for p in powers]


def row(sol, i, k):
    """Problem i of a batched JaxAllocation on its k real clients, as
    host arrays."""
    return {f: getattr(sol, f)[i][..., :k].numpy()
            if getattr(sol, f).dim() == 2 and f != 'objectives'
            else getattr(sol, f)[i].numpy() for f in sol._fields}


def assert_parity(ref, got, method, exits=True):
    """``got`` (a row) within the method's contract of ``ref`` (a host
    Allocation)."""
    tol = TOL[method]
    assert float(got['objective']) == pytest.approx(
        ref.objective, rel=tol['obj_rtol'], abs=1e-12)
    np.testing.assert_allclose(got['alpha'], ref.alpha, atol=tol['ab_atol'])
    np.testing.assert_allclose(got['beta'], ref.beta, atol=tol['ab_atol'])
    np.testing.assert_allclose(got['q'], ref.q, atol=tol['qp_atol'])
    np.testing.assert_allclose(got['p'], ref.p, atol=tol['qp_atol'])
    if exits:
        assert int(got['iters']) == ref.info['iters_used']
        assert int(got['exit_reason']) == ref.info['exit_reason']


def solve_grid(pairs, method, max_iters, **kw):
    """The reference's host solves and the port's one ragged batched
    solve of the same problems -> (refs, sol)."""
    refs = [RA.solve(r, method, max_iters=max_iters) for r, _ in pairs]
    batch = AJ.stack_problems([p for _, p in pairs], device='cpu', **kw)
    return refs, AJ.solve_batched(batch, method, max_iters=max_iters)


# ---------------------------------------------------------------------------
# (a) parity with the reference's NumPy solver
# ---------------------------------------------------------------------------

def test_alternating_parity_grid():
    """Alternating, powers -4 and -34 dBm, K in {4, 8}: one ragged batch."""
    pairs = grid(POWERS[::3])
    refs, sol = solve_grid(pairs, 'alternating', 2)
    for i, ((rp, _), ref) in enumerate(zip(pairs, refs)):
        assert_parity(ref, row(sol, i, rp.n), 'alternating')


def test_barrier_parity_grid():
    pairs = grid(POWERS)
    refs, sol = solve_grid(pairs, 'barrier', 2)
    for i, ((rp, _), ref) in enumerate(zip(pairs, refs)):
        assert_parity(ref, row(sol, i, rp.n), 'barrier', exits=False)
        assert np.isfinite(row(sol, i, rp.n)['objective'])


def test_uniform_is_exact():
    pairs = grid(POWERS)
    batch = AJ.stack_problems([p for _, p in pairs], device='cpu')
    sol = AJ.solve_batched(batch, 'uniform')
    for i, (rp, _) in enumerate(pairs):
        ref = RA.solve(rp, 'uniform')
        got = row(sol, i, rp.n)
        np.testing.assert_allclose(got['objective'], ref.objective,
                                   rtol=1e-12)
        for f in ('alpha', 'beta', 'q', 'p'):
            np.testing.assert_allclose(got[f], getattr(ref, f), rtol=1e-12,
                                       atol=0)
        assert int(got['iters']) == 0
        assert int(got['exit_reason']) == AJ.EXIT_CONVERGED
        assert np.isnan(got['objectives']).all()


def test_host_solve_matches_the_numpy_allocator():
    """``solve`` returns the host Allocation with the engine's info."""
    rp, pp = problems(4, -14.0, seed=3)
    ref = RA.solve(rp, 'barrier', max_iters=2)
    got = AJ.solve(pp, 'barrier', max_iters=2, device='cpu')
    assert got.info['backend'] == 'jax'
    assert got.info['iters_used'] == got.info['iters'] == 2
    assert len(got.info['objectives']) == 2
    assert_parity(ref, got._asdict() | {'iters': got.info['iters_used'],
                                        'exit_reason':
                                            got.info['exit_reason']},
                  'barrier')


# ---------------------------------------------------------------------------
# (f) the constructors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('k,power,seed', [(4, -14.0, 1), (8, -34.0, 2),
                                          (20, -4.0, 3)])
def test_problem_from_stats_matches_the_reference(k, power, seed):
    stats, fl = allocation_stats(k, power, seed)
    ref = RA.problem_from_stats(*stats, RefFLConfig(**dataclasses.asdict(fl)))
    got = AJ.problem_from_stats(*stats, fl, device='cpu')
    for name in 'ABCD':
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref.coef, name), rtol=1e-15,
                                   atol=0)
    np.testing.assert_array_equal(got.gains.numpy(), ref.gains)
    np.testing.assert_array_equal(got.p_w.numpy(), ref.p_w)
    assert float(got.sign_bits) == ref.sign_bits
    assert float(got.mod_bits) == ref.mod_bits
    for name in ('bandwidth_hz', 'noise_psd_w', 'latency_s', 'alpha_max'):
        assert float(getattr(got, name)) == getattr(ref.fl, name)
    assert got.mask is None and got.A.dtype == torch.float64


def test_solve_from_stats_solves_the_round_problem():
    """The training loop's path from the clients' scalars: the problem of
    ``problem_from_stats`` solved in one solver call."""
    stats, fl = allocation_stats(4, -14.0, 5)
    got = AJ.solve_from_stats(*stats, fl, method='barrier', max_iters=1,
                              device='cpu')
    want = AJ.solve_traceable(AJ.problem_from_stats(*stats, fl,
                                                    device='cpu'),
                              'barrier', max_iters=1)
    for a, b in zip(got, want):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    assert int(got.iters) == 1


def test_device_stats_stay_on_their_device():
    stats, fl = allocation_stats(4, -14.0, 0)
    g2 = torch.as_tensor(stats[0])
    got = AJ.problem_from_stats(g2, *stats[1:], fl)
    assert got.A.device == g2.device and got.gains.dtype == torch.float64


def test_stack_problems_pads_ragged_cohorts():
    _, p4 = problems(4, -14.0, 1)
    _, p6 = problems(6, -14.0, 2)
    batch = AJ.stack_problems([p4, p6], device='cpu')
    assert tuple(batch.A.shape) == (2, 6)
    np.testing.assert_array_equal(batch.mask.numpy(),
                                  [[1, 1, 1, 1, 0, 0], [1] * 6])
    np.testing.assert_array_equal(batch.A[0, 4:].numpy(), 0.0)
    np.testing.assert_array_equal(batch.gains[0, 4:].numpy(), 1.0)
    np.testing.assert_array_equal(batch.p_w[0, 4:].numpy(), 1.0)
    np.testing.assert_array_equal(batch.A[0, :4].numpy(), p4.coef.A)
    same = AJ.stack_problems([p4, p4], device='cpu')
    assert same.mask is None and tuple(same.sign_bits.shape) == (2,)
    with pytest.raises(ValueError):
        AJ.from_reference(p6, pad_to=4, device='cpu')


def test_batch_over_gains_repeats_everything_else():
    _, p4 = problems(4, -14.0, 1)
    one = AJ.from_reference(p4, device='cpu')
    gains = np.random.RandomState(0).uniform(1e-9, 1e-8, (3, 4))
    batch = AJ.batch_over_gains(one, gains)
    np.testing.assert_array_equal(batch.gains.numpy(), gains)
    for name in ('A', 'p_w', 'sign_bits', 'alpha_max'):
        for i in range(3):
            assert torch.equal(getattr(batch, name)[i], getattr(one, name))


def test_caps_follow_the_reference():
    assert AJ._caps(torch.float64) == (600.0, 500.0, -1e150, -745.0, 1e-8,
                                       1e-12)
    assert AJ._caps(torch.float32) == (80.0, 120.0, -3e38, -85.0, 1e-4,
                                       1e-6)


# ---------------------------------------------------------------------------
# (h) the kernel wrapper on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('method', ['uniform', 'barrier'])
def test_wrapper_runs_the_plain_version_on_cpu(method):
    _, p4 = problems(4, -14.0, 1)
    prob = AJ.from_reference(p4, device='cpu')
    ops.reset_launch_counts()
    got = ops.alloc_solve(prob, method, max_iters=1)
    want = AJ.solve_plain(prob, method, max_iters=1)
    for a, b in zip(got, want):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    assert ops.launch_counts['alloc_solve'] == 0
    assert AJ.solve_traceable(prob, method, max_iters=1).alpha.shape == (4,)


def test_wrapper_gate_picks_the_uniform_point():
    _, p4 = problems(4, -14.0, 1)
    prob = AJ.stack_problems([p4, p4], device='cpu')
    gate = torch.tensor([0.0, 1.0], dtype=torch.float64)
    got = ops.alloc_solve(prob, 'barrier', max_iters=1, gate=gate)
    uni = AJ.solve_batched(prob, 'uniform', max_iters=1)
    bar = AJ.solve_batched(prob, 'barrier', max_iters=1)
    for f in ('alpha', 'beta', 'q', 'p', 'objective', 'iters',
              'exit_reason'):
        assert torch.equal(getattr(got, f)[0], getattr(uni, f)[0]), f
        assert torch.equal(getattr(got, f)[1], getattr(bar, f)[1]), f
    nan = torch.tensor([float('nan')], dtype=torch.float64)
    one = AJ.from_reference(p4, device='cpu')
    got = ops.alloc_solve(one, 'barrier', max_iters=1, gate=nan)
    assert torch.equal(got.beta, AJ.solve_plain(one, 'uniform').beta)


def test_wrapper_refuses_unknown_methods_and_unbatched_batches():
    _, p4 = problems(4, -14.0, 1)
    prob = AJ.from_reference(p4, device='cpu')
    with pytest.raises(ValueError, match='method'):
        ops.alloc_solve(prob, 'newton')
    with pytest.raises(ValueError, match='batch'):
        AJ.solve_batched(prob, 'uniform')


def test_kernel_limits_are_read_from_the_source():
    limits = ops.alloc_limits()
    assert limits['MAX_K'] >= 1024 and limits['MAX_ITERS'] >= 6
    assert limits['N_TRIPS'] == len(ops.ALLOC_TRIPS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel path of alloc_solve')
    return torch.device('cuda')


def test_card_refuses_float32_and_wide_problems(card):
    """On the card the wrapper launches the kernel or raises: a float32
    problem launches the float32 instantiation (fused rounds) and equals
    its plain version bit for bit; a problem of mixed dtypes and a K above
    the kernel's limit raise, and nothing runs the plain version."""
    _, p4 = problems(4, -14.0, 1)
    f32 = AJ.from_reference(p4, dtype=torch.float32, device=card)
    ops.reset_launch_counts()
    got = ops.alloc_solve(f32, 'barrier', max_iters=1)
    assert ops.launch_counts['alloc_solve_f32'] == 1
    plain = AJ.solve_plain(f32, 'barrier', max_iters=1)
    for name in got._fields:
        assert torch.equal(getattr(got, name).nan_to_num(7.0),
                           getattr(plain, name).nan_to_num(7.0)), name
    with pytest.raises(TypeError, match='float64'):
        ops.alloc_solve(f32._replace(gains=f32.gains.double()), 'barrier')
    k = ops.alloc_limits()['MAX_K'] + 1
    wide = AJ.batch_over_gains(AJ.from_reference(p4, device=card),
                               np.ones((1, 4)))
    wide = AJ.JaxAllocationProblem(*(
        x.repeat(1, k // 4 + 1)[:, :k] if x.dim() == 2 else x
        for x in wide[:-1]))
    with pytest.raises(ValueError, match='clients'):
        ops.alloc_solve(wide, 'barrier')
    assert ops.launch_counts['alloc_solve'] == 0
