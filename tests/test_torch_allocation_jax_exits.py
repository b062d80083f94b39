"""Exit semantics and tolerance exits of the port's eq. (28) engine, on
the CPU through the plain version (``tests/test_allocation_jax.py``'s
``test_exit_reason_and_iters_semantics`` and
``test_inner_tol_frontier_within_contract``), and one round of the
simulator with ``allocation_backend='jax'`` beside the 'numpy' backend
given the same draws.  The reference's NumPy solver has no tolerance
exits, so ``inner_tol > 0`` is held to the port's own reference-faithful
solve (``inner_tol=0``) under the method's contract."""
import numpy as np
import pytest
import torch

from test_torch_allocation_jax import TOL, problems
from repro.core import allocation as RA
from repro_torch.configs.base import FLConfig
from repro_torch.core import allocation as PA
from repro_torch.core import allocation_jax as AJ
from repro_torch.core import transport
from repro_torch.training.fl_loop import build_simulator

K, PER_DEVICE = 4, 16


def test_exit_reason_and_iters_semantics():
    rp, pp = problems(6, -18.0, 31)
    prob = AJ.from_reference(pp, device='cpu')
    # uniform never iterates and always "converges"
    u = AJ.solve(pp, 'uniform', device='cpu')
    assert u.info['iters_used'] == 0
    assert u.info['exit_reason'] == AJ.EXIT_CONVERGED
    # a generous budget converges before the cap, as the host solver does
    sol = AJ.solve_traceable(prob, 'alternating', max_iters=8)
    iters = int(sol.iters)
    assert 0 < iters < 8
    assert int(sol.exit_reason) == AJ.EXIT_CONVERGED
    objs = sol.objectives.numpy()
    assert np.isfinite(objs[:iters]).all() and np.isnan(objs[iters:]).all()
    assert objs[iters - 1] == float(sol.objective)
    ref = RA.solve(rp, 'alternating', max_iters=8)
    assert ref.info['iters_used'] == iters
    assert ref.info['exit_reason'] == AJ.EXIT_CONVERGED
    np.testing.assert_allclose(objs[:iters], ref.info['objectives'],
                               rtol=TOL['alternating']['obj_rtol'])
    # a one-iteration budget cannot meet |prev - obj| with prev = inf;
    # its first iterate is the generous solve's
    capped = AJ.solve_traceable(prob, 'alternating', max_iters=1)
    assert int(capped.iters) == 1
    assert int(capped.exit_reason) in (AJ.EXIT_ITER_CAP,
                                       AJ.EXIT_UNIFORM_FALLBACK)
    assert float(capped.objectives[0]) == objs[0]
    # no iteration at all falls back to the uniform point
    none = AJ.solve_traceable(prob, 'barrier', max_iters=0)
    assert int(none.iters) == 0 and none.objectives.numel() == 0
    assert int(none.exit_reason) == AJ.EXIT_UNIFORM_FALLBACK
    assert torch.equal(none.beta, AJ.solve_traceable(prob, 'uniform').beta)


def test_nonfinite_problem_falls_back_to_uniform():
    """A NaN coefficient makes every objective NaN: no iterate is kept
    and the NaN-proof safeguard returns the uniform point."""
    _, pp = problems(4, -18.0, 32)
    prob = AJ.from_reference(pp, device='cpu')
    prob = prob._replace(A=prob.A.clone())
    prob.A[1] = float('nan')
    sol = AJ.solve_traceable(prob, 'barrier', max_iters=2)
    assert int(sol.iters) == 0
    assert int(sol.exit_reason) == AJ.EXIT_UNIFORM_FALLBACK
    assert np.isnan(sol.objectives.numpy()).all()
    uni = AJ.solve_traceable(prob, 'uniform')
    assert torch.equal(sol.alpha, uni.alpha)
    assert torch.equal(sol.beta, uni.beta)


@pytest.mark.parametrize('method', ['alternating', 'barrier'])
def test_inner_tol_frontier_within_contract(method):
    """inner_tol > 0 unlocks the tolerance exits (golden width, dual
    bisection, barrier displacement); the endpoint stays within the
    method's contract of the fixed-trip solve."""
    tol = TOL[method]
    batch = AJ.stack_problems([problems(4, -8.0, 41)[1],
                               problems(8, -26.0, 42)[1]], device='cpu')
    exact = AJ.solve_batched(batch, method, max_iters=3, inner_tol=0.0)
    fast = AJ.solve_batched(batch, method, max_iters=3, inner_tol=1e-6)
    np.testing.assert_allclose(fast.objective.numpy(),
                               exact.objective.numpy(),
                               rtol=tol['obj_rtol'], atol=1e-12)
    for name in ('q', 'p'):
        np.testing.assert_allclose(getattr(fast, name).numpy(),
                                   getattr(exact, name).numpy(), rtol=0,
                                   atol=tol['qp_atol'])


# ---------------------------------------------------------------------------
# (g) the round
# ---------------------------------------------------------------------------

def _round_pair(max_iters):
    """Two simulators on the same data, one per backend, run two rounds
    (round 0 is uniform: no compensation history) on the same draws."""
    out = {}
    for backend in ('jax', 'numpy'):
        fl = FLConfig(n_devices=K, wire='packed', channel='bitlevel',
                      allocation_backend=backend,
                      allocation_max_iters=max_iters)
        sim = build_simulator(fl, per_device=PER_DEVICE, n_test=64,
                              device='cpu')
        gen = torch.Generator().manual_seed(17)
        results = []
        for _ in range(2):
            draws = transport.make_draws(K, sim.dim, 0, fl.channel,
                                         torch.device('cpu'), gen, gen)
            results.append(sim.round_step(draws))
        out[backend] = (sim, results)
    return out


def _host_solve(sim, stats, max_iters):
    """The host solver on a round's stats (moved to the host)."""
    prob = PA.problem_from_stats(*(np.asarray(torch.as_tensor(stats[n]))
                                   for n in ('g2', 'gb2', 'v', 'd2')),
                                 sim.gains, sim.p_w, sim.dim, sim.fl)
    return prob, PA.solve(prob, 'alternating', max_iters=max_iters)


def test_jax_backend_round_matches_the_numpy_backend():
    """Round 0 is uniform on both; round 1 solves.  Across the backends
    q and p agree within 1e-6 and the solver's effort is the same; the
    objective within 1e-5 relative, because the 'numpy' backend sums
    ||gbar||^2 in float32 (as the reference's host path does) and C =
    L eta (||g||^2 - ||gbar||^2 + delta^2) cancels.  On each backend's
    own stats the two solvers meet the alternating contract."""
    pair = _round_pair(max_iters=1)
    (sim_j, res_j), (sim_n, res_n) = pair['jax'], pair['numpy']
    for rj, rn in zip(res_j, res_n):
        tj, tn = rj.telemetry, rn.telemetry
        np.testing.assert_allclose(tj.q.numpy(), tn.q.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tj.p.numpy(), tn.p.numpy(), rtol=0,
                                   atol=1e-6)
        # the solve's state stays on the device until to_host
        assert isinstance(tj.alloc_objective, torch.Tensor)
        host = tj.to_host()
        assert int(host.alloc_iters) == tn.alloc_iters
        assert int(host.alloc_exit_reason) == tn.alloc_exit_reason
        assert float(host.alloc_objective) == pytest.approx(
            tn.alloc_objective, rel=1e-5)
    assert int(res_j[0].telemetry.alloc_iters) == 0
    assert int(res_j[1].telemetry.alloc_iters) == 1
    tol = TOL['alternating']
    # the engine on the jax round's stats, the host solver on them
    _, ref = _host_solve(sim_j, res_j[1].stats, 1)
    sol = res_j[1].allocation
    assert float(sol.objective) == pytest.approx(ref.objective,
                                                 rel=tol['obj_rtol'])
    # the engine on the numpy round's stats, against that round
    prob, _ = _host_solve(sim_n, res_n[1].stats, 1)
    got = AJ.solve(prob, 'alternating', max_iters=1, device='cpu')
    want = res_n[1].allocation
    assert got.objective == pytest.approx(want.objective,
                                          rel=tol['obj_rtol'])
    for a, b in ((sol, ref), (got, want)):
        for name in ('q', 'p'):
            np.testing.assert_allclose(np.asarray(getattr(a, name)),
                                       getattr(b, name), rtol=0,
                                       atol=tol['qp_atol'])
    assert np.isfinite(sim_j.params.numpy()).all()
