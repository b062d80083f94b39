"""The float32 contract of the port's eq. (28) engine (plain version, on
the CPU): the f32 trace with the f32-safe caps (``allocation_jax._caps``)
against the reference's float64 NumPy solver, on method x K in {4, 8} x
power in {-4, -24} dBm at ``max_iters=3`` (a cut of the reference's
24-cell grid, ``src/repro/core/README.md`` "f32 solve_traceable
contract"): objective rtol 1e-4, q/p atol 5e-3, alpha/beta atol 5e-2,
everything finite.  Each method's four problems are one ragged float32
batch."""
import numpy as np
import pytest
import torch

from test_torch_allocation_jax import grid, row
from repro.core import allocation as RA
from repro_torch.core import allocation_jax as AJ

F32 = dict(obj_rtol=1e-4, qp_atol=5e-3, ab_atol=5e-2)


@pytest.mark.parametrize('method', ['alternating', 'barrier'])
def test_f32_trace_within_its_contract(method):
    pairs = grid((-4.0, -24.0))
    batch = AJ.stack_problems([p for _, p in pairs], dtype=torch.float32,
                              device='cpu')
    assert batch.A.dtype == torch.float32
    sol = AJ.solve_batched(batch, method, max_iters=3)
    assert sol.q.dtype == torch.float32
    for i, (rp, _) in enumerate(pairs):
        ref = RA.solve(rp, method, max_iters=3)
        got = row(sol, i, rp.n)
        for name in ('alpha', 'beta', 'q', 'p', 'objective'):
            assert np.isfinite(got[name]).all(), name
        assert float(got['objective']) == pytest.approx(
            ref.objective, rel=F32['obj_rtol'])
        for name in ('q', 'p'):
            np.testing.assert_allclose(got[name], getattr(ref, name),
                                       rtol=0, atol=F32['qp_atol'])
        for name in ('alpha', 'beta'):
            np.testing.assert_allclose(got[name], getattr(ref, name),
                                       rtol=0, atol=F32['ab_atol'])
