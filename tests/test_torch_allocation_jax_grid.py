"""The rest of the alternating parity grid of
``test_torch_allocation_jax.py``: powers -14 and -24 dBm, K in {4, 8}, at
``max_iters=2``, one ragged batched solve of the plain version on the CPU
against the reference's NumPy solver, under the alternating contract
(objective rtol 1e-8, alpha/beta atol 1e-4, q/p atol 1e-6, the same
``iters_used`` and ``exit_reason``).  A file of its own: the reference's
host solves of the grid take ~40 s on one CPU core, shared out evenly
between the two files."""
from test_torch_allocation_jax import POWERS, assert_parity, grid, row, \
    solve_grid


def test_alternating_parity_grid_mid_power():
    pairs = grid(POWERS[1:3])
    refs, sol = solve_grid(pairs, 'alternating', 2)
    for i, ((rp, _), ref) in enumerate(zip(pairs, refs)):
        assert_parity(ref, row(sol, i, rp.n), 'alternating')
