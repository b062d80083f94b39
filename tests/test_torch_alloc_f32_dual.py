"""The float32 eq. (28) solve's dual search, port against reference, on a
main-path problem: round 1 of the fused 'scan' run at full width (K = 20,
the paper's CNN, packed, bit-level, alternating, ``max_iters`` 6), kept
exactly by ``chip_smoke.py`` phase 10 (``fused-f32 round 1 problem``,
with the kernel's iterations, exit reason and trip counts) in
``tests/data/fused_f32_problem_k20.json``.

The port's plain version (``allocation_jax.solve_plain``, which the
``alloc_solve_f32`` kernel equals bit for bit on the card) and the
reference's ``solve_traceable`` (jitted, float32, on the CPU) run with
their dual searches recorded: the carry after every step of the bracket
growth (hi, need) and of the bisection (lo, hi), and the constraint sum
sum(beta(lambda)) each step tested.  ``repro.core.allocation_jax``
imports ``enable_x64`` from ``jax.experimental``, which the installed jax
no longer has: the ``RAJ`` fixture lends it ``jax.enable_x64`` while it
imports the module (the float32 solve never enters it) and takes both
back after this file's tests, so no other test sees them.

First test: the same iterations and exit reason as each other and as the
kernel on the card, and every carry of all 16 dual searches bit for bit;
the constraint sums within rtol ``SUM_RTOL`` (1e-3: the two sides' float32
golden sections round apart, never across the test); the solutions
within the f32 contract (objective rtol 1e-4, q/p atol 5e-3,
``tests/test_torch_allocation_jax_f32.py``).

Second test: why the float32 solve leaves the kernel's spine.  On this
problem the constraint is not met at any price in float64: each growth
runs to the 1e30 cap and every bisection midpoint is infeasible (the
spine), its bracket frozen only once float64 runs out of bits.  In
float32 each growth stops a decade early, at float32(1e29), where the
rounded objective is dominated by lambda * beta; its bisection then
turns feasible at some midpoints (off the spine) and its bracket stops
moving within ``F32_FROZEN`` (24) steps: every later step of the 60
tests the same price again.
"""
import importlib
import json
import pathlib
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import allocation_jax as AJ

DATA = pathlib.Path(__file__).parent / 'data' / 'fused_f32_problem_k20.json'
SUM_RTOL = 1e-3
F32_FROZEN = 24
F32 = dict(obj_rtol=1e-4, qp_atol=5e-3)


@pytest.fixture(scope='module')
def RAJ():
    """``repro.core.allocation_jax``, imported with ``enable_x64`` lent
    to ``jax.experimental``; afterwards the loan, the module and the
    package's attribute are taken back (other tests see the import fail
    as before)."""
    lent = not hasattr(jax.experimental, 'enable_x64')
    if lent:
        jax.experimental.enable_x64 = jax.enable_x64
    name = 'repro.core.allocation_jax'
    loaded = name in sys.modules
    try:
        yield importlib.import_module(name)
    finally:
        if lent:
            del jax.experimental.enable_x64
        if not loaded:
            sys.modules.pop(name, None)
            core = sys.modules.get('repro.core')
            if core is not None and hasattr(core, 'allocation_jax'):
                delattr(core, 'allocation_jax')


@pytest.fixture(scope='module')
def kept():
    rec = json.loads(DATA.read_text())
    fields = {f: torch.tensor(rec[f], dtype=torch.float32)
              for f in AJ.JaxAllocationProblem._fields if f in rec}
    return rec, AJ.JaxAllocationProblem(**fields)


def _port(prob, method, max_iters):
    """The port's plain solve with its dual search recorded."""
    rec = []
    fori, msum = AJ._bounded_fori, AJ._msum

    def sums(P, x):
        s = msum(P, x)
        rec.append(('sum', float(s.reshape(-1)[0])))
        return s

    def loop(n, body, init, stop, early_exit):
        if n not in (AJ.GROW_STEPS, AJ.BISECT_STEPS):
            return fori(n, body, init, stop, early_exit)

        def step(i, carry):
            new = body(i, carry)
            rec.append((n, float(new[0].reshape(-1)[0]),
                        float(new[1].reshape(-1)[0])))
            return new
        return fori(n, step, init, stop, early_exit)

    AJ._bounded_fori, AJ._msum = loop, sums
    try:
        sol = AJ.solve_plain(prob, method, max_iters=max_iters)
    finally:
        AJ._bounded_fori, AJ._msum = fori, msum
    return sol, rec


def _reference(RAJ, prob, method, max_iters):
    """The reference's jitted float32 solve with its dual search recorded
    (ordered host callbacks from inside the trace)."""
    rec = []
    fori, msum = RAJ._bounded_fori, RAJ._msum

    def sums(P, x):
        s = msum(P, x)
        jax.debug.callback(lambda v: rec.append(('sum', float(v))), s,
                           ordered=True)
        return s

    def loop(n, body, init, stop, early_exit):
        if n not in (AJ.GROW_STEPS, AJ.BISECT_STEPS):
            return fori(n, body, init, stop, early_exit)

        def step(i, carry):
            new = body(i, carry)
            jax.debug.callback(
                lambda a, b, n=n: rec.append((n, float(a), float(b))),
                new[0], new[1], ordered=True)
            return new
        return fori(n, step, init, stop, early_exit)

    RAJ._bounded_fori, RAJ._msum = loop, sums
    try:
        rp = RAJ.JaxAllocationProblem(*[
            None if x is None else jnp.asarray(x.numpy()) for x in prob])
        solve = jax.jit(RAJ.solve_traceable, static_argnames=RAJ._STATIC)
        sol = jax.block_until_ready(solve(rp, method, max_iters=max_iters))
        jax.effects_barrier()
    finally:
        RAJ._bounded_fori, RAJ._msum = fori, msum
    return sol, rec


def _steps(rec):
    """(loop trips, carry 0, carry 1, the last constraint sum before) a
    step of the dual search."""
    out, last = [], None
    for r in rec:
        if r[0] == 'sum':
            last = r[1]
        else:
            out.append((r[0], r[1], r[2], last))
    return out


def _duals(kinds):
    """[start, end) of each dual search: a growth run, then bisection."""
    starts = [i for i, k in enumerate(kinds) if k == AJ.GROW_STEPS
              and (i == 0 or kinds[i - 1] == AJ.BISECT_STEPS)]
    return list(zip(starts, starts[1:] + [len(kinds)]))


@pytest.fixture(scope='module')
def port_f32(kept):
    rec, prob = kept
    return _port(prob, rec['method'], rec['max_iters'])


def _brackets(steps):
    return [s[:3] for s in steps]


def test_f32_dual_search_is_the_references(RAJ, kept, port_f32):
    """Iterations, exit reason and every carry of the dual searches bit
    for bit; constraint sums within ``SUM_RTOL``; the solutions within
    the f32 contract."""
    rec, prob = kept
    got, got_rec = port_f32
    ref, ref_rec = _reference(RAJ, prob, rec['method'], rec['max_iters'])
    assert int(got.iters) == int(ref.iters) == rec['iters']
    assert int(got.exit_reason) == int(ref.exit_reason) == rec['exit_reason']
    mine, theirs = _steps(got_rec), _steps(ref_rec)
    assert _brackets(mine) == _brackets(theirs)
    assert len(_duals([s[0] for s in mine])) == rec['trips']['dual']
    np.testing.assert_allclose([s[3] for s in mine], [s[3] for s in theirs],
                               rtol=SUM_RTOL, atol=0)
    assert float(got.objective) == pytest.approx(float(ref.objective),
                                                 rel=F32['obj_rtol'])
    for name in ('q', 'p'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=F32['qp_atol'])


def _shape(steps):
    """Per dual search: (growth steps, final hi, bisection pattern: 'I' a
    midpoint infeasible (lo moves), 'F' feasible (hi moves), '=' the
    bracket unchanged)."""
    kinds = [s[0] for s in steps]
    out = []
    for start, end in _duals(kinds):
        grow = [s for s in steps[start:end] if s[0] == AJ.GROW_STEPS]
        lo, hi = 0.0, grow[-1][1]
        marks = ''
        for _, lo2, hi2, _ in steps[start + len(grow):end]:
            marks += ('=' if (lo2, hi2) == (lo, hi) else
                      'I' if hi2 == hi else 'F')
            lo, hi = lo2, hi2
        out.append((len(grow), grow[-1][1], marks))
    return out


def test_f32_dual_search_leaves_the_spine_where_f64_keeps_it(kept,
                                                            port_f32):
    """The float64 solve of the same problem grows every bracket to the
    1e30 cap and keeps every midpoint infeasible; the float32 one stops
    growing at float32(1e29), turns feasible at some midpoints and
    freezes its bracket within ``F32_FROZEN`` steps."""
    rec, prob = kept
    p64 = prob._replace(**{f: getattr(prob, f).double()
                           for f in prob._fields
                           if getattr(prob, f) is not None})
    _, rec64 = _port(p64, rec['method'], rec['max_iters'])
    f32, f64 = _shape(_steps(port_f32[1])), _shape(_steps(rec64))
    assert len(f32) == len(f64) == rec['trips']['dual']
    cap32 = float(torch.tensor(1e29, dtype=torch.float32))
    for (g32, hi32, m32), (g64, hi64, m64) in zip(f32, f64):
        assert g64 == AJ.GROW_STEPS and hi64 >= 1e30 * (1 - 1e-15)
        assert set(m64.rstrip('=')) == {'I'}
        assert g32 == AJ.GROW_STEPS and hi32 == cap32
        assert 'F' in m32 and m32.index('=') <= F32_FROZEN
        assert set(m32[m32.index('='):]) == {'='}
    print(f'float32: {f32[0]}; float64: {f64[0]}')
