"""The schedule of the ``alloc_solve`` kernel's speculative dual search
(``kernels/csrc/alloc_solve.cu``, ``sca``), held to the sequential dual
search of the plain version (``core.allocation_jax._dual``) on the CPU.

The kernel evaluates lam = 0 and the grow loop's prices ``nodes`` at a
time and the bisection's ``depth``-level subtree below its bracket at
once, walks what it evaluated as the sequential loops would, and takes
the final section from the round that evaluated its price.
``speculative_beta`` below is that schedule in plain Python, driven by
the same ``beta_of_lambda`` as the plain version's step
(``sequential_beta``: beta(0), then ``_dual``): the port's own golden
section of the SCA surrogate on a CPU problem (``golden_dual``), or a
made-up feasibility predicate that need not be monotone in the price
(the property test).  Both must give the same bits and take the same
number of golden sections on the sequential path.  The kernel's own constants are held to
the plain version's trip bounds, and the ``-Xptxas -v`` reader that
``chip_smoke.py`` fails a spilling build by is checked on a listing.
"""
import struct

import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.core import allocation_jax as AJ
from repro_torch.kernels import build, ops
from test_torch_allocation_jax import problems

F64 = dict(dtype=torch.float64)
# the kernel's layout: the groups that take a price and the levels of a
# round, tree_depth(nodes) = the deepest full subtree of at most nodes
LAYOUTS = [(n, max(d for d in range(1, 7) if 2 ** d - 1 <= n))
           for n in range(1, 7)] + [(2 ** d - 1, d) for d in range(3, 7)]


def speculative_beta(P, beta_of_lambda, early_exit: bool, inner_tol: float,
                     nodes: int, depth: int):
    """The kernel's SCA step from beta(0) to the dual's beta: -> (beta,
    golden sections of the sequential path, speculative golden sections
    off it, golden sections run)."""
    tol_exit = early_exit and inner_tol > 0.0
    seq = spec = ran = 0

    def run_round(prices):
        # one golden section a group, all of them before any is read
        nonlocal ran
        ran += len(prices)
        betas = [beta_of_lambda(torch.tensor([lam], **F64)) for lam in prices]
        return betas, [float(AJ._msum(P, b)) for b in betas]

    # position 0 is lam = 0, position 1 + i the grow loop's price p_i
    # (p_30, where its 30 steps end, only ever the final section)
    hi, lo, total = 1.0, 0.0, 0.0
    have = pending = False
    dual, fetched, pos = True, None, 0
    while pos <= AJ.GROW_STEPS + 1:
        n = min(nodes, AJ.GROW_STEPS + 2 - pos)
        prices = []
        for q in range(pos, pos + n):
            lam = 0.0 if q == 0 else 1.0
            for _ in range(q - 1):
                lam = lam * 10.0
            prices.append(lam)
        betas, sums = run_round(prices)
        used, stop = 0, False
        for j in range(n):
            q = pos + j
            if q == 0:
                used += 1
                seq += 1
                if not sums[0] > 1.0:
                    dual, fetched, stop = False, betas[0], True
                    break
                continue
            assert prices[j] == hi
            if q - 1 >= AJ.GROW_STEPS or not hi < 1e30:
                fetched, have, pending, stop = betas[j], True, True, True
                total = sums[j]
                used += 1
                break
            used += 1
            seq += 1
            if not sums[j] > 1.0:
                fetched, have, stop, total = betas[j], True, True, sums[j]
                break
            hi = hi * 10.0
        spec += n - used
        pos += n
        if stop:
            break
    if not dual:
        return fetched, seq, spec, ran
    # bisection: a full subtree of depth levels below (lo, hi) (group j
    # node j + 1 of the heap: children 2n infeasible, lo = mid, and
    # 2n + 1 feasible, hi = mid), or, while the walk keeps to the
    # infeasible side (the bracket's top infeasible too), a spine of L
    # nodes down that side (group i) and the feasible child of each but
    # the last (group L + i that of node i)
    step, spine = 0, have and total > 1.0
    while step < AJ.BISECT_STEPS:
        if tol_exit and hi - lo <= inner_tol * hi:
            break
        rem = AJ.BISECT_STEPS - step
        levels = min((nodes + 1) // 2 if spine else depth, rem)
        n = 2 * levels - 1 if spine else 2 ** levels - 1
        mids = []
        for g in range(n):
            l, h = lo, hi
            if spine:
                for _ in range(g - levels if g >= levels else g):
                    l = 0.5 * (l + h)
                if g >= levels:
                    h = 0.5 * (l + h)
            else:
                node = g + 1
                for bit in range(node.bit_length() - 2, -1, -1):
                    m = 0.5 * (l + h)
                    if (node >> bit) & 1:
                        h = m
                    else:
                        l = m
            mids.append(0.5 * (l + h))
        betas, sums = run_round(mids)
        g, lev, last, stop = 0, 0, -1, False
        while lev < levels and g >= 0:
            if lev > 0 and tol_exit and hi - lo <= inner_tol * hi:
                stop = True
                break
            seq += 1
            mid = 0.5 * (lo + hi)
            assert mid == mids[g]             # the walk reads what ran
            infeasible = sums[g] > 1.0
            if infeasible:
                lo = mid
            else:
                hi, last = mid, g
            if not spine:
                g = 2 * g + (1 if infeasible else 2)
            elif g + 1 >= levels:
                g = -1
            else:
                g = g + 1 if infeasible else levels + g
            lev += 1
        if last >= 0:
            # hi moved to a node's price: its betas are the final section's
            fetched, have, total = betas[last], True, sums[last]
            spec += pending
            pending = False
        spec += n - lev
        step += lev
        if stop:
            break
        spine = last < 0 and lev == levels
    if have:
        b = fetched
    else:
        b = beta_of_lambda(torch.tensor([hi], **F64))
        ran += 1
    seq += 1
    # a final section fetched from a walked node ran once for two uses
    assert ran == seq + spec - (have and not pending)
    scale = (1.0 / AJ._msum(P, b).clamp(min=1e-12)).clamp(max=1.0)
    return b * scale.reshape(-1, 1), seq, spec, ran


def sequential_beta(P, beta_of_lambda, early_exit, inner_tol):
    """The plain version's step (``optimize_beta_sca``'s, one problem):
    beta(0), and ``allocation_jax._dual`` where it breaks sum(beta) <= 1
    -> (beta, the prices of the golden sections it ran)."""
    prices = []

    def counted(lam):
        prices.append(float(lam.reshape(-1)[0]))
        return beta_of_lambda(lam)

    b = counted(torch.zeros(1, **F64))
    if float(AJ._msum(P, b)) > 1.0:
        b = AJ._dual(P, counted, torch.zeros(1, **F64), early_exit,
                     inner_tol)
    return b, prices


def golden_dual(scale: float, k: int = 4, golden_iters: int = 8):
    """(problem, beta_of_lambda) of one CPU problem: the port's SCA
    surrogate around the uniform point and its golden section (at
    ``golden_iters`` steps, to keep the CPU solves short).  Scaling the
    eq. (27) coefficients scales the surrogate against the price term:
    at 1e12 the grow loop takes eight steps, at 1e40 it runs all 30 to
    1e30 and every bisection step is infeasible."""
    _, p = problems(k, -14.0, 10 * k)
    prob = AJ.from_reference(p, device='cpu')
    P = AJ._lift(prob._replace(**{f: getattr(prob, f) * scale
                                  for f in 'ABCD'}))
    caps = AJ._caps(torch.float64)
    beta0 = torch.full((1, k), 1.0 / k, **F64)
    surrogate = AJ._surrogate(P, caps, torch.full((1, k), 0.5, **F64), beta0)

    def beta_of_lambda(lam):
        return AJ._golden_vec(lambda b: surrogate(b, lam.reshape(-1, 1)),
                              beta0, iters=golden_iters)

    assert float(AJ._msum(P, beta_of_lambda(torch.zeros(1, **F64)))) > 1.0
    return P, beta_of_lambda


@pytest.mark.parametrize('scale,capped', [(1e12, False), (1e40, True)])
@pytest.mark.parametrize('inner_tol', [0.0, 1e-7])
@pytest.mark.parametrize('nodes,depth', LAYOUTS)
def test_speculative_dual_is_the_sequential_dual(nodes, depth, inner_tol,
                                                 scale, capped):
    """Grow and tree walk at group counts 1-6 and depths 1-6, with and
    without the tolerance exit, the 1e30 cap reached and not: the same
    bits and the same sequential sections as ``_dual``."""
    P, bol = golden_dual(scale)
    want, prices = sequential_beta(P, bol, True, inner_tol)
    got, seq, spec, ran = speculative_beta(P, bol, True, inner_tol, nodes,
                                           depth)
    assert torch.equal(got, want)
    assert seq == len(prices)
    # capped: the grow loop priced 1e29, its 30th step
    assert (max(prices) >= 1e29) == capped
    if inner_tol == 0.0:
        assert seq >= AJ.BISECT_STEPS + 3 + (AJ.GROW_STEPS - 1) * capped
    if capped and inner_tol == 0.0:
        # every midpoint infeasible: hi stays p_30, whose section the
        # grow rounds ran, so the final section is never run again
        assert ran == seq + spec
        if nodes == 63:
            # one round of lam = 0, the 30 prices and p_30; the spine's 60
            # levels in two rounds of 32 + 31 and 28 + 27 sections
            assert ran == 32 + 63 + 55


def test_frozen_trips_do_not_change_the_schedule():
    """Without early exits (early_exit=False) the sequential loops run
    their frozen trips; the schedule's result is the same."""
    P, bol = golden_dual(1e12)
    want, _ = sequential_beta(P, bol, False, 1e-7)
    got, _, _, _ = speculative_beta(P, bol, False, 1e-7, 6, 2)
    assert torch.equal(got, want)


def predicate_dual(seed: int, p_infeasible: float, k: int = 3):
    """(problem, beta_of_lambda) whose feasibility at a price is a hash
    of the price's bits: no monotonicity at all."""
    P = AJ.JaxAllocationProblem(*(torch.ones((1, k), **F64) for _ in range(6)),
                                *(torch.ones((1, 1), **F64) for _ in range(6)),
                                None)

    def beta_of_lambda(lam):
        price = float(lam.reshape(-1)[0])
        bits = struct.unpack('<q', struct.pack('<d', price))[0]
        h = ((bits ^ seed) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        infeasible = (h >> 11) / float(1 << 53) < p_infeasible
        return torch.full((1, k), (0.5 if infeasible else 0.25)
                          + 1e-3 * (h & 7), **F64)

    return P, beta_of_lambda


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 62), p_infeasible=st.floats(0.0, 1.0),
       nodes=st.integers(1, 63), depth=st.integers(1, 6),
       inner_tol=st.sampled_from([0.0, 1e-12, 1e-6, 0.3]))
def test_walk_takes_the_sequential_bracket_of_any_predicate(
        seed, p_infeasible, nodes, depth, inner_tol):
    """A feasibility predicate that is not monotone in the price: the
    walk over the speculative rounds takes exactly the sequential
    bracket, so its result and its sequential section count are
    ``_dual``'s."""
    P, bol = predicate_dual(seed, p_infeasible)
    want, prices = sequential_beta(P, bol, True, inner_tol)
    got, seq, _, _ = speculative_beta(P, bol, True, inner_tol, nodes, depth)
    assert torch.equal(got, want)
    assert seq == len(prices)


def test_kernel_bounds_are_the_plain_versions():
    """The kernel's trip bounds and layout limits, read from its source:
    the plain version's golden, grow and bisection trips; 2^MAX_DEPTH - 1
    groups take a price; its layout and trip names match the wrapper's."""
    c = build.constants('alloc_solve')
    assert c['GOLDEN_STEPS'] == AJ.GOLDEN_ITERS
    assert c['GROW_STEPS'] == AJ.GROW_STEPS
    assert c['BISECT_STEPS'] == AJ.BISECT_STEPS
    assert c['MAX_NODES'] == 2 ** c['MAX_DEPTH'] - 1
    assert c['MAX_K'] <= c['BLOCK'] * c['MAX_CLUSTER']
    assert c['N_LAYOUT'] == len(ops.ALLOC_LAYOUT)
    assert c['N_TRIPS'] == len(ops.ALLOC_TRIPS)
    assert ops.ALLOC_TRIPS[-1] == 'spec_golden'


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z18alloc_solve_kernel4Args' for 'sm_90a'
ptxas info    : Function properties for _Z18alloc_solve_kernel4Args
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 208 registers, used 1 barriers, 36504 bytes smem
ptxas info    : Compile time = 3891.925 ms
ptxas info    : Function properties for __internal_accurate_pow
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z6kernelPj' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPj
    488 bytes stack frame, 1282 bytes spill stores, 5836 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 488 bytes cumulative stack size
"""


def test_ptxas_report_reads_registers_and_spills():
    got = build.parse_ptxas(PTXAS)
    assert got['_Z18alloc_solve_kernel4Args'] == dict(
        registers=208, stack=0, spill_stores=0, spill_loads=0)
    assert got['_Z6kernelPj'] == dict(registers=64, stack=488,
                                      spill_stores=1282, spill_loads=5836)
    assert 'registers' not in got['__internal_accurate_pow']
    assert build.parse_ptxas('') == {}

