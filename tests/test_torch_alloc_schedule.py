"""The schedule of the ``alloc_solve`` kernel's speculative dual search
(``kernels/csrc/alloc_solve.cu``, ``sca``), held to the sequential dual
search of the plain version (``core.allocation_jax._dual``) on the CPU.

The kernel evaluates lam = 0 and the grow loop's prices ``nodes`` at a
time, and below the bisection's bracket either the midpoints down a
predicted walk (the walk of the solve's previous dual search from the
same bracket, or every midpoint infeasible where the bracket's top is;
the round of the grow loop's last prices takes the first of them with
its spare groups) or, once the walk leaves the prediction, the full
``depth``-level subtree; it walks what it evaluated as the sequential
loops would, stops
at the first level that leaves the bracket as it was (``_dual``'s frozen
exit), and takes the final section from the round that evaluated its
price.  ``speculative_beta`` below is that schedule in plain Python, in
the problem's dtype, driven by the same ``beta_of_lambda`` as the plain
version's step (``sequential_beta``: beta(0), then ``_dual``): the
port's own golden section of the SCA surrogate on a CPU problem
(``golden_dual``; ``kept_f32_dual``, the float32 main-path problem whose
bracket freezes), or a made-up feasibility predicate that need not be
monotone in the price (the property test).  Both must give the same bits
and take the same number of golden sections on the sequential path.  The
kernel's own constants are held to the plain version's trip bounds, and
the ``-Xptxas -v`` reader that ``chip_smoke.py`` fails a spilling build
by is checked on a listing.
"""
import json
import pathlib
import struct

import numpy as np
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
           for n in range(1, 7)] + [(2 ** d - 1, d) for d in range(3, 7)] + [
               (92, 6)]
# a walk's verdicts, bit l set where level l's midpoint is infeasible
ALL_INFEASIBLE = (1 << 64) - 1
KEPT = pathlib.Path(__file__).parent / 'data' / 'fused_f32_problem_k20.json'


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """Small tensors: one intra-op thread (the suite runs in several
    workers, and more threads only contend), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speculative_beta(P, beta_of_lambda, early_exit: bool, inner_tol: float,
                     nodes: int, depth: int, dtype=torch.float64,
                     memo=None):
    """The kernel's SCA step from beta(0) to the dual's beta, in ``dtype``
    arithmetic.  ``memo``: (the bracket's top after the growth, the walk's
    verdicts) of the solve's dual search before this one, or None.  ->
    (beta, counts: golden sections of the sequential path 'seq', the
    speculative ones off it 'spec', golden sections run 'ran', rounds
    'rounds', bisection levels walked 'bisect'; this search's memo)."""
    tol_exit = early_exit and inner_tol > 0.0
    dt = np.float64 if dtype == torch.float64 else np.float32
    half, ten = dt(0.5), dt(10.0)
    n = dict(seq=0, spec=0, ran=0, rounds=0, bisect=0)

    def run_round(prices):
        # one golden section a group, all of them before any is read
        n['ran'] += len(prices)
        n['rounds'] += 1
        betas = [beta_of_lambda(torch.tensor([float(lam)], dtype=dtype))
                 for lam in prices]
        return betas, [float(AJ._msum(P, b)) for b in betas]

    def path_mids(lo, hi, path, step, count):
        # the midpoints down a predicted walk from (lo, hi) at level step
        mids = []
        for g in range(count):
            l, h = lo, hi
            for j in range(g):
                m = half * (l + h)
                if path >> (step + j) & 1:
                    l = m
                else:
                    h = m
            mids.append(half * (l + h))
        return mids

    # the prediction: the previous search's walk from its bracket, else
    # every midpoint infeasible below the grow loop's last price (where
    # 30 infeasible steps, or 1e30, end it)
    if memo is not None:
        pred_hi, pred_path = memo
    else:
        pred_hi, pred_path = dt(1.0), ALL_INFEASIBLE
        for _ in range(AJ.GROW_STEPS):
            if not pred_hi < dt(1e30):
                break
            pred_hi = pred_hi * ten
    # position 0 is lam = 0, position 1 + i the grow loop's price p_i
    # (p_30, where its 30 steps end, only ever the final section); the
    # round that prices the last positions gives its other groups the
    # predicted walk's first midpoints (ahead)
    hi, lo, total = dt(1.0), dt(0.0), 0.0
    have = pending = False
    dual, fetched, pos, ahead = True, None, 0, None
    while pos <= AJ.GROW_STEPS + 1:
        k = min(nodes, AJ.GROW_STEPS + 2 - pos)
        prices = []
        for q in range(pos, pos + k):
            lam = dt(0.0) if q == 0 else dt(1.0)
            for _ in range(q - 1):
                lam = lam * ten
            prices.append(lam)
        extra = 0
        if pos + k == AJ.GROW_STEPS + 2:
            extra = min(nodes - k, AJ.BISECT_STEPS)
        mids = path_mids(dt(0.0), pred_hi, pred_path, 0, extra)
        betas, sums = run_round(prices + mids)
        if extra:
            ahead = (mids, betas[k:], sums[k:])
        used, stop = 0, False
        for j in range(k):
            q = pos + j
            if q == 0:
                used += 1
                n['seq'] += 1
                if not sums[0] > 1.0:
                    dual, fetched, stop = False, betas[0], True
                    break
                continue
            assert prices[j] == hi
            if q - 1 >= AJ.GROW_STEPS or not hi < dt(1e30):
                fetched, have, pending, stop = betas[j], True, True, True
                total = sums[j]
                used += 1
                break
            used += 1
            n['seq'] += 1
            if not sums[j] > 1.0:
                fetched, have, stop, total = betas[j], True, True, sums[j]
                break
            hi = hi * ten
        n['spec'] += k - used
        pos += k
        if stop:
            break
    if not dual:
        n['spec'] += len(ahead[0]) if ahead else 0
        return fetched, n, memo
    # bisection.  A path round: the midpoints down a predicted walk
    # (group g the g-th), min(nodes, levels left) levels; the prediction
    # is the previous search's walk where it started from the same
    # bracket, else, where the bracket's top is infeasible, every midpoint
    # infeasible.  After the walk leaves the prediction, or with none: a
    # full subtree of depth levels below (lo, hi) (group j node j + 1 of
    # the heap: children 2n infeasible, lo = mid, and 2n + 1 feasible,
    # hi = mid).  The search ends at the first level that leaves (lo, hi)
    # as it was.  The first path round is the growth's ahead, where the
    # prediction it took holds.
    start = hi
    if memo is not None and memo[0] == hi:
        path = memo[1]
    elif have and total > 1.0:
        path = ALL_INFEASIBLE
    else:
        path = None
    if ahead and not (hi == pred_hi and path == pred_path):
        n['spec'] += len(ahead[0])
        ahead = None
    follow, walked = path is not None, ALL_INFEASIBLE
    step = 0
    while step < AJ.BISECT_STEPS:
        if tol_exit and hi - lo <= dt(inner_tol) * hi:
            break
        rem = AJ.BISECT_STEPS - step
        if ahead:
            mids, betas, sums = ahead
            levels = k = len(mids)
            ahead = None
        else:
            levels = min(nodes if follow else depth, rem)
            k = levels if follow else 2 ** levels - 1
            if follow:
                mids = path_mids(lo, hi, path, step, k)
            else:
                mids = []
                for g in range(k):
                    l, h = lo, hi
                    node = g + 1
                    for bit in range(node.bit_length() - 2, -1, -1):
                        m = half * (l + h)
                        if (node >> bit) & 1:
                            h = m
                        else:
                            l = m
                    mids.append(half * (l + h))
            betas, sums = run_round(mids)
        g, lev, last, stop = 0, 0, -1, False
        while lev < levels and g >= 0:
            if lev > 0 and tol_exit and hi - lo <= dt(inner_tol) * hi:
                stop = True
                break
            n['seq'] += 1
            mid = half * (lo + hi)
            assert mid == mids[g]             # the walk reads what ran
            infeasible = sums[g] > 1.0
            was = lo, hi
            if infeasible:
                lo = mid
            else:
                hi, last = mid, g
                walked &= ~(1 << (step + lev))
            if (lo, hi) == was:
                stop = True                   # frozen: lev + 1 levels ran
            elif not follow:
                g = 2 * g + (1 if infeasible else 2)
            elif infeasible == bool(path >> (step + lev) & 1):
                g = g + 1
            else:
                follow, g = False, -1         # off the prediction
            lev += 1
            if stop:
                break
        if last >= 0:
            # hi moved to a node's price: its betas are the final section's
            fetched, have, total = betas[last], True, sums[last]
            n['spec'] += pending
            pending = False
        n['spec'] += k - lev
        n['bisect'] += lev
        step += lev
        if stop:
            break
    if ahead:
        n['spec'] += len(ahead[0])            # the walk never came to it
    if have:
        b = fetched
    else:
        b = beta_of_lambda(torch.tensor([float(hi)], dtype=dtype))
        n['ran'] += 1
        n['rounds'] += 1
    n['seq'] += 1
    # a final section fetched from a walked node ran once for two uses
    assert n['ran'] == n['seq'] + n['spec'] - (have and not pending)
    scale = (1.0 / AJ._msum(P, b).clamp(min=1e-12)).clamp(max=1.0)
    return b * scale.reshape(-1, 1), n, (start, walked)


def sequential_beta(P, beta_of_lambda, early_exit, inner_tol,
                    dtype=torch.float64):
    """The plain version's step (``optimize_beta_sca``'s, one problem):
    beta(0), and ``allocation_jax._dual`` where it breaks sum(beta) <= 1
    -> (beta, the prices of the golden sections it ran)."""
    prices = []

    def counted(lam):
        prices.append(float(lam.reshape(-1)[0]))
        return beta_of_lambda(lam)

    b = counted(torch.zeros(1, dtype=dtype))
    if float(AJ._msum(P, b)) > 1.0:
        b = AJ._dual(P, counted, torch.zeros(1, dtype=dtype), early_exit,
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
    got, n, _ = speculative_beta(P, bol, True, inner_tol, nodes, depth)
    assert torch.equal(got, want)
    assert n['seq'] == len(prices)
    # capped: the grow loop priced 1e29, its 30th step
    assert (max(prices) >= 1e29) == capped
    if inner_tol == 0.0:
        # the bracket froze before the 60th level: the rest never ran
        assert 50 <= n['bisect'] < AJ.BISECT_STEPS
    if capped and inner_tol == 0.0:
        # every midpoint infeasible, as predicted: hi stays p_30, whose
        # section the grow rounds ran, so the final section is never run
        # again
        assert n['ran'] == n['seq'] + n['spec']
        if nodes == 92:
            # one round: lam = 0, the 30 prices and p_30, and the
            # predicted walk's 60 midpoints, walked to the freeze
            assert n['ran'] == 32 + 60 and n['rounds'] == 1
        if nodes == 63:
            # the walk's first 31 midpoints with the growth, 29 more in a
            # second round
            assert n['ran'] == 63 + 29 and n['rounds'] == 2


def test_frozen_trips_do_not_change_the_schedule():
    """Without early exits (early_exit=False) the sequential loops run
    their frozen trips; the schedule's result is the same."""
    P, bol = golden_dual(1e12)
    want, _ = sequential_beta(P, bol, False, 1e-7)
    got, _, _ = speculative_beta(P, bol, False, 1e-7, 6, 2)
    assert torch.equal(got, want)


def kept_f32_dual():
    """(problem, beta_of_lambda) of the first dual search of the float32
    main-path problem that ``chip_smoke.py`` phase 10 keeps
    (``tests/data/fused_f32_problem_k20.json``): the SCA surrogate of its
    first outer iteration (alpha by ``optimize_alpha`` at the uniform
    beta, around which it is made) and its 48-step golden section, as the
    plain version makes them; each price's section computed once."""
    rec = json.loads(KEPT.read_text())
    P = AJ._lift(AJ.JaxAllocationProblem(**{
        f: torch.tensor(rec[f], dtype=torch.float32)
        for f in AJ.JaxAllocationProblem._fields if f in rec}))
    caps = AJ._caps(torch.float32)
    _, beta0 = AJ._uniform_point(P)
    surrogate = AJ._surrogate(P, caps, AJ.optimize_alpha(P, beta0, caps=caps),
                              beta0)
    done = {}

    def beta_of_lambda(lam):
        key = float(lam.reshape(-1)[0])
        if key not in done:
            done[key] = AJ._golden_vec(
                lambda b: surrogate(b, lam.reshape(-1, 1)), beta0)
        return done[key]

    return P, beta_of_lambda


def test_f32_bracket_freezes_and_the_next_search_follows_its_walk():
    """The float32 main-path dual search (K = 20, the layout of one
    problem: 92 groups take a price, subtrees of depth 6): its growth
    stops at float32(1e29), where the sum is met, so nothing predicts its
    walk (5 rounds: the growth, then 4 subtrees); its bracket freezes
    before the 30th level; the schedule's result is ``_dual``'s bit for
    bit.  A next search from the same bracket that walks the same way
    follows the first one's walk: the growth and the whole bisection take
    one round."""
    P, bol = kept_f32_dual()
    f32 = dict(dtype=torch.float32)
    want, prices = sequential_beta(P, bol, True, 0.0, **f32)
    assert max(prices) == float(torch.tensor(1e29, **f32))
    first, n1, memo = speculative_beta(P, bol, True, 0.0, 92, 6, **f32)
    assert torch.equal(first, want) and n1['seq'] == len(prices)
    assert n1['bisect'] < 30 and memo[1] != ALL_INFEASIBLE
    assert n1['rounds'] == 5
    again, n2, memo2 = speculative_beta(P, bol, True, 0.0, 92, 6, memo=memo,
                                        **f32)
    assert torch.equal(again, want) and memo2 == memo
    assert n2['bisect'] == n1['bisect'] and n2['rounds'] == 1
    print(f'float32 kept dual: first {n1}, next {n2}')


def predicate_dual(seed: int, p_infeasible: float, k: int = 3,
                   dtype=torch.float64):
    """(problem, beta_of_lambda) whose feasibility at a price is a hash
    of the price's bits: no monotonicity at all."""
    kind = dict(dtype=dtype)
    P = AJ.JaxAllocationProblem(*(torch.ones((1, k), **kind)
                                  for _ in range(6)),
                                *(torch.ones((1, 1), **kind)
                                  for _ in range(6)), None)

    def beta_of_lambda(lam):
        price = float(lam.reshape(-1)[0])
        bits = struct.unpack('<q', struct.pack('<d', price))[0]
        h = ((bits ^ seed) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        infeasible = (h >> 11) / float(1 << 53) < p_infeasible
        return torch.full((1, k), (0.5 if infeasible else 0.25)
                          + 1e-3 * (h & 7), **kind)

    return P, beta_of_lambda


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 62), p_infeasible=st.floats(0.0, 1.0),
       nodes=st.integers(1, 92), depth=st.integers(1, 6),
       inner_tol=st.sampled_from([0.0, 1e-12, 1e-6, 0.3]),
       dtype=st.sampled_from([torch.float64, torch.float32]),
       seed2=st.one_of(st.none(), st.integers(0, 2 ** 62)))
def test_walk_takes_the_sequential_bracket_of_any_predicate(
        seed, p_infeasible, nodes, depth, inner_tol, dtype, seed2):
    """A feasibility predicate that is not monotone in the price, in
    float64 and float32 (whose brackets freeze within the 60 levels): the
    walk over the speculative rounds takes exactly the sequential
    bracket, so its result and its sequential section count are
    ``_dual``'s.  So does a second search of the same solve, which takes
    the first's walk as its prediction: the same predicate again (seed2
    None: a prediction that holds) or another (one that may not)."""
    memo = None
    for s in (seed, seed if seed2 is None else seed2):
        P, bol = predicate_dual(s, p_infeasible, dtype=dtype)
        want, prices = sequential_beta(P, bol, True, inner_tol, dtype)
        got, n, memo = speculative_beta(P, bol, True, inner_tol, nodes,
                                        depth, dtype, memo)
        assert torch.equal(got, want)
        assert n['seq'] == len(prices)


def test_kernel_bounds_are_the_plain_versions():
    """The kernel's trip bounds and layout limits, read from its source:
    the plain version's golden, grow and bisection trips; as many groups
    take a price as the grow loop's positions and a predicted walk's
    levels (one round of both), and a full subtree of MAX_DEPTH levels
    fits them; its layout and trip names match the wrapper's."""
    c = build.constants('alloc_solve')
    assert c['GOLDEN_STEPS'] == AJ.GOLDEN_ITERS
    assert c['GROW_STEPS'] == AJ.GROW_STEPS
    assert c['BISECT_STEPS'] == AJ.BISECT_STEPS
    assert c['MAX_NODES'] == AJ.GROW_STEPS + 2 + AJ.BISECT_STEPS
    assert 2 ** c['MAX_DEPTH'] - 1 <= c['MAX_NODES']
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

