#!/usr/bin/env python3
"""Same-call A/B timing of kernel versions on one CUDA card.

    python3 kernel_ab.py PREV_ROOT [--kernels NAME ...] [--profile] [--round]
                                   [--no-check]

times the wrapper calls of each named kernel (default: quantize_pack
and corrupt_fold) of ``PREV_ROOT`` (a checkout of an earlier commit, for
example ``git archive`` of it unpacked under ``build/``) against this
checkout's.  Each turn is a process of its own that imports the turn's
tree (``<tree>/src/repro_torch``: its sources, its build table and its
wrappers, so a kernel whose C interface changed is timed all the same)
and this checkout's ``chip_smoke``.  A turn first holds the tree's
kernels of each path it times against their plain versions, through the
tree's wrappers: the round kernels at the main shapes
(``chip_smoke.check_kernels(20, 62006, timed=False)``), the kernel API
on two clients of l=62,006 (``chip_smoke.check_api_kernels``);
``--no-check`` skips this, for a variant that leaves out part of the
work to see what that part costs.  It then times each named kernel's
calls (``wrapper_calls``: a round kernel's one call at the main shapes,
the modulus packets for the bit channel; an API kernel's calls at phase
6's shapes, ``api_calls``) on the same inputs for every tree with
``chip_smoke.kernel_ms``: each call on another copy of its inputs, so it
reads them from device memory ('ms'), and every call on one set (warm).
A dependent chain ('KERNEL:chain') is timed by ``chip_smoke.chain_ms``:
each call on the output of the one before it.  A call's time is all the
device work its wrapper queues: the kernel and whatever it launches
besides (``corrupt_fold_words``' threshold arithmetic, and in trees
before the accumulators its two output fills).  The turns run in the
order previous, new, new, previous.  Prints the card's name and power
limit, each turn's times, and as its last line a JSON object with every
turn and the mean of each version's two.

``--kernels alloc_solve`` times the eq. (28) solver kernel
(``alloc_calls``: the main path's solve and one batched call, five timed
calls each; its check is ``chip_smoke.check_alloc_kernel``, ~30 s of
plain solves a turn).

``--llm`` times phase 11's launcher run instead of kernels: each turn
runs ``launch.train.run`` on smollm-135m at chip_smoke's sizes
(``LLM_RUN``: K=4 clients of 8 x 256 tokens, packed, barrier, 'jax')
for ``LLM_AB_STEPS`` steps with the turn's tree and prints its step
times: ``--pairs`` pairs (default 2), each pair's first turn
alternating between the versions (previous, new, new, previous, ...),
then once more each (new, previous) with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the turn's environment (the
setting ``chip_smoke.py`` makes for its deterministic passes).

``--profile`` then runs each version's cold calls again under
``torch.profiler`` and prints, per call, the mean in-kernel device time
of its kernel's launches (CUPTI's kernel records) and, per call, the device
operations and their summed device time: what the call costs the card
without the gaps between launches.  ``--round`` builds the main path's
simulator once per version, runs one round and prints the device
operations of the next (``chip_smoke.round_launches``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# device clocks (~10 ms) that each timed batch of wrapper calls queues
# behind: a call does far more on the host than a bare launch
CALL_SLEEP = 20_000_000
# steps of an --llm turn (the first holds the warm-up)
LLM_AB_STEPS = 6
# the kernels of phase 11's launcher run
LLM_AB_KERNELS = ('quantize_pack', 'spfl_accumulate', 'alloc_solve')


def _import_tree(tree: Path):
    """Import the turn's tree's ``repro_torch`` and this checkout's
    chip_smoke; -> (chip_smoke, the tree's ``kernels.build``)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / 'src'))
    import chip_smoke
    from repro_torch.kernels import build
    return chip_smoke, build


def _setup(tree: Path, names):
    """Import the turn's tree and build the named kernels."""
    chip_smoke, build = _import_tree(tree)
    build.build(names)
    return chip_smoke


def wrapper_calls(chip_smoke, seed: int = 1, device: str = 'cuda',
                  path: str = 'round') -> dict:
    """{call: (call, inputs)}: wrapper calls of the kernels of ``path``,
    as ``call(*inputs)`` on ``device``; the inputs are what the call reads
    in bulk, its per-client scalars stay put.  'round': one call of each
    round kernel at the main shapes (K=20 clients, l=62,006 coordinates,
    3 bits; the bit channel and the fold on the framed modulus packets).
    'api': ``api_calls``."""
    if path == 'api':
        return api_calls(chip_smoke, seed, device)
    if path == 'alloc':
        return alloc_calls(chip_smoke, seed, device)
    import torch
    from repro_torch.core import bitchannel
    from repro_torch.kernels import ops
    from repro_torch.wire import packets
    k, n, bits = chip_smoke.K, 62006, chip_smoke.BITS
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((k, n), generator=gen, device=dev) * 0.01
    rand = torch.rand((k, n), generator=gen, device=dev)
    gmin = g.abs().amin(1).contiguous()
    gmax = g.abs().amax(1).contiguous()
    sw, qw = ops.quantize_pack_flat(g, rand, gmin, gmax, bits)
    _, mod = packets.frame_uplink_batch(sw, qw, gmin, gmax, n=n, bits=bits,
                                        round_idx=3)
    mod = mod.contiguous()
    ber = bitchannel.ber_for_success(
        torch.linspace(0.3, 1.0, k, device=dev), mod.shape[1])
    gbar = torch.rand((n,), generator=gen, device=dev) * 0.01
    ok = torch.ones((k,), dtype=torch.bool, device=dev)
    weight = torch.full((k,), 1.0 / k, device=dev)
    seeds = (0x1234ABCD + seed, 0xFEDCBA98)
    if hasattr(ops, 'seed_words'):
        # a tree whose kernel reads its seed words from the card
        seeds = ops.seed_words(seeds, dev)
    return {
        'quantize_pack': (lambda *t: ops.quantize_pack_flat(*t, bits),
                          (g, rand, gmin, gmax)),
        'spfl_accumulate': (lambda sp, mp, gb: ops.spfl_aggregate_packed(
            sp, mp, gb, gmin, gmax, ok, weight, ok, n, bits),
            (sw, qw, gbar)),
        'corrupt_fold': (lambda w, b: ops.corrupt_fold_words(seeds, w, b),
                         (mod, ber)),
        'fold_words': (ops.fold_words, (mod,)),
    }


def api_calls(chip_smoke, seed: int = 1, device: str = 'cuda') -> dict:
    """{call: (call, inputs)} of the per-client kernel API at phase 6's
    shapes: one client, l=62,006, 3 bits, mod_ok 1.  A call named
    'KERNEL:VARIANT' is another call of KERNEL: pack_bits on sign bits
    (bits 1), dequant and the roundtrip for a client whose modulus packet
    was lost (mod_ok 0), quantize and the roundtrip on row 1 of (2, n)
    g and uniforms ('odd_row': rows 8 mod 16 apart, as phase 6's odd
    clients'), and each one's dependent chain ('chain': its one input is
    the output of the call before it, see ``chain_ms``), pack_bits at 32
    bits on n = 62,016 values (a multiple of 32, so n words out), dequant
    and the roundtrip at mod_ok 0 with the output as the next gbar,
    unpack_bits at 32 bits on the same words, unpack_dequant at mod_ok 0
    with the output as the next gbar; unpack_bits and unpack_dequant also
    on row 1 of (2, words) tensors ('odd_row': rows 8 mod 16 apart) and
    unpack_dequant at mod_ok 0.  'KERNEL:after_X' is the call with the
    call that comes just before it in phase 6 (``chip_smoke.api_client``):
    pack_bits after quantize and after sign_to_bits, dequant after the
    roundtrip, the roundtrip after unpack_bits, quantize after the
    previous client's unpack_dequant, unpack_bits after pack_bits (of the
    sign bits) and unpack_dequant after dequant.  'client:queued' is
    phase 6's calls for one client (``chip_smoke.api_client``) with
    nothing read on the host, 'client:synced' the same with its
    identities read on the host between the calls, as phase 6 runs
    them."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wire import format as fmt
    n, bits = 62006, chip_smoke.BITS
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((n,), generator=gen, device=dev) * 0.01
    rand = torch.rand((n,), generator=gen, device=dev)
    gbar = torch.rand((n,), generator=gen, device=dev) * 0.01
    lo, hi = g.abs().amin().reshape(1), g.abs().amax().reshape(1)
    one, lost = torch.ones(1, device=dev), torch.zeros(1, device=dev)
    weight = torch.full((1,), 0.75, device=dev)
    sign, qidx = ops.stochastic_quantize_flat(g, rand, lo, hi, bits)
    sbits = fmt.sign_to_bits(sign)
    sw, qw = ops.pack_bits_flat(sbits, 1), ops.pack_bits_flat(qidx, bits)
    words = torch.randint(-2 ** 31, 2 ** 31, (fmt.n_groups(n) * 32,),
                          generator=gen, device=dev, dtype=torch.int32)
    g2, rand2 = torch.stack([g, g]), torch.stack([rand, rand])
    sw2, qw2 = torch.stack([sw, sw]), torch.stack([qw, qw])
    client = (lo, hi, one, weight)
    return {
        'quantize': (lambda x, r: ops.stochastic_quantize_flat(
            x, r, lo, hi, bits), (g, rand)),
        'quantize:odd_row': (lambda x, r: ops.stochastic_quantize_flat(
            x[1], r[1], lo, hi, bits), (g2, rand2)),
        'dequant': (lambda s, q, gb: ops.dequant_compensate_flat(
            s, q, gb, lo, hi, one, weight, bits), (sign, qidx, gbar)),
        'dequant:mod_ok0': (lambda s, q, gb: ops.dequant_compensate_flat(
            s, q, gb, lo, hi, lost, weight, bits), (sign, qidx, gbar)),
        'dequant:chain': (lambda gb: ops.dequant_compensate_flat(
            sign, qidx, gb, lo, hi, lost, one, bits), (gbar,)),
        'roundtrip': (lambda x, r, gb: ops.spfl_roundtrip_flat(
            x, r, gb, lo, hi, one, weight, bits), (g, rand, gbar)),
        'roundtrip:mod_ok0': (lambda x, r, gb: ops.spfl_roundtrip_flat(
            x, r, gb, lo, hi, lost, weight, bits), (g, rand, gbar)),
        'roundtrip:odd_row': (lambda x, r, gb: ops.spfl_roundtrip_flat(
            x[1], r[1], gb, lo, hi, one, weight, bits), (g2, rand2, gbar)),
        'roundtrip:chain': (lambda gb: ops.spfl_roundtrip_flat(
            g, rand, gb, lo, hi, lost, one, bits), (gbar,)),
        'pack_bits': (lambda v: ops.pack_bits_flat(v, bits), (qidx,)),
        'pack_bits:bits1': (lambda v: ops.pack_bits_flat(v, 1), (sbits,)),
        'pack_bits:chain': (lambda v: ops.pack_bits_flat(v, 32), (words,)),
        'unpack_bits': (lambda w: ops.unpack_bits_flat(w, n, bits), (qw,)),
        'unpack_dequant': (lambda s, q, gb: ops.unpack_dequant_flat(
            s, q, gb, lo, hi, one, weight, n, bits), (sw, qw, gbar)),
        'unpack_bits:odd_row': (lambda w: ops.unpack_bits_flat(
            w[1], n, bits), (qw2,)),
        'unpack_bits:chain': (lambda w: ops.unpack_bits_flat(
            w, w.shape[0], 32), (words,)),
        'unpack_dequant:mod_ok0': (lambda s, q, gb: ops.unpack_dequant_flat(
            s, q, gb, lo, hi, lost, weight, n, bits), (sw, qw, gbar)),
        'unpack_dequant:odd_row': (lambda s, q, gb: ops.unpack_dequant_flat(
            s[1], q[1], gb, lo, hi, one, weight, n, bits), (sw2, qw2, gbar)),
        'unpack_dequant:chain': (lambda gb: ops.unpack_dequant_flat(
            sw, qw, gb, lo, hi, lost, one, n, bits), (gbar,)),
        'pack_bits:after_quantize': (lambda x, r: ops.pack_bits_flat(
            ops.stochastic_quantize_flat(x, r, lo, hi, bits)[1], bits),
            (g, rand)),
        'pack_bits:after_sign_to_bits': (lambda s: ops.pack_bits_flat(
            fmt.sign_to_bits(s), 1), (sign,)),
        'dequant:after_roundtrip': (lambda x, r, gb, s, q: (
            ops.spfl_roundtrip_flat(x, r, gb, lo, hi, one, weight, bits),
            ops.dequant_compensate_flat(s, q, gb, lo, hi, one, weight,
                                        bits)), (g, rand, gbar, sign, qidx)),
        'quantize:after_unpack_dequant': (lambda s, q, gb, x, r: (
            ops.unpack_dequant_flat(s, q, gb, lo, hi, one, weight, n, bits),
            ops.stochastic_quantize_flat(x, r, lo, hi, bits)),
            (sw, qw, gbar, g, rand)),
        'roundtrip:after_unpack_bits': (lambda w, x, r, gb: (
            ops.unpack_bits_flat(w, n, bits),
            ops.spfl_roundtrip_flat(x, r, gb, lo, hi, one, weight, bits)),
            (qw, g, rand, gbar)),
        'unpack_bits:after_pack_bits': (lambda sb, w: (
            ops.pack_bits_flat(sb, 1), ops.unpack_bits_flat(w, n, bits)),
            (sbits, qw)),
        'unpack_dequant:after_dequant': (lambda s, q, gb, sw_, qw_: (
            ops.dequant_compensate_flat(s, q, gb, lo, hi, one, weight, bits),
            ops.unpack_dequant_flat(sw_, qw_, gb, lo, hi, one, weight, n,
                                    bits)), (sign, qidx, gbar, sw, qw)),
        'client:queued': (lambda x, r, gb, s, q: chip_smoke.api_client(
            x, r, gb, client, s, q, check=False), (g, rand, gbar, sw, qw)),
        'client:synced': (lambda x, r, gb, s, q: chip_smoke.api_client(
            x, r, gb, client, s, q), (g, rand, gbar, sw, qw)),
    }


def alloc_calls(chip_smoke, seed: int = 1, device: str = 'cuda') -> dict:
    """{call: (call, ())} of the eq. (28) solver kernel: 'alloc_solve',
    the main path's solve (K=20, alternating, the main run's max_iters,
    tol and gate) of its round 1, the first that solves, made by two
    rounds of the 'jax'-backend simulator (phase 4's, whose round 1
    does not depend on the solver: round 0 takes the uniform point);
    'alloc_solve:batch', that problem over 16 fading draws of its gains
    (``batch_over_gains``, one block or cluster a draw) in one call."""
    import numpy as np
    import torch
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import allocation_jax as AJ
    from repro_torch.kernels import ops
    from repro_torch.training.fl_loop import build_simulator
    fl = FLConfig(wire='packed', channel='bitlevel', allocation_backend='jax')
    sim = build_simulator(fl, per_device=500, n_test=2000, device=device)
    kept = []
    chip_smoke.keep_device_problems(sim, kept)
    sim.run(2)
    prob, gate = kept[1]['prob'], torch.amax(kept[1]['gb2'])
    rng = np.random.RandomState(seed)
    fading = rng.exponential(1.0, (16, prob.gains.shape[0]))
    draws = AJ.batch_over_gains(prob, prob.gains.cpu().numpy() * fading)
    kw = dict(max_iters=fl.allocation_max_iters or 6,
              tol=fl.allocation_tol or 1e-5,
              early_exit=fl.allocation_early_exit, gate=gate)
    return {
        'alloc_solve': (lambda: ops.alloc_solve(prob, fl.allocator, **kw),
                        ()),
        'alloc_solve:batch': (lambda: ops.alloc_solve(draws, fl.allocator,
                                                      **kw), ()),
    }


def kernel_of(call: str) -> str:
    """The kernel a call of ``wrapper_calls`` times: 'KERNEL:VARIANT' is
    a call of KERNEL."""
    return call.split(':')[0]


def calls_for(chip_smoke, names, seed: int = 1) -> dict:
    """The calls of ``wrapper_calls`` whose kernel is named, by path, and
    the per-client calls ('client:...') when a kernel API kernel is."""
    out = {}
    for path in ('round', 'api', 'alloc'):
        if any(n in chip_smoke.kernels_on(path) for n in names):
            out.update({c: v for c, v in wrapper_calls(
                chip_smoke, seed, path=path).items()
                if kernel_of(c) in names or kernel_of(c) == 'client'})
    return out


def _check(chip_smoke, names) -> None:
    """Hold the tree's kernels of each path that ``names`` touch against
    their plain versions at that path's shapes."""
    if any(n in chip_smoke.kernels_on('round') for n in names):
        chip_smoke.check_kernels(chip_smoke.K, 62006, timed=False, seed=1)
    if any(n in chip_smoke.kernels_on('api') for n in names):
        chip_smoke.check_api_kernels(2, 62006, chip_smoke.BITS, timed=False,
                                     seed=5)
    if 'alloc_solve' in names:
        chip_smoke.check_alloc_kernel(seed=13)


def time_turn(tree: Path, names, check: bool) -> dict:
    """{call: {'ms', 'warm_ms'}} of each call of the named kernels; a
    chain's 'ms' is ``chain_ms`` and its 'warm_ms' None."""
    chip_smoke = _setup(tree, names)
    if check:
        _check(chip_smoke, names)
    out = {}
    for call, (fn, inputs) in calls_for(chip_smoke, names).items():
        if call.endswith(':chain'):
            out[call] = {'ms': chip_smoke.chain_ms(fn, inputs[0],
                                                   sleep=CALL_SLEEP),
                         'warm_ms': None}
        elif kernel_of(call) == 'alloc_solve':
            # tens to hundreds of ms a solve: five timed calls, as
            # chip_smoke.time_device_solves
            out[call] = {'ms': chip_smoke.device_ms([fn], reps=5, inner=1,
                                                    sleep=CALL_SLEEP),
                         'warm_ms': None}
        else:
            out[call] = chip_smoke.kernel_ms(fn, inputs, lambda *t: t,
                                             sleep=CALL_SLEEP)
    return out


def profile_turn(tree: Path, names, check: bool) -> dict:
    """{call: {'kernel_ms': mean in-kernel time of its kernel's launches,
    'ops': device operations per call, 'device_ms': their summed device
    time per call}} over three passes of cold calls (each on another
    copy of the inputs; a chain's calls each on the output of the one
    before), from ``torch.profiler``'s CUDA records over a padded window
    (``chip_smoke.card_profile``); a call whose records hold no device
    time maps to None."""
    import torch
    chip_smoke = _setup(tree, names)
    out = {}
    for name, (call, inputs) in calls_for(chip_smoke, names).items():
        copies = chip_smoke.cold_copies(inputs) if inputs else [()]
        n_calls = 3 * len(copies)
        if name.endswith(':chain'):
            def run(x=inputs[0]):
                for _ in range(n_calls):
                    x = call(x)
        else:
            def run():
                for _ in range(3):
                    for c in copies:
                        call(*c)
        for c in copies:
            call(*c)
        with chip_smoke.card_profile() as prof:
            run()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        own = [e.device_time_total for e in events
               if f'{kernel_of(name)}_kernel' in e.name]
        total = sum(e.device_time_total for e in events)
        out[name] = ({'kernel_ms': sum(own) / len(own) / 1e3,
                      'ops': len(events) / n_calls,
                      'device_ms': total / n_calls / 1e3}
                     if own and total else None)
        del copies
        torch.cuda.empty_cache()
    return out


def round_turn(tree: Path, names, check: bool) -> str:
    """The device operations of the main path's second round."""
    chip_smoke = _setup(tree, names)
    from repro_torch.configs.base import FLConfig
    from repro_torch.training.fl_loop import build_simulator
    sim = build_simulator(FLConfig(wire='packed', channel='bitlevel'),
                          per_device=500, n_test=2000)
    sim.run(1)
    return chip_smoke.round_launches(sim)


def llm_turn(tree: Path, names, check: bool) -> dict:
    """Phase 11's launcher run with the tree's port: {'step_ms', 'loss'}
    of ``LLM_AB_STEPS`` steps (wall clock, as ``launch.train`` records
    them)."""
    chip_smoke, build = _import_tree(tree)
    build.build(names)
    from repro_torch.launch import train
    hist = train.run(chip_smoke.LLM_ARCH, steps=LLM_AB_STEPS,
                     **chip_smoke.LLM_RUN)
    return {'step_ms': [t * 1e3 for t in hist['step_s']],
            'loss': hist['loss']}


TURNS = {'time': time_turn, 'profile': profile_turn, 'round': round_turn,
         'llm': llm_turn}


def turn(kind: str, tree: Path, names, check: bool, env=None):
    """Run one turn in a process of its own (``env``: variables added to
    its environment); -> its result."""
    import os
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), '--turn', kind,
         str(tree), '--kernels', *names] + ([] if check else ['--no-check']),
        capture_output=True, text=True, env={**os.environ, **(env or {})})
    if out.returncode:
        raise RuntimeError(f'{kind} turn on {tree} failed:\n{out.stderr}')
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('prev_root', type=Path)
    parser.add_argument('--kernels', nargs='+',
                        default=['quantize_pack', 'corrupt_fold'],
                        choices=['quantize_pack', 'spfl_accumulate',
                                 'corrupt_fold', 'fold_words', 'quantize',
                                 'dequant', 'roundtrip', 'pack_bits',
                                 'unpack_bits', 'unpack_dequant',
                                 'alloc_solve'])
    parser.add_argument('--profile', action='store_true',
                        help='in-kernel time per launch and device time '
                             'per call (torch.profiler)')
    parser.add_argument('--round', action='store_true',
                        help="count the device operations of one main-path "
                             "round with each version")
    parser.add_argument('--llm', action='store_true',
                        help="time phase 11's smollm-135m launcher steps "
                             'with each version instead of kernels')
    parser.add_argument('--pairs', type=int, default=2,
                        help='--llm: pairs of turns, previous and new')
    parser.add_argument('--no-check', dest='check', action='store_false',
                        help='time without holding the kernels against '
                             'their plain versions (a diagnostic variant)')
    parser.add_argument('--turn', choices=sorted(TURNS),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('FAIL: no CUDA card', file=sys.stderr)
        return 1
    if args.turn:
        print(json.dumps(TURNS[args.turn](args.prev_root.resolve(),
                                          args.kernels, args.check)),
              flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    trees = {'previous': args.prev_root.resolve(), 'new': ROOT}
    card = chip_smoke.card_line()
    print(card, flush=True)
    if args.llm:
        return llm_ab(trees, card, args.pairs)
    runs = []
    for label in ('previous', 'new', 'new', 'previous'):
        ms = turn('time', trees[label], args.kernels, args.check)
        runs.append({'version': label, 'ms': ms})
        print(f'{label}: ' + ', '.join(
            f'{n} {t["ms"]:.7f} ms per call' + (
                f' (warm {t["warm_ms"]:.7f})' if t['warm_ms'] is not None
                else '') for n, t in ms.items()), flush=True)
    profiles, rounds = {}, {}
    for label, tree in trees.items():
        if args.profile:
            profiles[label] = turn('profile', tree, args.kernels, args.check)
            for name, split in profiles[label].items():
                print(f'{label} {name}: ' + (
                    'no device time in the profile' if split is None
                    else f'in-kernel {split["kernel_ms"]:.7f} ms per launch; '
                    f'per call {split["ops"]:g} device operations, '
                    f'{split["device_ms"]:.7f} ms'), flush=True)
        if args.round:
            rounds[label] = turn('round', tree, args.kernels, args.check)
            print(f'{label} main round device operations: {rounds[label]}',
                  flush=True)
    means = {label: {name: sum(r['ms'][name]['ms'] for r in runs
                               if r['version'] == label) / 2
                     for name in runs[0]['ms']} for label in trees}
    print(json.dumps({'card': card, 'runs': runs, 'mean_ms': means,
                      'profile': profiles, 'round': rounds}), flush=True)
    return 0


def turn_ms(run: dict) -> float:
    """An --llm turn's mean step time after its first step."""
    return statistics.mean(run['step_ms'][1:])


def llm_ab(trees: dict, card: str, pairs: int) -> int:
    """The --llm turns: ``pairs`` pairs (previous, new, new, previous,
    ...), then new and previous with the cuBLAS workspace setting."""
    cublas = {'CUBLAS_WORKSPACE_CONFIG': ':4096:8'}
    order = [(label, None) for i in range(pairs)
             for label in (('previous', 'new') if i % 2 == 0
                           else ('new', 'previous'))]
    order += [('new', cublas), ('previous', cublas)]
    runs = []
    for label, env in order:
        r = turn('llm', trees[label], list(LLM_AB_KERNELS), True, env)
        runs.append({'version': label, 'cublas_workspace': env is not None,
                     **r})
        print(f'{label}{" (cuBLAS :4096:8)" if env else ""}: step ms '
              f'{json.dumps(r["step_ms"])}; loss {json.dumps(r["loss"])}',
              flush=True)
    # steps 1.. of the plain turns: their mean, each turn's mean, and
    # the pairs whose new turn was the faster
    plain = [r for r in runs if not r['cublas_workspace']]
    means = {label: statistics.mean(
        t for r in plain if r['version'] == label for t in r['step_ms'][1:])
        for label in trees}
    turns = {label: [turn_ms(r) for r in plain if r['version'] == label]
             for label in trees}
    wins = 0
    for a, b in zip(plain[::2], plain[1::2]):
        new, prev = (a, b) if a['version'] == 'new' else (b, a)
        wins += turn_ms(new) < turn_ms(prev)
    print(json.dumps({'card': card, 'runs': runs,
                      'mean_step_ms_after_first': means,
                      'turn_means': turns, 'new_wins': wins,
                      'pairs': pairs}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
