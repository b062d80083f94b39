#!/usr/bin/env python3
"""Same-call A/B timing of kernel versions on one CUDA card.

    python3 kernel_ab.py PREV_ROOT [--kernels NAME ...] [--profile] [--round]
                                   [--no-check]

times a wrapper call of each named round kernel (default: quantize_pack
and corrupt_fold) of ``PREV_ROOT`` (a checkout of an earlier commit, for
example ``git archive`` of it unpacked under ``build/``) against this
checkout's.  Each turn is a process of its own that imports the turn's
tree (``<tree>/src/repro_torch``: its sources, its build table and its
wrappers, so a kernel whose C interface changed is timed all the same)
and this checkout's ``chip_smoke``.  A turn first holds the tree's round
kernels against their plain versions at the main shapes, through the
tree's wrappers (``chip_smoke.check_kernels(20, 62006, timed=False)``;
``--no-check`` skips this, for a variant that leaves out part of the
work to see what that part costs).  It then times one call of each named
kernel's wrapper on the same inputs for every tree (``wrapper_calls``:
the main shapes, the modulus packets for the bit channel) with
``chip_smoke.kernel_ms``: each call on another copy of its inputs, so it
reads them from device memory ('ms'), and every call on one set (warm).
A call's time is all the device work its wrapper queues: the kernel and
whatever it launches besides (``corrupt_fold_words``' threshold
arithmetic, and in trees before the accumulators its two output fills).
The turns run in the order previous, new, new, previous.  Prints the
card's name and power limit, each turn's times, and as its last line a
JSON object with every turn and the mean of each version's two.

``--profile`` then runs each version's cold calls again under
``torch.profiler`` and prints, per kernel, the mean in-kernel device time
of its launches (CUPTI's kernel records) and, per call, the device
operations and their summed device time: what the call costs the card
without the gaps between launches.  ``--round`` builds the main path's
simulator once per version, runs one round and prints the device
operations of the next (``chip_smoke.round_launches``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# device clocks (~10 ms) that each timed batch of wrapper calls queues
# behind: a call does far more on the host than a bare launch
CALL_SLEEP = 20_000_000


def _import_tree(tree: Path):
    """Import the turn's tree's ``repro_torch`` and this checkout's
    chip_smoke; -> (chip_smoke, the tree's ``kernels.build``)."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / 'src'))
    import chip_smoke
    from repro_torch.kernels import build
    return chip_smoke, build


def _setup(tree: Path):
    """Import the turn's tree and build its round kernels."""
    chip_smoke, build = _import_tree(tree)
    build.build(chip_smoke.kernels_on('round'))
    return chip_smoke


def wrapper_calls(chip_smoke, seed: int = 1, device: str = 'cuda') -> dict:
    """{kernel: (call, inputs)}: one wrapper call of each round kernel at
    the main shapes (K=20 clients, l=62,006 coordinates, 3 bits; the
    bit channel and the fold on the framed modulus packets), as
    ``call(*inputs)`` on ``device``.  The inputs are what the call reads
    in bulk; its per-client scalars stay put."""
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


def time_turn(tree: Path, names, check: bool) -> dict:
    """{kernel: {'ms', 'warm_ms'}} of one wrapper call each."""
    chip_smoke = _setup(tree)
    if check:
        chip_smoke.check_kernels(chip_smoke.K, 62006, timed=False, seed=1)
    calls = wrapper_calls(chip_smoke)
    return {name: chip_smoke.kernel_ms(calls[name][0], calls[name][1],
                                       lambda *t: t, sleep=CALL_SLEEP)
            for name in names}


def profile_turn(tree: Path, names, check: bool) -> dict:
    """{kernel: {'kernel_ms': mean in-kernel time of its launches,
    'ops': device operations per call, 'device_ms': their summed device
    time per call}} over three passes of cold calls (each on another
    copy of the inputs), from ``torch.profiler``'s CUDA records; a
    kernel whose records hold no device time maps to None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    chip_smoke = _setup(tree)
    calls = wrapper_calls(chip_smoke)
    out = {}
    for name in names:
        call, inputs = calls[name]
        copies = chip_smoke.cold_copies(inputs)
        for c in copies:
            call(*c)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                for c in copies:
                    call(*c)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        own = [e.device_time_total for e in events
               if f'{name}_kernel' in e.name]
        n_calls = 3 * len(copies)
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
    chip_smoke = _setup(tree)
    from repro_torch.configs.base import FLConfig
    from repro_torch.training.fl_loop import build_simulator
    sim = build_simulator(FLConfig(wire='packed', channel='bitlevel'),
                          per_device=500, n_test=2000)
    sim.run(1)
    return chip_smoke.round_launches(sim)


TURNS = {'time': time_turn, 'profile': profile_turn, 'round': round_turn}


def turn(kind: str, tree: Path, names, check: bool):
    """Run one turn in a process of its own; -> its result."""
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), '--turn', kind,
         str(tree), '--kernels', *names] + ([] if check else ['--no-check']),
        capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f'{kind} turn on {tree} failed:\n{out.stderr}')
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('prev_root', type=Path)
    parser.add_argument('--kernels', nargs='+',
                        default=['quantize_pack', 'corrupt_fold'],
                        choices=['quantize_pack', 'spfl_accumulate',
                                 'corrupt_fold', 'fold_words'])
    parser.add_argument('--profile', action='store_true',
                        help='in-kernel time per launch and device time '
                             'per call (torch.profiler)')
    parser.add_argument('--round', action='store_true',
                        help="count the device operations of one main-path "
                             "round with each version")
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
    runs = []
    for label in ('previous', 'new', 'new', 'previous'):
        ms = turn('time', trees[label], args.kernels, args.check)
        runs.append({'version': label, 'ms': ms})
        print(f'{label}: ' + ', '.join(
            f'{n} {t["ms"]:.7f} ms per call (warm {t["warm_ms"]:.7f})'
            for n, t in ms.items()), flush=True)
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
                     for name in args.kernels} for label in trees}
    print(json.dumps({'card': card, 'runs': runs, 'mean_ms': means,
                      'profile': profiles, 'round': rounds}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
