#!/usr/bin/env python3
"""Same-call A/B timing of kernel sources on one CUDA card.

    python3 kernel_ab.py PREV_ROOT [--kernels NAME ...] [--profile]

builds each named kernel (default: spfl_accumulate and fold_words) from
``PREV_ROOT/src/repro_torch/kernels/csrc/`` (a checkout of an earlier
commit, for example ``git archive`` of it unpacked under ``build/``) and
from this checkout, both through ``kernels.build`` (with the other
kernels of the round, which ``check_kernels`` runs too).  Then it runs
``chip_smoke.check_kernels(20, 62006, timed=True)`` once per version and
turn, in the order previous, new, new, previous, with the version's
sources in use (``build.use_sources``), so both go through the same
checks against the plain versions and the same CUDA-event timing
(``chip_smoke.device_ms``).  Prints the card's name and power limit, each
run's kernel times, and as its last line a JSON object with every run and
the mean of each version's two.

``--profile`` then runs the same timed checks with each version under
``torch.profiler`` and prints, per kernel, the mean in-kernel device time
of its launches (CUPTI's kernel records) beside the CUDA-event time per
launch of the same run: their difference is the gap the card spends
between back-to-back launches.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / 'src'))
sys.path.insert(0, str(ROOT))


def profile_run(names) -> dict:
    """{kernel: (mean CUPTI kernel ms, CUDA-event ms per launch)} over one
    timed ``check_kernels`` run at the main shapes; a kernel whose
    records hold no device time maps to None."""
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = chip_smoke.check_kernels(chip_smoke.K, 62006, timed=True,
                                       seed=1)
    out = {}
    for name in names:
        total = count = 0
        for evt in prof.key_averages():
            if f'{name}_kernel' in evt.key:
                total += getattr(evt, 'self_device_time_total',
                                 getattr(evt, 'self_cuda_time_total', 0))
                count += evt.count
        out[name] = ((total / count / 1e3, res[name]['ms'])
                     if count and total else None)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('prev_root', type=Path)
    parser.add_argument('--kernels', nargs='+',
                        default=['spfl_accumulate', 'fold_words'])
    parser.add_argument('--profile', action='store_true',
                        help='split each launch into in-kernel time '
                             '(torch.profiler) and the gap between launches')
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('FAIL: no CUDA card', file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import build

    csrc = {'previous': (args.prev_root / build.CSRC.relative_to(ROOT))
            .resolve(), 'new': build.CSRC}
    for label in csrc:    # check_kernels runs every kernel of the round
        build.use_sources(csrc[label])
        build.build(chip_smoke.kernels_on('round'))
    card = chip_smoke.card_line()
    print(card, flush=True)
    runs = []
    try:
        for label in ('previous', 'new', 'new', 'previous'):
            build.use_sources(csrc[label])
            res = chip_smoke.check_kernels(chip_smoke.K, 62006, timed=True,
                                           seed=1)
            ms = {name: res[name]['ms'] for name in args.kernels}
            runs.append({'version': label, 'ms': ms})
            print(f'{label}: ' + ', '.join(f'{n} {t:.7f} ms'
                                           for n, t in ms.items()),
                  flush=True)
        profiles = {}
        if args.profile:
            for label in csrc:
                build.use_sources(csrc[label])
                profiles[label] = profile_run(args.kernels)
                for name, split in profiles[label].items():
                    print(f'{label} {name}: ' + (
                        'no device time in the profile' if split is None
                        else f'in-kernel {split[0]:.7f} ms of '
                        f'{split[1]:.7f} ms per launch, gap '
                        f'{split[1] - split[0]:.7f} ms'), flush=True)
    finally:
        build.use_sources()
    means = {label: {name: sum(r['ms'][name] for r in runs
                               if r['version'] == label) / 2
                     for name in args.kernels} for label in csrc}
    print(json.dumps({'card': card, 'runs': runs, 'mean_ms': means,
                      'profile': profiles}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
