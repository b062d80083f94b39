"""Resource-allocation anatomy: how the hierarchical allocator (Algorithm
1) splits power between sign/modulus packets and bandwidth across devices
as the power budget shrinks — Remarks 1 and 2 made visible (the port of
the reference's ``examples/allocation_demo.py``).

  PYTHONPATH=src python -m repro_torch.examples.allocation_demo [--device cpu]

The five powers' eq. (28) problems are solved as one batch where their
tensors lie: one ``alloc_solve`` launch on the CUDA card, the plain
version with ``--device cpu``.  The placement is drawn from a ``torch.Generator``
seeded 0, so the table is the reference's in law, not bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import allocation as AL
from repro_torch.core import allocation_jax as AJ
from repro_torch.core import channel as CH
from repro_torch.device import resolve
from repro_torch.launch import env

POWERS_DBM = (-4.0, -20.0, -28.0, -34.0, -40.0)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain PyTorch path (default: the "
                         'CUDA card)')
    args = ap.parse_args(argv)
    env.configure_driver(args)
    dev = resolve(args.device)
    k = 8
    dist = CH.sample_distances(torch.Generator().manual_seed(0), k, 500.0)
    gains = CH.path_gain(np.asarray(dist, np.float64), 3.0)
    g2 = np.linspace(0.2, 4.0, k)               # client importance ramp
    gb2 = np.full(k, 0.4)
    v = np.sqrt(g2 * gb2) * 0.5
    d2 = np.full(k, 0.05)

    probs = []
    for power in POWERS_DBM:
        fl = dataclasses.replace(FLConfig(), tx_power_dbm=power)
        p_w = np.full(k, fl.tx_power_w)
        probs.append(AL.problem_from_stats(g2, gb2, v, d2, gains, p_w, 60000,
                                           fl))
    # the five problems in one batched solve
    sol = AJ.solve_batched(AJ.stack_problems(probs, device=dev),
                           'alternating', max_iters=2)
    alpha, beta, q, p = (x.detach().cpu().numpy()
                         for x in (sol.alpha, sol.beta, sol.q, sol.p))
    print(f'{"P(dBm)":>8} {"mean a*":>8} {"mean q":>8} {"mean p":>8} '
          f'{"corr(g2,beta)":>14}')
    rows = []
    for i, power in enumerate(POWERS_DBM):
        corr = float(np.corrcoef(g2, beta[i])[0, 1])
        print(f'{power:8.1f} {alpha[i].mean():8.3f} {q[i].mean():8.4f} '
              f'{p[i].mean():8.4f} {corr:14.3f}')
        rows.append({'power_dbm': power, 'alpha': float(alpha[i].mean()),
                     'q': float(q[i].mean()), 'p': float(p[i].mean()),
                     'corr_g2_beta': corr})
    print('\nNote: as power shrinks, q (sign) is held above p (modulus) — '
          'Remark 2 — and bandwidth correlates with ||g_k||^2 — Remark 1.')
    return rows


if __name__ == '__main__':
    main()
