"""Quickstart: 15 rounds of SP-FL (Algorithm 2) on the paper's CNN setting
(the port of the reference's ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Shows every moving part: Dirichlet non-IID partition, Rayleigh uplink,
hierarchical resource allocation, sign/modulus packets with compensation,
and the resulting accuracy curve against an error-free run.  ``ROUNDS``
(environment) sets the rounds; the run is on the CUDA card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs.base import FLConfig
from repro_torch.launch import env
from repro_torch.training.fl_loop import build_simulator


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain PyTorch path (default: the "
                         'CUDA card)')
    args = ap.parse_args(argv)
    env.configure_driver(args)
    out = {}
    for kind in ('spfl', 'error_free'):
        fl = FLConfig(n_devices=8, transport=kind, allocator='barrier',
                      tx_power_dbm=-30.0)
        sim = build_simulator(fl, per_device=150, n_test=500,
                              device=args.device)
        hist = sim.run(int(os.environ.get('ROUNDS', '15')))
        print(f'\n== transport={kind} ==')
        for i, (l, a) in enumerate(zip(hist.loss, hist.test_acc)):
            print(f'round {i:3d}  loss {l:.4f}  acc {a:.3f}')
        print(f'mean sign-packet success: '
              f'{sum(hist.sign_ok_frac) / len(hist.sign_ok_frac):.3f}')
        print(f'mean modulus-packet success: '
              f'{sum(hist.mod_ok_frac) / len(hist.mod_ok_frac):.3f}')
        out[kind] = hist
    return out


if __name__ == '__main__':
    main()
