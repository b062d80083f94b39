"""End-to-end driver: federated training of a language model with SP-FL
as the gradient transport (the port of the reference's
``examples/fl_train_lm.py``).

The default is a reduced SmolLM; ``--full`` trains the real ~135M
smollm-135m for a few hundred steps (sized for the card).

  PYTHONPATH=src python -m repro_torch.examples.fl_train_lm        # reduced
  PYTHONPATH=src python -m repro_torch.examples.fl_train_lm --full --steps 300

On the CUDA card unless ``--device cpu``.  ``--seq`` overrides the
sequence length: ``--full``'s
4 clients of 8 x 1024 tokens do not fit one 80 GB card (the dry run
counts 79.0 GB alive at once for one such client: every layer's float32
attention logits are kept for the backward), so on one card take
``--full --seq 256``.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import env
from repro_torch.launch.train import run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument('--full', action='store_true',
                    help='train the real smollm-135m (card-sized)')
    ap.add_argument('--steps', type=int, default=None)
    ap.add_argument('--clients', type=int, default=4)
    ap.add_argument('--seq', type=int, default=None,
                    help='tokens a sequence (default: 1024 with --full, '
                         'else 256)')
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain PyTorch path (default: the "
                         'CUDA card)')
    args = ap.parse_args(argv)
    env.configure_driver(args)
    arch = 'smollm-135m' if args.full else 'smollm-135m-reduced'
    steps = args.steps or (300 if args.full else 30)
    seq = args.seq or (1024 if args.full else 256)
    batch = 8 if args.full else 4
    h = run(arch, steps=steps, clients=args.clients, batch=batch, seq=seq,
            transport_kind='spfl', allocator='barrier', lr=0.05,
            bandwidth_hz=10e9, tx_power_dbm=-4.0, log_every=5,
            device=args.device)
    print(f'final loss: {h["loss"][-1]:.4f} (start {h["loss"][0]:.4f})')
    return h


if __name__ == '__main__':
    main()
