"""Batched serving over the model zoo: prefill a batch of prompts and
decode continuations (the port of the reference's
``examples/serve_batched.py``).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched \
      --arch mamba2-130m-reduced

On the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from repro_torch.launch import env
from repro_torch.launch.serve import run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='smollm-135m-reduced')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--new-tokens', type=int, default=16)
    ap.add_argument('--temperature', type=float, default=0.8)
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain PyTorch path (default: the "
                         'CUDA card)')
    args = ap.parse_args(argv)
    env.configure_driver(args)
    return run(args.arch, args.batch, args.prompt_len, args.new_tokens,
               args.temperature, device=args.device)


if __name__ == '__main__':
    main()
