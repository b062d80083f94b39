"""Serving launcher — batched prefill + decode over the model zoo (the
port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 4 --prompt-len 128 --new-tokens 32

runs on the CUDA card; ``--device cpu`` (or ``run(..., device='cpu')``)
takes the plain PyTorch path.  The weights are random, drawn from a
``torch.Generator`` on the device seeded with ``seed`` (the port's
initializers: not the reference's draws); the prompts are
``data.synthetic.synth_tokens`` at ``seed``; a vision model's prefix
embeddings are float32 normals from the same generator.
"""
from __future__ import annotations

import argparse
import time
from typing import Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data import synth_tokens
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import transformer as tf
from repro_torch.serving import generate


def run(arch: Union[str, ModelConfig], batch: int, prompt_len: int,
        new_tokens: int, temperature: float = 0.0, seed: int = 0,
        device: DeviceLike = None) -> dict:
    """Serve ``arch`` (a registry name, or a ``ModelConfig`` such as a
    registry entry cut in depth) -> {'seconds' (prefill and decode),
    'tokens_per_s' (batch x new_tokens over them), 'output' (batch,
    new_tokens) int32, 'prefill_ms', 'decode_ms_per_token' (the decode
    loop over its new_tokens - 1 steps)}, plus 'params', 'prompts' and
    'prefix' for a caller that checks the output."""
    dev = resolve(device)
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tf.init_params(cfg, gen, device=dev)
    prompts = torch.as_tensor(
        synth_tokens(batch, prompt_len, cfg.vocab_size, seed), device=dev)
    prefix = None
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        prefix = torch.randn((batch, cfg.n_prefix_tokens,
                              cfg.frontend_embed_dim), generator=gen,
                             dtype=torch.float32, device=dev)
    timings = {}
    t0 = time.perf_counter()
    out, _ = generate(params, cfg, prompts, new_tokens, prefix_embeds=prefix,
                      temperature=temperature, seed=seed, timings=timings)
    dt = time.perf_counter() - t0
    toks_per_s = batch * new_tokens / dt
    decode_ms = timings['decode_s'] * 1e3 / max(1, new_tokens - 1)
    print(f'arch={arch} batch={batch} prompt={prompt_len} '
          f'new={new_tokens}: {dt:.2f}s ({toks_per_s:.1f} tok/s; prefill '
          f'{timings["prefill_s"] * 1e3:.1f} ms, decode {decode_ms:.2f} '
          'ms/token)')
    print('sample:', out[0].tolist())
    return {'seconds': dt, 'tokens_per_s': toks_per_s, 'output': out,
            'prefill_ms': timings['prefill_s'] * 1e3,
            'decode_ms_per_token': decode_ms, 'params': params,
            'prompts': prompts, 'prefix': prefix}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default='smollm-135m-reduced')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--new-tokens', type=int, default=16)
    ap.add_argument('--temperature', type=float, default=0.0)
    ap.add_argument('--device', default=None,
                    help="'cpu' for the plain PyTorch path (default: the "
                         'CUDA card)')
    args = ap.parse_args(argv)
    return run(args.arch, args.batch, args.prompt_len, args.new_tokens,
               args.temperature, device=args.device)


if __name__ == '__main__':
    main()
