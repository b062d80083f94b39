"""Batched serving: prefill + autoregressive decode over the model zoo
(the port of ``repro.serving.engine``).

``generate`` runs the prompt through ``transformer.prefill`` into a
float32 cache, takes the first new token greedily from the prefill's
last logits (as the reference does, whatever the temperature), then
decodes one token a ``transformer.decode_step``: greedy, or with
``temperature > 0`` a Gumbel-max draw (the reference's
``jax.random.categorical``) whose uniforms come from one
``torch.Generator`` on the device seeded with ``seed``, one (B, V) draw a
step, so a sampled run is reproducible from its seed but its draws are
not jax's.  The loop runs eagerly, a ``decode_step`` a token; the new
token's position stays on the device (no host read inside the loop).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf

Tensor = torch.Tensor


def _next_token(logits: Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> Tensor:
    """(B, 1, V) logits -> (B, 1) int32: the argmax (first of equals), or
    the Gumbel-max draw at ``temperature``."""
    logits = logits[:, 0].to(torch.float32)
    if temperature > 0:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        logits = logits / temperature - torch.log(-torch.log(u))
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: Tensor, n_new: int,
             cache_len: Optional[int] = None,
             prefix_embeds: Optional[Tensor] = None,
             temperature: float = 0.0, seed: int = 0,
             timings: Optional[dict] = None) -> Tuple[Tensor, Tensor]:
    """prompt: (B, Tp) int -> (generated (B, n_new) int32, the prefill's
    last logits (B, 1, V)).  ``timings`` (a dict), when given, gets the
    wall seconds of the prefill (``prefill_s``) and of the decode loop
    (``decode_s``), each closed by a device synchronisation."""
    B, Tp = prompt.shape
    dev = prompt.device
    P = prefix_embeds.shape[1] if prefix_embeds is not None else 0
    cache_len = cache_len or (P + Tp + n_new + 8)
    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, cfg, prompt, cache_len,
                               prefix_embeds=prefix_embeds,
                               cache_dtype=torch.float32)
    token = _next_token(logits, 0.0, None)
    if timings is not None:
        _sync(dev)
        timings['prefill_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    generator = (torch.Generator(device=dev).manual_seed(seed)
                 if temperature > 0 else None)
    pos = torch.full((), P + Tp, dtype=torch.int32, device=dev)
    out = [token]
    for _ in range(n_new - 1):
        step_logits, cache = tf.decode_step(params, cfg, cache, token, pos)
        token = _next_token(step_logits, temperature, generator)
        out.append(token)
        pos = pos + 1
    tokens = torch.cat(out, dim=1)
    if timings is not None:
        _sync(dev)
        timings['decode_s'] = time.perf_counter() - t0
    return tokens, logits
