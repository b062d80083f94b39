"""Prefill, decode and serving in the port (``transformer.prefill``,
``decode_step``, ``serving.generate``, ``launch.serve``) against
``repro.models.transformer`` and ``repro.serving`` on the same numpy
inputs and weights, on all ten reduced architectures.

Contract: the prefill's last logits, every cache leaf and the decode
step's logits within rtol 1e-4 / atol 1e-5 of the reference's (float32
sums in another order); decode equals the full-sequence forward within
the reference's own 3e-3 (``tests/test_models.py``), MoE models at
capacity 8 (the two paths batch different token sets, so a drop could
otherwise differ); greedy ``generate`` gives the reference's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models import transformer as RT
from repro.serving import engine as RE
from repro_torch import tree
from repro_torch.configs import registry as TR
from repro_torch.launch import serve as TLS
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE

ALL = sorted(RR.ARCHITECTURES)
# the reference's prefill and decode step, compiled once a configuration
R_PREFILL = jax.jit(RT.prefill, static_argnames=('cfg', 'cache_len',
                                                 'cache_dtype'))
R_DECODE = jax.jit(RT.decode_step, static_argnames=('cfg',))


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, seed, B=2, T=12, **kw):
    cfg = RR.get_arch(name + '-reduced')
    tcfg = TR.get_arch(name + '-reduced')
    if cfg.is_moe:
        kw.setdefault('capacity_factor', 8.0)
    cfg = dataclasses.replace(cfg, **kw)
    tcfg = dataclasses.replace(tcfg, **kw)
    params = RT.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    prefix = None
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        prefix = rng.randn(B, cfg.n_prefix_tokens,
                           cfg.frontend_embed_dim).astype(np.float32)
    return cfg, tcfg, params, TT.params_from_reference(params), toks, prefix


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize('name', ALL)
def test_prefill_and_decode_match_reference(name):
    cfg, tcfg, params, tp, toks, prefix = _setup(name, 1)
    T = toks.shape[1]
    P = 0 if prefix is None else prefix.shape[1]
    rl, rc = R_PREFILL(params, cfg, _j(toks[:, :T - 1]), T + 4,
                       prefix_embeds=_j(prefix), cache_dtype=jnp.float32)
    with torch.no_grad():
        tl, tc = TT.prefill(tp, tcfg, _t(toks[:, :T - 1]), T + 4,
                            prefix_embeds=_t(prefix),
                            cache_dtype=torch.float32)
    _close(tl, rl)
    assert sorted(tc) == sorted(rc)
    for a, b in zip(tree.leaves(tc), jax.tree.leaves(rc)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        _close(a, b)
    rd, rc2 = R_DECODE(params, cfg, rc, _j(toks[:, T - 1:]), P + T - 1)
    with torch.no_grad():
        td, tc2 = TT.decode_step(tp, tcfg, tc, _t(toks[:, T - 1:]),
                                 P + T - 1)
    _close(td, rd)
    for a, b in zip(tree.leaves(tc2), jax.tree.leaves(rc2)):
        _close(a, b)
    # a zero cache has the reference's layout
    zero = TT.init_cache(tcfg, 2, T + 4, torch.float32)
    rzero = RT.init_cache(cfg, 2, T + 4, jnp.float32)
    assert [tuple(a.shape) for a in tree.leaves(zero)] == [
        b.shape for b in jax.tree.leaves(rzero)]


@pytest.mark.parametrize('name', ALL)
def test_decode_matches_forward(name):
    """The port's counterpart of ``tests/test_models.py``'s: prefill of
    T - 1 tokens then one decode step == the full forward's last logits."""
    cfg, tcfg, params, tp, toks, prefix = _setup(name, 2)
    T = toks.shape[1]
    P = 0 if prefix is None else prefix.shape[1]
    with torch.no_grad():
        hidden, _ = TT.forward(tp, tcfg, _t(toks), _t(prefix))
        full = TT.logits_fn(tp, tcfg, hidden[:, -1:])
        _, cache = TT.prefill(tp, tcfg, _t(toks[:, :T - 1]), T + 4,
                              prefix_embeds=_t(prefix),
                              cache_dtype=torch.float32)
        dec, _ = TT.decode_step(tp, tcfg, cache, _t(toks[:, T - 1:]),
                                P + T - 1)
    np.testing.assert_allclose(full.numpy(), dec.numpy(), atol=3e-3)


@pytest.mark.parametrize('name', ['gemma2-9b', 'mixtral-8x7b'])
def test_decode_through_a_wrapped_ring(name):
    """A prompt longer than the 64-token window: the sliding-window
    layers' ring has wrapped before decode starts, and wraps again
    while it runs; every step's logits equal the full forward's at that
    position (3e-3) and the reference's decode step's."""
    cfg, tcfg, params, tp, toks, _ = _setup(name, 3, T=74)
    assert tcfg.sliding_window == 64
    T0 = 70
    with torch.no_grad():
        hidden, _ = TT.forward(tp, tcfg, _t(toks))
        full = TT.logits_fn(tp, tcfg, hidden)
        _, cache = TT.prefill(tp, tcfg, _t(toks[:, :T0]), 80,
                              cache_dtype=torch.float32)
    _, rcache = R_PREFILL(params, cfg, _j(toks[:, :T0]), 80,
                          cache_dtype=jnp.float32)
    swa = [f'b{i}' for i, k in enumerate(tcfg.layer_pattern) if k == 'swa']
    assert swa and all(cache[b]['k'].shape[2] == 64 for b in swa)
    for t in range(T0, toks.shape[1]):
        with torch.no_grad():
            dec, cache = TT.decode_step(tp, tcfg, cache,
                                        _t(toks[:, t:t + 1]), t)
        rdec, rcache = R_DECODE(params, cfg, rcache, _j(toks[:, t:t + 1]),
                                t)
        np.testing.assert_allclose(dec.numpy()[:, 0], full.numpy()[:, t],
                                   atol=3e-3)
        _close(dec, rdec)


def test_batch_cache_layout_is_the_same_computation():
    """``decode_cache_layout='batch'`` is a sharding hint in the
    reference; in one process both layouts run the same code."""
    cfg, tcfg, params, tp, toks, _ = _setup('gemma2-9b', 4)
    out = []
    for layout in ('hd', 'batch'):
        c = dataclasses.replace(tcfg, decode_cache_layout=layout)
        with torch.no_grad():
            _, cache = TT.prefill(tp, c, _t(toks[:, :-1]), 20,
                                  cache_dtype=torch.float32)
            out.append(TT.decode_step(tp, c, cache, _t(toks[:, -1:]),
                                      toks.shape[1] - 1)[0])
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize('name', ['smollm-135m', 'mixtral-8x7b',
                                  'mamba2-130m', 'zamba2-2.7b',
                                  'paligemma-3b'])
def test_greedy_generate_matches_reference(name):
    cfg, tcfg, params, tp, toks, prefix = _setup(name, 5, T=8,
                                                 capacity_factor=1.25)
    want, wlogits = RE.generate(params, cfg, _j(toks), 6,
                                prefix_embeds=_j(prefix))
    got, logits = TE.generate(tp, tcfg, _t(toks), 6,
                              prefix_embeds=_t(prefix))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    _close(logits, wlogits)


def test_sampled_generate_is_reproducible_from_its_seed():
    _, tcfg, _, tp, toks, _ = _setup('smollm-135m', 6, T=8)
    runs = [TE.generate(tp, tcfg, _t(toks), 8, temperature=1.0, seed=s)[0]
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    greedy = TE.generate(tp, tcfg, _t(toks), 8)[0]
    # the first token is the prefill's argmax whatever the temperature
    assert torch.equal(runs[0][:, 0], greedy[:, 0])


def test_serve_run_on_the_cpu():
    res = TLS.run('paligemma-3b-reduced', batch=2, prompt_len=8,
                  new_tokens=5, device='cpu')
    assert tuple(res['output'].shape) == (2, 5)
    assert res['tokens_per_s'] > 0 and res['seconds'] > 0
    assert res['prefill_ms'] > 0 and res['decode_ms_per_token'] > 0
    assert tuple(res['prefix'].shape) == (2, 4, 64)
    again = TLS.main(['--arch', 'paligemma-3b-reduced', '--batch', '2',
                      '--prompt-len', '8', '--new-tokens', '5',
                      '--device', 'cpu'])
    assert torch.equal(again['output'], res['output'])
