"""``ModelConfig.remat_policy`` in the port (``models.transformer.forward``,
the reference's ``jax.checkpoint`` of each group): on five reduced
variants (dense, Zamba2's shared block, the MoE aux, Mamba2, the vision
prefix) the per-client losses and gradients under 'full' and 'dots'
equal 'none' bit for bit, through ``training.distributed.client_grads``
(``vmap`` of ``grad_and_value``) and through plain autograd (the standard
step's path); both stay within ``tests/test_torch_zoo.py``'s tolerances
of the reference's ``value_and_grad(loss_fn)`` under the same policy; an
unknown policy is 'full'; and on the meta device the peak of live bytes
of one FL step (``launch.dryrun.LiveBytes``) falls from 'none' to 'dots'
to 'full'.  Zamba2 runs three groups here (the reduced variant has one),
so its shared block's gradient sums over three uses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models import transformer as RT
from repro_torch import tree
from repro_torch.configs import registry as TR
from repro_torch.configs.base import FLConfig
from repro_torch.core import transport as tr
from repro_torch.launch import dryrun
from repro_torch.models import transformer as TT
from repro_torch.training import distributed as TD

ARCHS = ['smollm-135m', 'zamba2-2.7b', 'mixtral-8x7b', 'mamba2-130m',
         'paligemma-3b']
POLICIES = ('full', 'dots')
K = 2


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name: str, policy: str):
    """(reference, port) configurations of the reduced variant under
    ``policy`` (Zamba2 with three groups)."""
    extra = {'n_layers': 6} if name.startswith('zamba2') else {}
    ref = dataclasses.replace(RR.get_arch(name + '-reduced'),
                              remat_policy=policy, **extra)
    own = dataclasses.replace(TR.get_arch(name + '-reduced'),
                              remat_policy=policy, **extra)
    return ref, own


def _batch(cfg, seed: int, b: int = 2, t: int = 17) -> dict:
    rng = np.random.RandomState(seed)
    out = {'tokens': rng.randint(0, cfg.vocab_size, (K, b, t)).astype(
        np.int32)}
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        out['prefix'] = rng.randn(K, b, cfg.n_prefix_tokens,
                                  cfg.frontend_embed_dim).astype(np.float32)
    return out


def _port_grads(params, cfg, batch):
    """Per-client (losses, gradient leaves) and client 0's plain-autograd
    (loss, gradient leaves)."""
    toks = torch.as_tensor(batch['tokens'])
    pre = batch.get('prefix')
    pre = None if pre is None else torch.as_tensor(pre)
    losses, grads = TD.client_grads(params, cfg, toks, prefix=pre)
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss = TT.loss_fn(tree.unflatten(params, leaves), cfg, toks[0],
                      None if pre is None else pre[0])
    plain = torch.autograd.grad(loss, leaves)
    return (losses, tree.leaves(grads)), (loss.detach(), list(plain))


def _same(a, b) -> list:
    """Where two (loss, leaves) pairs differ in any bit."""
    bad = [] if torch.equal(a[0], b[0]) else ['loss']
    return bad + [i for i, (x, y) in enumerate(zip(a[1], b[1]))
                  if not torch.equal(x, y)]


@pytest.fixture(scope='module')
def runs():
    """Each variant's reference weights, batch and the port's results
    under every policy (one pass a policy; 'bogus' is unknown)."""
    out = {}
    for name in ARCHS:
        ref_cfg, _ = _cfgs(name, 'full')
        ref_params = RT.init_params(ref_cfg, jax.random.PRNGKey(5))
        batch = _batch(ref_cfg, 6)
        params = TT.params_from_reference(ref_params)
        res = {pol: _port_grads(params, _cfgs(name, pol)[1], batch)
               for pol in ('none', 'full', 'dots', 'bogus')}
        out[name] = dict(ref_params=ref_params, batch=batch, res=res)
    return out


@pytest.mark.parametrize('policy', POLICIES + ('bogus',))
@pytest.mark.parametrize('name', ARCHS)
def test_gradients_equal_the_kept_activations(runs, name, policy):
    none = runs[name]['res']['none']
    got = runs[name]['res'][policy]
    for path in range(2):          # vmapped per-client, plain autograd
        assert _same(got[path], none[path]) == [], (name, policy, path)


@pytest.mark.parametrize('policy', POLICIES)
@pytest.mark.parametrize('name', ARCHS)
def test_within_the_reference_under_the_same_policy(runs, name, policy):
    ref_cfg, _ = _cfgs(name, policy)
    run = runs[name]

    def one(p, bk):
        return jax.value_and_grad(lambda pp: RT.loss_fn(
            pp, ref_cfg, bk['tokens'], bk.get('prefix')))(p)

    losses, grads = jax.jit(jax.vmap(one, in_axes=(None, 0)))(
        run['ref_params'], jax.tree.map(jnp.asarray, run['batch']))
    got_losses, got = run['res'][policy][0]
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(losses),
                               rtol=1e-5)
    for a, b in zip(got, jax.tree.leaves(grads)):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=1e-4,
            atol=max(1e-6, 1e-5 * float(np.abs(b).max())))


def _peak(cfg) -> int:
    """The most bytes alive at once in one FL step (K = 2 clients of 2 x
    256 tokens) on the meta device."""
    meta = torch.device('meta')
    params = TT.init_params(cfg, torch.Generator(), device=meta)
    step = TD.make_fl_train_step(cfg, FLConfig(n_devices=K))
    batch = {'tokens': torch.empty((K, 2, 256), dtype=torch.int32,
                                   device=meta)}
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        batch['prefix'] = torch.empty(
            (K, 2, cfg.n_prefix_tokens, cfg.frontend_embed_dim),
            device=meta)
    gbar = tree.map(lambda x: torch.empty(x.shape, device=meta), params)
    q = torch.empty((K,), device=meta)
    draws = tr.TreeDraws(
        dryrun.MetaUniforms(K, [x.numel() for x in tree.leaves(params)]),
        sign_u=torch.empty((1, K), device=meta),
        mod_u=torch.empty((K,), device=meta))
    with dryrun.LiveBytes() as live:
        step(params, batch, gbar, q, q, draws)
    return live.peak


@pytest.mark.parametrize('name', ARCHS)
def test_peak_live_bytes_fall_none_dots_full(name):
    peaks = {pol: _peak(_cfgs(name, pol)[1])
             for pol in ('none', 'dots', 'full', 'bogus')}
    assert peaks['none'] > peaks['dots'] > peaks['full'], peaks
    assert peaks['bogus'] == peaks['full'], peaks


def test_no_grad_forward_keeps_nothing_extra():
    """Outside grad mode (evaluation, serving) every policy runs the
    groups as they are: the same hidden states and aux loss."""
    _, cfg = _cfgs('mixtral-8x7b', 'full')
    params = TT.init_params(cfg, torch.Generator().manual_seed(1))
    toks = torch.as_tensor(_batch(cfg, 2)['tokens'][0])
    with torch.no_grad():
        outs = [TT.forward(params, dataclasses.replace(
            cfg, remat_policy=pol), toks) for pol in ('none', 'full', 'dots')]
    for h, aux in outs[1:]:
        assert torch.equal(h, outs[0][0]) and torch.equal(aux, outs[0][1])
