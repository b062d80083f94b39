"""The rest of the model zoo in the port — mixture-of-experts (mixtral,
arctic), Mamba2 (mamba2-130m), Mamba2 with Zamba2's shared attention
block, the vision prefix (paligemma) and musicgen's audio decoder —
against ``repro.models.transformer`` on the same numpy inputs and
weights (``transformer.params_from_reference``), and one LLM-scale FL
step of each on the CPU.

Tolerances as ``tests/test_torch_models.py``: a reduced model's loss
within 1e-5 relative, its per-client gradients rtol 1e-4 / atol 1e-6,
the atol raised to 1e-5 of the leaf's largest |g| where that is larger
(a head's gradient sums 32 outer products: a coordinate that cancels
to near zero keeps the rounding of the large terms; one in 262,144 of
arctic's and musicgen's lm_head was 1.3-1.5e-6 off).
The MoE models are held where no route flips: routing is discontinuous,
and the two frameworks' hidden states differ by float32 rounding (the
blocks are held on shared inputs in ``tests/test_torch_moe.py``).
Names, shapes, dtypes and the leaf order are exact."""
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
from repro_torch.core import transport as TTR
from repro_torch.models import transformer as TT
from repro_torch.training import distributed as TD

ARCHS = ['mixtral-8x7b', 'arctic-480b', 'mamba2-130m', 'zamba2-2.7b',
         'paligemma-3b', 'musicgen-medium']
K = 2


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_paths(params):
    return [jax.tree_util.keystr(p, simple=True, separator='.')
            for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]


def _batch(cfg, seed, b=2, t=17):
    rng = np.random.RandomState(seed)
    out = {'tokens': rng.randint(0, cfg.vocab_size, (K, b, t)).astype(
        np.int32)}
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        out['prefix'] = rng.randn(K, b, cfg.n_prefix_tokens,
                                  cfg.frontend_embed_dim).astype(np.float32)
    return out


@pytest.mark.parametrize('name', ARCHS)
def test_loss_and_client_grads_match_reference(name):
    cfg = RR.get_arch(name + '-reduced')
    tcfg = TR.get_arch(name + '-reduced')
    params = RT.init_params(cfg, jax.random.PRNGKey(3))
    batch = _batch(cfg, 4)

    def one(p, bk):
        return jax.value_and_grad(
            lambda pp: RT.loss_fn(pp, cfg, bk['tokens'], bk.get('prefix')))(p)

    losses, grads = jax.jit(jax.vmap(one, in_axes=(None, 0)))(
        params, jax.tree.map(jnp.asarray, batch))
    tp = TT.params_from_reference(params)
    tb = tree.map(torch.as_tensor, batch)
    got_losses, got = TD.client_grads(tp, tcfg, tb['tokens'],
                                      prefix=tb.get('prefix'))
    np.testing.assert_allclose(got_losses.numpy(), np.asarray(losses),
                               rtol=1e-5)
    assert tree.paths(got) == _ref_paths(grads)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(grads)):
        assert tuple(a.shape) == b.shape
        b = np.asarray(b)
        np.testing.assert_allclose(
            a.numpy(), b, rtol=1e-4,
            atol=max(1e-6, 1e-5 * float(np.abs(b).max())))
    with torch.no_grad():
        loss0 = TT.Transformer(tcfg, tp).loss(tb['tokens'][0],
                                              tb.get('prefix', [None])[0])
    np.testing.assert_allclose(float(loss0), float(losses[0]), rtol=1e-5)


@pytest.mark.parametrize('name', ARCHS)
def test_leaf_order_names_and_dtypes(name):
    """The port's own tree has the reference's paths (``shared``,
    ``frontend_proj`` included), shapes and dtypes: in a bf16 model the
    router, ``A_log``, ``D`` and ``dt_bias`` are float32 leaves."""
    cfg = dataclasses.replace(RR.get_arch(name + '-reduced'),
                              param_dtype='bfloat16')
    tcfg = dataclasses.replace(TR.get_arch(name + '-reduced'),
                               param_dtype='bfloat16')
    ref = RT.init_params(cfg, jax.random.PRNGKey(0))
    own = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    paths = _ref_paths(ref)
    assert tree.paths(own) == paths
    assert tree.paths(TT.params_from_reference(ref)) == paths
    f32 = []
    for path, a, b in zip(paths, tree.leaves(own), jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).removeprefix('torch.') == str(b.dtype), path
        if a.dtype == torch.float32:
            f32.append(path.split('.')[-1])
    want = set()
    if tcfg.is_moe:
        want.add('router')
    if 'mamba' in tcfg.layer_pattern:
        want |= {'A_log', 'D', 'dt_bias'}
    assert set(f32) == want
    assert ('shared.attn.wq' in paths) == ('shared_attn' in
                                           tcfg.layer_pattern)
    assert ('frontend_proj' in paths) == bool(tcfg.frontend_embed_dim)
    if name == 'musicgen-medium':
        assert tcfg.frontend == 'audio' and 'frontend_proj' not in paths
    module = TT.Transformer(tcfg, own)
    assert set(dict(module.named_parameters())) == set(paths)


@pytest.mark.parametrize('name,dtype', [(a, 'float32') for a in ARCHS]
                         + [('mixtral-8x7b', 'bfloat16'),
                            ('mamba2-130m', 'bfloat16')])
def test_fl_train_step_on_the_cpu(name, dtype):
    """One packed-wire ``make_fl_train_step`` step of each (paligemma
    given its prefix batch; in bf16, a tree of bf16 and float32 leaves):
    finite losses, every leaf moved or kept in its dtype, ḡ float32."""
    cfg = dataclasses.replace(TR.get_arch(name + '-reduced'),
                              param_dtype=dtype)
    params = TT.init_params(cfg, torch.Generator().manual_seed(1))
    fl = FLConfig(n_devices=K, wire='packed', learning_rate=0.05)
    sizes = [int(x.numel()) for x in tree.leaves(params)]
    draws = TTR.make_tree_draws(K, sizes, 0, fl.channel, 'cpu',
                                torch.Generator().manual_seed(2),
                                torch.Generator().manual_seed(3))
    batch = tree.map(torch.as_tensor, _batch(cfg, 5, t=16))
    step = TD.make_fl_train_step(cfg, fl, 'spfl')
    q = torch.tensor([1.0, 0.8])
    new_params, new_gbar, m = step(params, batch, TD.init_gbar(params), q,
                                   torch.ones(K), draws)
    assert bool(torch.isfinite(m['client_losses']).all())
    moved = 0.0
    for a, b, g in zip(tree.leaves(new_params), tree.leaves(params),
                       tree.leaves(new_gbar)):
        assert a.dtype == b.dtype and g.dtype == torch.float32
        assert bool(torch.isfinite(a).all())
        moved += float(torch.sum(torch.abs(a.float() - b.float())))
    assert moved > 0.0
    if dtype != 'float32':
        assert {str(x.dtype) for x in tree.leaves(new_params)} == {
            'torch.float32', 'torch.bfloat16'}
    if name == 'arctic-480b':
        std, sm = TD.make_standard_train_step(cfg, fl)(
            params, {'tokens': batch['tokens'][0]})
        assert float(sm['g_norm_sq']) > 0.0
        with torch.no_grad():
            want = TT.loss_fn(params, cfg, batch['tokens'][0])
        np.testing.assert_allclose(float(sm['loss']), float(want),
                                   rtol=1e-6)
    if 'prefix' in batch:
        one = {'tokens': batch['tokens'][0], 'prefix': batch['prefix'][0]}
        std, sm = TD.make_standard_train_step(cfg, fl)(params, one)
        ev = TD.make_eval_step(cfg)(params, one)
        np.testing.assert_allclose(float(sm['loss']), float(ev), rtol=1e-6)
        np.testing.assert_allclose(float(ev), float(m['client_losses'][0]),
                                   rtol=1e-5)


def test_round_kernels_refuse_sizes_past_32_bit_ints():
    """mixtral-8x7b's largest leaf (w_gate, 8 x 4,096 x 14,336 values a
    client) fits the round kernels' int arguments; a size past 2^31 - 1
    is refused, not truncated."""
    from repro_torch.kernels import ops
    from repro_torch.wire import format as fmt
    n = 8 * 4096 * 14336
    assert n == 469_762_048
    ops._int_args('quantize_pack', k=2, n=n,
                  knob_words=fmt.n_groups(n) * 3)
    with pytest.raises(ValueError, match='32-bit int'):
        ops._int_args('spfl_accumulate', k=2, n=2 ** 31)


def test_launcher_runs_the_zoo_on_the_bit_channel(tmp_path):
    """``launch.train.run`` on the new zoo: ``channel='bitlevel'``
    reaches the run's ``FLConfig`` (its manifest), and a ``ModelConfig``
    cut in depth runs as ``arch``."""
    from repro_torch.launch import train as LT
    from repro_torch.obs import read_jsonl
    path = str(tmp_path / 'zoo.jsonl')
    hist = LT.run('mamba2-130m-reduced', steps=2, clients=2, batch=1,
                  seq=16, transport_kind='spfl', allocator='barrier',
                  lr=0.05, bandwidth_hz=10e9, tx_power_dbm=-4.0,
                  wire='packed', channel='bitlevel',
                  allocation_backend='jax', telemetry_path=path,
                  device='cpu')
    assert len(hist['loss']) == 2 and all(np.isfinite(hist['loss']))
    manifest, rows = read_jsonl(path)
    assert manifest['config']['channel'] == 'bitlevel' and len(rows) == 2
    one_layer = dataclasses.replace(TR.get_arch('mixtral-8x7b-reduced'),
                                    n_layers=1)
    hist = LT.run(one_layer, steps=1, clients=2, batch=1, seq=16,
                  transport_kind='spfl', allocator='uniform', lr=0.05,
                  bandwidth_hz=10e9, tx_power_dbm=-4.0, device='cpu')
    assert np.isfinite(hist['loss'][0])
