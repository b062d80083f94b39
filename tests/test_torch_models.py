"""The port's dense model zoo (``repro_torch.models``, ``configs``)
against ``repro.models`` and ``repro.configs`` on the same numpy inputs
and weights (``transformer.params_from_reference``).

Tolerances: the primitives rtol 1e-5 / atol 1e-6; a reduced model's
loss within 1e-5 relative and its per-client gradients rtol 1e-4 /
atol 1e-6 (the two frameworks sum the products in different orders in
float32).  Parameter counts, names, shapes and the leaf order are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models import attention as RA
from repro.models import common as RCM
from repro.models import mlp as RM
from repro.models import transformer as RT
from repro_torch import tree
from repro_torch.configs import registry as TR
from repro_torch.models import attention as TA
from repro_torch.models import common as TCM
from repro_torch.models import mlp as TM
from repro_torch.models import transformer as TT
from repro_torch.training import distributed as TD

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', sorted(RR.ARCHITECTURES))
def test_param_counts_match_reference(name):
    for n in (name, name + '-reduced'):
        ref, port = RR.get_arch(n), TR.get_arch(n)
        assert port.param_count() == ref.param_count(), n
        assert port.active_param_count() == ref.active_param_count(), n
        assert port.layer_kinds() == ref.layer_kinds(), n
    assert TR.get_arch('smollm-135m').param_count() == 134_515_008


def test_unknown_arch_and_shapes():
    with pytest.raises(KeyError):
        TR.get_arch('nope')
    assert TR.get_shape('train_4k') == TR.INPUT_SHAPES['train_4k']
    assert (TR.INPUT_SHAPES['long_500k'].seq_len
            == RR.INPUT_SHAPES['long_500k'].seq_len)


@pytest.mark.parametrize('name', ['mixtral-8x7b', 'mamba2-130m',
                                  'zamba2-2.7b', 'paligemma-3b'])
def test_non_dense_archs_name_their_roadmap_item(name):
    """The four non-dense families (ROADMAP Queue 1 item 13 (a)-(c)) build
    and take one FL step: no block kind or frontend is refused."""
    from repro_torch.core import transport as TTR
    cfg = TR.get_arch(name + '-reduced')
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    fl = TD.FLConfig(n_devices=2, wire='packed')
    sizes = [int(x.numel()) for x in tree.leaves(params)]
    draws = TTR.make_tree_draws(2, sizes, 0, fl.channel, 'cpu',
                                torch.Generator().manual_seed(1),
                                torch.Generator().manual_seed(2))
    batch = {'tokens': torch.as_tensor(_tokens(cfg, (2, 1, 9), 3))}
    if cfg.n_prefix_tokens:
        batch['prefix'] = torch.randn(
            (2, 1, cfg.n_prefix_tokens, cfg.frontend_embed_dim),
            generator=torch.Generator().manual_seed(4))
    new_params, _, m = TD.make_fl_train_step(cfg, fl)(
        params, batch, TD.init_gbar(params), torch.ones(2), torch.ones(2),
        draws)
    assert bool(torch.isfinite(m['client_losses']).all())
    assert [x.shape for x in tree.leaves(new_params)] == \
        [x.shape for x in tree.leaves(params)]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_rms_norm_and_softcap():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32) * 2.0
    scale = rng.randn(64).astype(np.float32) * 0.1
    _close(TCM.rms_norm(_t(x), _t(scale), 1e-6),
           RCM.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    _close(TCM.softcap(_t(x * 20), 30.0), RCM.softcap(jnp.asarray(x * 20),
                                                      30.0))
    assert torch.equal(TCM.softcap(_t(x), 0.0), _t(x))   # cap 0: identity


def test_apply_rope():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 37, 3, 32).astype(np.float32)
    pos = np.arange(37, dtype=np.int32) + 5
    np.testing.assert_array_equal(TCM.rope_frequencies(32, 1e4),
                                  RCM.rope_frequencies(32, 1e4))
    _close(TCM.apply_rope(_t(x), _t(pos), 1e4),
           RCM.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


@pytest.mark.parametrize('window,cap,q_chunk', [
    (0, 0.0, 1024), (8, 0.0, 1024), (0, 50.0, 16), (8, 5.0, 16)])
def test_gqa_attention(window, cap, q_chunk):
    rng = np.random.RandomState(2)
    B, T, H, KV, hd = 2, 37, 4, 2, 16
    q = rng.randn(B, T, H, hd).astype(np.float32)
    k = rng.randn(B, T, KV, hd).astype(np.float32)
    v = rng.randn(B, T, KV, hd).astype(np.float32)
    pos = np.arange(T, dtype=np.int32)
    want = RA.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), window=window, cap=cap, q_chunk=q_chunk)
    got = TA.multi_head_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                  window=window, cap=cap, q_chunk=q_chunk)
    _close(got, want)


def test_mlp():
    rng = np.random.RandomState(3)
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32) for n, s in
              (('w_gate', (32, 48)), ('w_up', (32, 48)),
               ('w_down', (48, 32)))}
    x = rng.randn(2, 5, 32).astype(np.float32)
    _close(TM.mlp_forward(tree.map(_t, params), _t(x)),
           RM.mlp_forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))


@pytest.mark.parametrize('cap', [0.0, 30.0])
def test_chunked_softmax_xent_ragged_chunks(cap):
    rng = np.random.RandomState(4)
    B, T, D, V = 2, 37, 16, 50
    x = rng.randn(B, T, D).astype(np.float32)
    emb = (rng.randn(D, V) * 0.3).astype(np.float32)
    labels = rng.randint(0, V, (B, T)).astype(np.int32)
    mask = (rng.rand(B, T) < 0.8).astype(np.float32)
    want = RCM.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(emb),
                                    jnp.asarray(labels), jnp.asarray(mask),
                                    cap, chunk=16)
    got = TCM.chunked_softmax_xent(_t(x), _t(emb), _t(labels), _t(mask),
                                   cap, chunk=16)
    _close(got, want)


# ---------------------------------------------------------------------------
# whole reduced models on the reference's weights
# ---------------------------------------------------------------------------

def _tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope='module')
def smollm():
    """Reduced smollm: the reference's weights, per-client losses and
    gradients of 3 clients' (2, 33) batches."""
    cfg = RR.get_arch('smollm-135m-reduced')
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    toks = _tokens(cfg, (3, 2, 33), 5)
    one = jax.value_and_grad(lambda p, t: RT.loss_fn(p, cfg, t))
    losses, grads = jax.jit(jax.vmap(one, in_axes=(None, 0)))(
        params, jnp.asarray(toks))
    return cfg, params, toks, np.asarray(losses), grads


def test_leaf_order_names_and_module(smollm):
    cfg, params, _, _, _ = smollm
    tp = TT.params_from_reference(params)
    ref_leaves = jax.tree.leaves(params)
    got = tree.leaves(tp)
    assert len(got) == len(ref_leaves) == 11
    for a, b in zip(got, ref_leaves):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref_paths = [jax.tree_util.keystr(p, simple=True, separator='.')
                 for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert tree.paths(tp) == ref_paths
    assert ref_paths[:3] == ['embed', 'final_norm', 'groups.b0.attn.wk']
    model = TT.Transformer(TR.get_arch(cfg.name), tp)
    names = dict(model.named_parameters())
    assert set(names) == set(ref_paths)
    assert names['groups.b0.attn.wq'].shape[0] == TT.n_groups(cfg)
    assert sum(x.numel() for x in tree.leaves(tp)) == cfg.param_count()
    # the port's own initializer gives the same tree
    own = TT.init_params(TR.get_arch(cfg.name),
                         torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree.leaves(own)] == \
        [tuple(x.shape) for x in ref_leaves]
    assert tree.paths(own) == ref_paths


def test_reduced_smollm_loss_and_client_grads(smollm):
    cfg, params, toks, losses, grads = smollm
    tcfg = TR.get_arch(cfg.name)
    tp = TT.params_from_reference(params)
    model = TT.Transformer(tcfg, tp)
    with torch.no_grad():
        loss0 = model.loss(_t(toks[0]))
    np.testing.assert_allclose(float(loss0), losses[0], rtol=1e-5)
    got_losses, got = TD.client_grads(tp, tcfg, _t(toks))
    np.testing.assert_allclose(got_losses.numpy(), losses, rtol=1e-5)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(grads)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize('name', ['gemma2-9b-reduced', 'qwen2.5-32b-reduced',
                                  'musicgen-medium-reduced'])
def test_reduced_dense_variants_loss(name):
    """gemma2: alternating sliding-window/global layers, attention and
    logit soft-capping, post-norms, embedding scale, tied head (the
    sequence longer than its 64-token window); qwen2.5: QKV bias, an
    untied head, rope theta 1e6; musicgen: the audio frontend, which has
    no projector and no prefix (a dense decoder over the EnCodec codes)."""
    cfg = RR.get_arch(name)
    params = RT.init_params(cfg, jax.random.PRNGKey(1))
    # non-zero norm scales and biases, so their layout counts too
    rng = np.random.RandomState(6)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + (0.05 * rng.randn(*a.shape)).astype(a.dtype)
        if str(p[-1].key).startswith(('ln', 'pln', 'b', 'final'))
        else a, params)
    toks = _tokens(cfg, (2, 80), 7)
    want = jax.jit(lambda p, t: RT.loss_fn(p, cfg, t))(params,
                                                      jnp.asarray(toks))
    with torch.no_grad():
        got = TT.loss_fn(TT.params_from_reference(params),
                         TR.get_arch(name), _t(toks))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
