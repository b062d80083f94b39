"""The port's mixture-of-experts block (``repro_torch.models.moe``)
against ``repro.models.moe`` on the same numpy inputs and weights.

Contract: given the same float32 router logits, the routes (top-k
experts, ties to the lower index), the stable sort of the assignments,
each assignment's position within its expert, the kept/dropped verdicts,
``drop_frac`` and ``lb_loss`` are exact; the block's output is within
1e-5 (the expert GEMMs sum in another order); per-client gradients
through ``torch.func.vmap`` within rtol 1e-4 / atol 1e-6 of the leaf's
largest gradient (a block's gradients here are O(10), not a loss's
O(0.01))."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import registry as RR
from repro.models import moe as RM
from repro_torch import tree
from repro_torch.configs import registry as TR
from repro_torch.models import moe as TM


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    return (dataclasses.replace(RR.get_arch(name + '-reduced'), **kw),
            dataclasses.replace(TR.get_arch(name + '-reduced'), **kw))


def _params(cfg, seed):
    ref = RM.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return ref, tree.map(lambda a: torch.as_tensor(np.array(a)), ref)


def _ref_plan(probs, k, E, capacity, rows):
    """The reference's routing and sort-based plan, row by row, from
    ``repro/models/moe.py``'s own ops (``lax.top_k``, stable argsort,
    searchsorted)."""
    top_p, top_e = jax.lax.top_k(probs, k)
    out = []
    for r in range(rows):
        flat_e = top_e[r].reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        se = flat_e[order]
        starts = jnp.searchsorted(se, jnp.arange(E, dtype=se.dtype))
        pos = jnp.arange(flat_e.shape[0]) - starts[se]
        out.append(dict(order=order, se=se, pos=pos, kept=pos < capacity))
    return top_e, out


CASES = [('mixtral-8x7b', 1.25, 'flat'), ('mixtral-8x7b', 0.5, 'flat'),
         ('arctic-480b', 1.25, 'flat'), ('arctic-480b', 0.5, 'grouped'),
         ('mixtral-8x7b', 8.0, 'grouped')]


@pytest.mark.parametrize('name,cf,dispatch', CASES)
def test_routes_positions_drops_match_reference(name, cf, dispatch):
    cfg, tcfg = _cfgs(name, capacity_factor=cf, moe_dispatch=dispatch)
    ref, tp = _params(cfg, 0)
    x = np.random.RandomState(1).randn(3, 24, cfg.d_model).astype(
        np.float32)
    y, aux = RM.moe_forward(ref, cfg, jnp.asarray(x))
    ty, taux = TM.moe_forward(tp, tcfg, torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    assert float(taux['drop_frac']) == float(aux['drop_frac'])
    assert float(taux['lb_loss']) == float(aux['lb_loss'])
    if cf < 1.0:
        assert float(aux['drop_frac']) > 0.0          # tokens were dropped
    # the plan, on the same float32 logits
    grouped = dispatch == 'grouped'
    rows = 3 if grouped else 1
    xr = x if grouped else x.reshape(1, -1, cfg.d_model)
    cap = (TM.grouped_capacity(24, tcfg) if grouped
           else TM.expert_capacity(72, tcfg))
    assert cap == (RM.expert_capacity(72, cfg) if not grouped else cap)
    logits = xr @ np.asarray(ref['router'])
    probs_t, _, top_e_t = TM.route(tp, tcfg, torch.as_tensor(xr))
    top_e, plan = _ref_plan(jax.nn.softmax(jnp.asarray(logits), -1),
                            cfg.topk, cfg.n_experts, cap, rows)
    np.testing.assert_array_equal(top_e_t.numpy(), np.asarray(top_e))
    got = TM.dispatch_plan(top_e_t, cfg.n_experts, cap)
    for r in range(rows):
        for f in ('order', 'se', 'pos', 'kept'):
            np.testing.assert_array_equal(got[f][r].numpy(),
                                          np.asarray(plan[r][f]), f)


def test_tied_router_breaks_ties_to_the_lower_index():
    cfg, tcfg = _cfgs('arctic-480b', capacity_factor=0.5)
    ref, tp = _params(cfg, 2)
    ref['router'] = jnp.zeros_like(ref['router'])
    tp['router'] = torch.zeros_like(tp['router'])
    x = np.random.RandomState(3).randn(2, 8, cfg.d_model).astype(np.float32)
    _, _, top_e = TM.route(tp, tcfg, torch.as_tensor(x))
    want = jax.lax.top_k(jax.nn.softmax(jnp.zeros((2, 8, cfg.n_experts))),
                         cfg.topk)[1]
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(want))
    assert top_e[..., 0].eq(0).all() and top_e[..., 1].eq(1).all()
    y, aux = RM.moe_forward(ref, cfg, jnp.asarray(x))
    ty, taux = TM.moe_forward(tp, tcfg, torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    assert float(taux['drop_frac']) == float(aux['drop_frac']) > 0.0


def test_dense_residual_is_added():
    cfg, tcfg = _cfgs('arctic-480b', capacity_factor=8.0)
    assert tcfg.dense_residual
    ref, tp = _params(cfg, 4)
    assert tree.paths(tp) == [
        jax.tree_util.keystr(p, simple=True, separator='.')
        for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert 'dense.w_gate' in tree.paths(tp)
    x = np.random.RandomState(5).randn(2, 8, cfg.d_model).astype(np.float32)
    y, _ = TM.moe_forward(tp, tcfg, torch.as_tensor(x))
    bare = dict(tp)
    del bare['dense']
    y0, _ = TM.moe_forward(bare, dataclasses.replace(
        tcfg, dense_residual=False), torch.as_tensor(x))
    from repro_torch.models.mlp import mlp_forward
    torch.testing.assert_close(y, y0 + mlp_forward(tp['dense'],
                                                   torch.as_tensor(x)))


def test_moe_matches_dense_oracle():
    """Sort-based dispatch == a brute-force loop over the experts (ample
    capacity), the port's counterpart of ``tests/test_models.py``'s."""
    _, cfg = _cfgs('mixtral-8x7b', capacity_factor=8.0)
    gen = torch.Generator().manual_seed(5)
    params = TM.init_moe(gen, cfg, torch.float32)
    x = torch.randn((2, 8, cfg.d_model), generator=gen) * 0.5
    y, aux = TM.moe_forward(params, cfg, x)
    assert float(aux['drop_frac']) == 0.0
    xf = x.reshape(16, cfg.d_model)
    probs = torch.softmax(xf @ params['router'], -1)
    top_p, top_e = torch.topk(probs, cfg.topk)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y_ref = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        h = (torch.nn.functional.silu(xf @ params['w_gate'][e])
             * (xf @ params['w_up'][e]))
        out = h @ params['w_down'][e]
        for k in range(cfg.topk):
            w = torch.where(top_e[:, k] == e, top_p[:, k], 0.0)
            y_ref = y_ref + w[:, None] * out
    torch.testing.assert_close(y.reshape(16, -1), y_ref, rtol=2e-4,
                               atol=2e-4)


def test_moe_grouped_matches_flat():
    """Per-row dispatch == flat dispatch given ample capacity."""
    _, cfg = _cfgs('arctic-480b', capacity_factor=8.0)
    gen = torch.Generator().manual_seed(9)
    params = TM.init_moe(gen, cfg, torch.float32)
    x = torch.randn((3, 8, cfg.d_model), generator=gen) * 0.5
    y1, a1 = TM.moe_forward(params, cfg, x)
    y2, a2 = TM.moe_forward(params, dataclasses.replace(
        cfg, moe_dispatch='grouped'), x)
    torch.testing.assert_close(y1, y2, atol=3e-4, rtol=1e-4)
    assert float(a1['drop_frac']) == float(a2['drop_frac']) == 0.0


@pytest.mark.parametrize('dispatch', ['flat', 'grouped'])
def test_client_gradients_under_vmap(dispatch):
    """Each client's gradient of the block (routing and drops included,
    cf 0.5; a fixed linear read-out plus the aux loss) through
    ``torch.func.vmap``, against the reference's
    ``jax.vmap(jax.grad)``."""
    cfg, tcfg = _cfgs('mixtral-8x7b', capacity_factor=0.5,
                      moe_dispatch=dispatch)
    ref, tp = _params(cfg, 6)
    rng = np.random.RandomState(7)
    x = rng.randn(3, 2, 12, cfg.d_model).astype(np.float32)
    proj = rng.randn(2, 12, cfg.d_model).astype(np.float32)

    def ref_loss(p, xb):
        y, aux = RM.moe_forward(p, cfg, xb)
        return jnp.sum(y * proj) + aux['lb_loss']

    want = jax.jit(jax.vmap(jax.grad(ref_loss), in_axes=(None, 0)))(
        ref, jnp.asarray(x))

    def loss(ls, xb):
        y, aux = TM.moe_forward(tree.unflatten(tp, ls), tcfg, xb)
        return torch.sum(y * torch.as_tensor(proj)) + aux['lb_loss']

    got = vmap(grad(loss), in_dims=(None, 0))(tree.leaves(tp),
                                              torch.as_tensor(x))
    for a, b in zip(got, jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))
