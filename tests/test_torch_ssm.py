"""The port's Mamba2 block (``repro_torch.models.ssm``) and its gated
norm against ``repro.models.ssm`` and ``repro.models.common`` on the same
numpy inputs and weights, and against the exact recurrence.

Tolerances: primitives rtol 1e-5 / atol 1e-6; the chunked scan against
the reference within 1e-5 (the within-chunk products sum in another
order) and against the naive recurrence within 2e-4 (the reference's
own oracle tolerance); a block's output and cache within 1e-5;
decode continuing a prefill within rtol 1e-3 / atol 1e-4 (the
reference's ``test_ssd_decode_continues_prefill``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RR
from repro.models import common as RCM
from repro.models import ssm as RS
from repro_torch import tree
from repro_torch.configs import registry as TR
from repro_torch.models import common as TCM
from repro_torch.models import ssm as TS


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_gated_rms_norm_and_softplus():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 48).astype(np.float32)
    z = rng.randn(2, 5, 48).astype(np.float32) * 3
    scale = rng.randn(48).astype(np.float32) * 0.1
    _close(TCM.gated_rms_norm(_t(x), _t(z), _t(scale), 1e-5),
           RCM.gated_rms_norm(jnp.asarray(x), jnp.asarray(z),
                              jnp.asarray(scale), 1e-5))
    v = np.concatenate([rng.randn(64) * 10, [-100.0, -30.0, 0.0, 30.0,
                                            100.0]]).astype(np.float32)
    _close(TCM.softplus(_t(v)), jax.nn.softplus(jnp.asarray(v)))


def _scan_inputs(seed, B=2, T=32, H=3, P=8, S=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, H, P).astype(np.float32) * 0.5,
            -np.abs(rng.randn(B, T, H)).astype(np.float32) * 0.3,
            rng.randn(B, T, S).astype(np.float32) * 0.5,
            rng.randn(B, T, S).astype(np.float32) * 0.5,
            rng.randn(B, H, P, S).astype(np.float32) * 0.5)


@pytest.mark.parametrize('chunk', [4, 8, 32])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    x_dt, dA, Bm, Cm, h0 = _scan_inputs(1)
    for init in (None, h0):
        y, h = TS.ssd_chunked(_t(x_dt), _t(dA), _t(Bm), _t(Cm), chunk=chunk,
                              initial_state=None if init is None
                              else _t(init))
        ry, rh = RS.ssd_chunked(jnp.asarray(x_dt), jnp.asarray(dA),
                                jnp.asarray(Bm), jnp.asarray(Cm),
                                chunk=chunk,
                                initial_state=None if init is None
                                else jnp.asarray(init))
        _close(y, ry, atol=1e-5)
        _close(h, rh, atol=1e-5)
        # the exact recurrence h_t = exp(dA_t) h_{t-1} + B_t x_t, y_t = C_t h_t
        hn = torch.zeros(h.shape) if init is None else _t(init)
        ys = []
        for t in range(x_dt.shape[1]):
            hn = (hn * torch.exp(_t(dA[:, t]))[..., None, None]
                  + torch.einsum('bhp,bs->bhps', _t(x_dt[:, t]),
                                 _t(Bm[:, t])))
            ys.append(torch.einsum('bs,bhps->bhp', _t(Cm[:, t]), hn))
        _close(y, torch.stack(ys, dim=1), rtol=2e-4, atol=2e-4)
        _close(h, hn, rtol=2e-4, atol=2e-4)


def test_ssd_chunked_keeps_the_divisibility_assertion():
    x_dt, dA, Bm, Cm, _ = _scan_inputs(2, T=12)
    with pytest.raises(AssertionError, match='not divisible'):
        TS.ssd_chunked(_t(x_dt), _t(dA), _t(Bm), _t(Cm), chunk=8)


def test_ssd_backward_is_finite_across_chunks():
    """exp of the masked (-inf) differences gives 0 and a 0 gradient:
    no NaN in the backward, at several chunks."""
    x_dt, dA, Bm, Cm, _ = _scan_inputs(3)
    ins = [_t(a).requires_grad_(True) for a in (x_dt, dA, Bm, Cm)]
    y, h = TS.ssd_chunked(*ins, chunk=8)
    (y.sum() + h.sum()).backward()
    ref = jax.grad(lambda *a: sum(jnp.sum(o) for o in RS.ssd_chunked(
        *a, chunk=8)), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x_dt, dA, Bm, Cm)))
    for t, r in zip(ins, ref):
        assert bool(torch.isfinite(t.grad).all())
        _close(t.grad, r, rtol=1e-4, atol=1e-4)


def test_causal_conv():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 20).astype(np.float32)
    w = rng.randn(4, 20).astype(np.float32) * 0.3
    b = rng.randn(20).astype(np.float32) * 0.1
    _close(TS._causal_conv(_t(x), _t(w), _t(b)),
           RS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


def _mamba(seed):
    cfg = RR.get_arch('mamba2-130m-reduced')
    ref = RS.init_mamba(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return cfg, TR.get_arch('mamba2-130m-reduced'), ref, tree.map(_t, ref)


@pytest.mark.parametrize('T', [2, 16])
def test_mamba_forward_with_cache(T):
    cfg, tcfg, ref, tp = _mamba(5)
    u = np.random.RandomState(6).randn(2, T, cfg.d_model).astype(
        np.float32) * 0.3
    out, cache = TS.mamba_forward(tp, tcfg, _t(u), return_cache=True)
    rout, rcache = RS.mamba_forward(ref, cfg, jnp.asarray(u),
                                    return_cache=True)
    _close(out, rout, atol=1e-5)
    for key in ('conv', 'ssm'):
        assert tuple(cache[key].shape) == rcache[key].shape
        _close(cache[key], rcache[key], atol=1e-5)
    _close(TS.mamba_forward(tp, tcfg, _t(u)), rout, atol=1e-5)


def test_ssd_decode_continues_prefill():
    """mamba_forward(return_cache) + mamba_decode == mamba_forward(T + 1),
    and each decode step equals the reference's."""
    cfg, tcfg, ref, tp = _mamba(4)
    B, T = 2, 16
    u = np.random.RandomState(7).randn(B, T + 2, cfg.d_model).astype(
        np.float32) * 0.3
    full = TS.mamba_forward(tp, tcfg, _t(u))
    _, cache = TS.mamba_forward(tp, tcfg, _t(u[:, :T]), return_cache=True)
    _, rcache = RS.mamba_forward(ref, cfg, jnp.asarray(u[:, :T]),
                                 return_cache=True)
    for t in (T, T + 1):
        y, cache = TS.mamba_decode(tp, tcfg, _t(u[:, t:t + 1]), cache)
        ry, rcache = RS.mamba_decode(ref, cfg, jnp.asarray(u[:, t:t + 1]),
                                     rcache)
        _close(y, full[:, t:t + 1].detach(), rtol=1e-3, atol=1e-4)
        _close(y, ry, atol=1e-5)
        for key in ('conv', 'ssm'):
            _close(cache[key], rcache[key], atol=1e-5)
    zero = TS.init_mamba_cache(tcfg, B, torch.float32)
    rzero = RS.init_mamba_cache(cfg, B, jnp.float32)
    for key in ('conv', 'ssm'):
        assert tuple(zero[key].shape) == rzero[key].shape


def test_bf16_block_keeps_float32_leaves_and_cache():
    """A bf16 block: A_log, D and dt_bias stay float32 leaves (the
    reference's init), the forward runs, and a decode step on a float32
    cache keeps the cache float32 and hands back bf16."""
    cfg = dataclasses.replace(RR.get_arch('mamba2-130m-reduced'),
                              param_dtype='bfloat16')
    tcfg = dataclasses.replace(TR.get_arch('mamba2-130m-reduced'),
                               param_dtype='bfloat16')
    ref = RS.init_mamba(jax.random.PRNGKey(8), cfg, jnp.bfloat16)
    own = TS.init_mamba(torch.Generator().manual_seed(8), tcfg,
                        torch.bfloat16)
    assert tree.paths(own) == sorted(ref)
    for name, leaf in zip(tree.paths(own), tree.leaves(own)):
        assert str(leaf.dtype).removeprefix('torch.') == str(ref[name].dtype)
        assert tuple(leaf.shape) == ref[name].shape
    u = torch.randn((2, 8, tcfg.d_model),
                    generator=torch.Generator().manual_seed(9)).to(
        torch.bfloat16)
    out, cache = TS.mamba_forward(own, tcfg, u, return_cache=True)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    cache = tree.map(lambda a: a.to(torch.float32), cache)
    y, new = TS.mamba_decode(own, tcfg, u[:, -1:], cache)
    assert y.dtype == torch.bfloat16
    assert new['conv'].dtype == new['ssm'].dtype == torch.float32
