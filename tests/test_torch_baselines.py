"""The paper's §V baselines in the port (``repro_torch.core.transport``:
dds, onebit, scheduling, error_free) against ``repro.core.transport`` on
the reference's own draws (``baseline_draws_from_key``), and the bit
channel's calibration of their single packets
(``core.bitchannel.calibrated_success_prob``).

Integers are exact: the packet masks, the schedule, the payload bits and
error_free's packed words and votes.  The aggregates are held to the
reference's FMA-wobble bound ``ulp_atol`` over the received clients'
weights; onebit's per-client scale is a mean of l values that XLA and
PyTorch sum in different orders, so its bound adds the a-priori error
of two such sums, l eps |scale| per client."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import baseline_draws_from_key, ulp_atol, words_np
from repro.configs.base import FLConfig as RefFLConfig
from repro.core import bitchannel as BC
from repro.core import transport as TR
from repro_torch.configs.base import FLConfig
from repro_torch.core import bitchannel as TBC
from repro_torch.core import transport as TTR

EPS = np.finfo(np.float32).eps
SHAPES = [(6, 333), (8, 1000)]


def _inputs(k, l, seed):
    """Gradients (a few exact zeros), and f32 gains and budgets that put
    the single-packet success probabilities across (0, 1) at l ~ 1e3."""
    rng = np.random.RandomState(seed)
    grads = (rng.randn(k, l) * 0.02).astype(np.float32)
    grads[0, :5] = 0.0
    gains = np.logspace(-15.5, -13.0, k).astype(np.float32)
    rng.shuffle(gains)
    p_w = np.full(k, 10 ** (-4.0 / 10) / 1000.0, np.float32)
    return grads, gains, p_w


def _fl(channel, **kw):
    ref = RefFLConfig(channel=channel, **kw)
    return ref, FLConfig(**dataclasses.asdict(ref))


def _run(kind, grads, gains, p_w, ref_fl, fl, key, channel):
    """(reference ghat, telemetry), (port ghat, telemetry)."""
    k, l = grads.shape
    beta = np.full(k, 1.0 / k, np.float32)
    draws = baseline_draws_from_key(kind, key, k, l, channel)
    g, gn, pw = (torch.as_tensor(a) for a in (grads, gains, p_w))
    if kind == 'dds':
        ref = TR.dds_aggregate(jnp.asarray(grads), jnp.asarray(beta),
                               jnp.asarray(gains), jnp.asarray(p_w), ref_fl,
                               key)
        got = TTR.dds_aggregate(g, torch.as_tensor(beta), gn, pw, fl, draws)
    elif kind == 'onebit':
        ref = TR.onebit_aggregate(jnp.asarray(grads), jnp.asarray(beta),
                                  jnp.asarray(gains), jnp.asarray(p_w),
                                  ref_fl, key)
        got = TTR.onebit_aggregate(g, torch.as_tensor(beta), gn, pw, fl,
                                   draws)
    else:
        ref = TR.scheduling_aggregate(jnp.asarray(grads), jnp.asarray(gains),
                                      jnp.asarray(p_w), ref_fl, key)
        got = TTR.scheduling_aggregate(g, gn, pw, fl, draws)
    return ref, got, draws


def _same_telemetry(tel, tel_r):
    for name, val in tel._asdict().items():
        ref = getattr(tel_r, name)
        assert (val is None) == (ref is None), name
        if val is not None:
            np.testing.assert_array_equal(val.numpy(), np.asarray(ref), name)


def _calibration_gap(q_port, q_ref, n_bits):
    """The port's and the reference's calibrated q for the same analytic
    q: within the BER calibration's documented gap (up to 12 ulp of BER,
    rtol 1e-5 once mapped back through the fold)."""
    cal = TBC.calibrated_success_prob(torch.as_tensor(q_port), n_bits)
    cal_r = np.asarray(BC.calibrated_success_prob(jnp.asarray(q_ref),
                                                  n_bits))
    np.testing.assert_allclose(cal.numpy(), cal_r, rtol=1e-5, atol=1e-7)
    return cal.numpy(), cal_r


@pytest.mark.parametrize('kind', ['dds', 'onebit', 'scheduling'])
@pytest.mark.parametrize('channel', ['bernoulli', 'bitlevel'])
@pytest.mark.parametrize('k,l', SHAPES)
def test_single_packet_baselines_match_reference(kind, channel, k, l):
    grads, gains, p_w = _inputs(k, l, seed=k * l)
    ref_fl, fl = _fl(channel)
    key = jax.random.PRNGKey(31 * k + len(kind))
    (ghat_r, tel_r), (ghat, tel), draws = _run(kind, grads, gains, p_w,
                                               ref_fl, fl, key, channel)
    ok = tel.sign_ok.numpy()
    # the masks could only flip where a fate uniform lies between the two
    # sides' success probabilities: pin that no draw does
    n_bits = l if kind == 'onebit' else l * (fl.quant_bits + 1) + fl.b0_bits
    if kind == 'scheduling':
        inst = draws.h2.numpy() * gains
        m = int(np.ceil(fl.scheduling_ratio * k))
        sched = inst >= np.sort(inst)[k - m]
        beta = np.where(sched, np.float32(1.0 / m),
                        np.float32(1e-9)).astype(np.float32)
    else:
        sched = np.ones(k, bool)
        beta = np.full(k, 1.0 / k, np.float32)
    q = TTR.single_packet_success_prob(torch.as_tensor(beta),
                                       torch.as_tensor(p_w),
                                       torch.as_tensor(gains), n_bits,
                                       fl).numpy()
    q_r = np.asarray(TR.single_packet_success_prob(
        jnp.asarray(beta), jnp.asarray(p_w), jnp.asarray(gains), n_bits,
        ref_fl))
    # exp and pow in f32: XLA's and PyTorch's differ by an ulp or two
    np.testing.assert_allclose(q, q_r, rtol=4 * EPS, atol=0)
    if channel == 'bitlevel':
        q, q_r = _calibration_gap(q, q_r, n_bits)
    u = draws.fate_u.numpy()[0]
    between = (u >= np.minimum(q, q_r)) & (u < np.maximum(q, q_r))
    assert not between.any()
    _same_telemetry(tel, tel_r)
    assert 0 < ok.sum() < k                 # some packets lost, some not
    assert not (ok & ~sched).any()
    denom = max(ok.sum(), 1)
    gmax = np.abs(grads).max(axis=1)
    atol = ulp_atol(ok / denom, gmax, np.zeros(1))
    if kind == 'onebit':
        scale = np.abs(grads).mean(axis=1)
        atol += float(np.sum(ok / denom * l * EPS * scale))
    np.testing.assert_allclose(ghat.numpy(), np.asarray(ghat_r), rtol=0,
                               atol=atol)


def test_scheduling_off_schedule_success_is_exactly_zero():
    """The unscheduled clients get 1e-9 of the band; 2^expo overflows to
    inf, so their q is exactly 0, on both sides."""
    k, l = 8, 1000
    _, gains, p_w = _inputs(k, l, seed=1)
    ref_fl, fl = _fl('bernoulli')
    n_bits = l * (fl.quant_bits + 1) + fl.b0_bits
    beta = np.full(k, 1e-9, np.float32)
    q = TTR.single_packet_success_prob(torch.as_tensor(beta),
                                       torch.as_tensor(p_w),
                                       torch.as_tensor(gains), n_bits, fl)
    q_r = TR.single_packet_success_prob(jnp.asarray(beta), jnp.asarray(p_w),
                                        jnp.asarray(gains), n_bits, ref_fl)
    assert np.all(q.numpy() == 0.0) and np.all(np.asarray(q_r) == 0.0)


def test_onebit_signs_of_zero_and_no_modulus():
    """sign(0) = 0: coordinates where every client's gradient is 0 stay 0
    (the packed wire would send them as +1); no modulus packet exists."""
    k, l = 6, 333
    grads, gains, p_w = _inputs(k, l, seed=2)
    grads[:, :7] = 0.0
    ref_fl, fl = _fl('bernoulli')
    _, (ghat, tel), _ = _run('onebit', grads, gains, p_w, ref_fl, fl,
                             jax.random.PRNGKey(4), 'bernoulli')
    assert tel.sign_ok.any() and not tel.mod_ok.any()
    assert np.all(ghat.numpy()[:7] == 0.0) and np.all(ghat.numpy()[7:] != 0)
    assert float(tel.payload_bits) == k * l


@pytest.mark.parametrize('wire', ['analytic', 'packed'])
@pytest.mark.parametrize('k,l', SHAPES)
def test_error_free_matches_reference(wire, k, l):
    grads, _, _ = _inputs(k, l, seed=k + l)
    ref_fl, fl = _fl('bernoulli', wire=wire)
    key = jax.random.PRNGKey(k)
    draws = baseline_draws_from_key('error_free', key, k, l, 'bernoulli')
    ghat_r, tel_r = TR.error_free_aggregate(jnp.asarray(grads), ref_fl, key,
                                            round_idx=3)
    ghat, tel = TTR.error_free_aggregate(torch.as_tensor(grads), fl, draws,
                                         round_idx=3)
    _same_telemetry(tel, tel_r)
    if wire == 'packed':
        sw_r, mw_r, bits_r = TR.encode_wire(
            TR._per_client_quantize(jnp.asarray(grads), fl.quant_bits, key),
            3)
        sw, mw, bits = TTR.quantize_encode_wire(
            torch.as_tensor(grads), draws.rand, fl.quant_bits, 3)
        np.testing.assert_array_equal(words_np(sw), np.asarray(sw_r))
        np.testing.assert_array_equal(words_np(mw), np.asarray(mw_r))
        assert bits == bits_r == float(tel.payload_bits)
        assert tel.sign_votes is not None
    else:
        assert float(tel.payload_bits) == k * (l * 4 + 64)
    np.testing.assert_allclose(
        ghat.numpy(), np.asarray(ghat_r), rtol=0,
        atol=ulp_atol(np.ones(k), np.abs(grads).max(axis=1),
                      np.zeros(1)) / k)


@pytest.mark.parametrize('n_bits', [333, 1000, 4064, 248088])
def test_calibrated_success_prob_matches_reference(n_bits):
    """Across the operating range and at the fold floor (q <= 2^-32
    saturates at 2^-32, to the f32 rounding of exp and log1p) the port's
    calibration stays within the documented BER gap of the
    reference's."""
    q = np.concatenate([np.logspace(-12, 0, 200), [0.0, 2.0 ** -33, 1.0]]
                       ).astype(np.float32)
    cal, cal_r = _calibration_gap(q, q, n_bits)
    assert cal[-3] == cal_r[-3] == cal[-2]
    np.testing.assert_allclose(cal[-3], 2.0 ** -32, rtol=4 * EPS)
    assert cal[-1] == cal_r[-1] == 1.0
    op = q >= 1e-3
    np.testing.assert_allclose(cal[op], q[op], rtol=1e-4)


def test_make_draws_per_kind():
    k, l = 3, 40
    gen = torch.Generator().manual_seed(0)
    cpu = torch.device('cpu')
    for kind, fields in (('dds', {'rand', 'fate_u'}),
                         ('onebit', {'fate_u'}),
                         ('scheduling', {'rand', 'fate_u', 'h2'}),
                         ('error_free', {'rand'})):
        d = TTR.make_draws(k, l, 0, 'bitlevel', cpu, gen, gen, kind=kind)
        present = {f for f, v in d._asdict().items()
                   if v is not None and v != ()}
        assert present == fields, kind
        if d.h2 is not None:
            assert bool((d.h2 >= 0).all()) and tuple(d.h2.shape) == (k,)
        if d.fate_u is not None:
            assert tuple(d.fate_u.shape) == (1, k)
