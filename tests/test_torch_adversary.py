"""The port's adversary (``repro_torch.adversary``) against
``repro.adversary``, fed the reference's own random inputs: the byzantine
permutation (``jax.random.permutation`` of the reference's fold), the
straggler uniforms (``jax.random.uniform`` of each round's key) and the
same packed frames.

Contract: integers and booleans bit for bit (masks, forged frames and
their CRC words, signs, labels, the straggler chain over 50 rounds, the
screen's ``gate`` and ``suspect``); the scaled ranges bit for bit (one
f32 product); ``robust_z`` bit for bit; ``suspicion`` within 4 ulp of
the largest |log g_max| over the MAD floor, plus 4 ulp of itself (XLA's
f32 ``log`` and PyTorch's differ by an ulp on ~8% of arguments, and a
score near the median is a difference of two logs); ``gate`` and
``suspect`` bit for bit wherever the suspicion is not within 1e-5
relative of the threshold.
The median is ``jnp.nanmedian``'s (mean of the two middle values), pinned
on an even valid count.  Shapes as ``tests/test_adversary.py``: K = 8,
l = 300 (the last payload word partial), and K in {1, 2, 20, 33}."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import words_np
from repro import adversary as RA
from repro.adversary import screen as RS
from repro.core import quantize as RQ
from repro.wire import format as RF
from repro.wire import packets as RP
from repro_torch import adversary as TA
from repro_torch.adversary import screen as TS
from repro_torch.core.quantize import QuantizedGradient
from repro_torch.wire import format as TF

K, L = 8, 300
KS = (1, 2, 8, 20, 33)


def _t(a):
    return torch.as_tensor(np.array(a))


def _perm(seed, k):
    """The reference's byzantine permutation, drawn as it draws it."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), RA.BYZ_FOLD)
    return _t(jax.random.permutation(key, k))


def _grads(k, l, seed):
    rng = np.random.RandomState(seed)
    common = rng.randn(l)
    return ((common[None, :] + 0.3 * rng.randn(k, l)) * 0.01).astype(
        np.float32)


def _frames(k, l, seed):
    """Framed sign and modulus words of a quantized (K, l) gradient, made
    by the reference's encoder."""
    g = jnp.asarray(_grads(k, l, seed))
    qg = RQ.stochastic_quantize(g, 3, jax.random.PRNGKey(seed))
    a = jnp.abs(g)
    return RP.encode_uplink_batch(qg.sign, qg.qidx, a.min(1), a.max(1),
                                  bits=3, round_idx=4)


def test_constants_match_reference():
    assert TA.ATTACK_KINDS == RA.ATTACK_KINDS
    assert TA.BYZ_FOLD == RA.BYZ_FOLD
    assert TA.STRAGGLER_FOLD == RA.STRAGGLER_FOLD
    for name in ('VOTE_MAD_FLOOR', 'NORM_MAD_FLOOR', 'VOTE_ANTI_EPS',
                 'VOTE_CONSENSUS_EPS'):
        assert getattr(TS, name) == getattr(RS, name), name


@pytest.mark.parametrize('frac', [0.0, 0.1, 0.25, 0.5, 1.0])
@pytest.mark.parametrize('k', KS)
def test_byzantine_mask_matches_reference(k, frac):
    for seed in (0, 3):
        want = np.asarray(RA.byzantine_mask(seed, k, frac))
        got = TA.byzantine_mask(k, frac, _perm(seed, k))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == math.floor(frac * k)


@pytest.mark.parametrize('k', KS)
@pytest.mark.parametrize('l', [300, 320])
def test_signflip_frames_match_reference_and_verify(k, l):
    sign_words, mod_words = _frames(k, l, seed=k + l)
    mask = RA.byzantine_mask(1, k, 0.5) | (jnp.arange(k) == 0)
    want = np.asarray(RA.signflip_frames(sign_words, mask, l))
    t_words = torch.as_tensor(np.array(sign_words).view(np.int32))
    got = TA.signflip_frames(t_words, _t(mask), l)
    np.testing.assert_array_equal(words_np(got), want)
    assert bool(TF.verify_frame(got).all())          # the forgery verifies
    np.testing.assert_array_equal(
        TA.clients.signflip_pattern(t_words.shape[1], l),
        np.asarray(RA.signflip_frames(jnp.zeros_like(sign_words),
                                      jnp.ones((k,), bool), l))[0])
    # the decoded signs of the forged rows are the exact negation
    dec = RP.decode_uplink_batch(jnp.asarray(want), mod_words, n=l, bits=3)
    honest = RP.decode_uplink_batch(sign_words, mod_words, n=l, bits=3)
    m = np.asarray(mask)[:, None]
    np.testing.assert_array_equal(
        np.asarray(dec.sign), np.where(m, -np.asarray(honest.sign),
                                       np.asarray(honest.sign)))
    assert bool(jnp.all(RF.verify_frame(jnp.asarray(want))))


def _qg_pair(k, l, seed, keepdim):
    g = jnp.asarray(_grads(k, l, seed))
    qg = RQ.stochastic_quantize(g, 3, jax.random.PRNGKey(seed))
    a = jnp.abs(g)
    gmn, gmx = a.min(1), a.max(1)
    if keepdim:
        gmn, gmx = gmn[:, None], gmx[:, None]
    qg = qg._replace(g_min=gmn, g_max=gmx)
    tq = QuantizedGradient(_t(qg.sign), _t(qg.qidx), _t(qg.g_min),
                           _t(qg.g_max), 3)
    return qg, tq


@pytest.mark.parametrize('keepdim', [False, True])
@pytest.mark.parametrize('k', [1, 8, 20])
def test_flip_signs_and_scale_ranges_match_reference(k, keepdim):
    qg, tq = _qg_pair(k, L, seed=k, keepdim=keepdim)
    mask = RA.byzantine_mask(2, k, 0.5) | (jnp.arange(k) == k - 1)
    flipped = TA.flip_signs(tq, _t(mask))
    assert flipped.sign.dtype == torch.int8
    np.testing.assert_array_equal(flipped.sign.numpy(),
                                  np.asarray(RA.flip_signs(qg, mask).sign))
    for scale in (10.0, 50.0, 0.3):
        s_r = RA.scale_ranges(qg, mask, scale)
        s_t = TA.scale_ranges(tq, _t(mask), scale)
        for f in ('g_min', 'g_max'):
            assert getattr(s_t, f).dtype == torch.float32
            np.testing.assert_array_equal(getattr(s_t, f).numpy(),
                                          np.asarray(getattr(s_r, f)), f)
        np.testing.assert_array_equal(s_t.qidx.numpy(), np.asarray(qg.qidx))


def test_flip_labels_matches_reference():
    y = np.tile(np.arange(10), (K, 3))[:, :20]
    mask = RA.byzantine_mask(0, K, 0.25)
    want = np.asarray(RA.flip_labels(jnp.asarray(y), mask, n_classes=10))
    got = TA.flip_labels(torch.as_tensor(y), _t(mask), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    got7 = TA.flip_labels(torch.as_tensor(y % 7), _t(mask), 7)
    np.testing.assert_array_equal(
        got7.numpy(), np.asarray(RA.flip_labels(jnp.asarray(y % 7), mask, 7)))


@pytest.mark.parametrize('rate', [0.0, 0.1, 0.25, 0.5, 0.999999, 1.0])
@pytest.mark.parametrize('stickiness', [-1.0, 0.0, 0.5, 0.999, 1.5])
def test_straggler_probs_match_reference(rate, stickiness):
    assert (TA.straggler_probs(rate, stickiness)
            == RA.straggler_probs(rate, stickiness))


@pytest.mark.parametrize('k', KS)
@pytest.mark.parametrize('rate,stickiness', [(0.25, 0.5), (0.3, 0.9),
                                             (0.0, 0.5), (0.6, 0.0)])
def test_straggler_chain_matches_reference(k, rate, stickiness):
    """50 rounds of the Gilbert chain, the port fed each round's
    reference uniforms: every state bit for bit."""
    key = jax.random.PRNGKey(k)
    s_r = RA.straggler_init(k)
    s_t = TA.straggler_init(k)
    assert s_t.dtype == torch.bool and bool(s_t.all())
    dropped = 0
    for n in range(50):
        kn = jax.random.fold_in(key, n)
        s_r, o_r = RA.straggler_step(kn, s_r, rate, stickiness)
        s_t, o_t = TA.straggler_step(_t(jax.random.uniform(kn, (k,))), s_t,
                                     rate, stickiness)
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_r))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
        dropped += int((~o_t).sum())
    if rate == 0.0:
        assert dropped == 0


def test_straggler_thresholds_compare_in_float32():
    """``u >= p_fail`` and ``u < p_rec`` with u one f32 ulp either side
    of the f32 rounding of the Python thresholds: the same verdicts as
    the reference's on the same uniforms."""
    p_fail, p_rec = RA.straggler_probs(0.3, 0.7)
    u = []
    for p in (p_fail, p_rec):
        c = np.float32(p)
        u += [np.nextafter(c, np.float32(0)), c,
              np.nextafter(c, np.float32(1))]
    u = np.array(u, np.float32)
    for state in (np.ones(6, bool), np.zeros(6, bool)):
        want = jnp.where(jnp.asarray(state), jnp.asarray(u) >= p_fail,
                         jnp.asarray(u) < p_rec)
        got, _ = TA.straggler_step(torch.as_tensor(u), torch.as_tensor(state),
                                   0.3, 0.7)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('rate', [0.0, 0.3, 1.0])
def test_bernoulli_active_matches_reference(rate):
    key = jax.random.PRNGKey(7)
    want = np.asarray(RA.bernoulli_active(key, 4096, rate))
    got = TA.bernoulli_active(_t(jax.random.uniform(key, (4096,))), rate)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# robust z-scores and the screen gate
# ---------------------------------------------------------------------------

def test_median_interpolates_as_jax():
    """torch.nanmedian takes the lower middle value; the reference's
    jnp.nanmedian the mean of the two."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0, math.nan])
    assert float(TS._nanmedian(x)) == 2.5 == float(
        jnp.nanmedian(jnp.asarray(x.numpy())))
    assert float(torch.nanmedian(x)) == 2.0
    assert math.isnan(float(TS._nanmedian(torch.full((3,), math.nan))))
    rng = np.random.RandomState(0)
    for c in range(0, 34):
        x = rng.randn(33).astype(np.float32)
        x[rng.permutation(33)[c:]] = np.nan
        want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
        got = TS._nanmedian(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f'{c} valid')


def _robust_cases():
    rng = np.random.RandomState(1)
    out = {}
    x = rng.randn(20).astype(np.float32)
    out['even'] = (x, np.ones(20, bool))
    out['odd'] = (x, np.arange(20) != 3)
    v = rng.rand(8) < 0.6
    v[:2] = True, False
    out['k8_partial'] = (rng.randn(8).astype(np.float32), v)
    out['none_valid'] = (x, np.zeros(20, bool))
    out['one_valid'] = (x, np.arange(20) == 5)
    tight = np.full(20, 0.3, np.float32)
    tight[::3] += 1e-6                             # MAD below its floor
    tight[7] = 5.0
    out['mad_floor'] = (tight, np.ones(20, bool))
    out['with_nan_inf'] = (np.where(np.arange(20) == 2, np.inf,
                                    np.where(np.arange(20) == 4, np.nan, x)
                                    ).astype(np.float32), np.ones(20, bool))
    return out


ROBUST = _robust_cases()


@pytest.mark.parametrize('case', sorted(ROBUST))
@pytest.mark.parametrize('floor', [RS.NORM_MAD_FLOOR, RS.VOTE_MAD_FLOOR])
def test_robust_z_matches_reference(case, floor):
    x, valid = ROBUST[case]
    want = np.asarray(RS.robust_z(jnp.asarray(x), jnp.asarray(valid), floor))
    got = TS.robust_z(torch.as_tensor(x), torch.as_tensor(valid), floor)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == 'none_valid':
        assert not got.numpy().any()


def suspicion_atol(g_max):
    """4 ulp of the largest |log g_max| carried through the z-score's
    smallest denominator (the norm MAD floor), plus 4 ulp of the score:
    XLA's f32 log differs from PyTorch's by an ulp on ~8% of arguments,
    and a score near the median is a difference of two logs."""
    logr = np.abs(np.log(np.maximum(np.asarray(g_max, np.float64), 1e-30)))
    return 4 * np.finfo(np.float32).eps * float(logr.max()) / RS.NORM_MAD_FLOOR


def _check_gate(got, want, z_thresh, g_max):
    gate, suspect, suspicion = got
    g_r, s_r, z_r = (np.asarray(v) for v in want)
    assert gate.dtype == torch.float32 and suspect.dtype == torch.bool
    np.testing.assert_allclose(suspicion.numpy(), z_r,
                               rtol=4 * np.finfo(np.float32).eps,
                               atol=suspicion_atol(g_max))
    far = np.abs(z_r - z_thresh) > 1e-5 * z_thresh
    np.testing.assert_array_equal(suspect.numpy()[far], s_r[far])
    np.testing.assert_array_equal(gate.numpy()[far], g_r[far])
    np.testing.assert_array_equal(gate.numpy(),
                                  np.where(suspect.numpy(), 0.0, 1.0))
    return far


def _gate_inputs(k, seed, attack):
    rng = np.random.RandomState(seed)
    g_max = np.exp(rng.randn(k) * 0.2 - 3.0).astype(np.float32)
    frac = rng.uniform(0.15, 0.35, k)
    if attack == 'scaled':
        g_max[1 % k] *= 50.0
    if attack == 'signflip':
        frac[0] = 0.8
    n_lanes = 300
    disagree = np.round(frac * n_lanes).astype(np.int32)
    mod_valid = rng.rand(k) < 0.9
    sign_valid = rng.rand(k) < 0.9
    return g_max, mod_valid, disagree, n_lanes, sign_valid


@pytest.mark.parametrize('attack', ['none', 'scaled', 'signflip'])
@pytest.mark.parametrize('k', KS)
@pytest.mark.parametrize('votes', [False, True])
def test_screen_gate_matches_reference(k, attack, votes):
    g_max, mod_valid, dis, n_lanes, sign_valid = _gate_inputs(k, k, attack)
    for shape in ((k,), (k, 1)):
        args_r = [jnp.asarray(g_max.reshape(shape)), jnp.asarray(mod_valid)]
        args_t = [torch.as_tensor(g_max.reshape(shape)),
                  torch.as_tensor(mod_valid)]
        if votes:
            args_r += [jnp.asarray(dis), n_lanes, jnp.asarray(sign_valid)]
            args_t += [torch.as_tensor(dis), n_lanes,
                       torch.as_tensor(sign_valid)]
        want = RS.screen_gate(*args_r, z_thresh=4.0)
        got = TS.screen_gate(*args_t, z_thresh=4.0)
        far = _check_gate(got, want, 4.0, g_max)
        assert far.all()


def test_screen_gate_anti_majority_rule():
    """A client disagreeing with a consensual cohort on > 52% of its lanes
    is flagged outright (suspicion >= 2 z), even where its robust z-score
    is small because the honest spread is wide; a near-tie cohort (median
    >= 0.45) flags nobody by this rule."""
    n_lanes = 1000
    k = 20
    rng = np.random.RandomState(4)
    frac = rng.uniform(0.05, 0.44, k)
    frac[3] = 0.53
    for case in ('consensus', 'near_tie'):
        f = frac if case == 'consensus' else np.full(k, 0.49) + (
            np.arange(k) == 3) * 0.04
        dis = np.round(f * n_lanes).astype(np.int32)
        g_max = np.full(k, 0.01, np.float32)
        valid = np.ones(k, bool)
        want = RS.screen_gate(jnp.asarray(g_max), jnp.asarray(valid),
                              jnp.asarray(dis), n_lanes, jnp.asarray(valid),
                              4.0)
        got = TS.screen_gate(torch.as_tensor(g_max), torch.as_tensor(valid),
                             torch.as_tensor(dis), n_lanes,
                             torch.as_tensor(valid), 4.0)
        _check_gate(got, want, 4.0, g_max)
        flagged = got[1].numpy()
        if case == 'consensus':
            assert flagged[3] and float(got[2][3]) >= 8.0
            assert flagged.sum() == 1
        else:
            assert not flagged.any()


def test_screen_gate_with_no_valid_row_scores_zero():
    k = 8
    g_max = torch.rand(k) + 0.1
    none = torch.zeros(k, dtype=torch.bool)
    gate, suspect, suspicion = TS.screen_gate(
        g_max, none, torch.full((k,), 200, dtype=torch.int32), 300, none)
    assert bool((gate == 1.0).all()) and not bool(suspect.any())
    assert not bool(suspicion.any())
