"""The reference's last public helpers in the port, each against the
reference on the same numpy-seeded inputs: the quantizer's
``dequantize`` and ``quantization_error_bound``, the one-client packet
forms, the materialized flip mask and ``corrupt_words``, the
unpack-per-client wire (``encode_wire`` / ``decode_wire`` /
``materialize_wire``), ``cnn_accuracy``, ``group_slice`` and the
engine's public ``success_probs``.  Integers and float32 words match bit
for bit; ``success_probs`` is held to the engine's own exit bit for bit
and to the reference's NumPy ``success_probs_np`` within the engine
parity tolerance (the reference's ``repro.core.allocation_jax`` does not
import under jax 0.9.0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_allocation_jax import TOL, problems
from test_torch_parity import seeds, words_np
from repro.core import allocation as RA
from repro.core import quantize as RQ
from repro.core import transport as TR
from repro.models import cnn as RC
from repro.models import transformer as RT
from repro.wire import corrupt as WC
from repro.wire import packets as PK
from repro_torch import tree
from repro_torch.configs import registry as TR_REG
from repro_torch.core import allocation_jax as AJ
from repro_torch.core import channel as TCH
from repro_torch.core import quantize as TQ
from repro_torch.core import transport as TTR
from repro_torch.models import cnn as TC
from repro_torch.models import transformer as TT
from repro_torch.wire import corrupt as TWC
from repro_torch.wire import format as tfmt
from repro_torch.wire import packets as TPK


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """Small tensors: one intra-op thread (the suite runs in several
    workers, and more threads only contend), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _grads(k, l, seed):
    """(K, l) float32 gradients with a few exact zeros (sign 0)."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(k, l) * 0.02).astype(np.float32)
    g[:, ::97] = 0.0
    return g


def _ref_qg(g, bits, seed):
    """The reference's per-client quantization of ``g`` (ranges (K, 1))."""
    return TR._per_client_quantize(jnp.asarray(g), bits,
                                   jax.random.PRNGKey(seed))


def _port_qg(qg):
    return TQ.QuantizedGradient(_t(qg.sign), _t(qg.qidx), _t(qg.g_min),
                                _t(qg.g_max), qg.bits)


def _same(got, want):
    """Bit for bit: same dtype width, same pattern."""
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == np.uint32:
        np.testing.assert_array_equal(got.astype(np.int64) & 0xFFFFFFFF,
                                      want.astype(np.int64))
    elif want.dtype == np.float32:
        np.testing.assert_array_equal(got.astype(np.float32).view(np.int32),
                                      want.view(np.int32))
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bits', [1, 3, 8])
def test_dequantize_and_error_bound_bit_for_bit(bits):
    g = _grads(5, 777, bits)
    qg = _ref_qg(g, bits, 100 + bits)
    _same(TQ.dequantize(_port_qg(qg)), RQ.dequantize(qg))
    g_min, g_max = qg.g_min[:, 0], qg.g_max[:, 0]
    for dim in (777, 62006, 28_311_552, 134_515_008, 134_515_009):
        _same(TQ.quantization_error_bound(_t(g_min), _t(g_max), dim, bits),
              RQ.quantization_error_bound(g_min, g_max, dim, bits))


def test_delta_sq_tree_is_the_error_bound():
    rng = np.random.RandomState(4)
    leaves = {'a': torch.as_tensor(rng.randn(3, 40).astype(np.float32)),
              'b': torch.as_tensor(rng.randn(3, 5, 7).astype(np.float32))}
    stats = TTR.tree_client_stats(leaves)
    got = TTR.delta_sq_tree(stats, 3)
    want = TR.quantization_error_bound(
        jnp.asarray(stats['g_min'].numpy()), jnp.asarray(stats['g_max']
                                                          .numpy()),
        stats['dim'], 3)
    _same(got, want)


def test_channel_state_holds_tensors():
    st = TCH.ChannelState(torch.tensor([10.0, 250.0]),
                          torch.tensor([0.1, 0.2]))
    assert st.distance_m.shape == st.tx_power_w.shape == (2,)
    with pytest.raises(AttributeError):
        st.distance_m = torch.zeros(2)


# ---------------------------------------------------------------------------
# one client's packets
# ---------------------------------------------------------------------------

def _client(n, bits, seed):
    rng = np.random.RandomState(seed)
    sign = rng.choice([-1, 0, 1], n).astype(np.int8)
    qidx = rng.randint(0, 2 ** bits, n).astype(np.int32)
    return sign, qidx


@pytest.mark.parametrize('n,bits', [(96, 1), (500, 3), (777, 3), (777, 8)])
def test_client_uplink_matches_reference_and_batch_row(n, bits):
    sign, qidx = _client(n, bits, n + bits)
    g_min, g_max = np.float32(0.125), np.float32(0.875)
    sw_r, mw_r = PK.encode_client_uplink(jnp.asarray(sign),
                                         jnp.asarray(qidx), g_min, g_max, 3,
                                         bits=bits, round_idx=12)
    sw, mw = TPK.encode_client_uplink(_t(sign), _t(qidx), g_min, g_max, 3,
                                      bits=bits, round_idx=12)
    assert sw.dtype == mw.dtype == torch.int32
    _same(sw, sw_r)
    _same(mw, mw_r)
    # row 3 of the batch forms is the same client
    k = 5
    signs = np.stack([_client(n, bits, n + bits + i)[0] for i in range(k)])
    signs[3] = sign
    qidxs = np.stack([_client(n, bits, n + bits + i)[1] for i in range(k)])
    qidxs[3] = qidx
    lo = np.full(k, 0.5, np.float32)
    hi = np.full(k, 0.75, np.float32)
    lo[3], hi[3] = g_min, g_max
    bsw, bmw = TPK.encode_uplink_batch(_t(signs), _t(qidxs), _t(lo), _t(hi),
                                       bits=bits, round_idx=12)
    assert torch.equal(bsw[3], sw) and torch.equal(bmw[3], mw)
    dec = TPK.decode_client_uplink(sw, mw, n=n, bits=bits)
    dec_r = PK.decode_client_uplink(sw_r, mw_r, n=n, bits=bits)
    bdec = TPK.decode_uplink_batch(bsw, bmw, n=n, bits=bits)
    for f in TPK.DecodedUplink._fields:
        _same(getattr(dec, f), getattr(dec_r, f))
        assert torch.equal(getattr(dec, f), getattr(bdec, f)[3]), f
    np.testing.assert_array_equal(dec.sign.numpy(),
                                  np.where(sign == 0, 1, sign))
    assert bool(dec.sign_ok) and bool(dec.mod_ok)


@pytest.mark.parametrize('word_idx', [0, 5, -1])
@pytest.mark.parametrize('damage', ['sign', 'mod'])
def test_client_decode_of_damaged_words(word_idx, damage):
    sign, qidx = _client(500, 3, 1)
    sw_r, mw_r = PK.encode_client_uplink(jnp.asarray(sign),
                                         jnp.asarray(qidx), 0.0, 1.0, 0,
                                         bits=3)
    if damage == 'sign':
        sw_r = sw_r.at[word_idx].set(sw_r[word_idx] ^ jnp.uint32(1 << 9))
    else:
        mw_r = mw_r.at[word_idx].set(mw_r[word_idx] ^ jnp.uint32(1 << 9))
    sw = tfmt.to_words(torch.as_tensor(np.asarray(sw_r).astype(np.int64)))
    mw = tfmt.to_words(torch.as_tensor(np.asarray(mw_r).astype(np.int64)))
    dec = TPK.decode_client_uplink(sw, mw, n=500, bits=3)
    dec_r = PK.decode_client_uplink(sw_r, mw_r, n=500, bits=3)
    for f in TPK.DecodedUplink._fields:
        _same(getattr(dec, f), getattr(dec_r, f))
    assert bool(dec.sign_ok) == (damage != 'sign')
    assert bool(dec.mod_ok) == (damage != 'mod')


def test_sign_packet_is_no_modulus_packet():
    sign, qidx = _client(96, 1, 2)
    sw, _ = TPK.encode_client_uplink(_t(sign), _t(qidx), 0.0, 1.0, 0, bits=1)
    padded = torch.nn.functional.pad(
        sw, (0, tfmt.modulus_packet_words(96, 1) - sw.shape[0]))
    assert not bool(TPK.decode_client_uplink(sw, padded, n=96,
                                             bits=1).mod_ok)


# ---------------------------------------------------------------------------
# the materialized flip mask
# ---------------------------------------------------------------------------

def _words(k, w, seed):
    return np.random.RandomState(seed).randint(0, 2 ** 32, (k, w),
                                               np.int64).astype(np.uint32)


@pytest.mark.parametrize('ber', ['zero', 'one', 'mid', 'per_client'])
@pytest.mark.parametrize('word0', [0, 3 * 2_654_208 + 17])
def test_flip_mask_ref_and_corrupt_words(ber, word0):
    k, w = 4, 67
    key = jax.random.PRNGKey(w + word0 % 1000)
    rates = {'zero': np.zeros(k, np.float32), 'one': np.ones(k, np.float32),
             'mid': np.full(k, 0.03, np.float32),
             'per_client': np.array([0.0, 1e-2, 0.5, 1.0], np.float32)}[ber]
    words = _words(k, w, 7)
    ref = np.asarray(WC.flip_mask_ref(key, (k, w), jnp.asarray(rates),
                                      word0))
    got = TWC.flip_mask_ref(seeds(key), (k, w), _t(rates), word0)
    _same(got, ref)
    # the loop over planes draws the same mask
    assert torch.equal(got, TWC.flip_mask(seeds(key), (k, w), _t(rates),
                                          word0))
    rx_r, m_r = WC.corrupt_words(key, jnp.asarray(words), jnp.asarray(rates),
                                 word0)
    rx, m = TWC.corrupt_words(seeds(key), tfmt.to_words(
        torch.as_tensor(words.astype(np.int64))), _t(rates), word0)
    assert rx.dtype == m.dtype == torch.int32
    np.testing.assert_array_equal(words_np(rx), np.asarray(rx_r))
    np.testing.assert_array_equal(words_np(m), np.asarray(m_r))
    np.testing.assert_array_equal(words_np(m), ref)
    if ber == 'zero':
        assert int(TWC.count_flips(m).sum()) == 0
    if ber == 'one':
        np.testing.assert_array_equal(words_np(rx), ~words)


def test_flip_mask_ref_takes_device_seed_words():
    """Seeds as the transport holds them: a (2,) int32 tensor."""
    key = jax.random.PRNGKey(5)
    pair = seeds(key)
    dev = tfmt.to_words(torch.tensor(pair, dtype=torch.int64))
    a = TWC.flip_mask_ref(pair, (3, 40), 0.1, 11)
    b = TWC.flip_mask_ref(dev, (3, 40), 0.1, 11)
    assert torch.equal(a, b)
    _same(a, WC.flip_mask_ref(key, (3, 40), 0.1, 11))


# ---------------------------------------------------------------------------
# the unpack-per-client wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('bits', [1, 3])
def test_encode_decode_materialize_wire(bits):
    k, l = 6, 1000
    qg_r = _ref_qg(_grads(k, l, 8), bits, 17)
    qg = _port_qg(qg_r)
    sw_r, mw_r, bits_r = TR.encode_wire(qg_r, 4)
    sw, mw, measured = TTR.encode_wire(qg, 4)
    _same(sw, sw_r)
    _same(mw, mw_r)
    assert measured == bits_r == tfmt.measured_uplink_bits(l, bits, k)
    rec, measured, crc_ok = TTR.materialize_wire(qg, round_idx=4)
    rec_r, _, crc_r = TR.materialize_wire(qg_r, round_idx=4)
    assert torch.equal(rec.qidx, qg.qidx)
    assert torch.equal(rec.sign, torch.where(qg.sign == 0, 1, qg.sign)
                       .to(torch.int8))
    for f in ('sign', 'qidx', 'g_min', 'g_max'):
        _same(getattr(rec, f), getattr(rec_r, f))
    assert rec.bits == bits
    assert bool(crc_ok.all()) and torch.equal(crc_ok, _t(crc_r))
    # damaged buffers: one sign word of client 1, one modulus word of 4
    bad_s = sw_r.at[1, 9].set(sw_r[1, 9] ^ jnp.uint32(1 << 31))
    bad_m = mw_r.at[4, 20].set(mw_r[4, 20] ^ jnp.uint32(1 << 2))
    rec_r, dec_r = TR.decode_wire(qg_r, bad_s, bad_m)
    rec, dec = TTR.decode_wire(qg, tfmt.to_words(_t(bad_s).to(torch.int64)),
                               tfmt.to_words(_t(bad_m).to(torch.int64)))
    for f in ('sign', 'qidx', 'g_min', 'g_max'):
        _same(getattr(rec, f), getattr(rec_r, f))
    for f in TPK.DecodedUplink._fields:
        _same(getattr(dec, f), getattr(dec_r, f))
    assert dec.sign_ok.tolist() == [i != 1 for i in range(k)]
    assert dec.mod_ok.tolist() == [i != 4 for i in range(k)]


def test_live_encoder_equals_plain_encoder():
    """quantize_encode_wire (the quantize_pack wrapper; its plain version
    on the CPU) frames the same words as the quantizer then encode_wire."""
    k, l = 4, 777
    g = torch.as_tensor(_grads(k, l, 3))
    rand = torch.rand((k, l), generator=torch.Generator().manual_seed(1))
    live = TTR.quantize_encode_wire(g, rand, 3, 2)
    a = g.abs()
    qg = TQ.stochastic_quantize(g, 3, rand, a.amin(1, keepdim=True),
                                a.amax(1, keepdim=True))
    plain = TTR.encode_wire(qg, 2)
    assert all(torch.equal(x, y) for x, y in zip(live[:2], plain[:2]))
    assert live[2] == plain[2]


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_cnn_accuracy_matches_reference():
    params = RC.init_cnn(jax.random.PRNGKey(3))
    rng = np.random.RandomState(0)
    images = rng.randn(64, 32, 32, 3).astype(np.float32)
    pred = np.asarray(jnp.argmax(RC.cnn_forward(params,
                                                jnp.asarray(images)), -1))
    labels = np.where(rng.uniform(size=64) < 0.6, pred,
                      rng.randint(0, 10, 64)).astype(np.int32)
    want = RC.cnn_accuracy(params, jnp.asarray(images), jnp.asarray(labels))
    model = TC.CNN()
    model.load_state_dict(TC.params_from_jax(
        {k: np.asarray(v) for k, v in params.items()}))
    got = TC.cnn_accuracy(model, torch.as_tensor(images).permute(0, 3, 1, 2),
                          torch.as_tensor(labels).long())
    _same(got, np.asarray(want))
    assert 0.5 < float(got) < 1.0


@pytest.mark.parametrize('name', ['smollm-135m-reduced',
                                  'mamba2-130m-reduced',
                                  'zamba2-2.7b-reduced'])
def test_group_slice_matches_reference(name):
    """Attention, Mamba2, and Zamba2's shared weights outside the groups;
    the reference's function on the same tree as NumPy arrays."""
    cfg = TR_REG.get_arch(name)
    tp = TT.init_params(cfg, torch.Generator().manual_seed(1))
    ref = tree.map(lambda a: a.float().numpy(), tp)
    for g in range(TT.n_groups(cfg)):
        want = RT.group_slice(ref, g)
        got = TT.group_slice(tp, g)
        assert tree.paths(got) == [
            jax.tree_util.keystr(p, simple=True, separator='.')
            for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
        for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.float().numpy(), b)


# ---------------------------------------------------------------------------
# the engine's success probabilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('method,power', [('uniform', -18.0),
                                          ('alternating', -18.0),
                                          ('barrier', -8.0)])
def test_success_probs_is_the_engines_exit(method, power):
    rp, pp = problems(4, power, 31)
    batch = AJ.stack_problems([pp, problems(4, power, 32)[1]], device='cpu')
    sol = AJ.solve_traceable(batch, method, max_iters=1)
    bq, bp = AJ.success_probs(batch, sol.alpha, sol.beta)
    assert torch.equal(bq, sol.q) and torch.equal(bp, sol.p)
    # one problem alone (a batched solve is its single solves, bit for bit)
    alpha, beta = sol.alpha[0], sol.beta[0]
    q, p = AJ.success_probs(AJ.from_reference(pp, device='cpu'), alpha, beta)
    assert torch.equal(q, sol.q[0]) and torch.equal(p, sol.p[0])
    q_r, p_r = RA.success_probs_np(rp, alpha.numpy(), beta.numpy())
    tol = TOL['barrier' if method == 'barrier' else 'alternating']['qp_atol']
    np.testing.assert_allclose(q.numpy(), q_r, rtol=0, atol=tol)
    np.testing.assert_allclose(p.numpy(), p_r, rtol=0, atol=tol)
