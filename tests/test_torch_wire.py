"""Wire layer of the PyTorch port against the JAX reference: bit-plane
packing, framing, bitcasts, stamps, the counter PRF, the bit channel and
packet encode/decode.  Every output here is integer (or a bitcast) and
must match bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import seeds, words_np
from repro.wire import corrupt as WC
from repro.wire import format as fmt
from repro.wire import packets as PK
from repro_torch.wire import corrupt as TC
from repro_torch.wire import format as tfmt
from repro_torch.wire import packets as TPK


@pytest.mark.parametrize('bits', range(1, 9))
@pytest.mark.parametrize('n', [1, 31, 32, 33, 63, 65, 1000, 4097])
def test_pack_unpack_matches_reference(bits, n):
    rng = np.random.RandomState(1000 * bits + n)
    vals = rng.randint(0, 2 ** bits, (3, n)).astype(np.uint32)
    ref = np.asarray(fmt.pack_bits_ref(jnp.asarray(vals), bits))
    got = tfmt.pack_bits_ref(torch.as_tensor(vals.astype(np.int64)), bits)
    np.testing.assert_array_equal(words_np(got), ref)
    assert got.shape[-1] == tfmt.payload_words(n, bits)
    back = tfmt.unpack_bits_ref(got, n, bits)
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(fmt.unpack_bits_ref(jnp.asarray(ref), n,
                                                     bits)))


def test_pack_full_width_words():
    """Bit 31 set: the int32 pattern must stay the uint32 word."""
    vals = np.full((2, 64), 1, np.uint32)
    ref = np.asarray(fmt.pack_bits_ref(jnp.asarray(vals), 1))
    got = tfmt.pack_bits_ref(torch.ones((2, 64), dtype=torch.int64), 1)
    assert ref[0, 0] == 0xFFFFFFFF
    np.testing.assert_array_equal(words_np(got), ref)


def test_sizes_and_sign_bits():
    for n in (1, 62006, 4097):
        for bits in (1, 3, 8):
            assert tfmt.sign_packet_words(n) == fmt.sign_packet_words(n)
            assert (tfmt.modulus_packet_words(n, bits)
                    == fmt.modulus_packet_words(n, bits))
            assert (tfmt.measured_uplink_bits(n, bits, 20)
                    == fmt.measured_uplink_bits(n, bits, 20))
    sign = np.array([-1, 0, 1, 1, -1], np.int8)
    np.testing.assert_array_equal(
        tfmt.sign_to_bits(torch.as_tensor(sign)).numpy(),
        np.asarray(fmt.sign_to_bits(jnp.asarray(sign))))
    np.testing.assert_array_equal(
        tfmt.bits_to_sign(torch.tensor([0, 1, 1])).numpy(),
        np.asarray(fmt.bits_to_sign(jnp.asarray([0, 1, 1]))))


@pytest.mark.parametrize('w', [1, 2, 5, 64, 1937, 5822])
def test_xor_fold_and_verify_frame(w):
    rng = np.random.RandomState(w)
    words = rng.randint(0, 2 ** 32, (4, w), dtype=np.uint64).astype(np.uint32)
    t = torch.as_tensor(words.view(np.int32))
    np.testing.assert_array_equal(words_np(tfmt.xor_fold(t)),
                                  np.asarray(fmt.xor_fold(jnp.asarray(words))))
    np.testing.assert_array_equal(
        tfmt.verify_frame(t).numpy(),
        np.asarray(fmt.verify_frame(jnp.asarray(words))))


def test_bitcasts_stamps_and_restamp():
    xs = np.array([0.0, -0.0, 1.5, -3.25e-8, np.inf, 3.4e38], np.float32)
    ref_w = np.asarray(fmt.f32_to_word(jnp.asarray(xs)))
    got_w = tfmt.f32_to_word(torch.as_tensor(xs))
    np.testing.assert_array_equal(words_np(got_w), ref_w)
    np.testing.assert_array_equal(
        tfmt.word_to_f32(got_w).numpy().view(np.uint32), xs.view(np.uint32))
    for rnd, att in ((0, 0), (5, 1), (2 ** 24 + 7, 3), (123, 255)):
        ref = int(fmt.stamp_round(rnd, att))
        assert tfmt.stamp_round(rnd, att) == ref
        word = torch.tensor([tfmt.word(ref)], dtype=torch.int32)
        assert int(tfmt.round_of(word)) == int(fmt.round_of(jnp.uint32(ref)))
        assert int(tfmt.attempt_of(word)) == int(fmt.attempt_of(
            jnp.uint32(ref)))
    rng = np.random.RandomState(3)
    body = rng.randint(0, 2 ** 32, (3, 9), dtype=np.uint64).astype(np.uint32)
    framed = np.asarray(fmt.frame([7, 8, 9], jnp.asarray(body[0])))
    got = tfmt.frame([7, 8, 9], torch.as_tensor(body[0].view(np.int32)))
    np.testing.assert_array_equal(words_np(got), framed)
    ref = np.asarray(fmt.restamp_word(jnp.asarray(framed), 1,
                                      jnp.uint32(0xDEADBEEF)))
    got = tfmt.restamp_word(got, 1, 0xDEADBEEF)
    np.testing.assert_array_equal(words_np(got), ref)
    assert bool(tfmt.verify_frame(got))


@pytest.mark.parametrize('plane', [0, 1, 17, 31])
def test_hash_bits_matches_reference(plane):
    rng = np.random.RandomState(plane)
    idx = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    idx[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    s0, s1 = 0xFFFFFFFF, 0x12345678
    ref = np.asarray(WC.hash_bits(jnp.asarray(idx), plane, jnp.uint32(s0),
                                  jnp.uint32(s1)))
    got = TC.hash_bits(torch.as_tensor(idx.astype(np.int64)), plane, s0, s1)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_flip_threshold_matches_reference():
    rng = np.random.RandomState(0)
    ber = np.concatenate([[0.0, 1e-9, 0.5, 1.0, 1.5, -0.1, 2.0 ** -33,
                           3 * 2.0 ** -33],
                          rng.uniform(0, 1e-3, 64),
                          rng.uniform(0, 1, 64)]).astype(np.float32)
    rt, ra = WC.flip_threshold(jnp.asarray(ber))
    gt, ga = TC.flip_threshold(torch.as_tensor(ber))
    np.testing.assert_array_equal(gt.numpy().astype(np.uint32),
                                  np.asarray(rt))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))


@pytest.mark.parametrize('k,w,word0', [(1, 40, 0), (4, 513, 0),
                                       (3, 100, 12345), (2, 77, 2 ** 32 - 50)])
def test_corrupt_fold_matches_reference(k, w, word0):
    rng = np.random.RandomState(k * w)
    words = rng.randint(0, 2 ** 32, (k, w), dtype=np.uint64).astype(np.uint32)
    ber = rng.uniform(0.0, 0.05, k).astype(np.float32)
    ber[0] = 1.0 if k > 2 else ber[0]            # the all-flip edge
    key = jax.random.PRNGKey(k + w)
    rx, fold, flips = WC.corrupt_fold(key, jnp.asarray(words),
                                      jnp.asarray(ber), jnp.uint32(word0))
    grx, gfold, gflips = TC.corrupt_fold(
        seeds(key), torch.as_tensor(words.view(np.int32)),
        torch.as_tensor(ber), word0)
    np.testing.assert_array_equal(words_np(grx), np.asarray(rx))
    np.testing.assert_array_equal(words_np(gfold), np.asarray(fold))
    np.testing.assert_array_equal(gflips.numpy(), np.asarray(flips))
    assert int(gflips.sum()) > 0


@pytest.mark.parametrize('n,bits', [(1, 1), (37, 3), (1000, 8), (4097, 3)])
def test_packets_encode_decode_match_reference(n, bits):
    rng = np.random.RandomState(n + bits)
    k = 3
    sign = rng.choice([-1, 0, 1], (k, n)).astype(np.int8)
    qidx = rng.randint(0, 2 ** bits, (k, n)).astype(np.int32)
    gmin = rng.uniform(0, 0.1, k).astype(np.float32)
    gmax = rng.uniform(0.5, 1, k).astype(np.float32)
    rs, rm = PK.encode_uplink_batch(jnp.asarray(sign), jnp.asarray(qidx),
                                    jnp.asarray(gmin), jnp.asarray(gmax),
                                    bits=bits, round_idx=6)
    ts, tm = TPK.encode_uplink_batch(
        torch.as_tensor(sign), torch.as_tensor(qidx), torch.as_tensor(gmin),
        torch.as_tensor(gmax), bits=bits, round_idx=6)
    np.testing.assert_array_equal(words_np(ts), np.asarray(rs))
    np.testing.assert_array_equal(words_np(tm), np.asarray(rm))
    # damage one word of client 1's modulus packet and one sign header
    rm_bad = np.asarray(rm).copy()
    rm_bad[1, -2] ^= 0x10
    rs_bad = np.asarray(rs).copy()
    rs_bad[2, 0] ^= 1
    ref = PK.decode_uplink_batch(jnp.asarray(rs_bad), jnp.asarray(rm_bad),
                                 n=n, bits=bits)
    got = TPK.decode_uplink_batch(torch.as_tensor(rs_bad.view(np.int32)),
                                  torch.as_tensor(rm_bad.view(np.int32)),
                                  n=n, bits=bits)
    for name in ('sign', 'qidx', 'g_min', 'g_max', 'client_id', 'round_idx',
                 'sign_ok', 'mod_ok'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert list(got.sign_ok.numpy()) == [True, True, False]
    assert list(got.mod_ok.numpy()) == [True, False, True]
    np.testing.assert_array_equal(
        words_np(TPK.sign_payload(ts)), np.asarray(PK.sign_payload(rs)))
    np.testing.assert_array_equal(
        words_np(TPK.mod_payload(tm)), np.asarray(PK.mod_payload(rm)))
    for a in (1, 2):
        np.testing.assert_array_equal(
            words_np(TPK.restamp_sign_retx(ts, a)),
            np.asarray(PK.restamp_sign_retx(rs, a)))
    rmin, rmax = PK.mod_header_ranges(rm)
    tmin, tmax = TPK.mod_header_ranges(tm)
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(rmin))
    np.testing.assert_array_equal(tmax.numpy(), np.asarray(rmax))
